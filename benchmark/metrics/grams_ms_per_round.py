"""``grams_ms_per_round``: the Grams (``graphs.compute_grams`` ->
``models/dnmf.py``, ``ops/gram_analytic.py``): CUDA events around each
call (``cardbench.trace``), summed over the window, per round.  A round
is one of ``Run.rounds_done``: in a cell that refines (``wb_refine``)
the refinement's rounds count too."""


def read(run):
    if run.spans is None or not run.rounds_done:
        return None
    return 1e3 * run.spans.get("grams", 0.0) / run.rounds_done
