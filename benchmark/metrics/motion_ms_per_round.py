"""``motion_ms_per_round``: the motion epoch (``graphs.motion_epoch`` ->
``models/dnmf.py``): CUDA events around each call (``cardbench.trace``),
summed over the window, per round.  A round is one of
``Run.rounds_done``: in a cell that refines (``wb_refine``) the
refinement's rounds count too."""


def read(run):
    if run.spans is None or not run.rounds_done:
        return None
    return 1e3 * run.spans.get("motion", 0.0) / run.rounds_done
