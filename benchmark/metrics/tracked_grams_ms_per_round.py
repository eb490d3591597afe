"""``tracked_grams_ms_per_round`` (refinement, ``models/refine.py``): the
Grams and ``c1`` at per-frame positions (``graphs.tracked_grams``: the
tracked c1 pass and the closed form, or the tracked Gram pass): CUDA
events around each call (``cardbench.trace``), summed over the window,
per refine round."""


def read(run):
    if run.spans is None or not run.refine_rounds:
        return None
    return 1e3 * run.spans.get("tracked_grams", 0.0) / run.refine_rounds
