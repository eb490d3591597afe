"""``refine_ms_per_round`` (refinement, ``models/refine.py``): the position
fit (``graphs.refine_positions``: a refine round's Adam epochs, refine
kernel D each): CUDA events around each call (``cardbench.trace``),
summed over the window, per refine round."""


def read(run):
    if run.spans is None or not run.refine_rounds:
        return None
    return 1e3 * run.spans.get("refine", 0.0) / run.refine_rounds
