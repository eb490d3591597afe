"""``frames_per_s``: ``T`` times the rounds completed in the window, over
the window's wall seconds, from the first job's start to the last job's
synchronized end; host clock.  The rounds are ``Run.rounds_done``: the
fit's, and in a cell that refines (``wb_refine``) the refinement's too,
each a pass over every frame."""


def read(run):
    if not run.rounds_done:
        return None
    return run.frames * run.rounds_done / run.window_s
