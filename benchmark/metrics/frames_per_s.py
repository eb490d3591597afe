"""``frames_per_s``: ``T`` times the rounds completed in the window, over
the window's wall seconds, from the first job's start to the last job's
synchronized end; host clock."""


def read(run):
    if not run.rounds_done:
        return None
    return run.frames * run.rounds_done / run.window_s
