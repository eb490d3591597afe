"""``capture_s`` (compiled programs, ``models/graphs.py``): the warm-up and
capture seconds of every cached graph entry after set-up
(``Entry.capture_seconds``)."""


def read(run):
    if not run.entries:
        return None
    return sum(e.capture_seconds for e in run.entries)
