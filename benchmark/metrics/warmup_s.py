"""``warmup_s`` (compiled programs, ``models/graphs.py``): the eager
warm-up seconds of every cached graph entry after set-up
(``Entry.warmup_seconds``, a part of ``capture_s``).  Nothing where the
entries do not count it."""


def read(run):
    seconds = [getattr(e, "warmup_seconds", None) for e in run.entries]
    if not seconds or None in seconds:
        return None
    return sum(seconds)
