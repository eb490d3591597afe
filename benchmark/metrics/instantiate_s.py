"""``instantiate_s`` (compiled programs, ``models/graphs.py``): the seconds
of every cached graph entry's ``instantiate()`` and the read of its kernel
nodes after set-up (``Entry.instantiate_seconds``, a part of
``capture_s``).  Nothing where the entries do not count it."""


def read(run):
    seconds = [getattr(e, "instantiate_seconds", None) for e in run.entries]
    if not seconds or None in seconds:
        return None
    return sum(seconds)
