"""``fill_ms_per_round`` (reader, ``data/streaming.py`` ->
``native/blockreader.cpp``): the host milliseconds inside a streamed
source's ``_fill`` (the wait on the native reader's prefetch of a block
and its copy into the pinned buffer; ``cardbench.trace.Fills``), summed
over the window, per round.  Nothing where no source streamed."""


def read(run):
    if not run.fill_bytes or not run.rounds_done:
        return None
    return 1e3 * run.fill_seconds / run.rounds_done
