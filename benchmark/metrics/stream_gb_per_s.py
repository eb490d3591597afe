"""``stream_gb_per_s`` (reader, ``data/streaming.py`` ->
``native/blockreader.cpp``): the bytes that a streamed source's ``_fill``
handed to the fit in the window (``cardbench.trace.Fills``), over the
window's wall seconds, in GB/s: the rate at which the reader fed the
fit.  Nothing where no source streamed."""


def read(run):
    if not run.fill_bytes or not run.window_s:
        return None
    return run.fill_bytes / run.window_s / 1e9
