"""``graph_buffers_gb`` (compiled programs, ``models/graphs.py``): the
cached entries' own static buffers (``Entry.buffer_bytes``) and the
streamed entries' shared frame buffers (``graphs.shared_bytes()``)."""


def read(run):
    if not run.entries:
        return None
    return (sum(e.buffer_bytes for e in run.entries)
            + run.shared_bytes) / 1e9
