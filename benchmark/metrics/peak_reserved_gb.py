"""``peak_reserved_gb``: ``torch.cuda.max_memory_reserved()`` over the
window, reset at its start once set-up's temporaries are freed."""


def read(run):
    if not run.peak_reserved_bytes:
        return None
    return run.peak_reserved_bytes / 1e9
