"""Spans: labels on ``torch.profiler``'s timeline at the port's layer
boundaries.

``span(name)`` is a context manager.  While a ``torch.profiler`` records,
it is ``record_function("span." + name)``: a host label stamped on the
profiler's one clock beside the device's kernels and copies, nested in
the spans around it (``engine.fit`` holds a job's).  Otherwise it is one
shared ``nullcontext``: a flag read, nothing allocated or recorded.  The
spans live in the profile (``runtime.profile_dir`` writes it), nowhere
else.

They mark the engine's steps and reads (:mod:`dnmf_tpu_torch.engine.
trainer`) and the graph cache's load, replay, outputs and captures
(:mod:`dnmf_tpu_torch.models.graphs`); never a function that a graph
captures, whose labels a replay would not run.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function("span." + name)`` while a profiler records, else
    one shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function("span." + name)
    return _OFF
