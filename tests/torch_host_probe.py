"""The host probe of the captured steps (imports no JAX).

A ``TorchDispatchMode`` that logs, with the port's line that ran it,
every op of :data:`HOST_OPS` that a step of ``models/graphs.py`` must not
run: a tensor made from host data (``aten.lift_fresh``: a copy from
pageable host memory, which a CUDA graph cannot hold), a host read
(``aten._local_scalar_dense``) and a collective (``c10d.*``, e.g.
``c10d.allreduce_``, ``c10d.allgather_``: a mesh's collectives run
between the replays, never inside one).  :func:`probed_replays` runs
every replay of a CPU entry (which calls its step eagerly on its
buffers) under the probe.
"""

from __future__ import annotations

import contextlib
import traceback

from torch.utils._python_dispatch import TorchDispatchMode

HOST_OPS = ("aten.lift_fresh", "aten._local_scalar_dense", "c10d.")


class HostProbe(TorchDispatchMode):
    """Logs the ops of :data:`HOST_OPS` with the port's line that ran
    them."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(HOST_OPS):
            where = [f"{f.filename.split('dnmf_tpu_torch/')[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "dnmf_tpu_torch/" in f.filename]
            self.hits.append((name, where[-1] if where else "?"))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def probed_replays():
    """Every ``graphs.Entry.replay`` inside the context under a
    :class:`HostProbe`; yields the list of ``(entry name, op, line)``
    hits.  Before an entry's first replay its step runs once, unprobed,
    on copies of its buffers: the warm-up that precedes a capture on the
    card, which builds the constants made from host data (cached per
    shape, read by the graph at their addresses)."""
    from dnmf_tpu_torch.models import graphs

    hits, replay = [], graphs.Entry.replay

    def probed(entry):
        if entry.replays == 0 and entry.step is not None:
            entry.step(*(buf.clone() for buf in entry.inputs))
        with HostProbe() as probe:
            replay(entry)
        hits.extend((entry.name,) + hit for hit in probe.hits)

    graphs.Entry.replay = probed
    try:
        yield hits
    finally:
        graphs.Entry.replay = replay
