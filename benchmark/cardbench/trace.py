"""What a ``--trace 1`` run reads: CUDA-event spans around the engine's
steps, host-clock spans around a streamed source's reads, and
``torch.profiler`` over one whole job.

The spans wrap the module attributes of ``dnmf_tpu_torch.models.graphs``
that the trainer calls (:data:`STEPS`), from here, without editing the
package: each call gets a start and an end event on the current stream
and a ``record_function`` label that the profile's host side carries.
:class:`Fills` wraps the ``_fill`` of one streamed source the same way,
on the host's clock.
"""

from __future__ import annotations

import collections
import time

import torch

# graphs attribute -> the span's name; a streamed fit's steps count as
# the resident fit's
STEPS = {"motion_epoch": "motion", "compute_grams": "grams",
         "motion_epoch_streaming": "motion",
         "compute_grams_streaming": "grams",
         "footprint_update": "traces", "refine_positions": "refine",
         "tracked_grams": "tracked_grams"}
NAME_CHARS = 160  # of a device activity's name in the breakdown


class Spans:
    """Start and end events of every wrapped call, by span name."""

    def __init__(self, module):
        self.module = module
        self.events = collections.defaultdict(list)
        self._saved = {}

    def install(self) -> None:
        for attr, name in STEPS.items():
            fn = getattr(self.module, attr)
            self._saved[attr] = fn
            setattr(self.module, attr, self._wrap(fn, name))

    def uninstall(self) -> None:
        for attr, fn in self._saved.items():
            setattr(self.module, attr, fn)
        self._saved = {}

    def clear(self) -> None:
        """Forget the events recorded so far; the wrappers stay."""
        for ev in self.events.values():
            ev.clear()

    def _wrap(self, fn, name):
        events = self.events[name]

        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(f"span.{name}"):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            events.append((start, end))
            return out

        return wrapped

    def seconds(self) -> dict:
        """Total seconds between each span's events, by span name."""
        torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in ev) * 1e-3
                for name, ev in self.events.items()}


class Fills:
    """Host seconds and bytes of a streamed source's ``_fill`` calls (the
    wait on the reader's prefetch of a block and its copy into the pinned
    buffer), by a wrapper on the source instance, each call labelled
    ``span.fill`` for the profile."""

    def __init__(self, source):
        self.source = source
        self.seconds = 0.0
        self.bytes = 0

    def install(self) -> None:
        fill = self.source._fill

        def wrapped(start, stop, out, voxels):
            with torch.profiler.record_function("span.fill"):
                t0 = time.perf_counter()
                fill(start, stop, out, voxels)
                self.seconds += time.perf_counter() - t0
            self.bytes += (stop - start) * out.shape[1] * 4  # float32
        self.source._fill = wrapped

    def uninstall(self) -> None:
        del self.source._fill  # the class's method again

    def clear(self) -> None:
        self.seconds, self.bytes = 0.0, 0


def _attr(event, *names):
    for n in names:
        if hasattr(event, n):
            return getattr(event, n)()
    raise AttributeError(names)


class Profile:
    """One profiled stretch: its device activities (kernels, copies and
    fills) and the host's ``span.*`` and ``job`` labels, in microseconds
    on the profiler's clock."""

    def __init__(self, prof, wall_s: float):
        self.wall_s = wall_s
        self.device, self.labels = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            try:
                start = _attr(e, "start_ns") * 1e-3
                dur = _attr(e, "duration_ns") * 1e-3
            except AttributeError:
                start, dur = _attr(e, "start_us"), _attr(e, "duration_us")
            if e.device_type() == cuda:
                if not (name.startswith("span.") or name == "job"):
                    self.device.append((name, start, start + dur))
            elif name.startswith("span.") or name == "job":
                self.labels.append((name, start, start + dur))

    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def kernel_seconds(self, names) -> float:
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) * 1e-6

    def kernel_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.device if name in n)

    def top_ops(self, n: int = 10) -> list:
        """The device activities that took most time, by name (cut to
        :data:`NAME_CHARS`), with their seconds."""
        by = collections.Counter()
        for name, s, e in self.device:
            by[name[:NAME_CHARS]] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches without device activity inside the job,
        each named by the innermost host label around its start."""
        dev = sorted(self.device, key=lambda d: d[1])
        gaps, end = [], None
        for _, s, e in dev:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            around = [lab for lab in self.labels if lab[1] <= a <= lab[2]]
            inner = min(around, key=lambda lab: lab[2] - lab[1],
                        default=("no label", 0, 0))
            name = inner[0] if inner[0] != "job" else "trainer, between steps"
            out.append([f"{name} @{(a - dev[0][1]) * 1e-6:.4f}s",
                        (b - a) * 1e-6])
        return out


def profile(fn):
    """Run ``fn()`` under ``torch.profiler`` (host and device), ending in
    a synchronize: ``(fn's result, Profile)``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("job"):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, Profile(prof, wall)

