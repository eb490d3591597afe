"""Captured CUDA graphs of the main path's steps: the port's ``jax.jit``.

The JAX package compiles each step of ``DeformableNMF.fit`` (the motion
epoch, the Grams, the trace update) and the whole ``fused_rounds``
schedule into one device program.  Here a step runs once eagerly on a
side stream (the warm-up: the kernels' build, cuBLAS's handle and
workspace, the kernels' shared-memory attributes), is captured into a
``torch.cuda.CUDAGraph`` on the same stream, and from then on is
replayed: one graph launch per step in place of its hundreds or
thousands of launches.  :func:`fused_rounds` captures one whole round
(the motion epochs, the Grams and the trace update), which carries its
state into its own input buffers, and replays it ``rounds`` times.

Where it applies.  Each function here decides for itself: with
``use_kernels`` and outside :func:`disabled` it goes through the cache,
else it calls its step function of :mod:`~dnmf_tpu_torch.models.dnmf`
directly (the plain route, the eager run that a captured one is held
against; :func:`disabled` is ``jax.disable_jit``'s counterpart).  On the
card an entry holds a graph; on the CPU, which has none, it holds the
step function and calls it on its buffers at each replay: the same key
and buffer protocol, run eagerly.  A capture or replay error raises;
nothing falls back to the eager path.

Cache.  One entry per key; the key holds what ``jax.jit`` treats as
static (the model, the optimizer, ``gamma``, the frame block, the Gram
mode and window, the iterations, the solver, ``use_kernels``) and every
input's shape, dtype, strides and device, with the video's address,
shape and strides.  At most :data:`MAX_ENTRIES` entries are kept, the
least recently used dropped first; :func:`clear` drops them all and
:func:`entries` lists them.

Inputs and outputs.  A call copies the state's leaves (``beta``, ``c``,
``pos``, ``sigma``, ``count``, ``mu``, ``nu``; the trace update also the
Grams) into the entry's static buffers, then replays.  The video is read
in place at the address in the key, never copied.  What a call returns
is a clone of the graph's output, or the caller's own input where the
step passes it through: no tensor handed out is one that a later replay
overwrites.

Launch counts.  The kernel wrappers of :mod:`~dnmf_tpu_torch.ops.fused`
count their launches in Python, which a replay does not run.  A capture
launches nothing and takes back what its wrappers counted.  The launches
of a replay are read from the captured graph itself (:func:`kernel_nodes`:
each wrapper's last kernel, :data:`LAST_KERNEL`, one node per call); the
capture raises where they differ from what the wrappers counted, and
every replay adds them to the wrappers' counters.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import time
from typing import Optional

import torch

from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.ops import fused

# Entries kept: ``fit`` holds three (motion epoch, Grams, trace update),
# ``fit_fused`` one.
MAX_ENTRIES = 8

# The kernel that each wrapper of the captured steps launches last, once
# per call (csrc/motion.cu, csrc/c1.cu, csrc/gram.cu).
LAST_KERNEL = {"motion_block": "motion_finish", "c1_block": "c1_finish",
               "gram_block": "gram_assemble"}

_entries: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()
_streams = {}  # device -> the side stream of warm-ups and captures
_disabled = 0  # depth of disabled() contexts


@contextlib.contextmanager
def disabled():
    """Run every step eagerly inside this context (``jax.disable_jit``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def _cached(use_kernels: bool) -> bool:
    return bool(use_kernels) and not _disabled


def clear() -> None:
    """Drop every entry (its graph and buffers)."""
    _entries.clear()


def entries() -> list:
    """The cached entries, least recently used first."""
    return list(_entries.values())


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API."""

    _fields_ = ([("func", ctypes.c_void_p)]
                + [(f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z",
                                                "block_x", "block_y",
                                                "block_z", "shared")]
                + [(f, ctypes.c_void_p) for f in ("params", "extra", "kern",
                                                  "ctx")])


def _driver_call(lib, name: str, *args) -> None:
    err = getattr(lib, name)(*args)
    if err:
        raise RuntimeError(f"{name} failed: CUresult {err}")


def kernel_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """The kernel nodes of a graph captured with ``keep_graph=True``, by
    kernel (mangled) name, read from the graph with the driver API
    (``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams``, then
    ``cuFuncGetName`` or ``cuKernelGetName``).  Copy and memset nodes are
    not kernels."""
    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _driver_call(lib, "cuGraphGetNodes", handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _driver_call(lib, "cuGraphGetNodes", handle, nodes, ctypes.byref(n))
    kind, out = ctypes.c_int(), {}
    for node in nodes[:n.value]:
        node = ctypes.c_void_p(node)
        _driver_call(lib, "cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params, name = _KernelNodeParams(), ctypes.c_char_p()
        _driver_call(lib, "cuGraphKernelNodeGetParams_v2", node,
                     ctypes.byref(params))
        if params.func:
            _driver_call(lib, "cuFuncGetName", ctypes.byref(name),
                         ctypes.c_void_p(params.func))
        else:
            _driver_call(lib, "cuKernelGetName", ctypes.byref(name),
                         ctypes.c_void_p(params.kern))
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out


class Entry:
    """One captured step: static input buffers, the graph (on the card) or
    the step function (on the CPU) and its outputs.

    ``replays`` counts the calls, ``capture_seconds`` is the warm-up and
    the capture, ``buffer_bytes`` the static buffers'; on the card
    ``nodes`` are the graph's kernel nodes by kernel name and
    ``launches`` each wrapper's launches in one replay, read from them.
    """

    def __init__(self, name: str, step, args):
        self.name = name
        self.inputs = tuple(a.clone() for a in args)
        self.replays = 0
        self.buffer_bytes = _nbytes(self.inputs)
        self.nodes, self.launches = {}, {}
        device = self.inputs[0].device
        t0 = time.perf_counter()
        if device.type == "cuda":
            self.graph, self.step = self._capture(step, device), None
        else:
            self.graph, self.step, self.outputs = None, step, ()
        self.capture_seconds = time.perf_counter() - t0

    def _capture(self, step, device):
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            step(*self.inputs)  # the warm-up
        before = fused.launch_counts()
        # The graph is kept beside its instance, so that its nodes can be
        # read (:func:`kernel_nodes`).
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.graph(graph, stream=stream):
                self.outputs = tuple(step(*self.inputs))
        finally:  # a capture launches nothing, even one that raised
            counted = {k: n - before[k]
                       for k, n in fused.launch_counts().items()}
            fused.add_launch_counts({k: -n for k, n in counted.items()})
        graph.instantiate()
        self.nodes = kernel_nodes(graph)
        self.launches = {
            wrapper: sum(n for k, n in self.nodes.items() if last in k)
            for wrapper, last in LAST_KERNEL.items()}
        differ = {k: (n, self.launches.get(k, 0)) for k, n in counted.items()
                  if n != self.launches.get(k, 0)}
        if differ:
            raise RuntimeError(
                f"{self.name}: the captured graph's kernels differ from its "
                f"wrappers' launches (wrapper: (launched, in the graph)): "
                f"{differ}")
        return graph

    def __call__(self, args) -> tuple:
        """Copy ``args`` into the buffers, replay, and hand out the
        outputs (:meth:`outputs_for`)."""
        self.load(args)
        self.replay()
        return self.outputs_for(args)

    def load(self, args) -> None:
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)

    def replay(self) -> None:
        self.replays += 1
        if self.graph is None:
            self.outputs = tuple(self.step(*self.inputs))
            return
        self.graph.replay()
        fused.add_launch_counts(self.launches)

    def outputs_for(self, args) -> tuple:
        """Each output as the caller's own input where the step passed that
        input through, else a clone."""
        out = []
        for o in self.outputs:
            same = [a for buf, a in zip(self.inputs, args) if o is buf]
            out.append(same[0] if same else o.clone())
        return tuple(out)


def _signature(*tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.stride(), t.device)
                 for t in tensors)


def _video_key(video: torch.Tensor) -> tuple:
    return (video.data_ptr(), tuple(video.shape), video.stride(),
            video.dtype, video.device)


def _entry(key: tuple, make) -> Entry:
    """The entry of ``key``, made by ``make()`` on a miss; the least
    recently used entries past :data:`MAX_ENTRIES` are dropped."""
    entry = _entries.get(key)
    if entry is None:
        entry = make()
        _entries[key] = entry
        while len(_entries) > MAX_ENTRIES:
            _entries.popitem(last=False)
    else:
        _entries.move_to_end(key)
    return entry


def _leaves(state: model_lib.DNMFState) -> tuple:
    return tuple(getattr(state, name) for name in model_lib.STATE_FIELDS)


def _state(leaves) -> model_lib.DNMFState:
    return model_lib.DNMFState(*leaves)


def _run(name: str, statics: tuple, step, args, video=None) -> tuple:
    key = (name,) + statics + _signature(*args) + (
        () if video is None else _video_key(video))
    return _entry(key, lambda: Entry(name, step, args))(args)


# ----------------------------------------------------------------------
# The captured steps
# ----------------------------------------------------------------------
def motion_epoch(state, video, model, optimizer, gamma: float,
                 frame_block: int = 16, use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.dnmf.motion_epoch_parallel` as one
    captured graph (eagerly without ``use_kernels`` or inside
    :func:`disabled`)."""
    if not _cached(use_kernels):
        return model_lib.motion_epoch_parallel(
            state, video, model, optimizer, gamma, frame_block, use_kernels)

    def step(*leaves):
        st, m = model_lib.motion_epoch_parallel(
            _state(leaves), video, model, optimizer, gamma, frame_block,
            use_kernels)
        return _leaves(st) + (m["recon_mse"], m["reg"])

    out = _run("motion_epoch", (model, optimizer, gamma, frame_block,
                                use_kernels), step, _leaves(state), video)
    return _state(out[:7]), {"recon_mse": out[7], "reg": out[8]}


def compute_grams(state, video, model, frame_block: int,
                  use_kernels: bool = False, gram_mode: str = "exact",
                  gram_window: Optional[int] = None):
    """:func:`~dnmf_tpu_torch.models.dnmf.grams_local` (no per-frame
    positions, no voxel range) as one captured graph: ``(grams, c1)``."""
    if not _cached(use_kernels):
        return model_lib.grams_local(state, video, model, frame_block,
                                     use_kernels, gram_mode, gram_window)

    def step(*leaves):
        return model_lib.grams_local(_state(leaves), video, model,
                                     frame_block, use_kernels, gram_mode,
                                     gram_window)

    return _run("compute_grams", (model, frame_block, use_kernels, gram_mode,
                                  gram_window), step, _leaves(state), video)


def footprint_update(state, grams, c1, iters: int, gamma: float = 0.0,
                     solver: str = "mu", use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.dnmf.footprint_update` as one
    captured graph; the Grams are inputs, copied like the state.
    ``use_kernels`` is the route of the steps around it: the update runs
    no kernel, and the plain route runs it eagerly."""
    if not _cached(use_kernels):
        return model_lib.footprint_update(state, grams, c1, iters, gamma,
                                          solver)

    def step(*args):
        return _leaves(model_lib.footprint_update(
            _state(args[:7]), args[7], args[8], iters, gamma, solver))

    out = _run("footprint_update", (iters, gamma, solver, use_kernels), step,
               _leaves(state) + (grams, c1))
    return _state(out)


def fused_rounds(state, video, model, optimizer, rounds: int, epochs: int,
                 mu_iters: int, gamma: float, mu_gamma: float = 0.0,
                 frame_block: int = 16, use_kernels: bool = False,
                 gram_mode: str = "exact", gram_window: Optional[int] = None,
                 trace_solver: str = "mu"):
    """:func:`~dnmf_tpu_torch.models.dnmf.fused_rounds`: one round
    (:func:`~dnmf_tpu_torch.models.dnmf.fused_round`) captured once and
    replayed ``rounds`` times.  The round copies its new state into its
    own input buffers, so the replays carry the state with no host work
    between them; after each replay its two metrics are copied on the
    device into the round's column of the history, which the caller
    reads once at the end."""
    kw = dict(epochs=epochs, mu_iters=mu_iters, gamma=gamma,
              mu_gamma=mu_gamma, frame_block=frame_block,
              use_kernels=use_kernels, gram_mode=gram_mode,
              gram_window=gram_window, trace_solver=trace_solver)
    if not _cached(use_kernels):
        return model_lib.fused_rounds(state, video, model, optimizer,
                                      rounds, **kw)
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")

    def step(*leaves):
        st, m = model_lib.fused_round(_state(leaves), video, model,
                                      optimizer, **kw)
        for buf, new in zip(leaves, _leaves(st)):
            buf.copy_(new)
        return m["recon_mse"], m["reg"]

    args = _leaves(state)
    key = ("fused_round", model, optimizer) + tuple(
        sorted(kw.items())) + _signature(*args) + _video_key(video)
    entry = _entry(key, lambda: Entry("fused_round", step, args))
    entry.load(args)
    history = []
    for r in range(rounds):
        entry.replay()
        if not history:
            history = [torch.empty((rounds,) + o.shape, dtype=o.dtype,
                                   device=o.device) for o in entry.outputs]
        for column, metric in zip(history, entry.outputs):
            column[r].copy_(metric)
    return (_state(tuple(buf.clone() for buf in entry.inputs)),
            {"recon_mse": history[0], "reg": history[1]})
