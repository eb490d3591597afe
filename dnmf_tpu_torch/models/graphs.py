"""Captured CUDA graphs of the main path's steps: the port's ``jax.jit``.

The JAX package compiles each step of ``DeformableNMF.fit`` (the motion
epoch, the Grams, the trace update, the width fit), the whole
``fused_rounds`` schedule, position refinement's two programs
(``refine_positions``, ``tracked_grams``) and the recordings round
(``jax.jit(jax.vmap(...))`` of ``parallel.batched_round``) into one
device program each, and so registration's and seeding's frame-block
steps (``rigid_correct_frames``, ``tile_and_correct_block`` with kernels F
and G, ``_accum_block`` and ``_accum_block_shifted``), the parity epoch
(``lax.scan`` of serial Adam steps) and ``StaticFootprintNMF.fit``'s
alternation.  Here a step runs once eagerly on a side stream
(the warm-up: the kernels' build, cuBLAS's handle and workspace, the
kernels' shared-memory attributes), is captured into a
``torch.cuda.CUDAGraph`` on the same stream, and from then on is
replayed: one graph launch per step in place of its hundreds or
thousands of launches.  :func:`fused_rounds` captures one whole round
(the motion epochs, the Grams and the trace update), which carries its
state into its own input buffers, and replays it ``rounds`` times.
:func:`refine_positions` (all its Adam epochs) and :func:`sigma_fit`
(all its steps) warm up on one epoch or step: the same kernels, scratch
shapes and handles, at a fraction of the eager run.
:func:`refined_rounds` runs refinement's rounds through three entries
(the positions, the tracked Grams, the trace update of
:func:`footprint_update` with ``gamma=0``), each replayed once a round.
:func:`rigid_block` and :func:`pwrigid_block` are a registration pass's
frame block (the correction and its finite sums), one entry per block
shape serving every template iteration; :func:`summary_blocks` folds a
seeding pass's blocks, its carry kept in the entry's buffers between
blocks.  :func:`motion_epoch_parity` captures one serial Adam step and
replays it once per batch, the step index on the card;
:func:`static_nmf_fit` one alternation, replayed once per iteration.
A host-streamed source's block steps (JAX's ``_stream_block_grads``,
``_stream_block_grams`` and ``_refined_rounds_block``) are
:func:`motion_epoch_streaming`, :func:`compute_grams_streaming` and
:func:`refined_rounds_streaming`, which run the plain streamed loops with
a block runner that replays the step (:func:`_stream`; one loop per step,
so the two routes' layouts are one): one entry per step and block shape,
replayed once per block of ``source.blocks()``, the zero-padded tail
included (its count of valid frames an int64 device scalar filled per
block); the motion epoch's one Adam step follows the pass eagerly, as in
the JAX package, and the refinement's entry holds a block's whole
alternation.

On a mesh (JAX's ``shard_map`` programs of ``parallel/sharded.py``,
``parallel/streaming.py`` and ``parallel/registration.py``) each rank
replays the same kind of entries between its collectives, which run
eagerly, outside any graph: on the clones of a step's outputs, on a
loop's own input buffers (the halo's exchange), and on a streamed
block's outputs in place, which its caller copies into the rank's
buffers before the next block's replay.  :func:`mesh_steps` is the step
runner that the sharded functions of :mod:`dnmf_tpu_torch.parallel` take
from their ``use_kernels`` (the motion epoch one entry on a
time-only mesh, two on a pixel axis with the mean over it between; the
Grams one, ``p_offset`` in the key, then the sum over the pixel axis; the
trace update one, or with smoothing one iteration replayed ``iters``
times with the halo's ``all_gather`` between; the streamed blocks through
:func:`_stream`), and refinement, the width fit, the recordings round on
a ``batch`` axis and registration's frame blocks go through the entries
of one device, on the rank's shard.

Where it applies.  Each function here decides for itself: with
``use_kernels`` (registration and seeding: always) and outside
:func:`disabled` it goes through the cache,
else it calls its step function of :mod:`~dnmf_tpu_torch.models.dnmf`
directly (the plain route, the eager run that a captured one is held
against; :func:`disabled` is ``jax.disable_jit``'s counterpart).  On the
card an entry holds a graph; on the CPU, which has none, it holds the
step function and calls it on its buffers at each replay: the same key
and buffer protocol, run eagerly.  A capture or replay error raises;
nothing falls back to the eager path.

Cache.  One entry per key; the key holds what ``jax.jit`` treats as
static (the model, the optimizer, ``gamma``, the frame block, the Gram
mode and window, the iterations, epochs or steps, the learning rate,
the solver, ``use_kernels``, a pixel shard's voxel range ``p_offset``)
and every input's shape, dtype, strides and
device, with the video's address, shape and strides.  At most
:data:`MAX_ENTRIES` entries are kept, the least recently used dropped
first; :func:`clear` drops them all and :func:`entries` lists them.

Memory.  Every graph on a device is captured into one memory pool
(:func:`_pool`), which holds the temporaries of the largest step once,
beside each entry's outputs: a pool per entry held each step's whole
working set (several GB for a whole-brain registration block).  Sharing
is safe because no output of a graph is read after another entry's
replay: each call clones the outputs it hands out right after its own
replay (:meth:`Entry.outputs_for`, :func:`_registration_block`),
:func:`fused_rounds` copies its metrics into a history allocated
outside the capture after each of its replays, and the carries of
:func:`fused_rounds`, :func:`summary_blocks`, :func:`motion_epoch_parity`
and :func:`static_nmf_fit` live in the entries' input buffers, which are
allocated outside the capture.

Inputs and outputs.  A call copies the state's leaves (``beta``, ``c``,
``pos``, ``sigma``, ``count``, ``mu``, ``nu``; the trace update also the
Grams, refinement the per-frame positions, the width fit its subsampled
frames, warps and traces) into the entry's static buffers, then
replays.  The video (the recordings' videos) is read in place at the
address in the key, never copied; a registration or seeding block's
frames are copied into the entry's frame buffer (from the host where
they arrive from there), with the template, ``add_to_movie``, the
block's valid count and its shifts; a streamed block's frames (a device
tensor from the source's side stream) device to device into the one
frame buffer that the streamed entries share (each loads it just before
its own replay), with its slices of beta, C and the positions, padded at
the tail.  What a call returns
is a clone of the graph's output, or the caller's own input where the
step passes it through: no tensor handed out is one that a later replay
overwrites.

Launch counts.  The kernel wrappers of :mod:`~dnmf_tpu_torch.ops.fused`
count their launches in Python, which a replay does not run.  A capture
launches nothing and takes back what its wrappers counted.  The graph
itself is held to those counts (:func:`kernel_nodes`; each wrapper
launches its last kernel, :data:`LAST_KERNEL`, once per call, and
wrappers that share a kernel are summed: :func:`replay_launches`); the
capture raises where they differ, and every replay adds the wrappers'
counts to their counters.

Spans (:mod:`dnmf_tpu_torch.utils.trace`, labels while a profiler
records): ``graphs.call`` around a call of a step through the cache (its
key, lookup and the entry's work), ``graphs.load``, ``graphs.replay``
(the launch, host side) and ``graphs.outputs`` (the clones,
:func:`fused_rounds`' history copies); on a miss ``graphs.entry.<name>``
around the entry's making, with ``graphs.warmup``, ``graphs.capture`` and
``graphs.instantiate`` inside it on the card.  None is inside a step.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
import weakref
from typing import Optional

import torch

from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import mu as mu_ops
from dnmf_tpu_torch.utils import trace

# Entries kept.  One ``register_and_demix`` run holds at most fifteen:
# registration four (the rigid and the piecewise-rigid block, each also
# at the tail block's shape), seeding one (every block padded to one
# shape), then the engine's nine: ``fit`` three (motion epoch, Grams,
# trace update) and a fourth where the Gram audit falls back to exact
# Grams, the width fit one, ``refine`` three (positions, tracked Grams, a
# trace update of its own iterations) and ``fit_fused`` one.  A parity
# fit's epoch takes the motion epoch's place; ``StaticFootprintNMF.fit``
# holds one entry of its own.  A streamed source's run holds fewer: its
# streamed motion epoch and Grams (and the audit's exact Grams) take the
# resident ones' places, one entry takes refine's three, and a streamed
# source has no ``fit_fused``, so registration, seeding and the engine's
# seven make twelve.  A rank of a mesh holds fewer still: a sharded
# registration four, and an engine on a time mesh eight (``fit``'s motion
# epoch, Grams, the audit's exact Grams, one trace update, smoothed or
# not, with either solver; the width fit; ``refine``'s three; no
# ``fit_fused``), on a pixel axis five (the motion epoch's two entries,
# exact Grams, the trace update, the width fit; no refinement), a
# streamed fit five: at most twelve together.  Three more keep a second
# run's entries (another video) alive beside the fifteen.  An entry costs
# its buffers and outputs: the temporaries are the one shared pool's.
MAX_ENTRIES = 18

# The kernel that each wrapper of the captured steps launches last, once
# per call (csrc/motion.cu, csrc/c1.cu, csrc/gram.cu, csrc/gram_closed.cu,
# csrc/refine.cu, csrc/phasecorr.cu, csrc/warp.cu).  The tracked and rows
# wrappers launch their untracked twin's kernels.  cuFFT's kernels in the
# registration graphs are no wrapper's.
LAST_KERNEL = {"motion_block": "motion_finish", "c1_block": "c1_finish",
               "c1_block_tracked": "c1_finish",
               "gram_block": "gram_assemble",
               "gram_block_tracked": "gram_assemble",
               "gram_block_rows": "gram_assemble",
               "analytic_grams": "gram_closed",
               "refine_block": "refine_finish",
               "phase_corr_block": "window_argmax",
               "fused_separable_warp": "warp_tile"}

_entries: "collections.OrderedDict[tuple, Entry]" = collections.OrderedDict()
_streams = {}  # device -> the side stream of warm-ups and captures
_pools = {}  # device -> the memory pool that its entries' graphs share
# a streamed block's layout -> the frame buffer that the streamed entries
# share (:func:`_frame_buffer`)
_frame_buffers: "weakref.WeakValueDictionary[tuple, torch.Tensor]" = (
    weakref.WeakValueDictionary())
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


def _pool(device: torch.device) -> tuple:
    """The memory pool of the graphs on ``device``: one for all of them,
    so that the cache holds the largest step's temporaries once, beside
    each entry's outputs, rather than a pool per entry.  A new pool once
    no cached graph holds the last one (a pool whose graphs are all gone
    cannot be shared again)."""
    if not any(e.graph is not None and e.device == device
               for e in _entries.values()):
        _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


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


def replay_launches(nodes: dict, counted: dict) -> dict:
    """Each wrapper's launches in one replay: ``counted`` (its wrappers'
    counts during the capture), once the graph's kernel ``nodes`` (by
    mangled name) bear them out.  Per last kernel of :data:`LAST_KERNEL`,
    the nodes whose name holds it must number the launches of the
    wrappers that end in it, summed (a graph cannot tell ``c1_block``'s
    ``c1_finish`` from ``c1_block_tracked``'s); a wrapper outside the
    table must have launched nothing.  ``RuntimeError`` otherwise."""
    counted = {k: n for k, n in counted.items() if n}
    differ = {k: n for k, n in counted.items() if k not in LAST_KERNEL}
    for last in sorted(set(LAST_KERNEL.values())):
        want = sum(counted.get(k, 0) for k, v in LAST_KERNEL.items()
                   if v == last)
        have = sum(n for name, n in nodes.items() if last in name)
        if have != want:
            differ[last] = (want, have)
    if differ:
        raise RuntimeError(
            "the captured graph's kernels differ from its wrappers' "
            "launches (last kernel: (launched, in the graph); a wrapper "
            f"without one: launched): {differ}")
    return counted


class Entry:
    """One captured step: static input buffers, the graph (on the card) or
    the step function (on the CPU) and its outputs.

    ``replays`` counts the calls, ``capture_seconds`` is the warm-up and
    the capture, of which ``warmup_seconds`` the warm-up (to its end on
    the card) and ``instantiate_seconds`` the graph's ``instantiate()``
    and the read of its nodes, ``buffer_bytes`` its own static buffers'
    (not a shared one's: :func:`shared_bytes`); on the card
    ``nodes`` are the graph's kernel nodes by kernel name,
    ``launches`` each wrapper's launches in one replay (held to them)
    and ``warmup_launches`` the wrappers' launches in the warm-up.
    ``warmup`` (default: ``step``) is the warm-up's function.
    """

    def __init__(self, name: str, step, args, warmup=None, device=None,
                 shared=()):
        self.name = name
        with trace.span("graphs.entry." + name):
            # ``device``: the buffers' (default the first input's), where
            # an input arrives from elsewhere (host frames).  ``shared``:
            # the places of inputs that are buffers already, which other
            # entries hold too (the streamed frame buffer): kept, not
            # copied.
            self.inputs = tuple(
                a if i in shared else a.clone() if device is None
                else a.to(device, copy=True) for i, a in enumerate(args))
            self.replays = 0
            self.buffer_bytes = _nbytes(
                [a for i, a in enumerate(self.inputs) if i not in shared])
            self.nodes, self.launches, self.warmup_launches = {}, {}, {}
            self.warmup_seconds = self.instantiate_seconds = 0.0
            self.device = device = self.inputs[0].device
            t0 = time.perf_counter()
            if device.type == "cuda":
                self.graph = self._capture(step, warmup or step, device)
                self.step = None
            else:
                self.graph, self.step, self.outputs = None, step, ()
            self.capture_seconds = time.perf_counter() - t0

    def _capture(self, step, warmup, device):
        stream = _side_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        before = fused.launch_counts()
        t0 = time.perf_counter()
        with trace.span("graphs.warmup"), torch.cuda.stream(stream):
            warmup(*self.inputs)
            stream.synchronize()  # as the capture would, at its start
        self.warmup_seconds = time.perf_counter() - t0
        self.warmup_launches = {k: n - before[k] for k, n in
                                fused.launch_counts().items()
                                if n != before[k]}
        before = fused.launch_counts()
        # The graph is kept beside its instance, so that its nodes can be
        # read (:func:`kernel_nodes`).
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with trace.span("graphs.capture"), torch.cuda.graph(
                    graph, pool=_pool(device), stream=stream):
                self.outputs = tuple(step(*self.inputs))
        finally:  # a capture launches nothing, even one that raised
            counted = {k: n - before[k]
                       for k, n in fused.launch_counts().items()}
            fused.add_launch_counts({k: -n for k, n in counted.items()})
        t0 = time.perf_counter()
        with trace.span("graphs.instantiate"):
            graph.instantiate()
            self.nodes = kernel_nodes(graph)
        self.instantiate_seconds = time.perf_counter() - t0
        try:
            self.launches = replay_launches(self.nodes, counted)
        except RuntimeError as e:
            raise RuntimeError(f"{self.name}: {e}") from None
        return graph

    def __call__(self, args) -> tuple:
        """Copy ``args`` into the buffers, replay, and hand out the
        outputs (:meth:`outputs_for`)."""
        self.load(args)
        self.replay()
        return self.outputs_for(args)

    def load(self, args) -> None:
        with trace.span("graphs.load"):
            for buf, a in zip(self.inputs, args):
                if a is not buf:  # a carry that the step keeps in its buffers
                    buf.copy_(a)

    def replay(self) -> None:
        self.replays += 1
        with trace.span("graphs.replay"):
            if self.graph is None:
                self.outputs = tuple(self.step(*self.inputs))
                return
            self.graph.replay()
        fused.add_launch_counts(self.launches)

    def outputs_for(self, args) -> tuple:
        """Each output as the caller's own input where the step passed that
        input through, else a clone."""
        out = []
        with trace.span("graphs.outputs"):
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


def _run(name: str, statics: tuple, step, args, video=None,
         warmup=None) -> tuple:
    with trace.span("graphs.call"):
        key = (name,) + statics + _signature(*args) + (
            () if video is None else _video_key(video))
        return _entry(key, lambda: Entry(name, step, args, warmup))(args)


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
        with trace.span("graphs.outputs"):
            if not history:
                history = [torch.empty((rounds,) + o.shape, dtype=o.dtype,
                                       device=o.device)
                           for o in entry.outputs]
            for column, metric in zip(history, entry.outputs):
                column[r].copy_(metric)
    return (_state(tuple(buf.clone() for buf in entry.inputs)),
            {"recon_mse": history[0], "reg": history[1]})


def motion_epoch_parity(state, video, batch_times, batch_weights, model,
                        optimizer, gamma: float, use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.dnmf.motion_epoch_parity`: one serial
    Adam step (:func:`~dnmf_tpu_torch.models.dnmf.parity_step`) captured
    once and replayed once per batch.  The epoch's ``batch_times`` and
    ``batch_weights`` (``[num_batches, B]``, on the host or the card) are
    copied into the entry's buffers once; each replay selects its row by
    a device step index, writes the new ``beta``, ``count``, ``mu`` and
    ``nu`` into its own input buffers and its ``mse`` and ``reg`` into
    the row's column of two ``[num_batches]`` buffers, and increments the
    index.  The metrics are those buffers' means, as the eager epoch's."""
    device = video.device
    if not _cached(use_kernels):
        return model_lib.motion_epoch_parity(
            state, video, batch_times.to(device), batch_weights.to(device),
            model, optimizer, gamma)
    nb = batch_times.shape[0]
    step = _parity_step(video, model, optimizer, gamma)
    zeros = torch.zeros(nb, dtype=torch.float32, device=device)
    args = _leaves(state) + (
        model_lib.model_voxel_basis(model, device=device), batch_times,
        batch_weights, torch.zeros(1, dtype=torch.int64, device=device),
        zeros, zeros)
    key = (("motion_epoch_parity", model, optimizer, gamma)
           + _signature(*args) + _video_key(video))
    entry = _entry(key, lambda: Entry("motion_epoch_parity", step, args,
                                      device=device))
    entry.load(args)
    for _ in range(nb):
        entry.replay()
    buf = _state(entry.inputs[:7])
    mses, regs = entry.inputs[-2:]
    return (state.replace(beta=buf.beta.clone(), count=buf.count.clone(),
                          mu=buf.mu.clone(), nu=buf.nu.clone()),
            {"recon_mse": mses.mean(), "reg": regs.mean()})


def _parity_step(video, model, optimizer, gamma: float):
    """The step of :func:`motion_epoch_parity`'s entry, on its buffers:
    the state's leaves, the voxel basis, the epoch's batches, the step
    index and the two metric columns."""
    def step(*args):
        cur, (vb, times, weights, index, mses, regs) = (_state(args[:7]),
                                                        args[7:])
        st, mse, reg = model_lib.parity_step(
            cur, video, times.index_select(0, index)[0],
            weights.index_select(0, index)[0], model, optimizer, gamma, vb,
            model_lib._maybe_stored_a(cur, model))
        for name in ("beta", "count", "mu", "nu"):
            getattr(cur, name).copy_(getattr(st, name))
        mses.index_copy_(0, index, mse.reshape(1))
        regs.index_copy_(0, index, reg.reshape(1))
        index.add_(1)
        return ()
    return step


def static_nmf_fit(a, c, y, d, gamma_a: float, iters: int):
    """``StaticFootprintNMF.fit``'s ``iters`` alternations
    (:func:`~dnmf_tpu_torch.ops.mu.static_alternation`), one captured
    and replayed ``iters`` times; the carry ``(a, c)`` stays in the
    entry's buffers between replays (eagerly inside :func:`disabled`).
    The video ``y [P, T]``, made anew by each ``fit``, is copied in like
    the carry; the engine's penalty field ``d [P, K]`` is read in place at
    the address in the key, as a video is.  Returns ``(a, c)``, clones."""
    if not _cached(True):
        for _ in range(iters):
            a, c = mu_ops.static_alternation(a, c, y, d, gamma_a)
        return a, c

    args = (a, c, y)
    key = ("static_nmf_fit", gamma_a) + _signature(*args) + _video_key(d)
    entry = _entry(key, lambda: Entry("static_nmf_fit",
                                      _static_step(d, gamma_a), args))
    entry.load(args)
    for _ in range(iters):
        entry.replay()
    return tuple(buf.clone() for buf in entry.inputs[:2])


def _static_step(d, gamma_a: float):
    """The step of :func:`static_nmf_fit`'s entry: one alternation, its
    result written into the carry's buffers ``(a, c)``."""
    def step(a, c, y):
        a_new, c_new = mu_ops.static_alternation(a, c, y, d, gamma_a)
        a.copy_(a_new)
        c.copy_(c_new)
        return ()
    return step


def sigma_fit(state, video_sub, betas_sub, c_sub, model, steps: int = 4,
              lr: float = 0.02, lo: float = 1.5, hi: float = 4.8,
              frame_block: int = 8, use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.dnmf.sigma_fit`, all ``steps`` Adam
    steps in one captured graph: ``(sigma, mse_trace [steps])``.  The
    subsampled frames, warps and traces are inputs, copied like the state
    (the caller gathers them anew at each call)."""
    if not _cached(use_kernels):
        return model_lib.sigma_fit(state, video_sub, betas_sub, c_sub, model,
                                   steps, lr, lo, hi, frame_block,
                                   use_kernels)

    def fit(n):
        def step(*args):
            return model_lib.sigma_fit(_state(args[:7]), *args[7:], model, n,
                                       lr, lo, hi, frame_block, use_kernels)
        return step

    return _run("sigma_fit", (model, steps, lr, lo, hi, frame_block,
                              use_kernels), fit(steps),
                _leaves(state) + (video_sub, betas_sub, c_sub),
                warmup=fit(1))


def refine_positions(state, pos_t, video, model, epochs: int = 20,
                     learning_rate: float = 0.05, prior: float = 1e-3,
                     frame_block: int = 16, use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.refine.refine_positions`, all
    ``epochs`` Adam steps in one captured graph: ``(pos_t, {"recon_mse":
    [T]})``.  ``pos_t`` None (the anchors) starts from a contiguous copy
    of the anchors, so that the first round and the later ones share a
    key."""
    kw = dict(learning_rate=learning_rate, prior=prior,
              frame_block=frame_block, use_kernels=use_kernels)
    if not _cached(use_kernels):
        return refine_lib.refine_positions(state, pos_t, video, model,
                                           epochs=epochs, **kw)
    if pos_t is None:
        pos_t = state.pos.expand((video.shape[0],) + tuple(state.pos.shape))
    pos_t = pos_t.contiguous()

    def fit(n):
        def step(*args):
            pos, m = refine_lib.refine_positions(_state(args[:7]), args[7],
                                                 video, model, epochs=n, **kw)
            return pos, m["recon_mse"]
        return step

    pos, mse = _run("refine_positions", (model, epochs) + tuple(
        sorted(kw.items())), fit(epochs), _leaves(state) + (pos_t,), video,
        warmup=fit(1))
    return pos, {"recon_mse": mse}


def tracked_grams(state, pos_t, video, model, frame_block: int = 16,
                  use_kernels: bool = False, gram_mode: str = "exact",
                  gram_window: Optional[int] = None):
    """:func:`~dnmf_tpu_torch.models.refine.tracked_grams` (the Grams at
    per-frame positions) as one captured graph: ``(grams, c1)``."""
    if not _cached(use_kernels):
        return refine_lib.tracked_grams(state, pos_t, video, model,
                                        frame_block, use_kernels, gram_mode,
                                        gram_window)

    def step(*args):
        return refine_lib.tracked_grams(_state(args[:7]), args[7], video,
                                        model, frame_block, use_kernels,
                                        gram_mode, gram_window)

    return _run("tracked_grams", (model, frame_block, use_kernels, gram_mode,
                                  gram_window), step,
                _leaves(state) + (pos_t.contiguous(),), video)


def refined_rounds(state, video, model, rounds: int = 2, epochs: int = 20,
                   mu_iters: int = 30, learning_rate: float = 0.05,
                   prior: float = 1e-3, frame_block: int = 16, pos_t=None,
                   use_kernels: bool = False, gram_mode: str = "exact",
                   gram_window: Optional[int] = None,
                   trace_solver: str = "mu"):
    """:func:`~dnmf_tpu_torch.models.refine.refined_rounds` through the
    cache: each round replays :func:`refine_positions`,
    :func:`tracked_grams` and :func:`footprint_update` (``gamma=0``: the
    plain MU or FISTA run of the eager loop), one entry each for all the
    rounds."""
    kw = dict(rounds=rounds, epochs=epochs, mu_iters=mu_iters,
              learning_rate=learning_rate, prior=prior,
              frame_block=frame_block, pos_t=pos_t, use_kernels=use_kernels,
              gram_mode=gram_mode, gram_window=gram_window,
              trace_solver=trace_solver)
    if not _cached(use_kernels):
        return refine_lib.refined_rounds(state, video, model, **kw)
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")
    metrics = {}
    for _ in range(rounds):
        pos_t, metrics = refine_positions(
            state, pos_t, video, model, epochs, learning_rate, prior,
            frame_block, use_kernels)
        g, c1 = tracked_grams(state, pos_t, video, model, frame_block,
                              use_kernels, gram_mode, gram_window)
        state = footprint_update(state, g, c1, mu_iters, 0.0, trace_solver,
                                 use_kernels)
    return state, pos_t, metrics


def batched_round(states, videos, model, optimizer, gamma: float,
                  mu_iters: int, mu_gamma: float = 0.0, frame_block: int = 8,
                  use_kernels: bool = False, gram_mode: str = "exact",
                  gram_window: Optional[int] = None):
    """One round of every recording (a stacked state, ``videos [R, T,
    P]``): :func:`~dnmf_tpu_torch.models.dnmf.fused_round` with one epoch
    and MU traces, as one captured graph; the recordings' videos are read
    in place.  Returns the stacked state and the metrics ``[R]``."""
    kw = dict(epochs=1, mu_iters=mu_iters, gamma=gamma, mu_gamma=mu_gamma,
              frame_block=frame_block, use_kernels=use_kernels,
              gram_mode=gram_mode, gram_window=gram_window)
    if not _cached(use_kernels):
        return model_lib.fused_round(states, videos, model, optimizer, **kw)

    def step(*leaves):
        st, m = model_lib.fused_round(_state(leaves), videos, model,
                                      optimizer, **kw)
        return _leaves(st) + (m["recon_mse"], m["reg"])

    out = _run("batched_round", (model, optimizer) + tuple(sorted(
        kw.items())), step, _leaves(states), videos)
    return _state(out[:7]), {"recon_mse": out[7], "reg": out[8]}


# ----------------------------------------------------------------------
# Host-streamed block steps
# ----------------------------------------------------------------------
def _layout(*tensors) -> tuple:
    """Shapes, dtypes and devices, without strides: a streamed step's
    inputs are all copied, so the buffers' layout is their own (a full
    block's C is a strided slice, the padded tail's a new tensor)."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def _frame_buffer(frames: torch.Tensor) -> torch.Tensor:
    """The streamed entries' one frame buffer of ``frames``' layout: each
    streamed step copies its block's frames into it just before its own
    replay, so one buffer serves them all.  It lives while an entry holds
    it."""
    key = _layout(frames)
    buf = _frame_buffers.get(key)
    if buf is None:
        buf = torch.empty_like(frames, memory_format=torch.contiguous_format)
        _frame_buffers[key] = buf
    return buf


def shared_bytes() -> int:
    """Bytes of the frame buffers that the streamed entries share (no
    entry's ``buffer_bytes`` counts them)."""
    return _nbytes(list(_frame_buffers.values()))


def _stream(name: str, statics: tuple, step, source, fixed: tuple,
            per_block, with_valid: bool = True, warmup=None):
    """The captured block runner of the streamed loops (the protocol of
    :func:`~dnmf_tpu_torch.models.dnmf.eager_blocks`): replay one entry
    per block of ``source.blocks()`` and yield ``(start, outputs)`` after
    each replay.  The step takes ``fixed + per_block(start) + (frames,)``,
    then (``with_valid``) the block's valid count as an int64 device
    scalar: ``fixed`` (the anchors, the widths) is copied in once per
    call, the block's state slices (``per_block``) and frames (a device
    tensor from the source's side stream, copied device to device into
    the shared :func:`_frame_buffer`) at every block, and the valid count
    is a fill.  One key serves every block, the zero-padded tail too."""
    entry = None
    for frames, start, valid in source.blocks():
        varying = tuple(per_block(start)) + (frames,)
        if entry is None:
            entry = _stream_entry(name, statics, step, fixed, varying,
                                  valid if with_valid else None, warmup)
        else:
            # The fixed inputs' buffers stand for themselves: not copied.
            entry.load(entry.inputs[:len(fixed)] + varying)
            if with_valid:
                entry.inputs[-1].fill_(valid)
        entry.replay()
        yield start, entry.outputs


def _stream_entry(name, statics, step, fixed, varying, valid, warmup):
    """The entry of a streamed step, loaded with its first block; nothing
    here outlives the call, so the pass holds no reference to that
    block's frames."""
    frames = varying[-1]
    args = fixed + varying + (() if valid is None else (torch.full(
        (), valid, dtype=torch.int64, device=frames.device),))
    key = (name,) + statics + _layout(*args)
    at = len(fixed) + len(varying) - 1  # the frames' place

    def make():
        buf = _frame_buffer(frames)
        buf.copy_(frames)
        return Entry(name, step, args[:at] + (buf,) + args[at + 1:], warmup,
                     shared=(at,))

    entry = _entry(key, make)
    entry.load(args)
    return entry


def _runner(name: str, statics: tuple, use_kernels: bool):
    """The block runner that a streamed loop is given: :func:`_stream`
    under ``name`` and ``statics`` (what the key holds beyond the inputs'
    shapes), or the plain :func:`~dnmf_tpu_torch.models.dnmf.eager_blocks`
    without ``use_kernels`` or inside :func:`disabled`."""
    if not _cached(use_kernels):
        return model_lib.eager_blocks
    return functools.partial(_stream, name, statics)


def motion_epoch_streaming(state, source, model, optimizer, gamma: float,
                           use_kernels: bool = False):
    """:func:`~dnmf_tpu_torch.models.dnmf.motion_epoch_streaming` with its
    block step (:func:`~dnmf_tpu_torch.models.dnmf.stream_block_grads`,
    JAX's ``_stream_block_grads``) as one captured graph, replayed once
    per block; the loop copies the grads and sums out after each replay,
    and one Adam step follows the pass, eagerly, as in the JAX package.
    The key holds ``model``, ``gamma``, the block and the inputs'
    shapes."""
    return model_lib.motion_epoch_streaming(
        state, source, model, optimizer, gamma, use_kernels,
        run_blocks=_runner("motion_epoch_streaming",
                           (model, gamma, source.block, use_kernels),
                           use_kernels))


def compute_grams_streaming(state, source, model, use_kernels: bool = False,
                            gram_mode: str = "exact",
                            gram_window: Optional[int] = None):
    """:func:`~dnmf_tpu_torch.models.dnmf.compute_grams_streaming` with its
    block step (:func:`~dnmf_tpu_torch.models.dnmf.grams_local` on the
    block, JAX's ``_stream_block_grams``) as one captured graph, replayed
    once per block into ``(G [T, K, K], c1 [T, K])``.  The key also holds
    ``gram_mode`` and ``gram_window``: the audit's fallback to exact Grams
    is a second entry."""
    return model_lib.compute_grams_streaming(
        state, source, model, use_kernels, gram_mode, gram_window,
        run_blocks=_runner("compute_grams_streaming",
                           (model, source.block, use_kernels, gram_mode,
                            gram_window), use_kernels))


def refined_rounds_streaming(state, source, model, rounds: int = 2,
                             epochs: int = 20, mu_iters: int = 30,
                             learning_rate: float = 0.05,
                             prior: float = 1e-3, pos_t=None,
                             use_kernels: bool = False,
                             gram_mode: str = "exact",
                             gram_window: Optional[int] = None,
                             trace_solver: str = "mu"):
    """:func:`~dnmf_tpu_torch.models.refine.refined_rounds_streaming` with
    a block's whole alternation (:func:`~dnmf_tpu_torch.models.refine.
    refine_block_rounds`: ``rounds x (epochs Adam steps on the positions
    + tracked Grams + MU or FISTA)``, JAX's ``_refined_rounds_block``, one
    ``lax.scan``) as one captured graph, replayed once per block and
    warmed up on one round of one epoch.  The block's positions and C are
    its buffers, loaded per block."""
    kw = dict(rounds=rounds, epochs=epochs, mu_iters=mu_iters,
              learning_rate=learning_rate, prior=prior,
              use_kernels=use_kernels, gram_mode=gram_mode,
              gram_window=gram_window, trace_solver=trace_solver)
    return refine_lib.refined_rounds_streaming(
        state, source, model, pos_t=pos_t, run_blocks=_runner(
            "refined_rounds_streaming",
            (model, source.block) + tuple(sorted(kw.items())), use_kernels),
        **kw)


# ----------------------------------------------------------------------
# A mesh's steps between its collectives
# ----------------------------------------------------------------------
class _MeshSteps:
    """The captured step runner of the sharded functions
    (:class:`~dnmf_tpu_torch.parallel.sharded.EagerSteps`' protocol): a
    step is an entry keyed by ``name``, ``statics`` (what the step closes
    over: the model, the optimizer, the rank's voxel range ``p_offset``,
    ...) and its inputs' shapes, replayed once per call, its outputs
    cloned; a loop's step carries its state in its own input buffers
    between its ``iters`` replays, with ``between(entry.inputs)`` (a
    halo's exchange) run eagerly before each, and clones of the buffers
    at ``writes`` come out; a streamed loop's blocks replay through
    :func:`_stream`, whose outputs are read in place until the next
    block's replay.  The collectives run between the replays, never
    inside a graph."""

    def __call__(self, name, statics, step, args, video=None) -> tuple:
        return _run(name, statics, step, args, video)

    def loop(self, name, statics, step, args, writes, iters,
             between) -> tuple:
        key = (name,) + statics + _signature(*args)
        entry = _entry(key, lambda: Entry(name, step, args))
        entry.load(args)
        for _ in range(iters):
            between(entry.inputs)
            entry.replay()
        return tuple(entry.inputs[i].clone() for i in writes)

    def blocks(self, name, statics):
        return functools.partial(_stream, name, statics)


_MESH_STEPS = _MeshSteps()


def mesh_steps(use_kernels: bool):
    """The step runner of the sharded functions of
    :mod:`dnmf_tpu_torch.parallel`: captured (:class:`_MeshSteps`) with
    ``use_kernels`` and outside :func:`disabled`, else their plain
    :data:`~dnmf_tpu_torch.parallel.sharded.EAGER`."""
    from dnmf_tpu_torch.parallel import sharded

    return _MESH_STEPS if _cached(use_kernels) else sharded.EAGER


# ----------------------------------------------------------------------
# Registration and seeding
# ----------------------------------------------------------------------
def _hashable(value):
    if isinstance(value, (list, tuple)):
        return tuple(_hashable(v) for v in value)
    return value


def _registration_block(name, frames, template, add_to_movie, cfg, collect):
    from dnmf_tpu_torch.registration import motion_correct as mc_lib

    correct, fields = {
        "rigid_block": (mc_lib.rigid_block, mc_lib.RIGID_STATICS),
        "pwrigid_block": (mc_lib.pwrigid_block, mc_lib.PWRIGID_STATICS)}[name]
    device = template.device
    if not isinstance(add_to_movie, torch.Tensor):
        add_to_movie = torch.full((), float(add_to_movie),
                                  dtype=torch.float32, device=device)

    def step(frames, template, add):
        corrected, shifts = correct(frames, template, cfg, add)
        return (corrected, shifts) + mc_lib.block_sums(corrected)

    args = (frames, template, add_to_movie)
    if _disabled:
        corrected, *rest = step(frames.to(device), template, add_to_movie)
        return (corrected if collect else None, *rest)
    key = ((name, device) + tuple(_hashable(getattr(cfg, f)) for f in fields)
           + _signature(*args))
    entry = _entry(key, lambda: Entry(name, step, args, device=device))
    entry.load(args)
    entry.replay()
    corrected, *rest = entry.outputs
    return (corrected.clone() if collect else None,
            *(o.clone() for o in rest))


def rigid_block(frames, template, add_to_movie, cfg, collect: bool = False):
    """A rigid pass's frame block: :func:`~dnmf_tpu_torch.registration.
    motion_correct.rigid_block` (``rigid_correct_frames``, with the 1p
    ``gSig_filt`` variant) and :func:`~dnmf_tpu_torch.registration.
    motion_correct.block_sums` as one captured graph, keyed by the block's
    shape and ``cfg``'s fields of ``RIGID_STATICS``.  ``frames`` may lie
    on the host: they are copied into the entry's frame buffer on the
    template's device; ``add_to_movie`` (a float or a device scalar) and
    the template are inputs.  Returns ``(corrected or None without
    collect, shifts [B, nd], finite sum, finite count)``."""
    return _registration_block("rigid_block", frames, template,
                               add_to_movie, cfg, collect)


def pwrigid_block(frames, template, add_to_movie, cfg,
                  collect: bool = False):
    """A piecewise-rigid pass's frame block: :func:`~dnmf_tpu_torch.
    registration.motion_correct.pwrigid_block` (``tile_and_correct_block``
    with every ``remap_mode`` and ``phasecorr_impl``: kernel F, kernel G,
    the plain path, DFT blending) and the block's finite sums as one
    captured graph, keyed by ``PWRIGID_STATICS``; otherwise as
    :func:`rigid_block`."""
    return _registration_block("pwrigid_block", frames, template,
                               add_to_movie, cfg, collect)


def summary_blocks(carry, blocks, size, clamp: bool):
    """Fold each ``(frames [B, P], valid, shifts [B, 3] or None)`` of
    ``blocks`` into the seeding moments ``carry``
    (:func:`~dnmf_tpu_torch.ops.seeding.fold_block`; ``valid`` and the
    carry's count are int64 device scalars), one captured graph per block
    shape, shifted or not.  The step writes the new carry into its own
    input buffers, where the entry's next block finds it: a block copies
    in only its frames, ``valid`` and shifts.  Returns the last carry
    (clones)."""
    from dnmf_tpu_torch.ops import seeding

    size = tuple(int(v) for v in size)
    device = carry[0].device
    if _disabled:
        for frames, valid, shifts in blocks:
            carry = seeding.fold_block(carry, frames.to(device), valid,
                                       shifts, size, clamp)
        return carry

    def step(*args):
        new = seeding.fold_block(args[:8], args[8], args[9],
                                 args[10] if len(args) > 10 else None, size,
                                 clamp)
        for buf, value in zip(args[:8], new):
            buf.copy_(value)
        return ()

    for frames, valid, shifts in blocks:
        args = tuple(carry) + (frames, valid) + (
            () if shifts is None else (shifts,))
        key = ("summary_block", size, clamp, device) + _signature(*args)
        entry = _entry(key, lambda: Entry("summary_block", step, args,
                                          device=device))
        entry.load(args)
        entry.replay()
        carry = entry.inputs[:8]
    return tuple(c.clone() for c in carry)
