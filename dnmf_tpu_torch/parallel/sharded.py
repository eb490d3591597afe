"""Frame- and voxel-sharded training steps over a process group.

Counterpart of ``dnmf_tpu/parallel/sharded.py``, with each rank running
the step on its own shard in place of ``shard_map``:

* ``beta [T, 10, 3]``, the Adam moments and the traces ``C [K, T]`` split
  by frames over the ``time`` axis; positions and widths are replicated;
  the video ``[T, P]`` splits by frames and, on a ``pixel`` axis, by
  voxels (:func:`shard_state`, :func:`shard_video`: this rank's slices;
  :func:`gather_state`: the whole state again on every rank).
* The deformation fit is per-frame independent, and Adam is elementwise:
  each rank steps its own frames.  On a pixel axis each rank evaluates its
  voxels only, and the per-frame gradients and metrics are summed over the
  axis and divided by its size (each shard's are means over its voxels).
* The per-frame Grams reduce over voxels: no communication on a time
  axis, one sum over a pixel axis.
* The temporally smoothed trace update couples +-1 frames: once per
  iteration each rank's two edge columns go to every rank of its time
  line by one ``all_gather`` (gloo's point-to-point calls take CPU tensors
  only; its collectives take CUDA tensors too), and each rank takes its
  neighbours'; the recording's ends replicate their own column.  FISTA
  takes the maximum of the ranks' Lipschitz bounds, plus ``4 gamma``.

Each function runs a rank's local work between two collectives as steps
of the step runner that ``models.graphs.mesh_steps(use_kernels)`` gives,
as on one device: with the kernels it replays each step as a captured
CUDA graph, the collectives running eagerly between the replays; without
them, or inside ``models.graphs.disabled()``, :data:`EAGER` runs the
steps eagerly.  The two routes share one layout, so the captured one is
held to this plain one bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from dnmf_tpu_torch.config import ModelConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import mu as mu_ops
from dnmf_tpu_torch.parallel.mesh import (PIXEL_AXIS, TIME_AXIS, all_gather,
                                          all_reduce, axis_index, axis_size,
                                          gather_time, video_sharding)

# State fields split by frames: along dim 0, and C [K, T] along dim 1.
_FRAME_FIELDS = ("beta", "mu", "nu")


class EagerSteps:
    """The plain step runner of the sharded functions: ``steps(name,
    statics, step, args, video=None)`` is ``step(*args)``;
    ``steps.loop(name, statics, step, args, writes, iters, between)``
    runs ``between(buffers)``, then ``step(*buffers)``, ``iters`` times,
    where ``buffers`` are ``args`` with copies at the positions
    ``writes`` (those that ``step`` and ``between`` write: the carry and
    the halo), and returns those copies; ``steps.blocks(name, statics)``
    is the streamed loops' block runner,
    :func:`~dnmf_tpu_torch.models.dnmf.eager_blocks`.  ``name`` and
    ``statics`` (what the step closes over) key the captured runner's
    entries; here they go unused."""

    def __call__(self, name, statics, step, args, video=None) -> tuple:
        return tuple(step(*args))

    def loop(self, name, statics, step, args, writes, iters,
             between) -> tuple:
        bufs = [a.clone() if i in writes else a for i, a in enumerate(args)]
        for _ in range(iters):
            between(bufs)
            step(*bufs)
        return tuple(bufs[i] for i in writes)

    def blocks(self, name, statics):
        return model_lib.eager_blocks


EAGER = EagerSteps()


def _leaves(state: model_lib.DNMFState) -> tuple:
    return tuple(getattr(state, name) for name in model_lib.STATE_FIELDS)


def _from_leaves(leaves) -> model_lib.DNMFState:
    return model_lib.DNMFState(*leaves)


def _check_frames(t: int, mesh) -> None:
    n = axis_size(mesh, TIME_AXIS)
    if t % n:
        raise ValueError(f"num_frames={t} must divide evenly over mesh "
                         f"time={n}")


def shard_state(state: model_lib.DNMFState, mesh) -> model_lib.DNMFState:
    """This rank's shard of a whole state: its frames of ``beta``, the
    Adam moments and ``C``; ``pos``, ``sigma`` and the step count as they
    are."""
    _check_frames(state.beta.shape[0], mesh)
    f = video_sharding(mesh).frames(state.beta.shape[0])
    out = {name: getattr(state, name)[f].clone() for name in _FRAME_FIELDS}
    return state.replace(c=state.c[:, f].clone(), **out)


def gather_state(state: model_lib.DNMFState, mesh) -> model_lib.DNMFState:
    """The whole state on every rank from the ranks' shards (the
    counterpart of reading back a sharded ``jax.Array``)."""
    out = {name: gather_time(getattr(state, name), mesh)
           for name in _FRAME_FIELDS}
    return state.replace(c=gather_time(state.c, mesh, dim=1), **out)


def shard_video(video_flat: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``[T, P]`` frames: its frames, and on a pixel
    axis its run of voxels."""
    t, p = video_flat.shape
    npix = axis_size(mesh, PIXEL_AXIS)
    if p % npix:
        raise ValueError(f"voxel count {p} must divide evenly over mesh "
                         f"pixel={npix}")
    _check_frames(t, mesh)
    sh = video_sharding(mesh)
    return video_flat[sh.frames(t), sh.voxels(p)].contiguous()


def _p_offset(mesh, video: torch.Tensor):
    """The first global voxel of this rank's block ``video [T_loc,
    P_loc]`` (None without a pixel axis)."""
    npix = axis_size(mesh, PIXEL_AXIS)
    return video_sharding(mesh).p_offset(video.shape[1] * npix)


def pixel_sum(mesh, *tensors):
    """Each tensor summed over the pixel axis, in one collective (the
    tensors as they are where the axis has one rank)."""
    if axis_size(mesh, PIXEL_AXIS) == 1:
        return tensors
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), mesh,
                      PIXEL_AXIS)
    return tuple(part.view_as(t) for part, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors))


def pixel_mean(mesh, *tensors):
    """Each tensor summed over the pixel axis and divided by its size: a
    shard's means over its voxels become the whole volume's."""
    npix = axis_size(mesh, PIXEL_AXIS)
    return tuple(t / npix for t in pixel_sum(mesh, *tensors)) \
        if npix > 1 else tensors


def sharded_motion_epoch(state: model_lib.DNMFState, video: torch.Tensor,
                         model: ModelConfig, optimizer: model_lib.Adam,
                         gamma: float, mesh, frame_block: int = 16,
                         use_kernels: bool = False
                         ) -> Tuple[model_lib.DNMFState, dict]:
    """The sharded counterpart of ``motion_epoch_parallel`` on this rank's
    shard (``state`` from :func:`shard_state`, ``video`` from
    :func:`shard_video`): per-frame gradients, on a pixel axis averaged
    over it, then the rank's Adam step.  The metrics are the recording's
    means, on every rank.  Steps: on a time-only mesh one (gradients,
    Adam and the two local sums), on a pixel axis two (gradients; Adam
    and the sums) with the axis's mean between them; the sums' reduction
    over the time axis follows."""
    steps = graphs.mesh_steps(use_kernels)
    p_offset = _p_offset(mesh, video)
    grads_key = (model, gamma, frame_block, use_kernels, p_offset)

    def grads(*leaves):
        return model_lib.frame_grads_local(
            _from_leaves(leaves), video, model, gamma, frame_block,
            use_kernels, p_offset=p_offset)

    def update(*args):  # the state's leaves, grads, mses, regs
        st = optimizer.step(_from_leaves(args[:7]), args[7])
        return _leaves(st) + (torch.stack([args[8].sum(), args[9].sum()]),)

    if axis_size(mesh, PIXEL_AXIS) == 1:
        out = steps("sharded_motion_epoch", grads_key + (optimizer,),
                    lambda *leaves: update(*leaves, *grads(*leaves)),
                    _leaves(state), video)
    else:
        g = pixel_mean(mesh, *steps("sharded_frame_grads", grads_key, grads,
                                    _leaves(state), video))
        out = steps("sharded_adam", (optimizer,), update, _leaves(state) + g)
    t_global = video.shape[0] * axis_size(mesh, TIME_AXIS)
    tot = all_reduce(out[7], mesh, TIME_AXIS) / t_global
    return _from_leaves(out[:7]), {"recon_mse": tot[0], "reg": tot[1]}


def _no_analytic_on_pixels(mesh, gram_mode: str) -> None:
    if gram_mode == "analytic" and axis_size(mesh, PIXEL_AXIS) > 1:
        raise ValueError(
            "gram_mode='analytic' is incompatible with a pixel mesh axis "
            "(whole-volume closed form; the sum over the pixel axis would "
            "count it once per shard)")


def sharded_compute_grams(state: model_lib.DNMFState, video: torch.Tensor,
                          model: ModelConfig, mesh, frame_block: int = 16,
                          use_kernels: bool = False, gram_mode: str = "exact",
                          gram_window=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's frames' Grams ``(G [T_loc, K, K], c1 [T_loc, K])``; on a
    pixel axis the shards' partial sums over their voxels are added over
    it.  ``gram_mode="analytic"`` (time meshes only) evaluates the closed
    forms of the rank's frames and runs the c1 pass on them.  One step
    (the rank's voxel range in its key), then the sum over the pixel
    axis."""
    _no_analytic_on_pixels(mesh, gram_mode)
    p_offset = _p_offset(mesh, video)

    def step(*leaves):
        return model_lib.grams_local(
            _from_leaves(leaves), video, model, frame_block, use_kernels,
            gram_mode, gram_window, p_offset=p_offset)

    g, c1 = graphs.mesh_steps(use_kernels)(
        "compute_grams", (model, frame_block, use_kernels,
                        gram_mode, gram_window, p_offset),
        step, _leaves(state), video)
    return pixel_sum(mesh, g, c1)


def edge_halo(c_loc: torch.Tensor, mesh):
    """``(left_col, right_col)`` ``[K]``: the right edge column of the
    left neighbour on the time axis and the left edge column of the right
    one, each rank's two edges sent to its whole time line by one
    ``all_gather``; the recording's first and last shards replicate their
    own edge column."""
    n, idx = axis_size(mesh, TIME_AXIS), axis_index(mesh, TIME_AXIS)
    if n == 1:
        return c_loc[:, 0], c_loc[:, -1]
    edges = all_gather(torch.stack([c_loc[:, 0], c_loc[:, -1]], dim=1), mesh,
                       TIME_AXIS)
    left = c_loc[:, 0] if idx == 0 else edges[idx - 1][:, 1]
    right = c_loc[:, -1] if idx == n - 1 else edges[idx + 1][:, 0]
    return left, right


def sharded_footprint_update(state: model_lib.DNMFState, grams: torch.Tensor,
                             c1: torch.Tensor, mesh, iters: int,
                             gamma: float = 0.0, solver: str = "mu",
                             use_kernels: bool = False
                             ) -> model_lib.DNMFState:
    """``iters`` trace updates of this rank's frames with the +-1-frame
    halo (:func:`edge_halo`) where ``gamma`` smooths: the multiplicative
    rule (``"mu"``) or FISTA (``"fista"``), whose step takes the maximum
    over the time axis of the ranks' Lipschitz bounds plus ``4 gamma``.

    Steps: without smoothing, the ``iters`` updates in one (FISTA's
    bound reduced before it, an input); with it, one iteration a step
    (MU: the traces; FISTA: the iterate, the extrapolated point and the
    momentum scalar, carried in the step's buffers), run ``iters`` times
    with the halo's exchange before each.  ``use_kernels`` is the route
    of the steps around it, as ``models.graphs.footprint_update``'s: the
    update runs no kernel."""
    if solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {solver!r}")
    steps = graphs.mesh_steps(use_kernels)
    c = state.c
    lip = None
    if solver == "fista":
        lip = all_reduce(mu_ops.gram_lipschitz(grams), mesh, TIME_AXIS,
                         op=dist.ReduceOp.MAX)
        if gamma:
            lip = lip + 4.0 * gamma
    if not gamma:
        if solver == "mu":
            (c,) = steps("sharded_mu", (iters,), lambda c, g, c1: (
                mu_ops.run_mu_temporal(c, g, c1, iters),), (c, grams, c1))
        else:
            (c,) = steps("sharded_fista", (iters,), lambda c, g, c1, lip: (
                mu_ops.nnls_temporal(c, g, c1, iters, lipschitz=lip),),
                (c, grams, c1, lip))
        return state.replace(c=c)

    def exchange(at):
        """Fill the halo buffers (the last two) from buffer ``at``."""
        def between(bufs):
            for buf, col in zip(bufs[-2:], edge_halo(bufs[at], mesh)):
                buf.copy_(col)
        return between

    edges = (c[:, 0], c[:, -1])  # placeholders: each iteration fills them
    if solver == "mu":
        def mu_step(c, g, c1, left, right):
            c.copy_(mu_ops.mu_temporal_step(c, g, c1, gamma=gamma,
                                            halo=(left, right)))
            return ()

        bufs = steps.loop("sharded_mu_halo", (gamma,), mu_step,
                          (c, grams, c1) + edges, (0, 3, 4), iters,
                          exchange(0))
        return state.replace(c=bufs[0])

    def fista_step(c_prev, y_c, tk, g, c1, inv_l, left, right):
        new = mu_ops.fista_step(c_prev, y_c, tk, g, c1, inv_l, gamma,
                                (left, right))
        for buf, value in zip((c_prev, y_c, tk), new):
            buf.copy_(value)
        return ()

    tk = torch.ones((), dtype=c.dtype, device=c.device)
    bufs = steps.loop("sharded_fista_halo", (gamma,), fista_step,
                      (c, c, tk, grams, c1, 1.0 / lip) + edges,
                      (0, 1, 2, 6, 7), iters, exchange(1))
    return state.replace(c=bufs[0])


def sharded_refined_rounds(state: model_lib.DNMFState, video: torch.Tensor,
                           model: ModelConfig, mesh, rounds: int = 2,
                           epochs: int = 20, mu_iters: int = 30,
                           learning_rate: float = 0.05, prior: float = 1e-3,
                           frame_block: int = 16, pos_t=None,
                           use_kernels: bool = False, gram_mode: str = "exact",
                           gram_window=None, trace_solver: str = "mu"):
    """Per-frame position refinement and tracked-Gram trace updates on
    this rank's frames (time meshes only).  Each frame's position problem
    and tracked Gram are its own and these trace updates do not smooth,
    so :func:`dnmf_tpu_torch.models.graphs.refined_rounds` (with the
    kernels its three captured programs, else
    :func:`dnmf_tpu_torch.models.refine.refined_rounds`) runs as it is on
    each rank, with no communication.  ``pos_t``: the rank's ``[T_loc, K, 3]`` (None: the
    anchors).  Returns ``(state, pos_t [T_loc, K, 3], {"recon_mse":
    [T_loc]})``."""
    if axis_size(mesh, PIXEL_AXIS) > 1:
        raise ValueError("sharded_refined_rounds requires a time-only mesh "
                         "(pixel axis must have size 1)")
    return graphs.refined_rounds(
        state, video, model, rounds=rounds, epochs=epochs, mu_iters=mu_iters,
        learning_rate=learning_rate, prior=prior, frame_block=frame_block,
        pos_t=pos_t, use_kernels=use_kernels, gram_mode=gram_mode,
        gram_window=gram_window, trace_solver=trace_solver)
