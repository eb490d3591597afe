"""Sharded epochs and Grams over a host-streamed recording.

Counterpart of ``dnmf_tpu/parallel/streaming.py``.  Each rank of the
``time`` axis owns a contiguous run of ``T / n`` frames (the layout of
:func:`~dnmf_tpu_torch.parallel.sharded.shard_video`) and reads it from
the source itself through ``source.blocks``: step ``off`` reads frames
``[d * shard_len + off, ... + block)`` for time rank ``d``, the frames
the JAX package's block rows hand that shard; on a ``pixel`` axis a rank
reads only its own run of voxels.  Per-rank gradient and Gram
buffers collect the blocks, and one Adam step follows the pass: the math
of the device-resident sharded epoch.

Each block's local work (the gradients, or the Grams, of the rank's
frames and voxels) is one step of the block runner of
``models.graphs.mesh_steps(use_kernels)``: with the kernels one captured
graph replayed per block, as ``models.graphs.motion_epoch_streaming``
does on one device, else (or inside ``models.graphs.disabled()``) the
plain :func:`~dnmf_tpu_torch.models.dnmf.eager_blocks`.  The sum or mean
over a pixel axis and the copy of the block's valid frames into the
rank's buffers run eagerly after each block, on the replay's outputs in
place (they hold until the next block's replay); the Adam step after the
pass runs eagerly too, once per epoch, as on one device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.parallel.mesh import (PIXEL_AXIS, TIME_AXIS, all_reduce,
                                          axis_size, video_sharding)
from dnmf_tpu_torch.parallel.sharded import (_no_analytic_on_pixels,
                                             pixel_mean, pixel_sum)


def _shard_geometry(state, source, mesh,
                    model=None) -> Tuple[int, int, int, int]:
    """``(time ranks, frames per rank, block, pixel ranks)``, with the
    checks of a source against the state and the mesh."""
    n = axis_size(mesh, TIME_AXIS)
    npix = axis_size(mesh, PIXEL_AXIS)
    t = state.beta.shape[0] * n
    if t != source.num_frames:
        raise ValueError(f"model has {t} frames but the streaming source "
                         f"holds {source.num_frames}")
    if npix > 1:
        if getattr(source, "size", None) is None:
            raise ValueError(
                "pixel-sharded streaming needs a source with a spatial "
                "shape ([T, M, N, Z]); this source is flat [T, P]")
        p = int(np.prod(source.size))
        if p % npix:
            raise ValueError(f"voxel count {p} must divide evenly over "
                             f"mesh pixel={npix}")
        if model is not None and model.deformation.footprint_mode != (
                "analytic"):
            raise ValueError(
                "pixel-sharded streaming requires analytic footprints")
    shard_len = t // n
    block = min(int(source.block), shard_len)
    return n, shard_len, block, npix


class _RankSource:
    """This rank's blocks of ``source`` as a source of their own (what a
    block runner reads): ``blocks()`` yields ``(frames [block, P_loc] on
    the source's device, offset in the rank's frames, valid frames)``,
    the last block zero-padded."""

    def __init__(self, source, mesh, shard_len: int, block: int):
        self.source, self.mesh = source, mesh
        self.shard_len, self.block = shard_len, block

    def blocks(self):
        sh = video_sharding(self.mesh)
        first = sh.time_index * self.shard_len
        for frames, start, valid in self.source.blocks(
                first, first + self.shard_len,
                sh.voxels(self.source.num_voxels)):
            # ``block`` <= the source's block holds every valid frame.
            yield frames[:self.block], start - first, valid


def sharded_motion_epoch_streaming(state: model_lib.DNMFState, source,
                                   model: ModelConfig,
                                   optimizer: model_lib.Adam, gamma: float,
                                   mesh, use_kernels: bool = False
                                   ) -> Tuple[model_lib.DNMFState, dict]:
    """One parallel-mode epoch over a host-streamed recording on this
    rank's shard: per-frame gradients block by block (on a pixel axis
    averaged over it), then one Adam step.  The metrics are the
    recording's means, as floats, on every rank."""
    n, shard_len, block, _ = _shard_geometry(state, source, mesh, model)
    p_offset = video_sharding(mesh).p_offset(source.num_voxels)

    def step(pos, sigma, beta, c, frames):
        return model_lib.frame_grads_local(
            model_lib.DNMFState(beta, c, pos, sigma, None, None, None),
            frames, model, gamma, block, use_kernels, p_offset=p_offset)

    def per_block(off):
        st = model_lib.block_state(state, off, block)
        return st.beta, st.c

    run_blocks = graphs.mesh_steps(use_kernels).blocks(
        "sharded_motion_epoch_streaming",
        (model, gamma, block, use_kernels, p_offset))
    grads = torch.zeros_like(state.beta)
    sums = torch.zeros(2, dtype=torch.float32, device=state.beta.device)
    for off, out in run_blocks(step, _RankSource(source, mesh, shard_len,
                                                 block),
                               (state.pos, state.sigma), per_block,
                               with_valid=False):
        valid = min(block, shard_len - off)
        g, mses, regs = pixel_mean(mesh, *out)
        grads[off:off + valid] = g[:valid]
        sums = sums + torch.stack([mses[:valid].sum(), regs[:valid].sum()])
    state = optimizer.step(state, grads)
    sums = all_reduce(sums, mesh, TIME_AXIS)
    t = source.num_frames
    return state, {"recon_mse": float(sums[0]) / t, "reg": float(sums[1]) / t}


def sharded_compute_grams_streaming(state: model_lib.DNMFState, source,
                                    model: ModelConfig, mesh,
                                    use_kernels: bool = False,
                                    gram_mode: str = "exact",
                                    gram_window=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's frames' Grams ``(G [T_loc, K, K], c1 [T_loc, K])`` over
    a host-streamed recording, ready for
    :func:`~dnmf_tpu_torch.parallel.sharded.sharded_footprint_update`; on
    a pixel axis the shards' partial sums are added over it."""
    n, shard_len, block, _ = _shard_geometry(state, source, mesh, model)
    _no_analytic_on_pixels(mesh, gram_mode)
    p_offset = video_sharding(mesh).p_offset(source.num_voxels)
    k = state.c.shape[0]
    kw = dict(dtype=torch.float32, device=state.beta.device)
    grams = torch.zeros((shard_len, k, k), **kw)
    c1s = torch.zeros((shard_len, k), **kw)

    def step(pos, sigma, beta, frames):
        return model_lib.grams_local(
            model_lib.DNMFState(beta, None, pos, sigma, None, None, None),
            frames, model, block, use_kernels, gram_mode, gram_window,
            p_offset=p_offset)

    run_blocks = graphs.mesh_steps(use_kernels).blocks(
        "sharded_compute_grams_streaming",
        (model, block, use_kernels, gram_mode, gram_window, p_offset))
    for off, out in run_blocks(
            step, _RankSource(source, mesh, shard_len, block),
            (state.pos, state.sigma),
            lambda off: (model_lib.block_state(state, off, block).beta,),
            with_valid=False):
        valid = min(block, shard_len - off)
        g, c1 = pixel_sum(mesh, *out)
        grams[off:off + valid] = g[:valid]
        c1s[off:off + valid] = c1[:valid]
    return grams, c1s
