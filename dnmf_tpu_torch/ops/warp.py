"""Kernel G: piecewise-rigid shift application for a 3-D frame block.

:func:`fused_separable_warp` has the JAX signature
(``dnmf_tpu/ops/pallas_warp.py``) minus the TPU tile sizes: frames
``[B, M, N, Z]``, per-patch shifts ``[B, prod(grid_shape), 3]``, rigid
shifts ``[B, 3]`` (the field clip centres).  Each frame is sampled at
``x + clip(field(x), rigid +- (max_deviation_rigid + 2))``, ``field`` the
cubic upsampling of the patch shifts, by three sequential edge-clamped
linear passes (m, n, z) -- ``_apply_remap_field(..., "separable")``.

A CUDA tensor launches ``csrc/warp.cu`` (or raises); a CPU tensor takes
:func:`fused_separable_warp_plain` (dense field + ``separable_warp``;
float64 inputs give the oracle).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dnmf_tpu_torch.ops.resample import separable_warp
from dnmf_tpu_torch.ops.resize import device_matrix, upsample_field


WARP_TM, WARP_TN = 4, 64  # kernel G's tile: m rows x n columns (all of z)


def _bounds(max_shifts, max_deviation_rigid):
    rb = int(max_deviation_rigid) + 2
    base_bound = tuple(int(np.ceil(float(ms))) + 1 for ms in max_shifts[:3])
    return rb, base_bound


def warp_halo(max_shifts, max_deviation_rigid: int = 3) -> int:
    """Kernel G's n halo on each side of a tile: every tap of the n pass,
    ``ceil(max_shifts_n) + 1`` of the base's integer part, ``rb + 1`` of
    the clipped residual and one for the lerp's second tap."""
    rb, base_bound = _bounds(max_shifts, max_deviation_rigid)
    return base_bound[1] + rb + 2


def warp_tile_bytes(size, grid_shape, halo: int) -> int:
    """Shared memory of one kernel-G tile: the m pass over the tile's
    columns and halo, the n pass over its columns, the field's per-frame
    ``H`` and per-row ``Q`` partial contractions."""
    m, n, z = (int(s) for s in size)
    gm, gn, _ = (int(g) for g in grid_shape)
    w1 = min(n, WARP_TN + 2 * halo)
    floats = (WARP_TM * w1 * z + WARP_TM * min(n, WARP_TN) * z
              + gm * gn * z * 3 + WARP_TM * gn * z * 3)
    return 4 * floats


def fused_separable_warp_plain(frames, patch_shifts, rigid_shifts,
                               grid_shape: Tuple[int, int, int], size,
                               max_shifts, max_deviation_rigid: int = 3):
    """Plain version of :func:`fused_separable_warp`."""
    rb, base_bound = _bounds(max_shifts, max_deviation_rigid)
    shifts4 = torch.stack([
        upsample_field(patch_shifts[..., d], grid_shape, tuple(size))
        for d in range(3)], dim=-1)
    return separable_warp(frames, shifts4, (rb,) * 3,
                          base=rigid_shifts.to(frames.dtype),
                          base_bound=base_bound)


def warp_field_plain(patch_shifts, grid_shape, size) -> torch.Tensor:
    """Kernel G's shift field ``[B, M, N, Z, 3]`` in the kernel's order of
    contraction: per frame ``H = Rz F`` over the grid's z, then ``Q = Rm
    H`` over its m, then ``Rn Q`` over its n (``upsample_field`` per axis,
    summed in another order)."""
    b = patch_shifts.shape[0]
    gm, gn, gz = (int(g) for g in grid_shape)
    rm, rn, rz = (device_matrix(g, s, patch_shifts.dtype,
                                patch_shifts.device)
                  for g, s in zip((gm, gn, gz), size))
    f = patch_shifts.reshape(b, gm, gn, gz, 3)
    h = torch.einsum("ze,bacei->bazci", rz, f)  # [B, gm, Z, gn, 3]
    q = torch.einsum("ma,bazci->bmzci", rm, h)  # [B, M, Z, gn, 3]
    return torch.einsum("nc,bmzci->bmnzi", rn, q)


def fused_separable_warp(frames: torch.Tensor, patch_shifts: torch.Tensor,
                         rigid_shifts: torch.Tensor,
                         grid_shape: Tuple[int, int, int], size, max_shifts,
                         max_deviation_rigid: int = 3) -> torch.Tensor:
    """Apply per-patch shift fields to a 3-D frame block; returns
    ``[B, M, N, Z]`` (see the module docstring)."""
    if frames.device.type == "cpu":
        return fused_separable_warp_plain(frames, patch_shifts, rigid_shifts,
                                          grid_shape, size, max_shifts,
                                          max_deviation_rigid)
    b = frames.shape[0]
    m, n, z = (int(s) for s in size)
    gm, gn, gz = (int(g) for g in grid_shape)
    if tuple(frames.shape) != (b, m, n, z):
        raise ValueError(f"fused_separable_warp: frames "
                         f"{tuple(frames.shape)} for size {(m, n, z)}")
    if tuple(patch_shifts.shape) != (b, gm * gn * gz, 3):
        raise ValueError(f"fused_separable_warp: patch shifts "
                         f"{tuple(patch_shifts.shape)} for grid "
                         f"{(gm, gn, gz)}")
    if tuple(rigid_shifts.shape) != (b, 3):
        raise ValueError(f"fused_separable_warp: rigid shifts "
                         f"{tuple(rigid_shifts.shape)} for {b} frames")
    for t in (frames, patch_shifts, rigid_shifts):
        if t.device != frames.device:
            raise ValueError("fused_separable_warp: all inputs must be on "
                             f"{frames.device}")
        if t.dtype != torch.float32:
            raise TypeError("fused_separable_warp: the kernel takes "
                            f"float32, got {t.dtype}")
    from dnmf_tpu_torch.ops import _build

    dev = frames.device
    rb, (bb_m, bb_n, bb_z) = _bounds(max_shifts, max_deviation_rigid)
    halo = warp_halo(max_shifts, max_deviation_rigid)
    smem = warp_tile_bytes(size, grid_shape, halo)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"fused_separable_warp: a tile of {WARP_TM} x {WARP_TN} x {z} "
            f"voxels with an n halo of {halo} (max_shifts {max_shifts}, "
            f"max_deviation_rigid {max_deviation_rigid}) and a {gm} x {gn} "
            f"patch grid needs {smem} bytes of shared memory; a block has "
            f"{limit}")
    lib = _build.load()
    rm, rn, rz = (device_matrix(g, s, torch.float32, dev)
                  for g, s in ((gm, m), (gn, n), (gz, z)))
    frames = frames.contiguous()
    grid = patch_shifts.contiguous()
    base = rigid_shifts.contiguous()
    out = torch.empty_like(frames)
    err = lib.dnmf_warp(
        frames.data_ptr(), out.data_ptr(), grid.data_ptr(), rm.data_ptr(),
        rn.data_ptr(), rz.data_ptr(), base.data_ptr(), b, m, n, z, gm, gn,
        gz, bb_m, bb_n, bb_z, WARP_TM, WARP_TN, halo, smem, float(rb),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dnmf_warp")
    fused_separable_warp.launches += 1
    return out


fused_separable_warp.launches = 0
