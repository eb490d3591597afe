"""Inverse warping by windowed nearest-neighbour search (port of
``dnmf_tpu/ops/interp.py``).

The source voxel nearest to an output location ``g`` lies within a small
index-space window around ``g`` for a smooth, small displacement, so a
static ``(2r+1)^3`` window search is exact whenever the displacement is
below ``r``.
"""

from __future__ import annotations

import math

import torch

from dnmf_tpu_torch.ops.basis import voxel_grid


def inverse_warp_nearest(values: torch.Tensor, psi: torch.Tensor, size,
                         radius: int = 2) -> torch.Tensor:
    """Nearest-neighbour inverse warp of one frame.

    Voxel ``p`` carries ``values [P]`` at deformed position ``psi [P, 3]``;
    the output at voxel ``g`` takes the value whose deformed position is
    nearest to ``g`` (first candidate in window order on ties).
    """
    m, n, z = (int(s) for s in size)
    grid = voxel_grid(size, dtype=psi.dtype, device=psi.device)
    dims = torch.tensor([m, n, z], device=psi.device)
    gi = grid.long()
    best_d = torch.full((grid.shape[0],), math.inf, dtype=psi.dtype,
                        device=psi.device)
    best_v = torch.zeros_like(values)
    rz = min(radius, z - 1)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            for dz in range(-rz, rz + 1):
                cand = gi + torch.tensor([dx, dy, dz], device=gi.device)
                valid = torch.all((cand >= 0) & (cand < dims), dim=-1)
                cc = torch.minimum(cand.clamp_min(0), dims - 1)
                idx = (cc[:, 0] * n + cc[:, 1]) * z + cc[:, 2]
                d = torch.sum((psi[idx] - grid) ** 2, dim=-1)
                d = torch.where(valid, d, math.inf)
                take = d < best_d
                best_d = torch.where(take, d, best_d)
                best_v = torch.where(take, values[idx], best_v)
    return best_v
