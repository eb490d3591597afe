"""Trilinear volume resampling and the separable warp (port of
``dnmf_tpu/ops/resample.py``).

:func:`trilinear_resample` samples a volume at voxel-unit coordinates
with ``grid_sample`` border semantics (``"zeros"``: out-of-bounds corners
contribute 0; ``"edge"``: coordinates clamped to the volume).
:func:`separable_warp` is the gather-light form of ``volume[x + s(x)]``
for smooth, bounded shift fields: three sequential 1-D hat-weighted
interpolations, edge-clamped, weights evaluated on the pre-shift lattice.
It is the plain version of kernel G (:mod:`dnmf_tpu_torch.ops.warp`).
"""

from __future__ import annotations

import functools
import itertools

import torch


# Unbounded: a captured graph reads these tensors at their addresses.
@functools.cache
def _lattice(dims: tuple, device):
    """``(dims [3], corners [8, 3])`` int64 on ``device``: the volume's
    axis lengths and the (dx, dy, dz) offsets of a cell's corners in
    loop order, made once per shape."""
    return (torch.tensor(dims, device=device),
            torch.tensor(list(itertools.product((0, 1), repeat=3)),
                         device=device))


def trilinear_resample(volume: torch.Tensor, coords: torch.Tensor,
                       padding: str = "zeros") -> torch.Tensor:
    """Sample ``volume [M, N, Z]`` or ``[M, N, Z, C]`` at ``coords [Q, 3]``
    (voxel units, x -> M, y -> N, z -> Z); returns ``[Q]`` or ``[Q, C]``."""
    squeeze = volume.ndim == 3
    if squeeze:
        volume = volume[..., None]
    m, n, z, c = volume.shape
    flat = volume.reshape(-1, c)
    dims, corners = _lattice((m, n, z), coords.device)
    if padding == "edge":
        coords = torch.minimum(torch.clamp_min(coords, 0.0),
                               (dims - 1).to(coords.dtype))
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.long()
    out = torch.zeros((coords.shape[0], c), dtype=volume.dtype,
                      device=volume.device)
    for i, (dx, dy, dz) in enumerate(itertools.product((0, 1), repeat=3)):
        corner = lo + corners[i]
        w = ((frac[:, 0] if dx else 1.0 - frac[:, 0])
             * (frac[:, 1] if dy else 1.0 - frac[:, 1])
             * (frac[:, 2] if dz else 1.0 - frac[:, 2]))
        valid = torch.all((corner >= 0) & (corner < dims), dim=-1)
        cc = torch.minimum(corner.clamp_min(0), dims - 1)
        idx = (cc[:, 0] * n + cc[:, 1]) * z + cc[:, 2]
        out = out + torch.where(valid[:, None], w[:, None] * flat[idx], 0.0)
    return out[:, 0] if squeeze else out


def resample_footprints(footprints: torch.Tensor, psi: torch.Tensor,
                        size) -> torch.Tensor:
    """Warp a footprint stack ``[P, K]`` by sampling at deformed voxel
    coordinates ``psi [P, 3]`` (zeros padding); returns ``[P, K]``."""
    m, n, z = (int(s) for s in size)
    return trilinear_resample(footprints.reshape(m, n, z, -1), psi,
                              padding="zeros")


def separable_warp(volume: torch.Tensor, shifts: torch.Tensor, max_shift,
                   base=None, base_bound=None) -> torch.Tensor:
    """``output(x) ~= volume[x + shifts(x)]`` (edge-clamped) as three
    sequential per-axis 1-D linear interpolations.

    Exact for locally constant fields; for smooth ones the weights are
    evaluated on the pre-shift lattice (``O(|ds/dx| * |s|)`` positional
    error, well under a tenth of a pixel for registration fields).

    Args:
      volume: ``[*batch, M, N, Z]``.
      shifts: ``[*batch, M, N, Z, 3]`` per-axis displacement field.
      max_shift: static per-axis bound ``(S_m, S_n, S_z)``: on ``|shifts|``
        without ``base``, on ``|shifts - base|`` with it (fields are
        clipped to it).
      base: optional ``[*batch, 3]`` per-axis constant part (e.g. each
        frame's rigid shift); its integer part moves into the tap index
        and the offsets cover only the residual.
      base_bound: static per-axis bound on ``|base|`` (with ``base``).

    Returns:
      ``[*batch, M, N, Z]``.
    """
    out = volume
    batch = volume.shape[:-3]
    for a in range(3):
        s_bound = int(max_shift[a])
        if base is None:
            if s_bound == 0:
                continue
            s = torch.clamp(shifts[..., a], -s_bound, s_bound)
            b_int = torch.zeros(batch, dtype=torch.long,
                                device=volume.device)
            r = s_bound
        else:
            bb = int(base_bound[a])
            if s_bound == 0 and bb == 0:
                continue  # identity axis (e.g. z of a 2-D field)
            ba = base[..., a]
            b_int = torch.clamp(torch.floor(ba), -bb, bb)
            lo = (ba - s_bound).reshape(batch + (1, 1, 1))
            hi = (ba + s_bound).reshape(batch + (1, 1, 1))
            s = torch.minimum(torch.maximum(shifts[..., a], lo), hi)
            # Residual relative to the integer base: in [-S-1, S+1].
            s = torch.clamp(s - b_int.reshape(batch + (1, 1, 1)),
                            -s_bound - 1, s_bound + 1)
            b_int = b_int.long()
            r = s_bound + 1
        n = out.shape[out.ndim - 3 + a]
        moved = out.movedim(out.ndim - 3 + a, -1)  # [*batch, ..., n]
        acc = torch.zeros_like(moved)
        s_m = s.movedim(s.ndim - 3 + a, -1)
        lattice = torch.arange(n, device=volume.device)
        for o in range(-r, r + 2):
            w = torch.clamp_min(1.0 - torch.abs(s_m - o), 0.0)
            idx = torch.clamp(lattice + (b_int[..., None] + o), 0, n - 1)
            index = idx.reshape(batch + (1, 1, n)).expand(moved.shape)
            acc = acc + w * torch.gather(moved, moved.ndim - 1, index)
        out = acc.movedim(-1, out.ndim - 3 + a)
    return out
