"""Quadratic deformation basis and coordinate-grid helpers.

A 3-D point ``p = (x, y, z)`` maps through a second-order polynomial with
per-frame coefficients ``beta [10, 3]``:

    warp(p) = phi(p) @ beta,   phi = [1, x, y, z, x^2, y^2, z^2, xy, xz, yz]

Counterpart of ``dnmf_tpu/ops/basis.py``.  Functions take an explicit
``device``/``dtype`` where they create tensors; everything else follows
its inputs.
"""

from __future__ import annotations

import torch

NUM_BASIS = 10


def quadratic_basis_points(points: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` coordinates -> ``[..., 10]`` quadratic basis."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack(
        [torch.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z,
         y * z], dim=-1)


def voxel_grid(size, dtype=torch.float32, device=None) -> torch.Tensor:
    """Flat identity coordinate grid ``[M*N*Z, 3]`` in ij order."""
    m, n, z = (int(s) for s in size)
    axes = [torch.arange(s, dtype=dtype, device=device) for s in (m, n, z)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def voxel_basis(size, dtype=torch.float32, device=None) -> torch.Tensor:
    """Quadratic basis of every voxel in pixel coordinates: ``[P, 10]``."""
    return quadratic_basis_points(voxel_grid(size, dtype, device))


def _hi(size, like: torch.Tensor) -> torch.Tensor:
    # max(size-1, 1): a singleton axis's only coordinate, 0, maps to -1
    # and denormalizes back to 0 exactly instead of dividing by zero.
    return torch.tensor([max(float(s) - 1.0, 1.0) for s in size],
                        dtype=like.dtype, device=like.device)


def normalize_points(points: torch.Tensor, size) -> torch.Tensor:
    """Map pixel coordinates ``[0, size-1]`` to ``[-1, 1]``."""
    return 2.0 * points / _hi(size, points) - 1.0


def denormalize_points(points: torch.Tensor, size) -> torch.Tensor:
    """Inverse of :func:`normalize_points`."""
    return (points + 1.0) / 2.0 * _hi(size, points)


def voxel_basis_normalized(size, dtype=torch.float32,
                           device=None) -> torch.Tensor:
    """Quadratic basis of every voxel in normalized coordinates."""
    return quadratic_basis_points(
        normalize_points(voxel_grid(size, dtype, device), size))


def identity_beta(num_frames: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Per-frame identity deformation coefficients ``[T, 10, 3]``."""
    b0 = torch.zeros((NUM_BASIS, 3), dtype=dtype, device=device)
    b0[1, 0] = b0[2, 1] = b0[3, 2] = 1.0
    return b0.expand(num_frames, NUM_BASIS, 3).clone()


def warp_points(points: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Warp ``[..., 3]`` points by one frame's ``beta [10, 3]``."""
    return quadratic_basis_points(points) @ beta


def invert_warp_points(points: torch.Tensor, beta: torch.Tensor,
                       iters: int = 3) -> torch.Tensor:
    """Solve ``warp(x) = points`` by the fixed-point iteration
    ``x <- x + (points - warp(x))`` (the warp is a near-identity map).

    ``beta`` is ``[10, 3]``, or ``[B, 10, 3]`` against ``points
    [B, ..., 3]`` for one inversion per frame.
    """
    x = points
    for _ in range(iters):
        x = x + (points - _warp_batched(x, beta))
    return x


def _warp_batched(points: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    if beta.ndim == 2:
        return warp_points(points, beta)
    flat = quadratic_basis_points(points).reshape(beta.shape[0], -1,
                                                  NUM_BASIS)
    return torch.bmm(flat, beta).reshape(points.shape)


def warp_voxel_coords(voxel_basis_arr: torch.Tensor, beta: torch.Tensor,
                      size, scaling: str) -> torch.Tensor:
    """Deformed pixel-space coordinates of all voxels.

    ``voxel_basis_arr [P, 10]`` (pixel or normalized, matching
    ``scaling``) and ``beta [10, 3]`` -> ``[P, 3]``; a batched ``beta
    [B, 10, 3]`` gives ``[B, P, 3]``.
    """
    psi = voxel_basis_arr @ beta
    if scaling == "normalized":
        psi = denormalize_points(psi, size)
    return psi
