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


# The JAX package's (and the reference's) name for the same function.
quadratic_basis = quadratic_basis_points


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


# ----------------------------------------------------------------------
# Registration-seeded warps: per-frame ridge fits to the patch shifts
# ----------------------------------------------------------------------
def _seed_targets(points, displacements, size, scaling):
    """Apparent positions ``q [T, n, 3]`` and warp displacement targets
    ``r = c - q`` (the warp maps apparent content back onto its anchor),
    in the beta coordinate space."""
    points = torch.as_tensor(points, dtype=torch.float32)
    disp = torch.as_tensor(displacements, dtype=torch.float32,
                           device=points.device)
    q = points[None] + disp
    c = points[None].expand(q.shape)
    if scaling == "normalized":
        q = normalize_points(q, size)
        c = normalize_points(c, size)
    return q, c - q


def affine_beta_from_displacements(points, displacements, size,
                                   scaling: str = "normalized",
                                   ridge: float = 1e-4) -> torch.Tensor:
    """Per-frame affine warps ``[T, 10, 3]`` fitted to a displacement field.

    ``points [n, 3]`` are the patch centres and ``displacements [T, n, 3]``
    the content displacements there; frame t's warp maps ``q = c + d`` back
    to ``c``.  The displacement ``warp(x) - x = g0 + (x - mu) @ g_lin`` is a
    ridge least-squares fit on the centred samples (a degenerate axis, such
    as a single z plane of patches, gets a zero column and keeps the
    identity); quadratic terms start at 0.  Under 4 points the seed is
    the mean translation.  All frames solve as one ``[T, 4, 4]`` batch.
    """
    t, n = displacements.shape[0], points.shape[0]
    points = torch.as_tensor(points, dtype=torch.float32)
    base = identity_beta(t, device=points.device)
    if n == 0:
        return base
    q, r = _seed_targets(points, displacements, size, scaling)
    if n < 4:
        base[:, 0, :] += r.mean(dim=1)
        return base
    mu = q.mean(dim=1, keepdim=True)  # [T, 1, 3]
    phi = torch.cat([torch.ones_like(q[..., :1]), q - mu], dim=-1)  # [T, n, 4]
    phi_t = phi.transpose(1, 2)
    a = phi_t @ phi + ridge * n * torch.eye(4, device=q.device)
    g = torch.linalg.solve(a, phi_t @ r)  # [T, 4, 3]
    g_lin = g[:, 1:, :]
    g0 = g[:, 0, :] - torch.einsum("td,tdc->tc", mu[:, 0, :], g_lin)
    base[:, 0, :] += g0
    base[:, 1:4, :] += g_lin
    return base


def _centered_quadratic_expansion(mu: torch.Tensor) -> torch.Tensor:
    """``[..., 10, 10]`` matrices T with ``phi_j(x - mu) = sum_i T[j, i]
    phi_i(x)`` in the basis order ``[1, x, y, z, x2, y2, z2, xy, xz, yz]``
    for centres ``mu [..., 3]``: standard-basis coefficients are ``T^T g``
    for a polynomial ``g`` fitted on centred coordinates."""
    mx, my, mz = mu[..., 0], mu[..., 1], mu[..., 2]
    t = torch.zeros(mu.shape[:-1] + (10, 10), dtype=mu.dtype,
                    device=mu.device)
    for j in range(10):
        t[..., j, j] = 1.0
    t[..., 1, 0], t[..., 2, 0], t[..., 3, 0] = -mx, -my, -mz
    # (x-mx)^2, (y-my)^2, (z-mz)^2
    for j, (m, lin) in enumerate(((mx, 1), (my, 2), (mz, 3))):
        t[..., 4 + j, 0] = m * m
        t[..., 4 + j, lin] = -2 * m
    # (x-mx)(y-my), (x-mx)(z-mz), (y-my)(z-mz)
    for j, (ma, la, mb, lb) in enumerate(((mx, 1, my, 2), (mx, 1, mz, 3),
                                          (my, 2, mz, 3))):
        t[..., 7 + j, 0] = ma * mb
        t[..., 7 + j, la] = -mb
        t[..., 7 + j, lb] = -ma
    return t


def quadratic_beta_from_displacements(points, displacements, size,
                                      scaling: str = "normalized",
                                      ridge: float = 1e-3) -> torch.Tensor:
    """Per-frame full-quadratic warps ``[T, 10, 3]`` fitted to a
    displacement field: :func:`affine_beta_from_displacements`'s contract
    with all 10 basis terms.

    Coordinates are centred per frame and each basis column scaled to
    unit RMS before the ridge solve; columns without sample variation
    (a single z plane, too few patches) are masked out and their
    coefficients pinned to 0; the centred polynomial is re-expanded into
    standard-basis coefficients.  Under 7 points it is the affine fit.
    All frames solve as one ``[T, 10, 10]`` batch.
    """
    t, n = displacements.shape[0], points.shape[0]
    if n < 7:
        return affine_beta_from_displacements(points, displacements, size,
                                              scaling=scaling)
    points = torch.as_tensor(points, dtype=torch.float32)
    base = identity_beta(t, device=points.device)
    q, r = _seed_targets(points, displacements, size, scaling)
    mu = q.mean(dim=1, keepdim=True)  # [T, 1, 3]
    phi = quadratic_basis_points(q - mu)  # [T, n, 10]
    col_rms = torch.sqrt(torch.mean(phi * phi, dim=1, keepdim=True))
    alive = (col_rms > 1e-6).to(phi.dtype)
    scale = torch.where(col_rms > 1e-6, col_rms, torch.ones_like(col_rms))
    phi_s = phi / scale * alive
    phi_t = phi_s.transpose(1, 2)
    a = phi_t @ phi_s + ridge * n * torch.eye(10, device=q.device)
    g = torch.linalg.solve(a, phi_t @ r)  # [T, 10, 3], scaled basis
    g = g / scale.transpose(1, 2) * alive.transpose(1, 2)
    t_mat = _centered_quadratic_expansion(mu[:, 0, :])
    return base + t_mat.transpose(1, 2) @ g


def translation_beta(shifts, size, scaling: str = "normalized"
                     ) -> torch.Tensor:
    """Per-frame pure translations ``[T, 10, 3]`` for registration
    corrections ``shifts [T, 3]`` (content moved by ``d`` has correction
    ``-d``; the footprints are sampled at ``x + shift``)."""
    shifts = torch.as_tensor(shifts, dtype=torch.float32)
    beta = identity_beta(shifts.shape[0], device=shifts.device)
    if scaling == "normalized":
        hi = torch.tensor([max(float(s) - 1.0, 1.0) for s in size],
                          device=shifts.device)
        beta[:, 0, :] = 2.0 * shifts / hi
    else:
        beta[:, 0, :] = shifts
    return beta
