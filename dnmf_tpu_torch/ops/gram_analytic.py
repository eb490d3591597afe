"""Closed-form MU Grams: the O(P K^2) pixel reduction done in O(K^2).

The product of two Gaussians is a Gaussian, so with ``c_k = 1/s_k^2``,
``c = c_k + c_l``, midpoint ``m = (c_k p_k + c_l p_l)/c`` and
``gamma = c_k c_l / c`` (all per axis),

    G_kl = exp(-gamma |p_k - p_l|^2) * S(m, c),
    S(m, c) = sum_x w(psi(x))^2 exp(-c |psi(x) - m|^2).

``S`` is evaluated by linearizing the warp around ``psi^{-1}(m)``, which
makes it a product of three windowed 1-D lattice sums (each carrying the
warp's own-axis curvature exactly); a thin axis of at most
``plane_axis_max`` planes is summed plane by plane.  The residual is the
cross-quadratic warp term, which the trainer's trust audit bounds.

Counterpart of ``dnmf_tpu/ops/gram_analytic.py`` (XLA code there, plain
PyTorch here), vectorized over a leading frame axis instead of vmapped;
a leading recordings axis (each recording with its own positions and
widths) folds into the frame axis.
"""

from __future__ import annotations

import math

import torch

from dnmf_tpu_torch.ops import basis as basis_ops


def _jac_diag(betas: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Diagonal of the warp Jacobian, ``[B, ..., 3]``, at ``points
    [B, ..., 3]`` (in the betas' coordinate space) for ``betas
    [B, 10, 3]``.  Pixel-space and normalized-space diagonals are equal."""
    shape = (betas.shape[0],) + (1,) * (points.ndim - 2)

    def b(j, d):
        return betas[:, j, d].reshape(shape)

    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([
        b(1, 0) + 2 * x * b(4, 0) + y * b(7, 0) + z * b(8, 0),
        b(2, 1) + 2 * y * b(5, 1) + x * b(7, 1) + z * b(9, 1),
        b(3, 2) + 2 * z * b(6, 2) + x * b(8, 2) + y * b(9, 2),
    ], dim=-1)


def _warp_pixel(points: torch.Tensor, betas: torch.Tensor, size,
                scaling: str) -> torch.Tensor:
    """Warp pixel-space ``points [B, ..., 3]`` by their frame's betas;
    returns pixel-space coordinates and the points in the betas' own
    space."""
    space = (basis_ops.normalize_points(points, size)
             if scaling == "normalized" else points)
    u = basis_ops._warp_batched(space, betas)
    if scaling == "normalized":
        u = basis_ops.denormalize_points(u, size)
    return u, space


def _invert_positions(pos_t: torch.Tensor, betas: torch.Tensor, size,
                      scaling: str, iters: int) -> torch.Tensor:
    """``x_tk = psi_t^{-1}(p_tk)`` in pixel space, ``[B, K, 3]``, for
    ``pos_t [B, K, 3]`` (or ``[1, K, 3]``, shared by every frame)."""
    pts = pos_t.expand((betas.shape[0],) + pos_t.shape[1:])
    if scaling == "normalized":
        pn = basis_ops.normalize_points(pts, size)
        inv = basis_ops.invert_warp_points(pn, betas, iters=iters)
        return basis_ops.denormalize_points(inv, size)
    return basis_ops.invert_warp_points(pts, betas, iters=iters)


def analytic_grams(betas: torch.Tensor, pos: torch.Tensor,
                   sigma: torch.Tensor, size, scaling: str = "normalized",
                   window: int = 16, iters: int = 3,
                   plane_axis_max: int = 4) -> torch.Tensor:
    """``[B, K, K]`` closed-form Grams for ``betas [B, 10, 3]``.

    ``pos [K, 3]`` (pixel space), or per-frame positions ``pos [B, K, 3]``
    (:func:`analytic_grams_tracked`); ``sigma [K]`` or ``[K, 3]``.
    ``window`` is the half-width of the per-axis lattice sums; it must
    cover the pair Gaussian (:func:`default_window`).

    A recordings axis, ``betas [R, B, 10, 3]`` with ``pos [R, K, 3]`` and
    ``sigma [R, K]`` or ``[R, K, 3]``, gives ``[R, B, K, K]`` in one call.
    """
    sig = sigma.to(torch.float32)
    if sig.ndim == betas.ndim - 2:  # isotropic
        sig = sig[..., None].expand(sig.shape + (3,))
    kwargs = dict(scaling=scaling, window=window, iters=iters,
                  plane_axis_max=plane_axis_max)
    if betas.ndim == 4:
        r, bsz, k = betas.shape[0], betas.shape[1], pos.shape[-2]

        def frames(t):  # [R, K, 3] -> each frame's copy, [R B, K, 3]
            return t[:, None].expand(r, bsz, k, 3).reshape(r * bsz, k, 3)

        return _grams(betas.reshape(r * bsz, 10, 3), frames(pos),
                      frames(sig), size, **kwargs).view(r, bsz, k, k)
    return _grams(betas, pos if pos.ndim == 3 else pos[None], sig[None], size,
                  **kwargs)


def pair_terms(pos_t, sig):
    """Per axis ``c = c_k + c_l``, the weights ``c_k / c`` and ``c_l / c``
    (``[F, K, K, 3]``), and the pair factor ``exp(-sum_d gamma_d delta_d^2)``
    (``[F, K, K]``) of positions ``pos_t [F, K, 3]`` and per-axis widths
    ``sig [F, K, 3]`` (either ``F`` may be 1)."""
    ck = 1.0 / (sig * sig)                               # [F, K, 3]
    c = ck[:, :, None, :] + ck[:, None, :, :]            # [F, K, K, 3]
    gamma = ck[:, :, None, :] * ck[:, None, :, :] / c
    wk = ck[:, :, None, :] / c
    wl = ck[:, None, :, :] / c
    delta2 = (pos_t[:, :, None, :] - pos_t[:, None, :, :]) ** 2
    return c, wk, wl, torch.exp(-torch.sum(gamma * delta2, dim=-1))


def _grams(betas, pos_t, sig, size, scaling, window, iters, plane_axis_max):
    """:func:`analytic_grams` for ``betas [B, 10, 3]``, ``pos_t [B or 1,
    K, 3]`` and per-axis widths ``sig [B or 1, K, 3]``."""
    size_t = tuple(int(s) for s in size)
    kw = dict(dtype=torch.float32, device=pos_t.device)
    hi = basis_ops.device_vector([float(s - 1) for s in size_t], **kw)
    bsz = betas.shape[0]

    c, wk, wl, pairfac = pair_terms(pos_t, sig)

    m = wk * pos_t[:, :, None, :] + wl * pos_t[:, None, :, :]  # [B|1, K, K, 3]
    xk = _invert_positions(pos_t, betas, size_t, scaling, iters)  # [B, K, 3]
    xm = wk * xk[:, :, None, :] + wl * xk[:, None, :, :]  # [B, K, K, 3]
    # Expand each axis's warp around the volume-clamped inverse point
    # (equal to x_m for interior anchors).
    xc = torch.minimum(torch.maximum(xm, torch.zeros((), **kw)), hi)
    u0, xc_space = _warp_pixel(xc, betas, size_t, scaling)
    jdd = _jac_diag(betas, xc_space)

    # Own-axis curvature h_d = d^2 psi_d / dx_d^2, constant in space.
    if scaling == "normalized":
        hvec = [4.0 * betas[:, 4 + d, d] / max(size_t[d] - 1.0, 1.0)
                for d in range(3)]
    else:
        hvec = [2.0 * betas[:, 4 + d, d] for d in range(3)]

    steps = torch.arange(2 * window + 1, **kw) - window

    def axis_sum(d, u0_d, jdd_d, xc_d, cb, m_d):
        """Windowed lattice sum along axis ``d`` over arguments of a
        common batch shape ``[B, K, K(, Z)]``."""
        h = hvec[d].reshape((bsz,) + (1,) * u0_d.ndim)
        x0 = torch.round(xc_d)
        xs = x0[..., None] + steps
        ds = xs - xc_d[..., None]
        u = u0_d[..., None] + jdd_d[..., None] * ds + 0.5 * h * ds * ds
        dist = torch.minimum(u, hi[d] - u)
        ramp = torch.clamp(1.0 + dist, 0.0, 1.0)
        val = ramp * ramp * torch.exp(-cb[..., None] * (u - m_d[..., None]) ** 2)
        valid = (xs >= 0.0) & (xs <= hi[d])
        return torch.sum(torch.where(valid, val, torch.zeros((), **kw)),
                         dim=-1)

    thin = min(range(3), key=lambda d: size_t[d])
    if size_t[thin] <= plane_axis_max:
        # Sum the thin axis exactly, plane by plane, and expand the other
        # two axes per plane.
        nz = size_t[thin]
        zvals = torch.arange(nz, **kw)
        onehot = basis_ops.device_vector(
            [1.0 if d == thin else 0.0 for d in range(3)], **kw)
        xb = xc[..., None, :] * (1.0 - onehot) + zvals[:, None] * onehot
        u0b, xb_space = _warp_pixel(xb, betas, size_t, scaling)
        jddb = _jac_diag(betas, xb_space)              # [B, K, K, Z, 3]

        ut = u0b[..., thin]
        dist = torch.minimum(ut, hi[thin] - ut)
        ramp = torch.clamp(1.0 + dist, 0.0, 1.0)
        s_planes = ramp * ramp * torch.exp(
            -c[..., thin, None] * (ut - m[..., thin, None]) ** 2)
        zshape = s_planes.shape
        for d in range(3):
            if d == thin:
                continue
            s_planes = s_planes * axis_sum(
                d, u0b[..., d], jddb[..., d],
                xc[..., d, None].expand(zshape),
                c[..., d, None].expand(zshape),
                m[..., d, None].expand(zshape),
            )
        return pairfac * torch.sum(s_planes, dim=-1)

    s = torch.ones_like(u0[..., 0])
    for d in range(3):
        s = s * axis_sum(d, u0[..., d], jdd[..., d], xc[..., d],
                         c[..., d], m[..., d])
    return pairfac * s


def analytic_grams_tracked(betas: torch.Tensor, pos_t: torch.Tensor,
                           sigma: torch.Tensor, size, **kwargs) -> torch.Tensor:
    """``[B, K, K]`` closed-form Grams with per-frame positions ``pos_t
    [B, K, 3]`` (the refinement phase's tracked anchors)."""
    return analytic_grams(betas, pos_t, sigma, size, **kwargs)


def analytic_gram_frame(beta: torch.Tensor, pos: torch.Tensor,
                        sigma: torch.Tensor, size, **kwargs) -> torch.Tensor:
    """Closed-form ``[K, K]`` Gram for one frame's ``beta [10, 3]``."""
    return analytic_grams(beta[None], pos, sigma, size, **kwargs)[0]


def default_window(shape_std: float) -> int:
    """Window half-width covering ``exp(-2 t^2 / sigma^2) < 1e-9`` plus
    linearization slack."""
    return int(math.ceil(3.3 * float(shape_std))) + 2
