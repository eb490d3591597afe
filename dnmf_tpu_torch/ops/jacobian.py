"""Closed-form Jacobian of the quadratic warp and the corner log-det
regularizer.  Counterpart of ``dnmf_tpu/ops/jacobian.py``: the Jacobian
follows the basis order ``[1, x, y, z, x^2, y^2, z^2, xy, xz, yz]``."""

from __future__ import annotations

import torch

from dnmf_tpu_torch.ops.basis import device_vector


def quadratic_jacobian(beta: torch.Tensor,
                       point: torch.Tensor) -> torch.Tensor:
    """``J[..., i, j] = d warp_i / d p_j`` for ``beta [..., 10, 3]`` at
    one ``point [3]``: ``[..., 3, 3]``."""
    x, y, z = point[0], point[1], point[2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    dphi = torch.stack([
        torch.stack([zero, zero, zero]),   # 1
        torch.stack([one, zero, zero]),    # x
        torch.stack([zero, one, zero]),    # y
        torch.stack([zero, zero, one]),    # z
        torch.stack([2 * x, zero, zero]),  # x^2
        torch.stack([zero, 2 * y, zero]),  # y^2
        torch.stack([zero, zero, 2 * z]),  # z^2
        torch.stack([y, x, zero]),         # xy
        torch.stack([z, zero, x]),         # xz
        torch.stack([zero, z, y]),         # yz
    ])  # [10, 3]
    return beta.transpose(-1, -2) @ dphi


def _det3(j: torch.Tensor) -> torch.Tensor:
    """Determinant of ``[..., 3, 3]`` by cofactor expansion."""
    return (j[..., 0, 0] * (j[..., 1, 1] * j[..., 2, 2]
                            - j[..., 1, 2] * j[..., 2, 1])
            - j[..., 0, 1] * (j[..., 1, 0] * j[..., 2, 2]
                              - j[..., 1, 2] * j[..., 2, 0])
            + j[..., 0, 2] * (j[..., 1, 0] * j[..., 2, 1]
                              - j[..., 1, 1] * j[..., 2, 0]))


def log_det_jacobian(beta: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """``log |det J_beta(point)|`` per leading index of ``beta``."""
    return torch.log(torch.abs(_det3(quadratic_jacobian(beta, point)))
                     + 1e-32)


def corner_regularizer(beta: torch.Tensor, size, detach: bool = False,
                       scaling: str = "pixel") -> torch.Tensor:
    """``log|det J(hi)|^2 + log|det J(lo)|^2`` at the two volume corners
    (``0`` and ``size-1`` in pixel scaling, ``-1`` and ``+1`` in
    normalized scaling), for ``beta [10, 3]`` or ``[B, 10, 3]``.

    ``detach=True`` reproduces the reference's gradient-free regularizer.
    """
    kw = dict(dtype=beta.dtype, device=beta.device)
    if scaling == "normalized":
        lo_pt = -torch.ones(3, **kw)
        hi_pt = torch.ones(3, **kw)
    else:
        lo_pt = torch.zeros(3, **kw)
        hi_pt = device_vector([float(s) - 1.0 for s in size], **kw)
    reg = (log_det_jacobian(beta, hi_pt) ** 2
           + log_det_jacobian(beta, lo_pt) ** 2)
    return reg.detach() if detach else reg


def corner_regularizer_and_grad(beta: torch.Tensor, size, detach: bool,
                                scaling: str):
    """Per-frame regularizer ``[B]`` and its gradient ``[B, 10, 3]``
    (zero when detached) for ``beta [B, 10, 3]``.  Frames are
    independent, so one backward pass of the sum gives every frame's
    gradient."""
    with torch.enable_grad():
        b = beta.detach().requires_grad_(True)
        reg = corner_regularizer(b, size, detach=False, scaling=scaling)
        (grad,) = torch.autograd.grad(reg.sum(), b)
    if detach:
        grad = torch.zeros_like(grad)
    return reg.detach(), grad
