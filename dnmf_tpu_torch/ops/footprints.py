"""Analytic Gaussian footprints evaluated at deformed coordinates.

``A_t[p, k] = exp(-sum_d (psi_pd - pos_kd)^2 / sigma_kd^2) * w(psi_p)``
with the border fade ``w`` (grid_sample zero-padding semantics).
Counterpart of ``dnmf_tpu/ops/footprints.py``.  Two formulations:

* ``direct``: subtract, square, exp.  Stable, and the only one on any
  path of the port (the kernels of ``csrc/`` evaluate this form).
* ``matmul``: the exponent is affine in ``[psi, ||psi||^2]`` (or
  ``[psi, psi^2]`` for per-axis widths), ``E = psi_aug @ W + b``
  (:func:`gaussian_weights`).  It sums O(coord^2) terms that cancel to
  the O(1) exponent, so it loses digits with the coordinates' magnitude
  and is wrecked by any reduced-mantissa product: keep TF32 off
  (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

from typing import Optional

import torch

from dnmf_tpu_torch.ops.basis import device_vector, voxel_basis


def gaussian_footprints(grid: torch.Tensor, pos: torch.Tensor,
                        sigma: torch.Tensor) -> torch.Tensor:
    """Gaussians at ``grid [..., P, 3]`` for centers ``pos [K, 3]`` and
    widths ``sigma [K]`` (isotropic) or ``[K, 3]`` (per axis):
    ``[..., P, K]``."""
    d = grid[..., :, None, :] - pos
    if sigma.ndim == 2:
        expo = -torch.sum((d * d) / (sigma * sigma), dim=-1)
    else:
        expo = -torch.sum(d * d, dim=-1) / sigma ** 2
    return torch.exp(expo)


def gaussian_weights(pos: torch.Tensor, sigma: torch.Tensor):
    """Affine exponent of the matmul formulation.

    Isotropic ``sigma [K]``: ``(W [4, K], b [K])`` with ``exponent =
    [psi, ||psi||^2] @ W + b``; per-axis ``sigma [K, 3]``: ``(W [6, K],
    b [K])`` against ``[psi, psi^2]``.
    """
    if sigma.ndim == 2:
        inv_s2 = 1.0 / (sigma * sigma)  # [K, 3]
        w = torch.cat([2.0 * pos.T * inv_s2.T, -inv_s2.T], dim=0)
        return w, -torch.sum(pos * pos * inv_s2, dim=-1)
    inv_s2 = 1.0 / sigma ** 2  # [K]
    w = torch.cat([2.0 * pos.T * inv_s2[None, :], -inv_s2[None, :]], dim=0)
    return w, -torch.sum(pos * pos, dim=-1) * inv_s2


def _bounds_mask(psi: torch.Tensor, size) -> torch.Tensor:
    """``[..., P, 1]`` border fade: 1 inside, linear ramp to 0 across the
    last voxel outside.

    The clip is written as ``minimum(maximum(...))`` so that autograd
    gives JAX's 0.5 subgradient at the ramp's ties (every face voxel of a
    thin volume sits on one at the identity warp); ``torch.clamp`` would
    give 1 there.
    """
    hi = device_vector([float(s) - 1.0 for s in size], dtype=psi.dtype,
                       device=psi.device)
    dist_in = torch.minimum(psi, hi - psi)
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
    one = torch.ones((), dtype=psi.dtype, device=psi.device)
    w = torch.minimum(torch.maximum(1.0 + dist_in, zero), one)
    return (w[..., 0] * w[..., 1] * w[..., 2])[..., None]


def evaluate_footprints(psi: torch.Tensor, pos: torch.Tensor,
                        sigma: torch.Tensor, size=None,
                        mask_out_of_bounds: bool = True,
                        formulation: str = "direct") -> torch.Tensor:
    """Warped footprints ``[..., P, K]`` at deformed coordinates
    ``psi [..., P, 3]``; ``formulation`` is ``"direct"`` or ``"matmul"``
    (module docstring)."""
    if formulation == "matmul":
        w, b = gaussian_weights(pos, sigma)
        sq = psi * psi if sigma.ndim == 2 else torch.sum(
            psi * psi, dim=-1, keepdim=True)
        a = torch.exp(torch.cat([psi, sq], dim=-1) @ w + b)
    elif formulation == "direct":
        a = gaussian_footprints(psi, pos, sigma)
    else:
        raise ValueError(f"unknown formulation: {formulation!r}")
    if mask_out_of_bounds:
        if size is None:
            raise ValueError("size is required when mask_out_of_bounds=True")
        a = a * _bounds_mask(psi, size)
    return a


def fused_reconstruction(psi: torch.Tensor, pos: torch.Tensor,
                         sigma: torch.Tensor, c_t: torch.Tensor, size=None,
                         mask_out_of_bounds: bool = True,
                         formulation: str = "direct") -> torch.Tensor:
    """One frame's reconstruction ``recon[p] = sum_k A_t[p, k] c_t[k]``,
    the footprints evaluated on the fly."""
    return evaluate_footprints(psi, pos, sigma, size=size,
                               mask_out_of_bounds=mask_out_of_bounds,
                               formulation=formulation) @ c_t


def reconstruct_frames(betas: torch.Tensor, c: torch.Tensor,
                       pos: torch.Tensor, sigma: torch.Tensor, size,
                       basis: Optional[torch.Tensor] = None,
                       mask_out_of_bounds: bool = True,
                       formulation: str = "direct") -> torch.Tensor:
    """Reconstructed frames ``[B, P]`` of warps ``betas [B, 10, 3]`` and
    traces ``c [B, K]``; ``basis`` is the voxel basis ``[P, 10]`` in the
    betas' coordinate space (default: the pixel basis)."""
    if basis is None:
        basis = voxel_basis(size, dtype=betas.dtype, device=betas.device)
    psi = basis @ betas  # [B, P, 3]
    a = evaluate_footprints(psi, pos, sigma, size=size,
                            mask_out_of_bounds=mask_out_of_bounds,
                            formulation=formulation)
    return torch.bmm(a, c[:, :, None])[..., 0]
