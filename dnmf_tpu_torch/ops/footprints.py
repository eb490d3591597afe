"""Analytic Gaussian footprints evaluated at deformed coordinates.

``A_t[p, k] = exp(-sum_d (psi_pd - pos_kd)^2 / sigma_kd^2) * w(psi_p)``
with the border fade ``w`` (grid_sample zero-padding semantics).  Only
the direct (subtract/square/exp) formulation is ported: a matmul-form
exponent sums cancelling O(coord^2) terms.  Counterpart of
``dnmf_tpu/ops/footprints.py``.
"""

from __future__ import annotations

import torch


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


def _bounds_mask(psi: torch.Tensor, size) -> torch.Tensor:
    """``[..., P, 1]`` border fade: 1 inside, linear ramp to 0 across the
    last voxel outside.

    The clip is written as ``minimum(maximum(...))`` so that autograd
    gives JAX's 0.5 subgradient at the ramp's ties (every face voxel of a
    thin volume sits on one at the identity warp); ``torch.clamp`` would
    give 1 there.
    """
    hi = torch.tensor([float(s) - 1.0 for s in size], dtype=psi.dtype,
                      device=psi.device)
    dist_in = torch.minimum(psi, hi - psi)
    zero = torch.zeros((), dtype=psi.dtype, device=psi.device)
    one = torch.ones((), dtype=psi.dtype, device=psi.device)
    w = torch.minimum(torch.maximum(1.0 + dist_in, zero), one)
    return (w[..., 0] * w[..., 1] * w[..., 2])[..., None]


def evaluate_footprints(psi: torch.Tensor, pos: torch.Tensor,
                        sigma: torch.Tensor, size=None,
                        mask_out_of_bounds: bool = True) -> torch.Tensor:
    """Warped footprints ``[..., P, K]`` at deformed coordinates
    ``psi [..., P, 3]``."""
    a = gaussian_footprints(psi, pos, sigma)
    if mask_out_of_bounds:
        if size is None:
            raise ValueError("size is required when mask_out_of_bounds=True")
        a = a * _bounds_mask(psi, size)
    return a
