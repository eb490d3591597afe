"""Trace updates on precomputed per-frame Grams.

The per-frame Gram ``G_t = A_t^T A_t [K, K]`` and projection
``c1_t = A_t^T y_t [K]`` do not depend on the traces, so they are
computed once per footprint update and every iteration costs
``O(K^2 T)``.  Counterpart of ``dnmf_tpu/ops/mu.py``; ``lax.scan`` loops
become Python loops.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

EPS = 1e-32  # the reference's denominator guard


def mu_grams(a_t: torch.Tensor,
             y_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G [K, K], c1 [K])`` of one frame's footprints ``a_t [P, K]``
    and frame ``y_t [P]``."""
    return a_t.T @ a_t, a_t.T @ y_t


def _neighbor_sum(c: torch.Tensor) -> torch.Tensor:
    """Edge-replicated +-1-frame neighbor sum along the time axis."""
    left = torch.cat([c[:, :1], c[:, :-1]], dim=1)
    right = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    return left + right


def mu_temporal_step(c: torch.Tensor, grams: torch.Tensor, c1: torch.Tensor,
                     gamma: Optional[float] = None) -> torch.Tensor:
    """One multiplicative update of ``c [K, T]`` given ``grams
    [T, K, K]`` and ``c1 [T, K]``; ``gamma`` weights the temporal
    smoothing (None or 0 disables it)."""
    c2 = torch.einsum("tkl,lt->kt", grams, c)
    num = c1.T
    den = c2
    if gamma is not None and gamma != 0.0:
        num = num + gamma * _neighbor_sum(c)
        den = den + 2.0 * gamma * c
    return c * num / (den + EPS)


def run_mu_temporal(c: torch.Tensor, grams: torch.Tensor, c1: torch.Tensor,
                    iters: int, gamma: Optional[float] = None) -> torch.Tensor:
    """``iters`` multiplicative updates."""
    for _ in range(iters):
        c = mu_temporal_step(c, grams, c1, gamma=gamma)
    return c


def gram_lipschitz(grams: torch.Tensor, gamma: Optional[float] = None,
                   power_iters: int = 12) -> torch.Tensor:
    """Lipschitz constant of the trace-subproblem gradient:
    ``max_t lambda_max(G_t)`` by batched power iteration (1.02 safety
    factor), plus ``4 gamma`` with temporal smoothing."""
    k = grams.shape[1]
    v = torch.ones_like(grams[:, :, 0]) / math.sqrt(k)
    n = None
    for _ in range(power_iters):
        w = torch.einsum("tkl,tl->tk", grams, v)
        n = torch.linalg.vector_norm(w, dim=1, keepdim=True)
        v = w / torch.clamp_min(n, 1e-30)
    lmax = torch.max(n[:, 0]) * 1.02
    if gamma:
        lmax = lmax + 4.0 * gamma
    return torch.clamp_min(lmax, 1e-12)


def nnls_temporal(c: torch.Tensor, grams: torch.Tensor, c1: torch.Tensor,
                  iters: int, gamma: Optional[float] = None,
                  lipschitz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FISTA (accelerated projected gradient) on the convex trace
    subproblem ``sum_t (1/2 c_t^T G_t c_t - c1_t^T c_t)`` (+ smoothing)
    over ``C >= 0`` — the objective the multiplicative rule descends."""
    lv = lipschitz if lipschitz is not None else gram_lipschitz(grams, gamma)
    inv_l = 1.0 / lv

    def grad(x):
        g = torch.einsum("tkl,lt->kt", grams, x) - c1.T
        if gamma is not None and gamma != 0.0:
            g = g + gamma * (2.0 * x - _neighbor_sum(x))
        return g

    c_prev, y_c = c, c
    tk = torch.tensor(1.0, dtype=c.dtype, device=c.device)
    for _ in range(iters):
        c_new = torch.clamp_min(y_c - inv_l * grad(y_c), 0.0)
        tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
        y_c = c_new + ((tk - 1.0) / tk1) * (c_new - c_prev)
        c_prev, tk = c_new, tk1
    return c_prev


def mu_spatial_step(a: torch.Tensor, c: torch.Tensor, y: torch.Tensor,
                    d: Optional[torch.Tensor] = None,
                    gamma: Optional[float] = None) -> torch.Tensor:
    """Multiplicative update of a static footprint matrix ``a [P, K]``
    given traces ``c [K, T]`` and the (motion-corrected) video ``y [P,
    T]``, with the optional distance-penalty field ``d [P, K]`` weighted
    by ``gamma``: ``a * (y c^T) / (a (c c^T) + gamma d)``."""
    a2 = a @ (c @ c.T)
    if d is not None and gamma is not None:
        a2 = a2 + gamma * d
    return a * (y @ c.T) / (a2 + EPS)


def distance_penalty(grid: torch.Tensor, pos: torch.Tensor,
                     rate: float = 0.01) -> torch.Tensor:
    """``D[p, k] = 1 - exp(-rate * ||grid_p - pos_k||)``: ``[P, K]``."""
    diff = grid[:, None, :] - pos[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return 1.0 - torch.exp(-rate * dist)
