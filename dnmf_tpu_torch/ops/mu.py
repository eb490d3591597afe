"""Trace updates on precomputed per-frame Grams.

The per-frame Gram ``G_t = A_t^T A_t [K, K]`` and projection
``c1_t = A_t^T y_t [K]`` do not depend on the traces, so they are
computed once per footprint update and every iteration costs
``O(K^2 T)``.  Counterpart of ``dnmf_tpu/ops/mu.py``; ``lax.scan`` loops
become Python loops.  The multiplicative rule takes leading batch axes
(several recordings: ``c [R, K, T]``, ``grams [R, T, K, K]``, ``c1 [R,
T, K]``), as the JAX package's ``vmap`` does.
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


def _neighbor_sum(c: torch.Tensor, halo=None) -> torch.Tensor:
    """+-1-frame neighbor sum along the time axis: edge-replicated, or
    with ``halo = (left_col, right_col)`` (each ``[K]``) the columns just
    outside ``c``'s frames (a time shard's neighbours)."""
    if halo is None:
        left_col, right_col = c[..., 0], c[..., -1]
    else:
        left_col, right_col = halo
    left = torch.cat([left_col[..., None], c[..., :-1]], dim=-1)
    right = torch.cat([c[..., 1:], right_col[..., None]], dim=-1)
    return left + right


def mu_temporal_step(c: torch.Tensor, grams: torch.Tensor, c1: torch.Tensor,
                     gamma: Optional[float] = None,
                     halo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """One multiplicative update of ``c [K, T]`` given ``grams
    [T, K, K]`` and ``c1 [T, K]``; ``gamma`` weights the temporal
    smoothing (None or 0 disables it).  ``halo`` (a time shard): the
    neighbouring shards' edge columns ``(left_col, right_col)``, used in
    place of edge replication."""
    c2 = torch.einsum("...tkl,...lt->...kt", grams, c)
    num = c1.transpose(-1, -2)
    den = c2
    if gamma is not None and gamma != 0.0:
        num = num + gamma * _neighbor_sum(c, halo)
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


def fista_step(c_prev: torch.Tensor, y_c: torch.Tensor, tk: torch.Tensor,
               grams: torch.Tensor, c1: torch.Tensor, inv_l: torch.Tensor,
               gamma: Optional[float] = None,
               halo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One FISTA iteration of :func:`nnls_temporal` from the last iterate
    ``c_prev``, the extrapolated point ``y_c`` and the momentum scalar
    ``tk``, with the step ``inv_l = 1 / L``; ``halo`` as
    :func:`mu_temporal_step`'s, at ``y_c``.  Returns ``(c_new, y_new,
    tk_new)``."""
    g = torch.einsum("tkl,lt->kt", grams, y_c) - c1.T
    if gamma is not None and gamma != 0.0:
        g = g + gamma * (2.0 * y_c - _neighbor_sum(y_c, halo))
    c_new = torch.clamp_min(y_c - inv_l * g, 0.0)
    tk1 = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tk * tk))
    y_new = c_new + ((tk - 1.0) / tk1) * (c_new - c_prev)
    return c_new, y_new, tk1


def nnls_temporal(c: torch.Tensor, grams: torch.Tensor, c1: torch.Tensor,
                  iters: int, gamma: Optional[float] = None,
                  lipschitz: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FISTA (accelerated projected gradient) on the convex trace
    subproblem ``sum_t (1/2 c_t^T G_t c_t - c1_t^T c_t)`` (+ smoothing)
    over ``C >= 0`` — the objective the multiplicative rule descends:
    ``iters`` of :func:`fista_step` (edge-replicated; a time shard's
    update runs them with its halo, ``parallel.sharded_footprint_update``).
    ``lipschitz``: the constant, default :func:`gram_lipschitz`'s."""
    lv = lipschitz if lipschitz is not None else gram_lipschitz(grams, gamma)
    inv_l = 1.0 / lv
    c_prev, y_c = c, c
    tk = torch.ones((), dtype=c.dtype, device=c.device)
    for _ in range(iters):
        c_prev, y_c, tk = fista_step(c_prev, y_c, tk, grams, c1, inv_l,
                                     gamma)
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


def static_alternation(a: torch.Tensor, c: torch.Tensor, y: torch.Tensor,
                       d: torch.Tensor, gamma: float):
    """One alternation of ``StaticFootprintNMF.fit``: the traces ``c ->
    c (A^T y) / ((A^T A) c)``, then :func:`mu_spatial_step` of ``a`` at
    the new traces.  Returns ``(a, c)``."""
    c = c * (a.T @ y) / ((a.T @ a) @ c + EPS)
    return mu_spatial_step(a, c, y, d=d, gamma=gamma), c


def distance_penalty(grid: torch.Tensor, pos: torch.Tensor,
                     rate: float = 0.01) -> torch.Tensor:
    """``D[p, k] = 1 - exp(-rate * ||grid_p - pos_k||)``: ``[P, K]``."""
    diff = grid[:, None, :] - pos[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    return 1.0 - torch.exp(-rate * dist)
