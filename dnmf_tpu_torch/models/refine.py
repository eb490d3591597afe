"""Per-frame per-neuron position refinement (the final polish).

Counterpart of ``dnmf_tpu/models/refine.py``.  One quadratic warp per
frame cannot follow neurons that move semi-independently; this phase
fits per-frame positions ``pos_t [T, K, 3]`` in the model's warped frame,
``A_t[p, k] = exp(-|psi_t(p) - pos_t[k]|^2 / sigma_k^2)``, by Adam
against the reconstruction, with a quadratic tether to the anchors, and
alternates it with trace updates on per-frame-position Grams.  Frames
are independent, so an epoch is one Adam step on every frame at once.

:func:`refined_rounds_streaming` runs the same alternation block by
block over a host-streamed source, in one pass over the recording.

With ``use_kernels`` the data term and its ``dpos`` come from the refine
kernel (:func:`dnmf_tpu_torch.ops.fused.refine_block`, all frames in one
call) and the Grams from the tracked c1 or Gram kernels; without, from
the plain versions, one frame block at a time.  Refinement needs analytic
footprints (``ValueError`` in resample mode, as in the JAX package);
unfaded ones (``mask_out_of_bounds=False``) take the plain versions only.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from dnmf_tpu_torch.config import ModelConfig
from dnmf_tpu_torch.models.dnmf import (Adam, DNMFState, block_state,
                                        check_kernels, grams_local,
                                        _blocks, _valid_mask)
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import mu as mu_ops


def _check_refine(model: ModelConfig, use_kernels: bool) -> None:
    if model.deformation.footprint_mode != "analytic":
        raise ValueError("position refinement requires analytic footprints")
    check_kernels(model, use_kernels)


def refine_positions(state: DNMFState, pos_t: Optional[torch.Tensor],
                     video: torch.Tensor, model: ModelConfig,
                     epochs: int = 20, learning_rate: float = 0.05,
                     prior: float = 1e-3, frame_block: int = 16,
                     use_kernels: bool = False
                     ) -> Tuple[torch.Tensor, dict]:
    """Fit per-frame neuron positions by Adam against the reconstruction.

    ``pos_t [T, K, 3]`` starts the fit (None: the anchors broadcast over
    frames); ``learning_rate`` is in pixels; ``prior`` weighs
    ``mean_k |pos_t - anchor|^2`` per frame against the data MSE.  The
    state is not modified.  Returns ``(pos_t, {"recon_mse": [T]})``, the
    MSE of the last epoch, taken before its update.
    """
    _check_refine(model, use_kernels)
    t = video.shape[0]
    k = state.pos.shape[0]
    anchors = state.pos
    if pos_t is None:
        pos_t = anchors.expand(t, k, 3)
    scaling = model.deformation.basis_scaling
    c_t = state.c.T
    adam = Adam(learning_rate)
    count, mu, nu = adam.init(pos_t)
    # The kernel takes every frame at once; the plain version's memory
    # grows with the frames of a call, so it goes one frame block at a time.
    blocks = [(0, t)] if use_kernels else _blocks(t, frame_block)
    if use_kernels:
        refine = fused.refine_block
    else:
        refine = functools.partial(
            fused.refine_block_plain,
            mask_out_of_bounds=model.deformation.mask_out_of_bounds)
    mses = None
    for _ in range(epochs):
        parts = [refine(state.beta[s:e], pos_t[s:e], state.sigma, c_t[s:e],
                        video[s:e], model.size, scaling)
                 for s, e in blocks]
        mses = torch.cat([m for m, _ in parts])
        dpos = torch.cat([d for _, d in parts])
        # The anchor tether's gradient: d/dpos of mean_k |pos - anchor|^2.
        grad = dpos + (2.0 * prior / k) * (pos_t - anchors)
        pos_t, count, mu, nu = adam.update(pos_t, grad, count, mu, nu)
    return pos_t, {"recon_mse": mses}


def tracked_grams(state: DNMFState, pos_t: torch.Tensor, video: torch.Tensor,
                  model: ModelConfig, frame_block: int = 16,
                  use_kernels: bool = False, gram_mode: str = "exact",
                  gram_window: Optional[int] = None):
    """Per-frame MU statistics ``(G [T, K, K], c1 [T, K])`` at per-frame
    positions: the tracked Gram pass (``"exact"``), or closed-form Grams
    plus the tracked c1 pass (``"analytic"``)."""
    _check_refine(model, use_kernels)
    return grams_local(state, video, model, frame_block, use_kernels,
                       gram_mode, gram_window, pos_t=pos_t)


def refined_rounds(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                   rounds: int = 2, epochs: int = 20, mu_iters: int = 30,
                   learning_rate: float = 0.05, prior: float = 1e-3,
                   frame_block: int = 16,
                   pos_t: Optional[torch.Tensor] = None,
                   use_kernels: bool = False, gram_mode: str = "exact",
                   gram_window: Optional[int] = None,
                   trace_solver: str = "mu"
                   ) -> Tuple[DNMFState, torch.Tensor, dict]:
    """Alternate position refinement with tracked-Gram trace updates
    (``"mu"`` or ``"fista"``).  Returns ``(state with updated C, pos_t,
    metrics of the last refinement)``; beta and the anchors are kept."""
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")
    metrics = {}
    for _ in range(rounds):
        pos_t, metrics = refine_positions(
            state, pos_t, video, model, epochs=epochs,
            learning_rate=learning_rate, prior=prior,
            frame_block=frame_block, use_kernels=use_kernels)
        g, c1 = tracked_grams(state, pos_t, video, model, frame_block,
                              use_kernels, gram_mode, gram_window)
        solve = (mu_ops.nnls_temporal if trace_solver == "fista"
                 else mu_ops.run_mu_temporal)
        state = state.replace(c=solve(state.c, g, c1, iters=mu_iters))
    return state, pos_t, metrics


def refined_rounds_streaming(state: DNMFState, source, model: ModelConfig,
                             rounds: int = 2, epochs: int = 20,
                             mu_iters: int = 30, learning_rate: float = 0.05,
                             prior: float = 1e-3,
                             pos_t: Optional[torch.Tensor] = None,
                             use_kernels: bool = False,
                             gram_mode: str = "exact",
                             gram_window: Optional[int] = None,
                             trace_solver: str = "mu"
                             ) -> Tuple[DNMFState, torch.Tensor, dict]:
    """:func:`refined_rounds` over a host-streamed video, in one pass.

    Positions, tracked Grams and the trace update all factor over frames,
    so each block of ``source.blocks()`` runs the whole ``rounds x
    (epochs + trace update)`` alternation on its own frames: the
    recording is read once.  The zero-padded tail block is padded with
    identity warps, zero traces and the anchors, and masked out.
    Returns ``(state with updated C, pos_t [T, K, 3], {"recon_mse"})``,
    the last round's mean data term.
    """
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")
    solve = (mu_ops.nnls_temporal if trace_solver == "fista"
             else mu_ops.run_mu_temporal)
    t, k = state.beta.shape[0], state.pos.shape[0]
    block = source.block
    if pos_t is None:
        pos_t = state.pos.expand(t, k, 3)
    pos_pad = torch.cat([pos_t, state.pos.expand(block, k, 3)])
    pos_out, c_out, sse = [], [], []
    for frames, start, valid in source.blocks():
        st = block_state(state, start, block)
        pos_b = pos_pad[start:start + block]
        for _ in range(rounds):
            pos_b, m = refine_positions(
                st, pos_b, frames, model, epochs=epochs,
                learning_rate=learning_rate, prior=prior, frame_block=block,
                use_kernels=use_kernels)
            g, c1 = tracked_grams(st, pos_b, frames, model, block,
                                  use_kernels, gram_mode, gram_window)
            st = st.replace(c=solve(st.c, g, c1, iters=mu_iters))
        mask = _valid_mask(block, valid, frames.device)
        sse.append(torch.sum(m["recon_mse"] * mask))
        pos_out.append(pos_b)
        c_out.append(st.c)
    c_new = torch.cat(c_out, dim=1)[:, :t]
    return (state.replace(c=c_new), torch.cat(pos_out)[:t],
            {"recon_mse": torch.stack(sse).sum() / t})


def sharded_refined_rounds(*args, **kwargs):
    """Refinement over a time-sharded mesh: not ported yet."""
    raise NotImplementedError(
        "sharded_refined_rounds (mesh refinement) is not ported yet "
        "(ROADMAP Queue 1 item 10)")
