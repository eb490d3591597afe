"""Deformable NMF state and update steps.

Counterpart of ``dnmf_tpu/models/dnmf.py``: per-frame parallel Adam on
the warps ``beta [T, 10, 3]`` and the reference's serial mini-batch
schedule (:func:`motion_epoch_parity`), per-frame Grams (exact, or closed
form plus the c1 video pass), MU or FISTA on the traces ``C [K, T]``,
the per-neuron width fit :func:`sigma_fit` and the diagnostic
:func:`spatial_pushforward`.  The state is a dataclass of tensors;
functions run eagerly and loop over frame blocks in Python.  On the card
:mod:`dnmf_tpu_torch.models.graphs` captures the motion epoch, the Grams,
the trace update, the width fit, a round of :func:`fused_rounds`, a
round over stacked recordings and a parity step (:func:`parity_step`) as
CUDA graphs (the JAX package's ``jit``); the functions here are the steps
it captures.

A stacked state (a leading recordings axis on every field: several
recordings of one size, K and T, :func:`dnmf_tpu_torch.parallel.
batched.stack_states`) with videos ``[R, T, P]`` goes through the same
round functions (:func:`frame_grads_local`, :func:`motion_epoch_parallel`,
:func:`grams_local`, :func:`footprint_update`, ``Adam.step``): each frame
block covers every recording, so each video pass is one launch for all
of them, and the Adam step, the corner regularizer and the trace updates
take the recordings axis as a leading batch axis.  Models that no kernel
computes take the footprint ops recording by recording.

Analytic footprints with the border fade (the production configuration)
take the video passes of :mod:`dnmf_tpu_torch.ops.fused`: with
``use_kernels`` their CUDA kernel wrappers (which run the plain versions
on CPU tensors), else the plain versions.  Resampled footprints
(``footprint_mode="resample"``: trilinear samples of a stored footprint
volume, the reference's numerics) and unfaded ones
(``mask_out_of_bounds=False``) are functions that no kernel computes:
they take the footprint ops, with gradients by autograd over pixel
chunks, and ``use_kernels=True`` raises ``ValueError`` for them
(:func:`kernels_apply`).  The parity epoch is plain PyTorch in every
configuration, as the JAX package's is; with ``use_kernels`` its step is
captured, without (resampled footprints among them) it runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig, OptimizerConfig
from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.ops import footprints as fp_ops
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import gram_analytic as ga
from dnmf_tpu_torch.ops import jacobian as jac_ops
from dnmf_tpu_torch.ops import mu as mu_ops
from dnmf_tpu_torch.ops import resample as resample_ops
from dnmf_tpu_torch.ops.interp import inverse_warp_nearest

STATE_FIELDS = ("beta", "c", "pos", "sigma", "count", "mu", "nu")


@dataclasses.dataclass
class DNMFState:
    """Learnable factors and the Adam state of ``beta``.

    beta: ``[T, 10, 3]`` per-frame warp coefficients.
    c: ``[K, T]`` non-negative traces.
    pos: ``[K, 3]`` neuron centers; sigma: ``[K]`` or ``[K, 3]`` widths.
    count: int32 scalar, Adam steps taken; mu, nu: Adam's first and
      second moments, shaped like ``beta``.
    """

    beta: torch.Tensor
    c: torch.Tensor
    pos: torch.Tensor
    sigma: torch.Tensor
    count: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor

    def replace(self, **changes) -> "DNMFState":
        return dataclasses.replace(self, **changes)


def state_from_numpy(d: dict, device="cpu") -> DNMFState:
    """State from a dict of arrays keyed by :data:`STATE_FIELDS` (the JAX
    package's state as NumPy: its optax Adam state gives count, mu and
    nu)."""
    out = {}
    for name in STATE_FIELDS:
        dtype = torch.int32 if name == "count" else torch.float32
        out[name] = torch.as_tensor(np.array(d[name]), dtype=dtype,
                                    device=device)
    return DNMFState(**out)


def state_to_numpy(state: DNMFState) -> dict:
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in STATE_FIELDS}


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps)`` as an elementwise update: moments
    ``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``, bias
    corrections from the incremented ``count``, and the step
    ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def update(self, param: torch.Tensor, grad: torch.Tensor,
               count: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor):
        """One step on any tensor: ``(param, count, mu, nu)`` after it.
        ``count`` may carry leading axes of ``param`` (a stacked state's
        ``[R]``: each recording's own step count, as the JAX package's
        ``vmap``-ed optax steps)."""
        mu = (1 - self.b1) * grad + self.b1 * mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * nu
        count = count + 1
        n = count.reshape(count.shape + (1,) * (param.ndim - count.ndim))
        # Python-float bases against the device count: float32 powers,
        # and no tensor made from host data (a captured graph holds none).
        mu_hat = mu / (1 - torch.pow(self.b1, n))
        nu_hat = nu / (1 - torch.pow(self.b2, n))
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return param + step * (-self.learning_rate), count, mu, nu

    @staticmethod
    def init(param: torch.Tensor):
        """``(count, mu, nu)`` of a fresh optimizer for ``param``."""
        return (torch.zeros((), dtype=torch.int32, device=param.device),
                torch.zeros_like(param), torch.zeros_like(param))

    def step(self, state: DNMFState, grads: torch.Tensor) -> DNMFState:
        beta, count, mu, nu = self.update(state.beta, grads, state.count,
                                          state.mu, state.nu)
        return state.replace(beta=beta, count=count, mu=mu, nu=nu)


def make_motion_optimizer(config: OptimizerConfig) -> Adam:
    """Adam on beta with torch-default hyperparameters."""
    return Adam(config.learning_rate)


def init_state(model: ModelConfig, positions=None,
               generator: Optional[torch.Generator] = None,
               device="cpu", beta0=None) -> DNMFState:
    """Identity warps (or ``beta0 [T, 10, 3]``, e.g. registration-seeded),
    uniform random traces and, without ``positions``, uniform random
    positions, drawn on the CPU from ``generator``; constant widths.  The
    Adam moments start at zero around the initial warps."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    k, t = model.num_neurons, model.num_frames
    if model.sigma_axes not in (1, 3):
        raise ValueError(f"sigma_axes must be 1 (isotropic) or 3 (per-axis), "
                         f"got {model.sigma_axes}")
    if beta0 is None:
        beta = basis_ops.identity_beta(t, device=device)
    else:
        beta = torch.as_tensor(beta0, dtype=torch.float32).to(device).clone()
        if tuple(beta.shape) != (t, basis_ops.NUM_BASIS, 3):
            raise ValueError(f"beta0 {tuple(beta.shape)} for {t} frames")
    c = torch.rand((k, t), generator=generator).to(device)
    if positions is None:
        positions = 1.0 + torch.rand((k, 3), generator=generator) * torch.tensor(
            model.size, dtype=torch.float32)
    pos = torch.as_tensor(positions, dtype=torch.float32).to(device)
    sig_shape = (k,) if model.sigma_axes == 1 else (k, 3)
    sigma = torch.full(sig_shape, model.shape_std, dtype=torch.float32,
                       device=device)
    count, mu, nu = Adam.init(beta)
    return DNMFState(beta=beta, c=c, pos=pos, sigma=sigma, count=count,
                     mu=mu, nu=nu)



def kernels_apply(model: ModelConfig) -> bool:
    """Whether the video passes of :mod:`dnmf_tpu_torch.ops.fused` (the
    kernels and their plain versions) compute this model's function:
    analytic footprints with the border fade."""
    d = model.deformation
    return d.footprint_mode == "analytic" and d.mask_out_of_bounds


def check_kernels(model: ModelConfig, use_kernels: bool) -> None:
    """Raise ``ValueError`` for ``use_kernels`` on a model whose function
    the kernels do not compute."""
    if use_kernels and not kernels_apply(model):
        d = model.deformation
        raise ValueError(
            "the kernels compute analytic footprints with the border fade; "
            f"footprint_mode={d.footprint_mode!r} with mask_out_of_bounds="
            f"{d.mask_out_of_bounds} needs use_kernels=False")


def model_voxel_basis(model: ModelConfig, device="cpu") -> torch.Tensor:
    """``[P, 10]`` voxel basis in the model's beta coordinate space."""
    if model.deformation.basis_scaling == "normalized":
        return basis_ops.voxel_basis_normalized(model.size, device=device)
    return basis_ops.voxel_basis(model.size, device=device)


def _maybe_stored_a(state: DNMFState, model: ModelConfig):
    """The stored footprint volume ``[P, K]`` of resample mode (the
    Gaussians on the voxel grid), else None."""
    if model.deformation.footprint_mode != "resample":
        return None
    grid = basis_ops.voxel_grid(model.size, device=state.pos.device)
    return fp_ops.gaussian_footprints(grid, state.pos, state.sigma)


def _footprints_at(psi, pos, sigma, model: ModelConfig, stored_a=None):
    """Footprints ``[..., P, K]`` at deformed coordinates ``psi [..., P,
    3]``: analytic (anchors ``pos [K, 3]``, or per-frame ``[B, K, 3]``
    against ``psi [B, P, 3]``), or trilinear samples of ``stored_a``."""
    mode = model.deformation.footprint_mode
    if mode == "analytic":
        if pos.ndim == 3:
            pos = pos[:, None]  # [B, 1, K, 3] against psi [B, P, 1, 3]
        return fp_ops.evaluate_footprints(
            psi, pos, sigma, size=model.size,
            mask_out_of_bounds=model.deformation.mask_out_of_bounds)
    if mode == "resample":
        if stored_a is None:
            raise ValueError("resample mode requires stored_a")
        a = resample_ops.resample_footprints(stored_a, psi.reshape(-1, 3),
                                             model.size)
        return a.reshape(psi.shape[:-1] + a.shape[-1:])
    raise ValueError(f"unknown footprint mode: {mode!r}")


def frame_footprints(beta_t, pos, sigma, model: ModelConfig,
                     voxel_basis: torch.Tensor,
                     stored_a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warped footprints ``[P, K]`` of one frame: analytic, or (resample
    mode) trilinear samples of ``stored_a`` (:func:`_maybe_stored_a`)."""
    psi = basis_ops.warp_voxel_coords(voxel_basis, beta_t, model.size,
                                      model.deformation.basis_scaling)
    return _footprints_at(psi, pos, sigma, model, stored_a)


def _warp_rows(vb, betas, model: ModelConfig) -> torch.Tensor:
    """``warp_voxel_coords`` of basis rows ``vb [C, 10]`` for ``betas [B,
    10, 3]`` as a broadcast product and sum: autograd's matmul backward
    reduces the C rows in one ``[10, 3]``-output product, which cuBLAS
    runs on four thread blocks (1.3 ms per call at the ROI shape on the
    H100); this form reduces them in parallel."""
    psi = torch.sum(vb[:, :, None] * betas[:, None], dim=-2)
    if model.deformation.basis_scaling == "normalized":
        psi = basis_ops.denormalize_points(psi, model.size)
    return psi


def _pixel_chunks(betas, pos, sigma, model: ModelConfig, vb, stored_a):
    """``(start, stop, a [B, C, K])``: the footprints of frames ``betas
    [B, 10, 3]`` over chunks of pixels, so that the ``[B, P, K]`` stack
    (and its autograd graph) need not fit in memory."""
    k = pos.shape[-2]
    for start, stop in fused._chunks(vb.shape[0], betas.shape[0] * k * 3):
        psi = _warp_rows(vb[start:stop], betas, model)
        yield start, stop, _footprints_at(psi, pos, sigma, model, stored_a)


def _frame_sse_grads(betas, pos, sigma, c_blk, y_blk, model: ModelConfig,
                     vb, stored_a):
    """Per-frame ``sum_p (recon - y)^2`` ``[B]`` and its gradient with
    respect to ``betas [B, 10, 3]``, by autograd over pixel chunks."""
    sse = torch.zeros(betas.shape[0], dtype=betas.dtype, device=betas.device)
    grad = torch.zeros_like(betas)
    with torch.enable_grad():
        b = betas.detach().requires_grad_(True)
        for start, stop, a in _pixel_chunks(b, pos, sigma, model, vb,
                                            stored_a):
            r = torch.bmm(a, c_blk[:, :, None])[..., 0] - y_blk[:, start:stop]
            s = torch.sum(r * r, dim=1)
            (g,) = torch.autograd.grad(s.sum(), b)
            sse += s.detach()
            grad += g
    return sse, grad


def _footprint_grams(betas, pos, sigma, y, model: ModelConfig, vb, stored_a,
                     exact: bool = True):
    """``(G [B, K, K] or None, c1 [B, K])`` of frames ``betas`` from the
    footprint ops over pixel chunks (``exact=False``: c1 only)."""
    bsz, k = betas.shape[0], pos.shape[-2]
    kw = dict(dtype=betas.dtype, device=betas.device)
    g = torch.zeros((bsz, k, k), **kw) if exact else None
    c1 = torch.zeros((bsz, k), **kw)
    for start, stop, a in _pixel_chunks(betas, pos, sigma, model, vb,
                                        stored_a):
        if exact:
            g += torch.bmm(a.transpose(1, 2), a)
        c1 += torch.bmm(y[:, None, start:stop], a)[:, 0]
    return g, c1


def reconstruct(betas, c_block, pos, sigma, model: ModelConfig,
                voxel_basis: torch.Tensor,
                stored_a: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reconstructed frames ``[B, P]`` of warps ``betas [B, 10, 3]`` and
    traces ``c_block [B, K]`` (either footprint mode)."""
    psi = basis_ops.warp_voxel_coords(voxel_basis, betas, model.size,
                                      model.deformation.basis_scaling)
    a = _footprints_at(psi, pos, sigma, model, stored_a)
    return torch.bmm(a, c_block[:, :, None])[..., 0]


def batch_loss(beta, times, weights, y_block, c, pos, sigma,
               model: ModelConfig, voxel_basis: torch.Tensor, gamma: float,
               stored_a: Optional[torch.Tensor] = None):
    """The reference's batch loss ``mse(recon, y) + gamma * reg.mean()``
    over a (zero-weight padded) frame batch: ``(loss, (mse, reg_mean))``.

    ``beta [T, 10, 3]`` is the full tensor (only the rows of ``times
    [B]`` get a gradient); ``weights [B]`` are 1 for real frames and 0
    for padding; ``y_block [B, P]`` holds the batch's frames.
    """
    betas = beta[times]
    recon = reconstruct(betas, c[:, times].T, pos, sigma, model, voxel_basis,
                        stored_a)
    sse = torch.sum((recon - y_block) ** 2, dim=-1)
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    mse = torch.sum(sse * weights) / (denom * recon.shape[-1])
    reg = jac_ops.corner_regularizer(
        betas, model.size, detach=model.deformation.detach_regularizer,
        scaling=model.deformation.basis_scaling)
    reg_mean = torch.sum(reg * weights) / denom
    return mse + gamma * reg_mean, (mse, reg_mean)


def _batch_loss_grad(beta, times, weights, y_block, c, pos, sigma,
                     model: ModelConfig, vb, gamma: float, stored_a):
    """``(d batch_loss / d beta, mse, reg_mean)``: the data term's
    gradient by autograd over pixel chunks (the batch's ``[B, P, K]``
    graph need not fit in memory), added onto the batch's rows."""
    betas = beta[times]
    sse, dsse = _frame_sse_grads(betas, pos, sigma, c[:, times].T, y_block,
                                 model, vb, stored_a)
    regs, dregs = jac_ops.corner_regularizer_and_grad(
        betas, model.size, model.deformation.detach_regularizer,
        model.deformation.basis_scaling)
    p = y_block.shape[-1]
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    w = (weights / denom)[:, None, None]
    rows = w * dsse / p + gamma * (w * dregs)
    grad = torch.zeros_like(beta).index_add_(0, times, rows)
    return (grad, torch.sum(sse * weights) / (denom * p),
            torch.sum(regs * weights) / denom)


def motion_epoch_parity(state: DNMFState, video: torch.Tensor,
                        batch_times: torch.Tensor,
                        batch_weights: torch.Tensor, model: ModelConfig,
                        optimizer: Adam, gamma: float
                        ) -> Tuple[DNMFState, dict]:
    """One epoch of the reference's schedule: serial Adam steps over
    mini-batches against the *full* ``beta``, so that the moments of
    frames outside a batch decay too; ``count`` steps once per batch.

    ``batch_times [num_batches, B]`` (int64 frame indices) and
    ``batch_weights [num_batches, B]`` (1 real, 0 padding) give the
    batches; the metrics are the means over batches of ``mse`` and
    ``reg_mean`` (:func:`batch_loss`).
    """
    vb = model_voxel_basis(model, device=video.device)
    stored_a = _maybe_stored_a(state, model)
    mses, regs = [], []
    for times, weights in zip(batch_times, batch_weights):
        state, mse, reg = parity_step(state, video, times, weights, model,
                                      optimizer, gamma, vb, stored_a)
        mses.append(mse)
        regs.append(reg)
    return state, {"recon_mse": torch.stack(mses).mean(),
                   "reg": torch.stack(regs).mean()}


def parity_step(state: DNMFState, video: torch.Tensor, times: torch.Tensor,
                weights: torch.Tensor, model: ModelConfig, optimizer: Adam,
                gamma: float, vb: torch.Tensor, stored_a=None):
    """One serial Adam step of :func:`motion_epoch_parity` on the batch
    ``times [B]``, ``weights [B]``: ``(state, mse, reg_mean)``."""
    grad, mse, reg = _batch_loss_grad(
        state.beta, times, weights, video[times], state.c, state.pos,
        state.sigma, model, vb, gamma, stored_a)
    beta, count, mu, nu = optimizer.update(state.beta, grad, state.count,
                                           state.mu, state.nu)
    return state.replace(beta=beta, count=count, mu=mu, nu=nu), mse, reg


def _recording(state: DNMFState, r: int) -> DNMFState:
    return DNMFState(**{name: getattr(state, name)[r]
                        for name in STATE_FIELDS})


def _each_recording(fn, state: DNMFState, video: torch.Tensor, *args,
                    **kwargs):
    """``fn`` on each recording of a stacked state, the outputs stacked:
    the footprint ops' path for the models that no kernel computes."""
    outs = [fn(_recording(state, r), video[r], *args, **kwargs)
            for r in range(video.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _blocks(t: int, frame_block: int):
    fb = max(1, min(frame_block, t))
    return [(s, min(s + fb, t)) for s in range(0, t, fb)]


def _pixel_local(model: ModelConfig, p_offset, what: str) -> None:
    """A pixel shard's footprints must be analytic."""
    if (p_offset is not None
            and model.deformation.footprint_mode != "analytic"):
        raise ValueError(f"pixel-sharded {what} require analytic footprints")


def _local_basis(model: ModelConfig, video: torch.Tensor, p_offset):
    """The footprint ops' voxel basis of the frames' voxels: rows
    ``[p_offset, p_offset + P_loc)`` of the model's (all of it without an
    offset)."""
    vb = model_voxel_basis(model, device=video.device)
    if p_offset is None:
        return vb
    return vb[int(p_offset):int(p_offset) + video.shape[1]]


def frame_grads_local(state: DNMFState, video: torch.Tensor,
                      model: ModelConfig, gamma: float, frame_block: int,
                      use_kernels: bool = False, p_offset=None):
    """Per-frame ``(grads [T, 10, 3], mses [T], regs [T])`` of
    ``mse_t + gamma * reg_t``.

    The data term and its gradient come one frame block at a time (the
    last block is simply shorter: frames are independent, so nothing is
    padded): from the motion pass of :mod:`~dnmf_tpu_torch.ops.fused`
    (its analytic gradient) where :func:`kernels_apply`, else from the
    footprint ops by autograd.  The corner regularizer and its gradient
    are computed for all frames at once.

    A pixel shard (analytic footprints only): ``video [T, P_loc]`` holds
    the global voxels ``[p_offset, p_offset + P_loc)``; the footprint ops
    evaluate on the model's basis rows of that range and the fused passes
    take ``p_offset``.  The data
    terms are then means over the shard's voxels, whose mean over the
    shards is the whole volume's.

    A stacked state and ``video [R, T, P]`` (no voxel range) give ``[R,
    T, ...]``: each frame block is one motion pass over every recording.
    """
    check_kernels(model, use_kernels)
    _pixel_local(model, p_offset, "gradients")
    batched = state.beta.ndim == 4
    if batched and not kernels_apply(model):
        return _each_recording(frame_grads_local, state, video, model, gamma,
                               frame_block, use_kernels, p_offset)
    scaling = model.deformation.basis_scaling
    # The regularizer is per frame: every recording's frames in one call.
    regs, dregs = jac_ops.corner_regularizer_and_grad(
        state.beta.reshape(-1, basis_ops.NUM_BASIS, 3), model.size,
        model.deformation.detach_regularizer, scaling)
    regs = regs.view(state.beta.shape[:-2])
    dregs = dregs.view(state.beta.shape)
    if kernels_apply(model):
        motion = fused.motion_block if use_kernels else fused.motion_block_plain

        def data_term(s, e):
            return motion(state.beta[..., s:e, :, :], state.pos, state.sigma,
                          state.c[..., s:e].transpose(-1, -2),
                          video[..., s:e, :], model.size, scaling,
                          p_offset=p_offset)
    else:
        vb = _local_basis(model, video, p_offset)
        stored_a = _maybe_stored_a(state, model)

        def data_term(s, e):
            sse, dsse = _frame_sse_grads(
                state.beta[s:e], state.pos, state.sigma, state.c[:, s:e].T,
                video[s:e], model, vb, stored_a)
            return sse / video.shape[1], dsse / video.shape[1]

    mses, dbetas = zip(*(data_term(s, e)
                         for s, e in _blocks(video.shape[-2], frame_block)))
    return (torch.cat(dbetas, dim=-3) + gamma * dregs,
            torch.cat(mses, dim=-1), regs)


def motion_epoch_parallel(state: DNMFState, video: torch.Tensor,
                          model: ModelConfig, optimizer: Adam, gamma: float,
                          frame_block: int = 16, use_kernels: bool = False
                          ) -> Tuple[DNMFState, dict]:
    """One epoch: one Adam step with per-frame gradients (frames are
    independent given C, and Adam is elementwise).  A stacked state gives
    per-recording metrics ``[R]``."""
    grads, mses, regs = frame_grads_local(state, video, model, gamma,
                                          frame_block, use_kernels)
    state = optimizer.step(state, grads)
    return state, {"recon_mse": mses.mean(-1), "reg": regs.mean(-1)}


def grams_local(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                frame_block: int, use_kernels: bool = False,
                gram_mode: str = "exact", gram_window: Optional[int] = None,
                pos_t: Optional[torch.Tensor] = None, p_offset=None):
    """Per-frame MU statistics ``(grams [T, K, K], c1 [T, K])``.

    ``gram_mode="exact"`` runs the Gram pass; ``"analytic"`` evaluates
    ``G`` in closed form (:mod:`dnmf_tpu_torch.ops.gram_analytic`;
    analytic footprints only; with ``use_kernels`` on CUDA tensors one
    :func:`~dnmf_tpu_torch.ops.fused.analytic_grams` over all the call's
    frames, else per frame block) and runs only the c1 pass.  ``gram_window``
    bounds the closed form's lattice window (default: sized for
    ``model.shape_std``).  With per-frame positions ``pos_t [T, K, 3]``
    the footprints sit at each frame's own positions instead of the
    anchors (the tracked passes).  The passes are those of
    :mod:`~dnmf_tpu_torch.ops.fused` where :func:`kernels_apply`, else
    the footprint ops (with the stored volume in resample mode).

    A pixel shard (``p_offset`` as :func:`frame_grads_local`'s,
    shared anchors, exact Grams): the Grams and c1 are the sums over the
    shard's voxels, whose sum over the shards is the whole volume's.

    A stacked state and ``video [R, T, P]`` (shared anchors, no voxel
    range) give ``(grams [R, T, K, K], c1 [R, T, K])``: each frame block
    is one Gram (or c1) pass over every recording, and the closed form
    takes every recording's frames in one call.
    """
    check_kernels(model, use_kernels)
    _pixel_local(model, p_offset, "Grams")
    if gram_mode not in ("exact", "analytic"):
        raise ValueError(f"unknown gram_mode: {gram_mode!r}")
    batched = state.beta.ndim == 4
    if batched and (pos_t is not None or p_offset is not None):
        raise ValueError("a recordings axis takes neither per-frame "
                         "positions nor a voxel range")
    if batched and not kernels_apply(model):
        return _each_recording(grams_local, state, video, model, frame_block,
                               use_kernels, gram_mode, gram_window)
    pixel_local = p_offset is not None
    if gram_mode == "analytic" and pixel_local:
        raise ValueError(
            "gram_mode='analytic' computes the whole volume's Gram in closed "
            "form: pixel-sharded partial sums would count it once per "
            "shard; use gram_mode='exact' on pixel meshes")
    if pixel_local and pos_t is not None:
        raise ValueError("per-frame positions take no voxel range")
    if (gram_mode == "analytic"
            and model.deformation.footprint_mode != "analytic"):
        raise ValueError("gram_mode='analytic' requires analytic footprints")
    scaling = model.deformation.basis_scaling
    window = gram_window or ga.default_window(model.shape_std)
    fast = kernels_apply(model)
    exact = gram_mode == "exact"
    # With the kernels on the card the closed form takes the call's frames
    # at once; elsewhere frame_block bounds its [B, K, K, 2w+1] terms.
    closed_once = use_kernels and not exact and video.is_cuda
    if fast:
        c1_fn = fused.c1_block if use_kernels else fused.c1_block_plain
        gram_fn = fused.gram_block if use_kernels else fused.gram_block_plain
    else:
        vb = _local_basis(model, video, p_offset)
        stored_a = _maybe_stored_a(state, model)
    kw = {} if p_offset is None else {"p_offset": p_offset}
    t = video.shape[-2]
    grams, c1s = [], []
    for s, e in _blocks(t, frame_block):
        betas = state.beta[..., s:e, :, :]
        pos = state.pos if pos_t is None else pos_t[s:e]
        frames = video[..., s:e, :]
        if fast and exact:
            g, c1 = gram_fn(betas, pos, state.sigma, frames, model.size,
                            scaling, **kw)
        elif fast:
            c1 = c1_fn(betas, pos, state.sigma, frames, model.size, scaling)
        else:
            g, c1 = _footprint_grams(betas, pos, state.sigma, video[s:e],
                                     model, vb, stored_a, exact)
        if not closed_once:
            if not exact:
                g = ga.analytic_grams(betas, pos, state.sigma, model.size,
                                      scaling=scaling, window=window)
            grams.append(g)
        c1s.append(c1)
    c1 = torch.cat(c1s, dim=-2)
    if closed_once:
        return fused.analytic_grams(
            state.beta[..., :t, :, :], state.pos if pos_t is None
            else pos_t[:t], state.sigma, model.size, scaling=scaling,
            window=window), c1
    return torch.cat(grams, dim=-3), c1


compute_grams = grams_local


def footprint_update(state: DNMFState, grams: torch.Tensor, c1: torch.Tensor,
                     iters: int, gamma: float = 0.0,
                     solver: str = "mu") -> DNMFState:
    """``iters`` trace updates on precomputed Grams: the multiplicative
    rule (``"mu"``) or FISTA (``"fista"``).  The multiplicative rule
    updates a stacked state's ``c [R, K, T]`` from ``grams [R, T, K, K]``
    and ``c1 [R, T, K]``, every recording at once; FISTA takes one
    recording."""
    g = gamma if gamma else None
    if solver == "fista" and state.c.ndim != 2:
        raise ValueError("FISTA takes one recording's traces c [K, T]")
    if solver == "mu":
        c = mu_ops.run_mu_temporal(state.c, grams, c1, iters=iters, gamma=g)
    elif solver == "fista":
        c = mu_ops.nnls_temporal(state.c, grams, c1, iters=iters, gamma=g)
    else:
        raise ValueError(f"unknown trace solver: {solver!r}")
    return state.replace(c=c)


def _sigma_grad_autograd(state: DNMFState, sigma, video_sub, betas_sub,
                         c_sub, model: ModelConfig, blocks):
    """``(d mean_t mse_t / d sigma, mean_t mse_t)`` over the subsample
    from the footprint ops, by autograd over frame blocks and pixel
    chunks.  In resample mode the stored volume is built from ``sigma``
    itself (sampling only moves values around, so a volume of fixed
    widths has no width gradient), and the chunks' gradients with
    respect to it flow back to ``sigma`` once."""
    s_frames, p = video_sub.shape
    resample = model.deformation.footprint_mode == "resample"
    vb = model_voxel_basis(model, device=video_sub.device)
    total = torch.zeros((), dtype=sigma.dtype, device=sigma.device)
    with torch.enable_grad():
        sg = sigma.detach().requires_grad_(True)
        stored = leaf = None
        if resample:
            grid = basis_ops.voxel_grid(model.size, device=sg.device)
            stored = fp_ops.gaussian_footprints(grid, state.pos, sg)
            leaf = stored.detach().requires_grad_(True)
        g_leaf = torch.zeros_like(leaf if resample else sg)
        for s, e in blocks:
            for start, stop, a in _pixel_chunks(
                    betas_sub[s:e], state.pos, sg, model, vb, leaf):
                r = (torch.bmm(a, c_sub[s:e, :, None])[..., 0]
                     - video_sub[s:e, start:stop])
                part = torch.sum(r * r) / p
                (g,) = torch.autograd.grad(part, leaf if resample else sg)
                g_leaf += g
                total += part.detach()
        if resample:
            (g_leaf,) = torch.autograd.grad(stored, sg, grad_outputs=g_leaf)
    return g_leaf / s_frames, total / s_frames


def sigma_fit(state: DNMFState, video_sub: torch.Tensor,
              betas_sub: torch.Tensor, c_sub: torch.Tensor,
              model: ModelConfig, steps: int = 4, lr: float = 0.02,
              lo: float = 1.5, hi: float = 4.8, frame_block: int = 8,
              use_kernels: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-neuron footprint-width fit: ``steps`` Adam iterations on
    log-sigma against a frame subsample.

    ``video_sub [S, P]``, ``betas_sub [S, 10, 3]`` and ``c_sub [S, K]``
    are the subsampled frames, their warps and traces; sigma (``[K]`` or
    per-axis ``[K, 3]``) is clipped to ``[lo, hi]`` pixels.  Where
    :func:`kernels_apply`, the gradient of the mean per-frame data term
    comes from the refine pass with ``want_dsigma`` at the anchors, one
    frame block at a time (the kernel with ``use_kernels``, else autograd
    over pixel chunks); otherwise from the footprint ops by autograd.

    Returns ``(sigma, mse_trace [steps])``, sigma in the input shape.
    """
    check_kernels(model, use_kernels)
    s_frames = video_sub.shape[0]
    k = state.pos.shape[0]
    scaling = model.deformation.basis_scaling
    refine = fused.refine_block if use_kernels else fused.refine_block_plain
    blocks = _blocks(s_frames, frame_block)

    def grads_for(sigma):
        if not kernels_apply(model):
            return _sigma_grad_autograd(state, sigma, video_sub, betas_sub,
                                        c_sub, model, blocks)
        dsig = torch.zeros_like(sigma)
        mse = torch.zeros((), dtype=torch.float32, device=sigma.device)
        for s, e in blocks:
            pos = state.pos.expand(e - s, k, 3)
            mses, _, ds = refine(betas_sub[s:e], pos, sigma, c_sub[s:e],
                                 video_sub[s:e], model.size, scaling,
                                 want_dsigma=True)
            dsig = dsig + ds.sum(dim=0)
            mse = mse + mses.sum()
        return dsig / s_frames, mse / s_frames

    adam = Adam(lr)
    log_lo, log_hi = float(np.log(lo)), float(np.log(hi))
    log_s = torch.clamp(torch.log(state.sigma), log_lo, log_hi)
    count, mu, nu = adam.init(log_s)
    mses = []
    for _ in range(steps):
        sigma = torch.exp(log_s)
        dsig, mse = grads_for(sigma)
        log_s, count, mu, nu = adam.update(log_s, dsig * sigma, count, mu, nu)
        log_s = torch.clamp(log_s, log_lo, log_hi)
        mses.append(mse)
    return torch.exp(log_s), torch.stack(mses)


def spatial_pushforward(state: DNMFState, video: torch.Tensor,
                        model: ModelConfig, frame_block: int = 16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warped footprints and the inverse-warped video of every frame:
    ``(a_all [T, P, K], y_inv [T, P])``, for diagnostics and rendering
    (the trace updates never need the whole ``A``).  ``frame_block``
    frames' footprints are evaluated at a time; only call where ``T * P *
    K`` fits in memory."""
    vb = model_voxel_basis(model, device=video.device)
    stored_a = _maybe_stored_a(state, model)
    a_all, y_inv = [], []
    for s, e in _blocks(video.shape[0], frame_block):
        psi = basis_ops.warp_voxel_coords(vb, state.beta[s:e], model.size,
                                          model.deformation.basis_scaling)
        a_all.append(_footprints_at(psi, state.pos, state.sigma, model,
                                    stored_a))
        y_inv.extend(inverse_warp_nearest(video[i], psi[i - s], model.size)
                     for i in range(s, e))
    return torch.cat(a_all), torch.stack(y_inv)


# ----------------------------------------------------------------------
# Host-streamed variants: frame blocks from a source's ``blocks()``
# ----------------------------------------------------------------------
def block_state(state: DNMFState, start: int, block: int) -> DNMFState:
    """The state of frames ``[start, start + block)``: beta padded with
    identity warps and C with zero columns past the last frame, so that a
    zero-padded tail block gets the same fixed shape as the others."""
    beta = state.beta[start:start + block]
    c = state.c[:, start:start + block]
    short = block - beta.shape[0]
    if short:
        beta = torch.cat([beta, basis_ops.identity_beta(
            short, device=beta.device)])
        c = torch.nn.functional.pad(c, (0, short))
    return state.replace(beta=beta, c=c)


def _valid_mask(block: int, valid, device) -> torch.Tensor:
    """``[block]`` float mask of a block's first ``valid`` frames;
    ``valid`` is an int or an int64 device scalar (a captured block
    step's, loaded per block)."""
    return (torch.arange(block, device=device) < valid).to(torch.float32)


def stream_block_grads(state: DNMFState, frames: torch.Tensor, valid,
                       model: ModelConfig, gamma: float, block: int,
                       use_kernels: bool = False):
    """One streamed block's per-frame gradients, masked by ``valid``
    (:func:`_valid_mask`), and the masked sums of its mse and reg: the
    block step of :func:`motion_epoch_streaming` (``state``: the block's,
    :func:`block_state`)."""
    g, ms, rs = frame_grads_local(state, frames, model, gamma, block,
                                  use_kernels)
    mask = _valid_mask(block, valid, g.device)
    return g * mask[:, None, None], torch.sum(ms * mask), torch.sum(rs * mask)


def stream_block(state: DNMFState, source) -> int:
    """The block of a streamed loop's source; ``ValueError`` unless the
    source holds the state's frames (its blocks would leave frames of the
    state out, or run past them)."""
    t = state.beta.shape[0]
    if source.num_frames != t:
        raise ValueError(f"model has {t} frames but the streaming source "
                         f"holds {source.num_frames}")
    return int(source.block)


def eager_blocks(step, source, fixed: tuple, per_block, with_valid=True,
                 warmup=None):
    """The plain block runner of the streamed loops: ``step(*fixed,
    *per_block(start), frames)``, then (``with_valid``) the block's count
    of valid frames, on each block of ``source.blocks()``, yielding
    ``(start, outputs)``.  ``models.graphs`` hands the loops a runner
    that replays the step as one captured graph instead (``warmup`` is
    its warm-up's step), so each loop copies a block's outputs out before
    it asks for the next."""
    del warmup
    for frames, start, valid in source.blocks():
        yield start, step(*fixed, *per_block(start), frames,
                          *((valid,) if with_valid else ()))


def block_outputs(state: DNMFState, block: int, *shape) -> torch.Tensor:
    """A streamed loop's output buffer over the blocks that cover the
    recording, ``[T rounded up to the block, *shape]``: what the loop
    hands out is its first ``T`` rows."""
    rows = -(-state.beta.shape[0] // block) * block
    return state.beta.new_empty((rows,) + tuple(shape))


def motion_epoch_streaming(state: DNMFState, source, model: ModelConfig,
                           optimizer: Adam, gamma: float,
                           use_kernels: bool = False,
                           run_blocks=eager_blocks
                           ) -> Tuple[DNMFState, dict]:
    """One parallel-mode epoch over a host-streamed video: per-frame
    gradients block by block (:func:`stream_block_grads`), then one Adam
    step on all frames (the math of :func:`motion_epoch_parallel`).  The
    per-block metrics stay on the device: a host read per block would
    serialize the copies and the compute.

    ``run_blocks`` runs the block step (:func:`eager_blocks`);
    ``graphs.motion_epoch_streaming``, which the engine calls on one
    device, passes one that replays it as a captured graph.  The eager
    epoch is what that one is held against; ``bench``'s ``streamed_io``
    section times it."""
    block = stream_block(state, source)

    def step(pos, sigma, beta, c, frames, valid):
        return stream_block_grads(DNMFState(beta, c, pos, sigma, None, None,
                                            None), frames, valid, model,
                                  gamma, block, use_kernels)

    def per_block(start):
        st = block_state(state, start, block)
        return st.beta, st.c

    t = state.beta.shape[0]
    grads = block_outputs(state, block, *state.beta.shape[1:])
    mses, regs = [], []
    fixed = (state.pos, state.sigma)
    for start, (g, ms, rs) in run_blocks(step, source, fixed, per_block):
        grads[start:start + block].copy_(g)
        mses.append(ms.clone())
        regs.append(rs.clone())
    state = optimizer.step(state, grads[:t])
    return state, {"recon_mse": torch.stack(mses).sum() / t,
                   "reg": torch.stack(regs).sum() / t}


def compute_grams_streaming(state: DNMFState, source, model: ModelConfig,
                            use_kernels: bool = False,
                            gram_mode: str = "exact",
                            gram_window: Optional[int] = None,
                            run_blocks=eager_blocks):
    """Per-frame MU statistics ``(grams [T, K, K], c1 [T, K])`` over a
    host-streamed video, one :func:`grams_local` per block, run by
    ``run_blocks`` as in :func:`motion_epoch_streaming`
    (``graphs.compute_grams_streaming`` replays it)."""
    block = stream_block(state, source)

    def step(pos, sigma, beta, frames):
        return grams_local(DNMFState(beta, None, pos, sigma, None, None,
                                     None), frames, model, block,
                           use_kernels, gram_mode, gram_window)

    t, k = state.beta.shape[0], state.pos.shape[0]
    grams, c1s = block_outputs(state, block, k, k), block_outputs(
        state, block, k)
    for start, (g, c1) in run_blocks(
            step, source, (state.pos, state.sigma),
            lambda start: (block_state(state, start, block).beta,),
            with_valid=False):
        grams[start:start + block].copy_(g)
        c1s[start:start + block].copy_(c1)
    return grams[:t], c1s[:t]


def fused_round(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                optimizer: Adam, epochs: int, mu_iters: int, gamma: float,
                mu_gamma: float = 0.0, frame_block: int = 16,
                use_kernels: bool = False, gram_mode: str = "exact",
                gram_window: Optional[int] = None,
                trace_solver: str = "mu") -> Tuple[DNMFState, dict]:
    """One round of :func:`fused_rounds`: ``epochs`` Adam epochs on beta,
    the Grams and ``mu_iters`` trace updates; the last epoch's metrics."""
    for _ in range(epochs):
        state, m = motion_epoch_parallel(state, video, model, optimizer,
                                         gamma, frame_block, use_kernels)
    grams, c1 = grams_local(state, video, model, frame_block, use_kernels,
                            gram_mode, gram_window)
    state = footprint_update(state, grams, c1, mu_iters, mu_gamma,
                             trace_solver)
    return state, m


def fused_rounds(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                 optimizer: Adam, rounds: int, epochs: int, mu_iters: int,
                 gamma: float, mu_gamma: float = 0.0, frame_block: int = 16,
                 use_kernels: bool = False, gram_mode: str = "exact",
                 gram_window: Optional[int] = None,
                 trace_solver: str = "mu") -> Tuple[DNMFState, dict]:
    """``rounds x (epochs x Adam on beta + Grams + mu_iters trace
    updates)``; metrics are the last epoch's per round, ``[rounds]``:
    a loop of :func:`fused_round` (captured once and replayed by
    :func:`dnmf_tpu_torch.models.graphs.fused_rounds`)."""
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")
    kw = dict(epochs=epochs, mu_iters=mu_iters, gamma=gamma,
              mu_gamma=mu_gamma, frame_block=frame_block,
              use_kernels=use_kernels, gram_mode=gram_mode,
              gram_window=gram_window, trace_solver=trace_solver)
    recon, reg = [], []
    for _ in range(rounds):
        state, m = fused_round(state, video, model, optimizer, **kw)
        recon.append(m["recon_mse"])
        reg.append(m["reg"])
    return state, {"recon_mse": torch.stack(recon), "reg": torch.stack(reg)}
