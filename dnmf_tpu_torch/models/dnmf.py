"""Deformable NMF state and update steps.

Counterpart of ``dnmf_tpu/models/dnmf.py``: per-frame parallel Adam on
the warps ``beta [T, 10, 3]`` and the reference's serial mini-batch
schedule (:func:`motion_epoch_parity`), per-frame Grams (exact, or closed
form plus the c1 video pass), MU or FISTA on the traces ``C [K, T]``,
the per-neuron width fit :func:`sigma_fit` and the diagnostic
:func:`spatial_pushforward`.  The state is a dataclass of tensors;
functions run eagerly and loop over frame blocks in Python.

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
configuration, as the JAX package's is.
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
        """One step on any tensor: ``(param, count, mu, nu)`` after it."""
        mu = (1 - self.b1) * grad + self.b1 * mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * nu
        count = count + 1
        f32 = dict(dtype=torch.float32, device=count.device)
        mu_hat = mu / (1 - torch.tensor(self.b1, **f32) ** count)
        nu_hat = nu / (1 - torch.tensor(self.b2, **f32) ** count)
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
    beta, count, mu, nu = state.beta, state.count, state.mu, state.nu
    mses, regs = [], []
    for times, weights in zip(batch_times, batch_weights):
        grad, mse, reg = _batch_loss_grad(
            beta, times, weights, video[times], state.c, state.pos,
            state.sigma, model, vb, gamma, stored_a)
        beta, count, mu, nu = optimizer.update(beta, grad, count, mu, nu)
        mses.append(mse)
        regs.append(reg)
    state = state.replace(beta=beta, count=count, mu=mu, nu=nu)
    return state, {"recon_mse": torch.stack(mses).mean(),
                   "reg": torch.stack(regs).mean()}


def _blocks(t: int, frame_block: int):
    fb = max(1, min(frame_block, t))
    return [(s, min(s + fb, t)) for s in range(0, t, fb)]


def frame_grads_local(state: DNMFState, video: torch.Tensor,
                      model: ModelConfig, gamma: float, frame_block: int,
                      use_kernels: bool = False):
    """Per-frame ``(grads [T, 10, 3], mses [T], regs [T])`` of
    ``mse_t + gamma * reg_t``.

    The data term and its gradient come one frame block at a time (the
    last block is simply shorter: frames are independent, so nothing is
    padded): from the motion pass of :mod:`~dnmf_tpu_torch.ops.fused`
    (its analytic gradient) where :func:`kernels_apply`, else from the
    footprint ops by autograd.  The corner regularizer and its gradient
    are computed for all frames at once.
    """
    check_kernels(model, use_kernels)
    scaling = model.deformation.basis_scaling
    regs, dregs = jac_ops.corner_regularizer_and_grad(
        state.beta, model.size, model.deformation.detach_regularizer, scaling)
    if kernels_apply(model):
        motion = fused.motion_block if use_kernels else fused.motion_block_plain

        def data_term(s, e):
            return motion(state.beta[s:e], state.pos, state.sigma,
                          state.c[:, s:e].T, video[s:e], model.size, scaling)
    else:
        vb = model_voxel_basis(model, device=video.device)
        stored_a = _maybe_stored_a(state, model)

        def data_term(s, e):
            sse, dsse = _frame_sse_grads(
                state.beta[s:e], state.pos, state.sigma, state.c[:, s:e].T,
                video[s:e], model, vb, stored_a)
            return sse / video.shape[1], dsse / video.shape[1]

    mses, dbetas = zip(*(data_term(s, e)
                         for s, e in _blocks(video.shape[0], frame_block)))
    return torch.cat(dbetas) + gamma * dregs, torch.cat(mses), regs


def motion_epoch_parallel(state: DNMFState, video: torch.Tensor,
                          model: ModelConfig, optimizer: Adam, gamma: float,
                          frame_block: int = 16, use_kernels: bool = False
                          ) -> Tuple[DNMFState, dict]:
    """One epoch: one Adam step with per-frame gradients (frames are
    independent given C, and Adam is elementwise)."""
    grads, mses, regs = frame_grads_local(state, video, model, gamma,
                                          frame_block, use_kernels)
    state = optimizer.step(state, grads)
    return state, {"recon_mse": mses.mean(), "reg": regs.mean()}


def grams_local(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                frame_block: int, use_kernels: bool = False,
                gram_mode: str = "exact", gram_window: Optional[int] = None,
                pos_t: Optional[torch.Tensor] = None):
    """Per-frame MU statistics ``(grams [T, K, K], c1 [T, K])``.

    ``gram_mode="exact"`` runs the Gram pass; ``"analytic"`` evaluates
    ``G`` in closed form (:mod:`dnmf_tpu_torch.ops.gram_analytic`;
    analytic footprints only) and runs only the c1 pass.  ``gram_window``
    bounds the closed form's lattice window (default: sized for
    ``model.shape_std``).  With per-frame positions ``pos_t [T, K, 3]``
    the footprints sit at each frame's own positions instead of the
    anchors (the tracked passes).  The passes are those of
    :mod:`~dnmf_tpu_torch.ops.fused` where :func:`kernels_apply`, else
    the footprint ops (with the stored volume in resample mode).
    """
    check_kernels(model, use_kernels)
    if gram_mode not in ("exact", "analytic"):
        raise ValueError(f"unknown gram_mode: {gram_mode!r}")
    if (gram_mode == "analytic"
            and model.deformation.footprint_mode != "analytic"):
        raise ValueError("gram_mode='analytic' requires analytic footprints")
    scaling = model.deformation.basis_scaling
    window = gram_window or ga.default_window(model.shape_std)
    fast = kernels_apply(model)
    if fast:
        c1_fn = fused.c1_block if use_kernels else fused.c1_block_plain
        gram_fn = fused.gram_block if use_kernels else fused.gram_block_plain
    else:
        vb = model_voxel_basis(model, device=video.device)
        stored_a = _maybe_stored_a(state, model)
    grams, c1s = [], []
    for s, e in _blocks(video.shape[0], frame_block):
        betas = state.beta[s:e]
        pos = state.pos if pos_t is None else pos_t[s:e]
        exact = gram_mode == "exact"
        if fast and exact:
            g, c1 = gram_fn(betas, pos, state.sigma, video[s:e], model.size,
                            scaling)
        elif fast:
            c1 = c1_fn(betas, pos, state.sigma, video[s:e], model.size,
                       scaling)
        else:
            g, c1 = _footprint_grams(betas, pos, state.sigma, video[s:e],
                                     model, vb, stored_a, exact)
        if not exact:
            g = ga.analytic_grams(betas, pos, state.sigma, model.size,
                                  scaling=scaling, window=window)
        grams.append(g)
        c1s.append(c1)
    return torch.cat(grams), torch.cat(c1s)


compute_grams = grams_local


def footprint_update(state: DNMFState, grams: torch.Tensor, c1: torch.Tensor,
                     iters: int, gamma: float = 0.0,
                     solver: str = "mu") -> DNMFState:
    """``iters`` trace updates on precomputed Grams: the multiplicative
    rule (``"mu"``) or FISTA (``"fista"``)."""
    g = gamma if gamma else None
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


def _valid_mask(block: int, valid: int, device) -> torch.Tensor:
    return (torch.arange(block, device=device) < valid).to(torch.float32)


def motion_epoch_streaming(state: DNMFState, source, model: ModelConfig,
                           optimizer: Adam, gamma: float,
                           use_kernels: bool = False
                           ) -> Tuple[DNMFState, dict]:
    """One parallel-mode epoch over a host-streamed video: per-frame
    gradients block by block, then one Adam step on all frames (the math
    of :func:`motion_epoch_parallel`).  The per-block metrics stay on the
    device: a host read per block would serialize the copies and the
    compute."""
    grads, mses, regs = [], [], []
    block = source.block
    for frames, start, valid in source.blocks():
        st = block_state(state, start, block)
        g, ms, rs = frame_grads_local(st, frames, model, gamma, block,
                                      use_kernels)
        mask = _valid_mask(block, valid, g.device)
        grads.append(g * mask[:, None, None])
        mses.append(torch.sum(ms * mask))
        regs.append(torch.sum(rs * mask))
    t = state.beta.shape[0]
    state = optimizer.step(state, torch.cat(grads)[:t])
    return state, {"recon_mse": torch.stack(mses).sum() / t,
                   "reg": torch.stack(regs).sum() / t}


def compute_grams_streaming(state: DNMFState, source, model: ModelConfig,
                            use_kernels: bool = False,
                            gram_mode: str = "exact",
                            gram_window: Optional[int] = None):
    """Per-frame MU statistics ``(grams [T, K, K], c1 [T, K])`` over a
    host-streamed video."""
    gs, c1s = [], []
    block = source.block
    for frames, start, _valid in source.blocks():
        g, c1 = grams_local(block_state(state, start, block), frames, model,
                            block, use_kernels, gram_mode, gram_window)
        gs.append(g)
        c1s.append(c1)
    t = state.beta.shape[0]
    return torch.cat(gs)[:t], torch.cat(c1s)[:t]


def fused_rounds(state: DNMFState, video: torch.Tensor, model: ModelConfig,
                 optimizer: Adam, rounds: int, epochs: int, mu_iters: int,
                 gamma: float, mu_gamma: float = 0.0, frame_block: int = 16,
                 use_kernels: bool = False, gram_mode: str = "exact",
                 gram_window: Optional[int] = None,
                 trace_solver: str = "mu") -> Tuple[DNMFState, dict]:
    """``rounds x (epochs x Adam on beta + Grams + mu_iters trace
    updates)``; metrics are the last epoch's per round, ``[rounds]``."""
    if trace_solver not in ("mu", "fista"):
        raise ValueError(f"unknown trace solver: {trace_solver!r}")
    recon, reg = [], []
    for _ in range(rounds):
        for _ in range(epochs):
            state, m = motion_epoch_parallel(state, video, model, optimizer,
                                             gamma, frame_block, use_kernels)
        grams, c1 = grams_local(state, video, model, frame_block, use_kernels,
                                gram_mode, gram_window)
        state = footprint_update(state, grams, c1, mu_iters, mu_gamma,
                                 trace_solver)
        recon.append(m["recon_mse"])
        reg.append(m["reg"])
    return state, {"recon_mse": torch.stack(recon), "reg": torch.stack(reg)}
