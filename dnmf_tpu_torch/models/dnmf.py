"""Deformable NMF state and update steps of one demixing round.

Counterpart of ``dnmf_tpu/models/dnmf.py`` on its main path: per-frame
parallel Adam on the warps ``beta [T, 10, 3]``, per-frame Grams (exact,
or closed form plus the c1 video pass), and MU or FISTA on the traces
``C [K, T]``.  The state is a dataclass of tensors; functions run
eagerly and loop over frame blocks in Python.  ``use_kernels`` selects
the CUDA kernel wrappers of :mod:`dnmf_tpu_torch.ops.fused` (which run
their plain versions on CPU tensors); ``False`` runs the plain versions.
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

    def step(self, state: DNMFState, grads: torch.Tensor) -> DNMFState:
        mu = (1 - self.b1) * grads + self.b1 * state.mu
        nu = (1 - self.b2) * (grads * grads) + self.b2 * state.nu
        count = state.count + 1
        f32 = dict(dtype=torch.float32, device=count.device)
        mu_hat = mu / (1 - torch.tensor(self.b1, **f32) ** count)
        nu_hat = nu / (1 - torch.tensor(self.b2, **f32) ** count)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        return state.replace(beta=state.beta + update * (-self.learning_rate),
                             count=count, mu=mu, nu=nu)


def make_motion_optimizer(config: OptimizerConfig) -> Adam:
    """Adam on beta with torch-default hyperparameters."""
    return Adam(config.learning_rate)


def init_state(model: ModelConfig, positions=None,
               generator: Optional[torch.Generator] = None,
               device="cpu") -> DNMFState:
    """Identity warps, uniform random traces and, without
    ``positions``, uniform random positions, drawn on the CPU from
    ``generator``; constant widths."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    k, t = model.num_neurons, model.num_frames
    if model.sigma_axes not in (1, 3):
        raise ValueError(f"sigma_axes must be 1 (isotropic) or 3 (per-axis), "
                         f"got {model.sigma_axes}")
    beta = basis_ops.identity_beta(t, device=device)
    c = torch.rand((k, t), generator=generator).to(device)
    if positions is None:
        positions = 1.0 + torch.rand((k, 3), generator=generator) * torch.tensor(
            model.size, dtype=torch.float32)
    pos = torch.as_tensor(positions, dtype=torch.float32).to(device)
    sig_shape = (k,) if model.sigma_axes == 1 else (k, 3)
    sigma = torch.full(sig_shape, model.shape_std, dtype=torch.float32,
                       device=device)
    return DNMFState(beta=beta, c=c, pos=pos, sigma=sigma,
                     count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=torch.zeros_like(beta), nu=torch.zeros_like(beta))


def check_main_path(model: ModelConfig) -> None:
    """Raise for model options outside the ported slice."""
    if model.deformation.footprint_mode != "analytic":
        raise NotImplementedError(
            f"footprint_mode={model.deformation.footprint_mode!r} is not "
            "ported yet (ROADMAP Queue 1 item 11)")
    if not model.deformation.mask_out_of_bounds:
        raise NotImplementedError(
            "mask_out_of_bounds=False is not ported yet (ROADMAP Queue 1 "
            "item 11)")


def model_voxel_basis(model: ModelConfig, device="cpu") -> torch.Tensor:
    """``[P, 10]`` voxel basis in the model's beta coordinate space."""
    if model.deformation.basis_scaling == "normalized":
        return basis_ops.voxel_basis_normalized(model.size, device=device)
    return basis_ops.voxel_basis(model.size, device=device)


def frame_footprints(beta_t, pos, sigma, model: ModelConfig,
                     voxel_basis: torch.Tensor) -> torch.Tensor:
    """Warped footprints ``[P, K]`` of one frame (analytic mode)."""
    check_main_path(model)
    psi = basis_ops.warp_voxel_coords(voxel_basis, beta_t, model.size,
                                      model.deformation.basis_scaling)
    return fp_ops.evaluate_footprints(psi, pos, sigma, size=model.size)


def _blocks(t: int, frame_block: int):
    fb = max(1, min(frame_block, t))
    return [(s, min(s + fb, t)) for s in range(0, t, fb)]


def frame_grads_local(state: DNMFState, video: torch.Tensor,
                      model: ModelConfig, gamma: float, frame_block: int,
                      use_kernels: bool = False):
    """Per-frame ``(grads [T, 10, 3], mses [T], regs [T])`` of
    ``mse_t + gamma * reg_t``.

    The data term and its analytic gradient come from the motion pass,
    one frame block at a time (the last block is simply shorter: frames
    are independent, so nothing is padded); the corner regularizer and
    its gradient are computed for all frames at once.
    """
    check_main_path(model)
    scaling = model.deformation.basis_scaling
    motion = fused.motion_block if use_kernels else fused.motion_block_plain
    regs, dregs = jac_ops.corner_regularizer_and_grad(
        state.beta, model.size, model.deformation.detach_regularizer, scaling)
    mses, dbetas = [], []
    for s, e in _blocks(video.shape[0], frame_block):
        mse, db = motion(state.beta[s:e], state.pos, state.sigma,
                         state.c[:, s:e].T, video[s:e], model.size, scaling)
        mses.append(mse)
        dbetas.append(db)
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
                gram_mode: str = "exact", gram_window: Optional[int] = None):
    """Per-frame MU statistics ``(grams [T, K, K], c1 [T, K])``.

    ``gram_mode="exact"`` runs the Gram pass; ``"analytic"`` evaluates
    ``G`` in closed form (:mod:`dnmf_tpu_torch.ops.gram_analytic`) and
    runs only the c1 pass.  ``gram_window`` bounds the closed form's
    lattice window (default: sized for ``model.shape_std``).
    """
    check_main_path(model)
    if gram_mode not in ("exact", "analytic"):
        raise ValueError(f"unknown gram_mode: {gram_mode!r}")
    scaling = model.deformation.basis_scaling
    window = gram_window or ga.default_window(model.shape_std)
    grams, c1s = [], []
    for s, e in _blocks(video.shape[0], frame_block):
        betas = state.beta[s:e]
        if gram_mode == "analytic":
            c1_fn = fused.c1_block if use_kernels else fused.c1_block_plain
            grams.append(ga.analytic_grams(betas, state.pos, state.sigma,
                                           model.size, scaling=scaling,
                                           window=window))
            c1s.append(c1_fn(betas, state.pos, state.sigma, video[s:e],
                             model.size, scaling))
        else:
            gram_fn = (fused.gram_block if use_kernels
                       else fused.gram_block_plain)
            g, c1 = gram_fn(betas, state.pos, state.sigma, video[s:e],
                            model.size, scaling)
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
