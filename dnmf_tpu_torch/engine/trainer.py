"""User-facing driver: alternating deformation fits and trace updates.

Counterpart of ``dnmf_tpu/engine/trainer.py`` on the main path:
``DeformableNMF(model, optimizer, runtime, positions=..., device=...)
.fit(video)`` runs ``outer_rounds`` x (``motion_epochs`` parallel Adam
epochs on the warps, with ``fit_sigma`` a width fit on a frame
subsample, then Grams and ``mu_iters`` trace updates), with the
once-per-fit trust audit of the closed-form Grams; ``.refine(video)``
then fits per-frame neuron positions.  Options outside the ported slice
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig, OptimizerConfig, RuntimeConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.ops import gram_analytic as ga


@dataclasses.dataclass
class FitResult:
    state: model_lib.DNMFState
    metrics: List[dict]

    @property
    def traces(self) -> np.ndarray:
        return self.state.c.detach().cpu().numpy()

    @property
    def beta(self) -> np.ndarray:
        return self.state.beta.detach().cpu().numpy()


def audit_analytic_gram(state: model_lib.DNMFState, model: ModelConfig,
                        window=None, use_kernels: bool = False) -> dict:
    """One-frame exact-vs-closed-form Gram comparison (the trust gate).

    Takes the frame whose beta deviates most from the identity warp and
    returns ``{"frame", "rel_err"}`` with ``rel_err = max|G_an - G_exact|
    / max|G_exact|``.  The Gram does not depend on the video, so a zero
    frame feeds the exact pass.
    """
    ident = basis_ops.identity_beta(1, device=state.beta.device)[0]
    severity = torch.sum(torch.abs(state.beta - ident), dim=(1, 2))
    t_idx = int(torch.argmax(severity))
    beta1 = state.beta[t_idx:t_idx + 1]
    state1 = state.replace(beta=beta1, c=state.c[:, :1])
    zeros = torch.zeros((1, model.num_voxels), dtype=torch.float32,
                        device=state.beta.device)
    g_exact, _ = model_lib.compute_grams(state1, zeros, model, frame_block=1,
                                         use_kernels=use_kernels,
                                         gram_mode="exact")
    if window is None:
        window = ga.default_window(model.shape_std)
    g_an = ga.analytic_grams(beta1, state.pos, state.sigma, model.size,
                             scaling=model.deformation.basis_scaling,
                             window=window)
    rel = float(torch.max(torch.abs(g_an - g_exact))
                / torch.clamp_min(torch.max(torch.abs(g_exact)), 1e-30))
    return {"frame": t_idx, "rel_err": rel}


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class DeformableNMF:
    """Alternating optimizer over a device-resident video.

    Usage::

        dnmf = DeformableNMF(model_cfg, opt_cfg, positions=pos0,
                             device="cuda")
        result = dnmf.fit(video)   # video [T, M, N, Z] or [T, P]
    """

    def __init__(self, model: ModelConfig, optimizer: OptimizerConfig,
                 runtime: Optional[RuntimeConfig] = None, positions=None,
                 device="cpu"):
        self.model = model
        self.opt_config = optimizer
        self.runtime = runtime or RuntimeConfig()
        self.device = torch.device(device)
        self._check_slice()
        self.optimizer = model_lib.make_motion_optimizer(optimizer)
        self.state = model_lib.init_state(
            model, positions=positions,
            generator=torch.Generator().manual_seed(optimizer.seed),
            device=self.device)
        self.metrics: List[dict] = []
        self._base_sigma = self.state.sigma
        # Per-frame positions [T, K, 3] from refine(), None before it.
        self.pos_t: Optional[torch.Tensor] = None
        if self.runtime.use_kernels is None:
            self._use_kernels = self.device.type == "cuda"
        else:
            self._use_kernels = bool(self.runtime.use_kernels)
        mode = self.runtime.gram_mode
        if mode == "auto":
            # Footprints are analytic and there is no pixel mesh on the
            # ported path, so the closed form is always valid here.
            mode = "analytic"
        elif mode not in ("exact", "analytic"):
            raise ValueError(f"unknown gram_mode: {mode!r} "
                             "(expected 'auto', 'exact', or 'analytic')")
        self._gram_mode = mode
        self._gram_audited = False

    def _check_slice(self) -> None:
        model_lib.check_main_path(self.model)
        rt, opt = self.runtime, self.opt_config
        if opt.motion_mode == "parity":
            raise _not_ported("motion_mode='parity'", 11)
        if opt.motion_mode != "parallel":
            raise ValueError(f"unknown motion_mode: {opt.motion_mode!r}")
        if rt.mesh_time or rt.mesh_batch or rt.mesh_pixel:
            raise _not_ported("mesh_time/mesh_batch/mesh_pixel", 10)
        if rt.checkpoint_dir:
            raise _not_ported("checkpoint_dir (save/restore)", 11)
        if rt.profile_dir:
            raise _not_ported("profile_dir (per-round traces)", 11)

    # ------------------------------------------------------------------
    def _video_flat(self, video) -> torch.Tensor:
        if hasattr(video, "blocks") or hasattr(video, "frames_flat"):
            raise _not_ported("streamed and dataset video sources", 8)
        video = torch.as_tensor(video, dtype=torch.float32, device=self.device)
        if video.ndim == 4:
            video = video.reshape(video.shape[0], -1)
        # NMF non-negativity: clamp raw arrays as the dataset wrappers do.
        return torch.clamp_min(video, 0.0).contiguous()

    def _gram_window(self) -> Optional[int]:
        """Lattice window of the closed-form Grams, sized for the widest
        sigma the fit will see (``sigma_anneal`` scales it up; fitted
        widths may climb to the upper clip bound)."""
        if self._gram_mode != "analytic":
            return None
        factor = max((1.0,) + tuple(self.opt_config.sigma_anneal))
        if self.opt_config.fit_sigma:
            factor = max(factor, self.opt_config.sigma_bounds[1])
        return ga.default_window(factor * self.model.shape_std)

    def _maybe_audit_analytic(self) -> None:
        """Once per fit: compare one frame's exact Gram with the closed
        form and fall back to ``gram_mode="exact"`` past
        ``runtime.gram_trust_tol``."""
        if self._gram_mode != "analytic" or self._gram_audited:
            return
        self._gram_audited = True
        tol = self.runtime.gram_trust_tol
        if tol is None:
            return
        audit = audit_analytic_gram(self.state, self.model,
                                    window=self._gram_window(),
                                    use_kernels=self._use_kernels)
        self.metrics.append({"phase": "gram_audit", "tol": tol, **audit})
        if audit["rel_err"] > tol:
            warnings.warn(
                "analytic-Gram trust audit breached "
                f"(frame {audit['frame']}: rel err {audit['rel_err']:.2e}"
                f" > tol {tol:g}) — falling back to gram_mode='exact' "
                "for the rest of this engine's updates", RuntimeWarning)
            self._gram_mode = "exact"

    # ------------------------------------------------------------------
    def update_motion(self, video, epochs: Optional[int] = None) -> dict:
        """``epochs`` parallel Adam epochs on the warps."""
        return self._motion(self._video_flat(video), epochs)

    def _motion(self, video_flat: torch.Tensor, epochs=None) -> dict:
        epochs = epochs or self.opt_config.motion_epochs
        last = {}
        for _ in range(epochs):
            self.state, m = model_lib.motion_epoch_parallel(
                self.state, video_flat, self.model, self.optimizer,
                self.opt_config.gamma_motion,
                frame_block=self.runtime.frame_block,
                use_kernels=self._use_kernels)
            last = {k: float(v) for k, v in m.items()}
            self.metrics.append({"phase": "motion", **last})
        return last

    def update_footprints(self, video, iters: Optional[int] = None) -> dict:
        """Grams once, then ``iters`` trace updates."""
        return self._footprints(self._video_flat(video), iters)

    def _footprints(self, video_flat: torch.Tensor, iters=None) -> dict:
        iters = iters or self.opt_config.mu_iters
        self._maybe_audit_analytic()
        grams, c1 = model_lib.compute_grams(
            self.state, video_flat, self.model,
            frame_block=self.runtime.frame_block,
            use_kernels=self._use_kernels, gram_mode=self._gram_mode,
            gram_window=self._gram_window())
        self.state = model_lib.footprint_update(
            self.state, grams, c1, iters=iters,
            gamma=self.opt_config.gamma_traces,
            solver=self.opt_config.trace_solver)
        m = {"phase": "traces", "c_mean": float(torch.mean(self.state.c))}
        self.metrics.append(m)
        return m

    def update_sigma(self, video, steps: Optional[int] = None) -> dict:
        """Fit per-neuron footprint widths on ``sigma_frames`` frames spread
        over the recording (:func:`dnmf_tpu_torch.models.dnmf.sigma_fit`);
        updates both the live widths and the anneal base."""
        return self._sigma(self._video_flat(video), steps)

    def _sigma(self, video_flat: torch.Tensor, steps=None) -> dict:
        cfg = self.opt_config
        t = self.model.num_frames
        s = min(cfg.sigma_frames, t)
        idx = torch.as_tensor(np.linspace(0, t - 1, s).round().astype(int),
                              device=self.device)
        sigma, mses = model_lib.sigma_fit(
            self.state, video_flat[idx], self.state.beta[idx],
            self.state.c[:, idx].T, self.model,
            steps=steps or cfg.sigma_steps, lr=cfg.sigma_lr,
            lo=cfg.sigma_bounds[0] * self.model.shape_std,
            hi=cfg.sigma_bounds[1] * self.model.shape_std,
            frame_block=min(self.runtime.frame_block, s),
            use_kernels=self._use_kernels)
        self.state = self.state.replace(sigma=sigma)
        self._base_sigma = sigma
        m = {"phase": "sigma", "mse": float(mses[-1]),
             "sigma_mean": float(torch.mean(sigma)),
             "sigma_min": float(torch.min(sigma)),
             "sigma_max": float(torch.max(sigma))}
        self.metrics.append(m)
        return m

    def _check_finite(self, phase: str) -> None:
        if not self.runtime.check_finite:
            return
        for name, leaf in (("beta", self.state.beta), ("C", self.state.c)):
            if not bool(torch.all(torch.isfinite(leaf))):
                raise FloatingPointError(
                    f"non-finite {name} after {phase} — check learning "
                    "rate / regularizer weights")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, video, rounds: Optional[int] = None) -> FitResult:
        """Full alternation schedule; returns final state + metric log."""
        video_flat = self._video_flat(video)
        rounds = rounds or self.opt_config.outer_rounds
        self._gram_audited = False
        anneal = self.opt_config.sigma_anneal
        plain_rounds = 0  # rounds at the base widths (sigma_every cadence)
        for r in range(rounds):
            factor = anneal[r] if r < len(anneal) else 1.0
            self.state = self.state.replace(sigma=self._base_sigma * factor)
            t0 = time.perf_counter()
            motion_m = self._motion(video_flat)
            self._check_finite("motion")
            if self.opt_config.fit_sigma and factor == 1.0:
                # Width fitting waits out the annealed (deliberately
                # widened) rounds, then runs every sigma_every-th round.
                if plain_rounds % max(self.opt_config.sigma_every, 1) == 0:
                    self._sigma(video_flat)
                    self._check_finite("sigma")
                plain_rounds += 1
            traces_m = self._footprints(video_flat)
            self._check_finite("traces")
            self._sync()
            entry = {
                "phase": "round", "round": r,
                "seconds": time.perf_counter() - t0,
                **{f"motion_{k}": v for k, v in motion_m.items()},
                **{f"traces_{k}": v for k, v in traces_m.items()},
            }
            self._log(entry)
        # End on the base widths even when the anneal covers the last round.
        self.state = self.state.replace(sigma=self._base_sigma)
        return FitResult(state=self.state, metrics=self.metrics)

    def refine(self, video, rounds: int = 3, epochs: int = 40,
               mu_iters: int = 40, learning_rate: float = 0.08,
               prior: float = 3e-4) -> FitResult:
        """Per-frame per-neuron position refinement (final polish):
        ``rounds`` x (``epochs`` Adam steps on the positions, then the
        tracked Grams and ``mu_iters`` trace updates).  Stores the
        positions on ``self.pos_t`` (``[T, K, 3]``, model frame); a later
        call starts from them.  Device-resident video only."""
        video_flat = self._video_flat(video)
        self._maybe_audit_analytic()
        t0 = time.perf_counter()
        self.state, self.pos_t, m = refine_lib.refined_rounds(
            self.state, video_flat, self.model, rounds=rounds, epochs=epochs,
            mu_iters=mu_iters, learning_rate=learning_rate, prior=prior,
            frame_block=self.runtime.frame_block, pos_t=self.pos_t,
            use_kernels=self._use_kernels, gram_mode=self._gram_mode,
            gram_window=self._gram_window(),
            trace_solver=self.opt_config.trace_solver)
        self._check_finite("refine")
        self._sync()
        self._log({"phase": "refine", "rounds": rounds, "epochs": epochs,
                   "seconds": time.perf_counter() - t0,
                   "recon_mse": float(torch.mean(m["recon_mse"]))})
        return FitResult(state=self.state, metrics=self.metrics)

    def _log(self, entry: dict) -> None:
        self.metrics.append(entry)
        if self.runtime.metrics_path:
            with open(self.runtime.metrics_path, "a") as f:
                f.write(json.dumps(entry) + "\n")

    def save(self, path: str) -> None:
        raise _not_ported("DeformableNMF.save", 11)

    def restore(self, path: str) -> None:
        raise _not_ported("DeformableNMF.restore", 11)

    @property
    def traces(self) -> np.ndarray:
        return self.state.c.detach().cpu().numpy()

    def positions_all(self, iters: int = 3) -> np.ndarray:
        """Apparent positions ``warp_t^{-1}(p_k)`` of every neuron in
        every frame: ``[T, K, 3]``."""
        beta = self.state.beta
        pts = self.state.pos.expand((beta.shape[0],) + self.state.pos.shape)
        if self.model.deformation.basis_scaling == "normalized":
            p = basis_ops.normalize_points(pts, self.model.size)
            inv = basis_ops.invert_warp_points(p, beta, iters=iters)
            out = basis_ops.denormalize_points(inv, self.model.size)
        else:
            out = basis_ops.invert_warp_points(pts, beta, iters=iters)
        return out.detach().cpu().numpy()
