"""User-facing driver: alternating deformation fits and trace updates.

Counterpart of ``dnmf_tpu/engine/trainer.py``:
``DeformableNMF(model, optimizer, runtime, positions=..., device=...)
.fit(video)`` runs ``outer_rounds`` x (``motion_epochs`` Adam epochs on
the warps, per-frame parallel or the reference's serial mini-batches
(``motion_mode="parity"``), with ``fit_sigma`` a width fit on a frame
subsample, then Grams and ``mu_iters`` trace updates), with the
once-per-fit trust audit of the closed-form Grams; ``.fit_fused(video)``
runs the same schedule as one call per anneal segment;
``.refine(video)`` then fits per-frame neuron positions.  ``video`` is
an array or tensor held on the engine's device, a dataset
(:mod:`dnmf_tpu_torch.data.datasets`; its ``frames_flat()`` goes to that
device as it is, not clamped again), or a host-streamed source
(:mod:`dnmf_tpu_torch.data.streaming`) whose frame blocks go to that
device.  ``runtime.checkpoint_dir`` saves every round
(:meth:`DeformableNMF.save` / :meth:`~DeformableNMF.restore`),
``runtime.profile_dir`` traces the last round with ``torch.profiler``.
:class:`StaticFootprintNMF` is the static-footprint MU mode.

``fit``'s steps (the motion epoch or, in parity mode, one serial Adam
step per batch, the width fit, the Grams, the trace update), each round
of ``fit_fused`` and ``refine``'s (the positions, the tracked Grams, the
trace update) go through :mod:`dnmf_tpu_torch.models.graphs` (the JAX
package's ``jit``): with the kernels on the card each is a captured CUDA
graph; the Gram audit, the finiteness checks and the metric reads run
eagerly between them.  While a ``torch.profiler`` records, each of these
carries a span (:mod:`dnmf_tpu_torch.utils.trace`): ``engine.fit``,
``engine.init``, ``engine.round``, ``engine.prepare``, ``engine.motion``,
``engine.sigma``, ``engine.grams``, ``engine.traces``, ``engine.audit``
and ``engine.read`` (one per read of device values:
an epoch's metrics, the mean trace, a finiteness check's leaf, the width
fit's and ``refine``'s metrics).  Models that the kernels do not compute
(``reference_demo_model(parity=True)``'s resampled footprints) run every
step eagerly.  A streamed source goes through it too: its motion epoch
and Grams replay one captured block step per frame block, its refinement
one captured alternation per block, and its width fit's subsample is on
the card.  On a mesh each rank replays the same steps on its shard
between the collectives (``graphs.mesh_steps``: the sharded epoch, Grams
and trace update of :mod:`dnmf_tpu_torch.parallel`, a smoothed update
one replay per iteration with the halo's exchange between; refinement
and the width fit as on one device), which run eagerly.
``StaticFootprintNMF.fit``'s alternation is captured on the card.
``models.graphs.clear()`` drops the graphs, ``models.graphs.disabled()``
runs every step eagerly.

``runtime.mesh_time`` / ``mesh_pixel`` (and ``mesh_batch`` beside
``mesh_time``) shard the fit over the ranks of a process group
(:mod:`dnmf_tpu_torch.parallel`; start it with
:func:`~dnmf_tpu_torch.parallel.initialize_distributed` or ``torchrun``):
every rank builds the same engine, passes the same (whole) video and runs
the same calls; the engine keeps its rank's shard of the state
(``engine.state``) and reads its own frames and voxels, and :meth:`fit`
and :meth:`refine` return the whole state on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from dnmf_tpu_torch import parallel
from dnmf_tpu_torch.config import ModelConfig, OptimizerConfig, RuntimeConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.ops import footprints as fp_ops
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import gram_analytic as ga
from dnmf_tpu_torch.ops import mu as mu_ops
from dnmf_tpu_torch.parallel import mesh as mesh_lib
from dnmf_tpu_torch.utils import checkpoint
from dnmf_tpu_torch.utils.trace import span


def _job(method):
    """``method`` (a whole job: ``fit``, ``fit_fused``, ``refine``) under
    the span ``engine.fit``."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with span("engine.fit"):
            return method(self, *args, **kwargs)

    return call


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


def _strongest_frame(severity: torch.Tensor, mesh) -> Tuple[int, int]:
    """``(frame, local index or -1)``: the first frame of the largest
    severity over the recording (``severity``: this rank's frames), and
    its index in this rank's frames where the rank owns it."""
    loc = int(torch.argmax(severity))
    if mesh is None:
        return loc, loc
    t0 = mesh_lib.axis_index(mesh, mesh_lib.TIME_AXIS) * severity.shape[0]
    best = torch.stack([severity[loc].double(),
                        torch.tensor(float(t0 + loc), dtype=torch.float64,
                                     device=severity.device)])
    cands = [(float(c[0]), -int(c[1])) for c in mesh_lib.all_gather(
        best, mesh, mesh_lib.TIME_AXIS)]
    frame = -max(cands)[1]  # ties: the first frame, as argmax takes it
    own = t0 <= frame < t0 + severity.shape[0]
    return frame, frame - t0 if own else -1


def audit_analytic_gram(state: model_lib.DNMFState, model: ModelConfig,
                        window=None, use_kernels: bool = False,
                        mesh=None) -> dict:
    """One-frame exact-vs-closed-form Gram comparison (the trust gate).

    Takes the frame whose beta deviates most from the identity warp and
    returns ``{"frame", "rel_err"}`` with ``rel_err = max|G_an - G_exact|
    / max|G_exact|``.  The Gram does not depend on the video, so a zero
    frame feeds the exact pass.  On a mesh ``state`` is the rank's shard:
    the frame is the recording's strongest, its owner on each time line
    computes the comparison and a sum over the time axis hands it to the
    others, so every rank takes the same decision.
    """
    ident = basis_ops.identity_beta(1, device=state.beta.device)[0]
    severity = torch.sum(torch.abs(state.beta - ident), dim=(1, 2))
    t_idx, local = _strongest_frame(severity, mesh)
    rel = 0.0
    if local >= 0:
        rel = _audit_frame(state, model, local, window, use_kernels)
    if mesh is not None:
        rel = float(mesh_lib.all_reduce(
            torch.tensor([rel], dtype=torch.float64, device=state.beta.device),
            mesh, mesh_lib.TIME_AXIS)[0])
    return {"frame": t_idx, "rel_err": rel}


def _audit_frame(state: model_lib.DNMFState, model: ModelConfig, t_idx: int,
                 window, use_kernels: bool) -> float:
    """The audit's relative error at frame ``t_idx`` of ``state``."""
    beta1 = state.beta[t_idx:t_idx + 1]
    state1 = state.replace(beta=beta1, c=state.c[:, :1])
    zeros = torch.zeros((1, model.num_voxels), dtype=torch.float32,
                        device=state.beta.device)
    g_exact, _ = model_lib.compute_grams(state1, zeros, model, frame_block=1,
                                         use_kernels=use_kernels,
                                         gram_mode="exact")
    if window is None:
        window = ga.default_window(model.shape_std)
    closed = fused.analytic_grams if use_kernels else ga.analytic_grams
    g_an = closed(beta1, state.pos, state.sigma, model.size,
                  scaling=model.deformation.basis_scaling, window=window)
    return float(torch.max(torch.abs(g_an - g_exact))
                 / torch.clamp_min(torch.max(torch.abs(g_exact)), 1e-30))


class DeformableNMF:
    """Alternating optimizer over a device-resident or streamed video.

    Usage::
        dnmf = DeformableNMF(model_cfg, opt_cfg, positions=pos0)
        result = dnmf.fit(video)   # [T, M, N, Z], [T, P], a dataset or
                                   # a streamed source

    The engine runs on the CUDA device unless ``device`` says otherwise
    (``device="cpu"`` runs the plain versions on the CPU).  ``beta0 [T,
    10, 3]`` seeds the warps, e.g. from registration.

    ``runtime.use_kernels`` is resolved here, once, as the JAX package
    resolves ``use_pallas``: None takes the CUDA kernels on the card for
    the configurations whose function they compute (analytic footprints
    with the border fade) and the plain versions otherwise, so
    ``footprint_mode="resample"`` and ``mask_out_of_bounds=False`` run
    plain; ``True`` with either of those raises ``ValueError``.  Parity
    mode draws each epoch's batch order from a ``torch.Generator``
    seeded with ``optimizer.seed``.

    With ``runtime.mesh_time`` or ``mesh_pixel`` the engine is one rank of
    a sharded fit (module docstring); ``gram_mode="auto"`` then takes the
    closed form only without a pixel axis (its Gram is the whole
    volume's, and the pixel shards' sum would count it once per shard).
    """

    def __init__(self, model: ModelConfig, optimizer: OptimizerConfig,
                 runtime: Optional[RuntimeConfig] = None, positions=None,
                 device="cuda", beta0=None):
        with span("engine.init"):
            self.model = model
            self.opt_config = optimizer
            self.runtime = runtime or RuntimeConfig()
            self.device = torch.device(device)
            self._check_options()
            self.optimizer = model_lib.make_motion_optimizer(optimizer)
            self.state = model_lib.init_state(
                model, positions=positions,
                generator=torch.Generator().manual_seed(optimizer.seed),
                device=self.device, beta0=beta0)
            self._mesh = None
            rt = self.runtime
            if rt.mesh_time or rt.mesh_pixel:
                self._mesh = parallel.make_mesh(
                    num_time=rt.mesh_time or 1, num_batch=rt.mesh_batch or 1,
                    num_pixel=rt.mesh_pixel or 1)
                if model.num_frames % (rt.mesh_time or 1):
                    raise ValueError(
                        "num_frames must divide evenly over mesh_time")
                self.state = parallel.shard_state(self.state, self._mesh)
            self._batch_gen = torch.Generator().manual_seed(optimizer.seed)
            self.metrics: List[dict] = []
            self._base_sigma = self.state.sigma
            # Per-frame positions [T, K, 3] from refine(), None before it.
            self.pos_t: Optional[torch.Tensor] = None
            # positions_all's (beta, pos, iters, out)
            self._positions_cache = None
            if self.runtime.use_kernels is None:
                self._use_kernels = (self.device.type == "cuda"
                                     and model_lib.kernels_apply(model))
            else:
                self._use_kernels = bool(self.runtime.use_kernels)
                model_lib.check_kernels(model, self._use_kernels)
            mode = self.runtime.gram_mode
            if mode == "auto":
                # The closed form wherever valid: analytic footprints, no
                # pixel axis.
                analytic = (model.deformation.footprint_mode == "analytic"
                            and (rt.mesh_pixel or 1) <= 1)
                mode = "analytic" if analytic else "exact"
            elif mode not in ("exact", "analytic"):
                raise ValueError(f"unknown gram_mode: {mode!r} "
                                 "(expected 'auto', 'exact', or 'analytic')")
            self._gram_mode = mode
            self._gram_audited = False

    def _check_options(self) -> None:
        rt, opt, model = self.runtime, self.opt_config, self.model
        if opt.motion_mode not in ("parallel", "parity"):
            raise ValueError(f"unknown motion_mode: {opt.motion_mode!r}")
        if rt.mesh_batch and not rt.mesh_time:
            raise ValueError(
                "mesh_batch partitions recordings, which a single "
                "DeformableNMF does not have: use "
                "dnmf_tpu_torch.parallel.batched for multi-recording runs "
                "(set mesh_time for frame sharding)")
        if (rt.mesh_time or rt.mesh_pixel) and opt.motion_mode == "parity":
            raise ValueError(
                "parity motion mode is batch-serial and bypasses the mesh; "
                "use motion_mode='parallel' with mesh axes")
        if rt.mesh_pixel and rt.mesh_pixel > 1:
            if model.deformation.footprint_mode != "analytic":
                raise ValueError("mesh_pixel (Gram tensor parallelism) "
                                 "requires analytic footprints")
            if model.num_voxels % rt.mesh_pixel:
                raise ValueError(
                    "voxel count must divide evenly over mesh_pixel")

    # ------------------------------------------------------------------
    def _rank0(self) -> bool:
        """Whether this process writes the files of a fit (every
        process without a mesh, global rank 0 on one)."""
        return self._mesh is None or torch.distributed.get_rank() == 0

    def _whole(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A time-sharded tensor of this engine whole (as it is without a
        mesh)."""
        if self._mesh is None:
            return x
        return parallel.gather_time(x, self._mesh, dim)

    def full_state(self) -> model_lib.DNMFState:
        """The whole state: ``state`` itself, or on a mesh the ranks'
        shards gathered (a collective: every rank calls it)."""
        if self._mesh is None:
            return self.state
        return parallel.gather_state(self.state, self._mesh)

    # ------------------------------------------------------------------
    @staticmethod
    def _is_streaming(video) -> bool:
        return hasattr(video, "blocks") and not hasattr(video, "frames_flat")

    def _prepare(self, video):
        """A streamed source as it is (on the engine's device), anything
        else as the flat tensor on the device (:meth:`_video_flat`)."""
        with span("engine.prepare"):
            if not self._is_streaming(video):
                return self._video_flat(video)
        dev = torch.device(video.device)
        if dev.type != self.device.type or (
                (dev.index or 0) != (self.device.index or 0)):
            raise ValueError(f"the source streams to {dev}, the engine runs "
                             f"on {self.device}: open it with "
                             f"device={str(self.device)!r}")
        return video

    def _video_flat(self, video) -> torch.Tensor:
        """A dataset's ``frames_flat()`` as it is (the simulated and
        NeuroPAL datasets clamp when they are built); a raw array or
        tensor flattened and clamped (NMF non-negativity), as the JAX
        package does.  On a mesh, this rank's frames and voxels only
        (sliced before they go to the device)."""
        raw = not hasattr(video, "frames_flat")
        video = torch.as_tensor(video if raw else video.frames_flat())
        if video.ndim == 4:
            video = video.reshape(video.shape[0], -1)
        if self._mesh is not None:
            video = parallel.shard_video(video, self._mesh)
        video = video.to(self.device, torch.float32)
        return (torch.clamp_min(video, 0.0) if raw else video).contiguous()

    def _epoch_batches(self):
        """One parity epoch's ``(times, weights)``, ``[num_batches, B]``
        host tensors: the frames in shuffled (or natural) order, the last
        batch padded with frame 0 at weight 0.  The epoch copies them into
        its entry's buffers (:func:`~dnmf_tpu_torch.models.graphs.
        motion_epoch_parity`)."""
        t, b = self.model.num_frames, self.opt_config.batch_size
        order = (torch.randperm(t, generator=self._batch_gen)
                 if self.opt_config.shuffle else torch.arange(t))
        pad = (-t) % b
        times = torch.cat([order, torch.zeros(pad, dtype=order.dtype)])
        weights = torch.cat([torch.ones(t), torch.zeros(pad)])
        nb = (t + pad) // b
        return times.reshape(nb, b), weights.reshape(nb, b)

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
        with span("engine.audit"):
            audit = audit_analytic_gram(self.state, self.model,
                                        window=self._gram_window(),
                                        use_kernels=self._use_kernels,
                                        mesh=self._mesh)
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
        """``epochs`` Adam epochs on the warps: per-frame parallel, or in
        parity mode serial mini-batches.  A streamed source runs the
        streamed parallel epoch in either mode, as the JAX package does
        (ROADMAP Queue 3)."""
        return self._motion(self._prepare(video), epochs)

    def _motion(self, video, epochs=None) -> dict:
        epochs = epochs or self.opt_config.motion_epochs
        gamma = self.opt_config.gamma_motion
        last = {}
        mesh = self._mesh
        for _ in range(epochs):
            with span("engine.motion"):
                if self._is_streaming(video) and mesh is None:
                    # one device: the captured block step
                    self.state, m = graphs.motion_epoch_streaming(
                        self.state, video, self.model, self.optimizer, gamma,
                        self._use_kernels)
                elif self._is_streaming(video):
                    self.state, m = parallel.sharded_motion_epoch_streaming(
                        self.state, video, self.model, self.optimizer, gamma,
                        mesh, use_kernels=self._use_kernels)
                elif self.opt_config.motion_mode == "parity":
                    times, weights = self._epoch_batches()
                    self.state, m = graphs.motion_epoch_parity(
                        self.state, video, times, weights, self.model,
                        self.optimizer, gamma, self._use_kernels)
                elif mesh is None:  # one device: the captured step
                    self.state, m = graphs.motion_epoch(
                        self.state, video, self.model, self.optimizer, gamma,
                        self.runtime.frame_block, self._use_kernels)
                else:
                    self.state, m = parallel.sharded_motion_epoch(
                        self.state, video, self.model, self.optimizer, gamma,
                        mesh, frame_block=self.runtime.frame_block,
                        use_kernels=self._use_kernels)
            with span("engine.read"):
                last = {k: float(v) for k, v in m.items()}
            self.metrics.append({"phase": "motion", **last})
        return last

    def update_footprints(self, video, iters: Optional[int] = None) -> dict:
        """Grams once, then ``iters`` trace updates."""
        return self._footprints(self._prepare(video), iters)

    def _footprints(self, video, iters=None) -> dict:
        iters = iters or self.opt_config.mu_iters
        self._maybe_audit_analytic()
        kw = dict(use_kernels=self._use_kernels, gram_mode=self._gram_mode,
                  gram_window=self._gram_window())
        mesh = self._mesh  # None: the steps on one device
        with span("engine.grams"):
            if self._is_streaming(video) and mesh is None:
                # one device: the captured block step
                grams, c1 = graphs.compute_grams_streaming(
                    self.state, video, self.model, **kw)
            elif self._is_streaming(video):
                grams, c1 = parallel.sharded_compute_grams_streaming(
                    self.state, video, self.model, mesh, **kw)
            elif mesh is None:  # one device: the captured step
                grams, c1 = graphs.compute_grams(
                    self.state, video, self.model, self.runtime.frame_block,
                    **kw)
            else:
                grams, c1 = parallel.sharded_compute_grams(
                    self.state, video, self.model, mesh,
                    frame_block=self.runtime.frame_block, **kw)
        update = dict(iters=iters, gamma=self.opt_config.gamma_traces,
                      solver=self.opt_config.trace_solver)
        with span("engine.traces"):
            if mesh is None:
                self.state = graphs.footprint_update(
                    self.state, grams, c1, use_kernels=self._use_kernels,
                    **update)
            else:
                self.state = parallel.sharded_footprint_update(
                    self.state, grams, c1, mesh,
                    use_kernels=self._use_kernels, **update)
        m = {"phase": "traces", "c_mean": self._c_mean()}
        self.metrics.append(m)
        return m

    def _c_mean(self) -> float:
        """The mean trace value over the recording."""
        with span("engine.read"):
            if self._mesh is None:
                return float(torch.mean(self.state.c))
            total = mesh_lib.all_reduce(torch.sum(self.state.c).double(),
                                        self._mesh, mesh_lib.TIME_AXIS)
            return float(total) / (self.state.c.shape[0]
                                   * self.model.num_frames)

    def update_sigma(self, video, steps: Optional[int] = None) -> dict:
        """Fit per-neuron footprint widths on ``sigma_frames`` frames spread
        over the recording (:func:`dnmf_tpu_torch.models.dnmf.sigma_fit`);
        updates both the live widths and the anneal base.  A streamed
        source gives those frames by a fixed-size host gather
        (``read``), whatever the recording's length."""
        return self._sigma(self._prepare(video), steps)

    def _sigma(self, video, steps=None) -> dict:
        cfg = self.opt_config
        t = self.model.num_frames
        s = min(cfg.sigma_frames, t)
        idx_np = np.linspace(0, t - 1, s).round().astype(int)
        with span("engine.sigma"):
            idx = torch.as_tensor(idx_np, device=self.device)
            if self._is_streaming(video):
                video_sub = torch.from_numpy(np.concatenate(
                    [video.read(int(i), int(i) + 1) for i in idx_np])).to(
                    self.device)
            elif self._mesh is not None:
                video_sub = self._gather_frames(video, idx_np)
            else:
                video_sub = video[idx]
            # On a mesh every rank fits the widths on the same whole
            # frames: no collective inside, so the same captured fit.
            beta = self._whole(self.state.beta)
            c = self._whole(self.state.c, 1)
            sigma, mses = graphs.sigma_fit(
                self.state, video_sub, beta[idx], c[:, idx].T, self.model,
                steps=steps or cfg.sigma_steps, lr=cfg.sigma_lr,
                lo=cfg.sigma_bounds[0] * self.model.shape_std,
                hi=cfg.sigma_bounds[1] * self.model.shape_std,
                frame_block=min(self.runtime.frame_block, s),
                use_kernels=self._use_kernels)
            self.state = self.state.replace(sigma=sigma)
            self._base_sigma = sigma
        with span("engine.read"):
            m = {"phase": "sigma", "mse": float(mses[-1]),
                 "sigma_mean": float(torch.mean(sigma)),
                 "sigma_min": float(torch.min(sigma)),
                 "sigma_max": float(torch.max(sigma))}
        self.metrics.append(m)
        return m

    def _gather_frames(self, video: torch.Tensor,
                       idx: np.ndarray) -> torch.Tensor:
        """Whole frames ``idx`` of a sharded video (``video``: this
        rank's block): each owner's rows summed over the time axis, the
        pixel shards' runs joined."""
        sh = mesh_lib.video_sharding(self._mesh)
        frames = sh.frames(self.model.num_frames)
        rows = torch.zeros((len(idx), video.shape[1]), dtype=video.dtype,
                           device=video.device)
        for j, i in enumerate(idx):
            if frames.start <= i < frames.stop:
                rows[j] = video[i - frames.start]
        rows = mesh_lib.all_reduce(rows, self._mesh, mesh_lib.TIME_AXIS)
        return torch.cat(mesh_lib.all_gather(rows, self._mesh,
                                             mesh_lib.PIXEL_AXIS), dim=1)

    def _check_finite(self, phase: str) -> None:
        if not self.runtime.check_finite:
            return
        for name, leaf in (("beta", self.state.beta), ("C", self.state.c)):
            bad = torch.logical_not(torch.all(torch.isfinite(leaf)))
            if self._mesh is not None:  # every rank raises, or none does
                bad = mesh_lib.all_reduce(
                    bad.to(torch.float32).reshape(1), self._mesh,
                    mesh_lib.TIME_AXIS, op=torch.distributed.ReduceOp.MAX)
            with span("engine.read"):
                bad = bool(bad.any())
            if bad:
                raise FloatingPointError(
                    f"non-finite {name} after {phase} — check learning "
                    "rate / regularizer weights")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    @_job
    def fit(self, video, rounds: Optional[int] = None) -> FitResult:
        """Full alternation schedule; returns final state + metric log.

        With ``runtime.profile_dir`` the last round runs under
        ``torch.profiler`` and its trace is written to
        ``{profile_dir}/round_{r}.trace.json`` (Chrome trace format), the
        round's steps, reads and graph replays named in it by their spans
        (``span.engine.round``, ``span.engine.motion``,
        ``span.graphs.replay``, ...: :mod:`dnmf_tpu_torch.utils.trace`);
        with ``runtime.checkpoint_dir`` every round is saved to
        ``{checkpoint_dir}/round_{r}.pt`` (:meth:`save`).
        """
        video = self._prepare(video)
        rounds = rounds or self.opt_config.outer_rounds
        self._gram_audited = False
        anneal = self.opt_config.sigma_anneal
        plain_rounds = 0  # rounds at the base widths (sigma_every cadence)
        for r in range(rounds):
            factor = anneal[r] if r < len(anneal) else 1.0
            t0 = time.perf_counter()
            prof = (self._profiler()
                    if self.runtime.profile_dir and r == rounds - 1 else None)
            with prof or contextlib.nullcontext(), span("engine.round"):
                self.state = self.state.replace(
                    sigma=self._base_sigma * factor)
                motion_m = self._motion(video)
                self._check_finite("motion")
                if self.opt_config.fit_sigma and factor == 1.0:
                    # Width fitting waits out the annealed (deliberately
                    # widened) rounds, then runs every sigma_every-th round.
                    if plain_rounds % max(self.opt_config.sigma_every,
                                          1) == 0:
                        self._sigma(video)
                        self._check_finite("sigma")
                    plain_rounds += 1
                traces_m = self._footprints(video)
                self._check_finite("traces")
                self._sync()
            if prof is not None:
                os.makedirs(self.runtime.profile_dir, exist_ok=True)
                rank = ("" if self._mesh is None else
                        f".rank{torch.distributed.get_rank()}")
                prof.export_chrome_trace(os.path.join(
                    self.runtime.profile_dir, f"round_{r}{rank}.trace.json"))
            entry = {
                "phase": "round", "round": r,
                "seconds": time.perf_counter() - t0,
                **{f"motion_{k}": v for k, v in motion_m.items()},
                **{f"traces_{k}": v for k, v in traces_m.items()},
            }
            self._log(entry)
            if self.runtime.checkpoint_dir:
                self.save(os.path.join(self.runtime.checkpoint_dir,
                                       f"round_{r}.pt"))
        # End on the base widths even when the anneal covers the last round.
        self.state = self.state.replace(sigma=self._base_sigma)
        return FitResult(state=self.full_state(), metrics=self.metrics)

    @_job
    def fit_fused(self, video, rounds: Optional[int] = None) -> FitResult:
        """The alternation as one call of
        :func:`~dnmf_tpu_torch.models.graphs.fused_rounds` per run of equal
        ``sigma_anneal`` factors (one call without an anneal); the same
        factors as :meth:`fit` in parallel mode, with per-round metrics.
        The closed-form Grams are audited before (deciding the mode for
        the whole call) and again after (a witness in the metrics).
        Parity mode, ``fit_sigma`` (its host-side cadence) and streamed
        sources raise ``ValueError``: use :meth:`fit`."""
        if self._mesh is not None or self._is_streaming(video):
            raise ValueError(
                "fit_fused supports the single-device, device-resident "
                "path; use fit() for meshes and streamed videos")
        if self.opt_config.motion_mode == "parity":
            raise ValueError("fit_fused requires motion_mode='parallel'")
        if self.opt_config.fit_sigma:
            raise ValueError(
                "fit_fused runs the whole schedule in one call and cannot "
                "interleave the sigma-fitting cadence; use fit() with "
                "fit_sigma=True")
        video = self._prepare(video)
        rounds = rounds or self.opt_config.outer_rounds
        self._gram_audited = False
        self._maybe_audit_analytic()
        anneal = self.opt_config.sigma_anneal
        segments = []  # [factor, rounds] runs of equal anneal factors
        for r in range(rounds):
            factor = anneal[r] if r < len(anneal) else 1.0
            if segments and segments[-1][0] == factor:
                segments[-1][1] += 1
            else:
                segments.append([factor, 1])
        cfg = self.opt_config
        recon, reg = [], []
        for factor, seg_rounds in segments:
            self.state = self.state.replace(sigma=self._base_sigma * factor)
            self.state, m = graphs.fused_rounds(
                self.state, video, self.model, self.optimizer,
                rounds=seg_rounds, epochs=cfg.motion_epochs,
                mu_iters=cfg.mu_iters, gamma=cfg.gamma_motion,
                mu_gamma=cfg.gamma_traces,
                frame_block=self.runtime.frame_block,
                use_kernels=self._use_kernels, gram_mode=self._gram_mode,
                gram_window=self._gram_window(),
                trace_solver=cfg.trace_solver)
            with span("engine.read"):
                recon.extend(float(v) for v in m["recon_mse"])
                reg.extend(float(v) for v in m["reg"])
        self.state = self.state.replace(sigma=self._base_sigma)
        for r in range(rounds):
            self.metrics.append({"phase": "round", "round": r,
                                 "motion_recon_mse": recon[r],
                                 "motion_reg": reg[r]})
        self._gram_audited = False
        self._maybe_audit_analytic()
        self._check_finite("fused fit")
        return FitResult(state=self.state, metrics=self.metrics)

    @_job
    def refine(self, video, rounds: int = 3, epochs: int = 40,
               mu_iters: int = 40, learning_rate: float = 0.08,
               prior: float = 3e-4) -> FitResult:
        """Per-frame per-neuron position refinement (final polish):
        ``rounds`` x (``epochs`` Adam steps on the positions, then the
        tracked Grams and ``mu_iters`` trace updates).  Stores the
        positions on ``self.pos_t`` (``[T, K, 3]``, model frame); a later
        call starts from them.  A streamed source runs the alternation
        block by block in one pass over the recording
        (:func:`dnmf_tpu_torch.models.refine.refined_rounds_streaming`,
        each block's alternation one captured graph:
        ``graphs.refined_rounds_streaming``).
        On a time mesh each rank refines its own frames through the same
        captured programs (:func:`~dnmf_tpu_torch.parallel.
        sharded_refined_rounds`; ``pos_t`` holds the rank's ``[T_loc, K,
        3]``); pixel meshes and
        streamed sources on a mesh raise ``NotImplementedError``, as in
        the JAX package."""
        if self._mesh is not None and (self.runtime.mesh_pixel or 1) > 1:
            raise NotImplementedError(
                "position refinement reduces over whole frames: "
                "unsupported on a pixel-sharded mesh (use mesh_time)")
        if self._mesh is not None and self._is_streaming(video):
            raise NotImplementedError(
                "streamed refinement is single-device (per-frame "
                "independent: shard the recording across engines instead)")
        video = self._prepare(video)
        self._maybe_audit_analytic()
        t0 = time.perf_counter()
        kw = dict(rounds=rounds, epochs=epochs, mu_iters=mu_iters,
                  learning_rate=learning_rate, prior=prior, pos_t=self.pos_t,
                  use_kernels=self._use_kernels, gram_mode=self._gram_mode,
                  gram_window=self._gram_window(),
                  trace_solver=self.opt_config.trace_solver)
        if self._is_streaming(video):  # one device: captured per block
            self.state, self.pos_t, m = graphs.refined_rounds_streaming(
                self.state, video, self.model, **kw)
        elif self._mesh is None:  # one device: the captured programs
            self.state, self.pos_t, m = graphs.refined_rounds(
                self.state, video, self.model,
                frame_block=self.runtime.frame_block, **kw)
        else:
            self.state, self.pos_t, m = parallel.sharded_refined_rounds(
                self.state, video, self.model, self._mesh,
                frame_block=self.runtime.frame_block, **kw)
        self._check_finite("refine")
        self._sync()
        recon = torch.atleast_1d(m["recon_mse"])
        if self._mesh is not None:
            recon = self._whole(recon)
        with span("engine.read"):
            recon = float(torch.mean(recon))
        self._log({"phase": "refine", "rounds": rounds, "epochs": epochs,
                   "seconds": time.perf_counter() - t0, "recon_mse": recon})
        return FitResult(state=self.full_state(), metrics=self.metrics)

    def _log(self, entry: dict) -> None:
        self.metrics.append(entry)
        if self.runtime.metrics_path and self._rank0():
            with open(self.runtime.metrics_path, "a") as f:
                f.write(json.dumps(entry) + "\n")

    def save(self, path: str) -> None:
        """Checkpoint the state (factors and Adam moments), the anneal's
        base widths, the parity batch generator and, once :meth:`refine`
        has run, its positions ``pos_t``
        (:mod:`dnmf_tpu_torch.utils.checkpoint`).  A fresh engine that restores it and fits the
        remaining rounds gives the unbroken run's factors, bit for bit;
        its ``fit`` counts the anneal schedule and the width-fitting
        cadence from its own first round.  On a mesh (a collective: every
        rank calls it) rank 0 writes the whole state, and every rank
        returns once the file is there."""
        extra = {"base_sigma": self._base_sigma,
                 "batch_rng": self._batch_gen.get_state()}
        if self.pos_t is not None:
            extra["pos_t"] = self._whole(self.pos_t)
        state = self.full_state()
        if self._rank0():
            checkpoint.save_state(path, state, **extra)
        if self._mesh is not None:
            torch.distributed.barrier()

    def restore(self, path: str) -> None:
        """Load a checkpoint of :meth:`save` onto the engine's device (on
        a mesh, this rank's shard of it).  A checkpoint without refined
        positions clears ``pos_t``: positions refined before the restore
        belong to the replaced factors."""
        self.state, extra = checkpoint.load_state(path, self.device)
        self.pos_t = extra.get("pos_t")
        if self._mesh is not None:
            self.state = parallel.shard_state(self.state, self._mesh)
            if self.pos_t is not None:
                self.pos_t = self.pos_t[mesh_lib.video_sharding(
                    self._mesh).frames(self.model.num_frames)].clone()
        self._base_sigma = extra.get("base_sigma", self.state.sigma)
        if "batch_rng" in extra:
            self._batch_gen.set_state(extra["batch_rng"].cpu())

    @property
    def traces(self) -> np.ndarray:
        """``C [K, T]`` of the whole recording (on a mesh a collective)."""
        return self._whole(self.state.c, 1).detach().cpu().numpy()

    def positions_at(self, frame: int, iters: int = 3) -> np.ndarray:
        """Apparent positions ``warp_t^{-1}(p_k)`` ``[K, 3]`` at one
        frame (:meth:`positions_all`)."""
        return self.positions_all(iters=iters)[frame]

    def positions_all(self, iters: int = 3) -> np.ndarray:
        """Apparent positions ``warp_t^{-1}(p_k)`` of every neuron in
        every frame: ``[T, K, 3]``, by fixed-point iteration.  After
        :meth:`refine`, the refined per-frame positions ``pos_t`` take the
        anchors' place.  The host result is cached on the identity of
        ``state.beta``, of the positions (``pos_t`` or ``state.pos``; on a
        mesh the rank's own tensors) and on ``iters``, as the JAX
        package caches it, so a loop of :meth:`positions_at` solves once;
        a hit returns the same read-only array."""
        local_pos = self.pos_t if self.pos_t is not None else self.state.pos
        cache = self._positions_cache
        if (cache is not None and cache[0] is self.state.beta
                and cache[1] is local_pos and cache[2] == iters):
            return cache[3]
        beta = self._whole(self.state.beta)
        pts = (self._whole(self.pos_t) if self.pos_t is not None else
               self.state.pos.expand((beta.shape[0],) + self.state.pos.shape))
        if self.model.deformation.basis_scaling == "normalized":
            p = basis_ops.normalize_points(pts, self.model.size)
            inv = basis_ops.invert_warp_points(p, beta, iters=iters)
            out = basis_ops.denormalize_points(inv, self.model.size)
        else:
            out = basis_ops.invert_warp_points(pts, beta, iters=iters)
        out = out.detach().cpu().numpy()
        # Frozen: a caller writing to a hit's array would change every
        # later positions_all / positions_at.
        out.setflags(write=False)
        self._positions_cache = (self.state.beta, local_pos, iters, out)
        return out


class StaticFootprintNMF:
    """Classic static-footprint NMF on a motion-corrected video: MU
    updates of a learned footprint matrix ``A [P, K]`` (with the
    distance-penalty field ``D`` around the positions) alternated with MU
    updates of the traces ``C [K, T]``.  Counterpart of the JAX
    package's class; its products are plain ``torch.matmul`` (TF32 off,
    PyTorch's default), and on the card one alternation is a captured
    graph replayed once per iteration
    (:func:`~dnmf_tpu_torch.models.graphs.static_nmf_fit`, the JAX
    package's jitted step).  ``generator`` (a ``torch.Generator``, default
    seed 0) draws the initial traces on the CPU."""

    def __init__(self, model: ModelConfig, positions, gamma_a: float = 1.0,
                 penalty_rate: float = 0.01,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        self.model = model
        self.device = torch.device(device)
        grid = basis_ops.voxel_grid(model.size, device=self.device)
        pos = torch.as_tensor(positions, dtype=torch.float32).to(self.device)
        sigma = torch.full((model.num_neurons,), model.shape_std,
                           device=self.device)
        self.a = fp_ops.gaussian_footprints(grid, pos, sigma)  # [P, K]
        self.d = mu_ops.distance_penalty(grid, pos, rate=penalty_rate)
        self.gamma_a = gamma_a
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.c = torch.rand((model.num_neurons, model.num_frames),
                            generator=generator).to(self.device)

    def fit(self, video, iters: int = 50):
        """``iters`` alternating trace and footprint updates on the
        clamped video; returns ``(A [P, K], C [K, T])``."""
        y = torch.as_tensor(video, dtype=torch.float32).to(self.device)
        y = torch.clamp_min(y.reshape(y.shape[0], -1), 0.0).T  # [P, T]
        self.a, self.c = graphs.static_nmf_fit(self.a, self.c, y, self.d,
                                               self.gamma_a, iters)
        return self.a, self.c
