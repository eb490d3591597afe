"""End-to-end pipeline: registration -> position seeding -> demixing.

Counterpart of ``dnmf_tpu/engine/pipeline.py``:
:func:`register_and_demix` registers the recording, seeds neuron
positions (given points, or peaks of the summary images or of the
registration template), seeds the per-frame warps from the registration
shifts, then runs ``DeformableNMF.fit`` and, optionally, ``refine``.
Everything runs on the CUDA device unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from dnmf_tpu_torch.config import (ModelConfig, OptimizerConfig,
                                   RegistrationConfig, RuntimeConfig)
from dnmf_tpu_torch.engine.trainer import DeformableNMF, FitResult
from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.registration import MotionCorrect


def detect_peaks(volume: np.ndarray, num_peaks: int,
                 min_distance: float = 4.0,
                 smooth_sigma: float = 1.0) -> np.ndarray:
    """Greedy local maxima with distance suppression: up to ``num_peaks``
    ``[K, 3]`` voxel coordinates, brightest first."""
    from scipy.ndimage import gaussian_filter

    vol = gaussian_filter(np.asarray(volume, dtype=np.float64), smooth_sigma)
    flat_order = np.argsort(vol.reshape(-1))[::-1]
    coords = np.stack(np.unravel_index(flat_order, vol.shape), axis=1)
    chosen: list = []
    for c in coords:
        if len(chosen) == num_peaks:
            break
        if all(np.linalg.norm(c - p) >= min_distance for p in chosen):
            chosen.append(c.astype(np.float64))
    return np.stack(chosen)


@dataclasses.dataclass
class PipelineResult:
    fit: FitResult
    motion: MotionCorrect
    positions: np.ndarray  # [K, 3, T] registration-tracked positions
    # Wall seconds of each stage ("registration", "seeding", "fit",
    # "refine"), the device synchronized at each stage's end.
    seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def traces(self) -> np.ndarray:
        return self.fit.traces


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _seed_beta(mc: MotionCorrect, reg_cfg: RegistrationConfig, size,
               scaling: str, seed_mode: str) -> torch.Tensor:
    """Per-frame warps ``[T, 10, 3]`` from the registration: a ridge fit
    to the patch-shift field (piecewise-rigid), else pure translations."""
    if not reg_cfg.pw_rigid:
        corr = np.asarray(mc.shifts_rig)
        if corr.shape[1] < 3:
            corr = np.pad(corr, ((0, 0), (0, 3 - corr.shape[1])))
        corr = corr - corr[0:1]
        return basis_ops.translation_beta(
            torch.as_tensor(corr, dtype=torch.float32), size, scaling=scaling)
    # Apparent content positions at the patch centres, in
    # apply_shifts_points' sign conventions (x/y displacement -(shift_t -
    # shift_0), z the opposite sign).
    xs = np.asarray(mc.x_shifts_els)
    ys = np.asarray(mc.y_shifts_els)
    zs = np.asarray(mc.z_shifts_els)
    disp = np.stack([-(xs - xs[0]), -(ys - ys[0]), (zs - zs[0])], axis=-1)
    # Axes too shallow for FFT shift estimates (a +-1 circular shift is
    # ambiguous on 2 planes) must not pollute the seed.
    for d, dim in enumerate(size):
        if dim < 4:
            disp[:, :, d] = 0.0
    centers = mc._patch_centers().astype(np.float32)
    if centers.shape[1] < 3:
        centers = np.pad(centers, ((0, 0), (0, 3 - centers.shape[1])))
    # Full quadratic where the patch grid constrains it ("auto": >= 12
    # patch centres), else affine.
    fit = (basis_ops.quadratic_beta_from_displacements
           if seed_mode == "quadratic" or (seed_mode == "auto"
                                           and centers.shape[0] >= 12)
           else basis_ops.affine_beta_from_displacements)
    return fit(torch.from_numpy(centers),
               torch.as_tensor(disp, dtype=torch.float32), size,
               scaling=scaling)


def register_and_demix(video, num_neurons: Optional[int] = None,
                       points: Optional[np.ndarray] = None,
                       registration: Optional[RegistrationConfig] = None,
                       model: Optional[ModelConfig] = None,
                       optimizer: Optional[OptimizerConfig] = None,
                       runtime: Optional[RuntimeConfig] = None,
                       seed_deformation: bool = True,
                       seed_mode: str = "auto", seeder: str = "summary",
                       refine_positions: bool = False,
                       refine_rounds: int = 3, refine_epochs: int = 40,
                       device="cuda") -> PipelineResult:
    """Full pipeline on a time-major video ``[T, M, N, Z]``.

    1. Piecewise-rigid registration (the template built from the video).
    2. Neuron positions: ``points [K, 3]`` (frame-0 coordinates), or
       peaks of the correlation x PNR summary images (``seeder=
       "summary"``, one extra pass over rigid-corrected blocks) or of the
       registration template (``"template"``), moved from template space
       to frame 0; per-frame positions from ``apply_shifts_points``.
    3. Deformable NMF seeded at the frame-0 positions, the warps seeded
       from the registration shifts (``seed_deformation``; ``seed_mode``
       "auto", "affine" or "quadratic"), then ``refine`` if asked.

    ``video`` is a NumPy array (registered on the host as it is, moved to
    ``device`` for the fit), a tensor, an ``np.memmap`` (streamed), or a
    streaming source (``StreamingVideo`` / ``RawFileVideo`` opened on
    ``device``): then every stage streams and device memory is bounded by
    the block size.
    """
    if seed_mode not in ("auto", "affine", "quadratic"):
        raise ValueError(f"unknown seed_mode: {seed_mode!r} "
                         "(expected 'auto', 'affine', or 'quadratic')")
    if seeder not in ("summary", "template"):
        raise ValueError(f"unknown seeder: {seeder!r} "
                         "(expected 'summary' or 'template')")
    device = torch.device(device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    streaming = hasattr(video, "blocks") and not hasattr(video, "frames_flat")
    if streaming:
        from dnmf_tpu_torch.data.streaming import SpatialView

        reg_video = SpatialView(video)  # validates the spatial shape
        t, m, n, z = reg_video.shape
        fit_video = video
    elif isinstance(video, np.memmap):
        from dnmf_tpu_torch.data.streaming import StreamingVideo

        t, m, n, z = video.shape
        reg_video = video
        fit_video = StreamingVideo(video, device=device)
        streaming = True
    else:
        if not isinstance(video, torch.Tensor):
            video = np.asarray(video, dtype=np.float32)
        t, m, n, z = video.shape
        reg_video = video
        fit_video = None  # moved to the device below

    # return_mc=False: the pipeline needs only the shifts and templates;
    # keeping the corrected movie would hold the recording on the host
    # twice.
    reg_cfg = registration or RegistrationConfig(
        max_shifts=(8, 8, 2), pw_rigid=True,
        strides=(max(m // 2, 8), max(n // 2, 8), max(z, 1)),
        overlaps=(8, 8, 0), is3d=True, border_nan=False, return_mc=False)
    mc = MotionCorrect(reg_video, reg_cfg, device=device).motion_correct()
    lap("registration")

    if points is None:
        if num_neurons is None:
            raise ValueError("need either points or num_neurons")
        if seeder == "summary":
            from dnmf_tpu_torch.ops.seeding import (detect_peaks_summary,
                                                    summary_images)

            # One extra pass, each block rigid-corrected with the
            # estimated shifts, so that the peaks sit in template space.
            src = fit_video if streaming else video
            rig = np.asarray(getattr(mc, "shifts_rig", []), np.float64)
            moved = rig.size > 0 and np.abs(rig).max() > 1e-3
            corr_img, pnr_img = summary_images(
                src, (m, n, z), shifts=rig if moved else None, device=device)
            points = detect_peaks_summary(corr_img, pnr_img, num_neurons)
        else:
            template = _host(mc.total_template_els if reg_cfg.pw_rigid
                             else mc.total_template_rig)
            points = detect_peaks(template, num_neurons)
        # Peaks live in template space; apply_shifts_points takes frame-0
        # points.
        points = mc.template_points_to_frame0(points)
        lap("seeding")
    points = np.asarray(points, dtype=np.float64)
    if num_neurons is not None and points.shape[0] < num_neurons:
        # As the JAX package does, this also fires for user points fewer
        # than num_neurons (ROADMAP Queue 3).
        warnings.warn(
            f"seeder found {points.shape[0]} of the requested "
            f"{num_neurons} neurons (min-distance packing limit)",
            RuntimeWarning, stacklevel=2)
        if model is not None and model.num_neurons != points.shape[0]:
            raise ValueError(
                f"ModelConfig.num_neurons={model.num_neurons} but only "
                f"{points.shape[0]} seeds were detected — pass "
                "points=... or a matching ModelConfig")

    if reg_cfg.pw_rigid:
        positions = mc.apply_shifts_points(points)
    else:
        shifts = np.asarray(mc.shifts_rig)  # [T, nd] corrections
        positions = np.repeat(points[:, :, None], t, axis=2)
        for d in range(min(3, shifts.shape[1])):
            positions[:, d, :] += -shifts[None, :, d] + shifts[0, d]

    model_cfg = model or ModelConfig(size=(m, n, z),
                                     num_neurons=points.shape[0],
                                     num_frames=t, shape_std=3.0)
    # The default schedule: 6 rounds of 12 motion epochs and 50 trace
    # iterations.
    opt_cfg = optimizer or OptimizerConfig(learning_rate=1e-3, outer_rounds=6,
                                           motion_epochs=12)
    beta0 = (_seed_beta(mc, reg_cfg, (m, n, z),
                        model_cfg.deformation.basis_scaling, seed_mode)
             if seed_deformation else None)

    engine = DeformableNMF(
        model_cfg, opt_cfg, runtime,
        positions=torch.as_tensor(positions[:, :, 0], dtype=torch.float32),
        beta0=beta0, device=device)
    if fit_video is None:
        fit_video = torch.as_tensor(video).to(device).reshape(t, -1)
    fit = engine.fit(fit_video)
    lap("fit")
    if refine_positions:
        fit = engine.refine(fit_video, rounds=refine_rounds,
                            epochs=refine_epochs)
        lap("refine")
    return PipelineResult(fit=fit, motion=mc, positions=positions,
                          seconds=seconds)
