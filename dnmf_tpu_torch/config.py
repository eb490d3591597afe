"""Typed configuration dataclasses of the PyTorch port.

Field for field the same names and defaults as ``dnmf_tpu/config.py``,
so one configuration drives either package.  The one rename is
``RuntimeConfig.use_pallas`` -> ``RuntimeConfig.use_kernels``: the
hand-written CUDA kernels of :mod:`dnmf_tpu_torch.ops.fused` take the
place of the Pallas kernels.  ``SimulatorConfig`` drives the fixture
generator :mod:`dnmf_tpu_torch.data.simulator`, the ``reference_demo_*``
presets give the reference demo's model, schedule and fixture, and
``high_snr_registration`` is the JAX package's registration preset.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeformationConfig:
    """Quadratic deformation model settings.

    ``footprint_mode``: ``"analytic"`` evaluates the Gaussians directly
    at deformed coordinates; ``"resample"`` samples a stored footprint
    volume trilinearly (the reference's numerics).  Only analytic
    footprints with the border fade run the CUDA kernels.
    """

    footprint_mode: str = "analytic"
    # Coordinate space of the beta parameterization: "normalized" builds
    # the basis on [-1, 1]^3 (all 10 coefficients O(1) sensitive);
    # "pixel" on raw voxel coordinates (the reference's choice).
    basis_scaling: str = "normalized"
    # Fade footprints to zero where the deformed coordinate leaves the
    # volume (grid_sample zero-padding semantics).
    mask_out_of_bounds: bool = True
    # True reproduces the reference's detached (gradient-free) Jacobian
    # regularizer; False makes it differentiable.
    detach_regularizer: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shapes and priors of the deformable NMF model."""

    size: Tuple[int, int, int] = (50, 50, 2)  # (M, N, Z) voxels
    num_neurons: int = 10  # K
    num_frames: int = 100  # T
    shape_std: float = 3.0  # sigma of the Gaussian footprints
    # 1: per-neuron scalar widths sigma [K]; 3: per-axis widths [K, 3].
    sigma_axes: int = 1
    deformation: DeformationConfig = dataclasses.field(
        default_factory=DeformationConfig
    )
    dtype: str = "float32"

    @property
    def num_voxels(self) -> int:
        m, n, z = self.size
        return m * n * z


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Alternating-optimization schedule: ``outer_rounds`` x
    (``motion_epochs`` Adam epochs on beta + ``mu_iters`` trace
    updates)."""

    learning_rate: float = 1e-5
    batch_size: int = 4
    outer_rounds: int = 5
    motion_epochs: int = 10
    mu_iters: int = 50
    gamma_motion: float = 1.0  # Jacobian regularizer weight
    gamma_traces: float = 0.0  # temporal smoothing weight
    # "parallel": per-frame independent Adam.  "parity": the reference's
    # serial mini-batch schedule (batch_size frames per Adam step).
    motion_mode: str = "parallel"
    shuffle: bool = True
    # Per-round multipliers on the footprint widths (padded with 1.0).
    sigma_anneal: Tuple[float, ...] = ()
    # Per-neuron width fitting: sigma_steps Adam steps on log-sigma over
    # sigma_frames frames, every sigma_every-th round at the base widths.
    fit_sigma: bool = False
    sigma_lr: float = 0.05
    sigma_steps: int = 2
    sigma_frames: int = 8
    sigma_every: int = 2
    # Clip bounds as multipliers of shape_std.  The upper bound also
    # sizes the analytic-Gram lattice window.
    sigma_bounds: Tuple[float, float] = (0.5, 1.6)
    # Trace-subproblem solver: "mu" (multiplicative) or "fista".
    trace_solver: str = "mu"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution settings."""

    # Frames per kernel launch in the motion and Gram passes.
    frame_block: int = 8
    # Mesh axis sizes; None => single device.  mesh_time (frames) and
    # mesh_pixel (voxels; analytic footprints) shard the fit over the
    # process group of :mod:`dnmf_tpu_torch.parallel`; mesh_batch sizes
    # the mesh's batch axis beside them.
    mesh_time: Optional[int] = None
    mesh_batch: Optional[int] = None
    mesh_pixel: Optional[int] = None
    # Hand-written CUDA kernels for the motion, c1 and Gram passes.
    # None = kernels on the card for analytic footprints with the border
    # fade, the plain PyTorch versions otherwise (and on the CPU); False =
    # the plain versions everywhere; True raises for resampled or unfaded
    # footprints, whose function the kernels do not compute.
    use_kernels: Optional[bool] = None
    # MU Gram computation: "auto" (closed form wherever valid: analytic
    # footprints and no pixel mesh; guarded by the per-fit trust audit),
    # "exact" (the O(P K^2) pixel reduction; the only mode on pixel
    # meshes) or "analytic" (closed form, O(K^2); only the c1 video pass
    # remains; not on pixel meshes).
    gram_mode: str = "auto"
    # Trust gate for analytic Grams: the strongest-warp frame's exact
    # Gram is compared with the closed form once per fit; a larger max
    # relative error falls the fit back to "exact".  None disables it.
    gram_trust_tol: Optional[float] = 0.02
    # Raise on non-finite factors after each update phase.
    check_finite: bool = False
    # torch.profiler trace of the last fit() round into this directory,
    # its steps named by the spans of utils/trace.py.
    profile_dir: Optional[str] = None
    # Checkpoint after every fit() round into this directory.
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """FFT rigid / piecewise-rigid registration settings
    (:class:`dnmf_tpu_torch.registration.MotionCorrect`).

    Field for field ``dnmf_tpu.config.RegistrationConfig``.  Two fields
    choose the hand-written kernels of the piecewise-rigid frame block:

    * ``phasecorr_impl``: ``"fused"`` runs the per-patch correlation as
      kernel F (:mod:`dnmf_tpu_torch.ops.phasecorr`; its plain version on
      CPU tensors), ``"xla"`` the plain per-patch
      ``phase_cross_correlation`` on ``torch.fft``, ``"auto"`` kernel F
      for 3-D remap blocks on CUDA tensors and the plain path otherwise.
    * ``remap_mode``: ``"exact"`` (trilinear gather), ``"separable"``
      (three hat-weighted passes in plain PyTorch) or ``"fused"`` (kernel
      G, :mod:`dnmf_tpu_torch.ops.warp`).  ``"fused"`` falls back to
      ``"separable"`` wherever the block path is not the fused one, as
      in the JAX package.

    ``dft_precision`` is accepted for compatibility: on the card every
    option computes the transforms in float32 FMA, without TF32.
    """

    max_shifts: Tuple[int, ...] = (6, 6)
    niter_rig: int = 1
    niter_els: int = 1  # the reference pins the elastic phase to 1
    # Temporal chunking; the per-phase fields override ``splits``.
    splits: int = 1
    splits_rig: Optional[int] = None
    splits_els: Optional[int] = None
    # Frames seeding the initial template (None = all frames).
    template_init_max_frames: Optional[int] = None
    strides: Tuple[int, ...] = (96, 96)
    overlaps: Tuple[int, ...] = (32, 32)
    upsample_factor_grid: int = 4
    upsample_factor_fft: int = 10
    max_deviation_rigid: int = 3
    pw_rigid: bool = False
    is3d: bool = False
    border_nan: object = True  # True | False | "min" | "copy"
    gSig_filt: Optional[Tuple[int, ...]] = None
    min_mov: Optional[float] = None
    # Interpolating remap (True) or per-patch DFT shifts + blending.
    use_remap: bool = True
    remap_mode: str = "exact"  # "exact" | "separable" | "fused"
    # x/y decimation of the global rigid pre-estimate (1 = full res).
    rigid_decimate: int = 1
    # Frames per device transfer and per block call.
    frame_block: int = 16
    # Chunks registered in template-refinement iterations (all but the
    # last, which registers every chunk).
    num_splits_to_process: Optional[int] = None
    num_splits_to_process_rig: Optional[int] = None
    num_splits_to_process_els: Optional[int] = None
    # Keep the corrected movie (host-resident).
    return_mc: bool = True
    phasecorr_impl: str = "auto"  # "auto" | "fused" | "xla"
    dft_precision: str = "high"

    def resolved_splits(self, phase: str) -> int:
        """Per-phase chunk count (``phase`` in {"rig", "els"})."""
        v = self.splits_rig if phase == "rig" else self.splits_els
        return self.splits if v is None else v

    def resolved_num_splits_to_process(self, phase: str) -> Optional[int]:
        v = (self.num_splits_to_process_rig if phase == "rig"
             else self.num_splits_to_process_els)
        return self.num_splits_to_process if v is None else v


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Synthetic-video generator settings (ground-truthed fixture).

    Field for field ``dnmf_tpu.config.SimulatorConfig``: ``motion`` is
    ``"gp"`` (GP offsets i.i.d. per frame), ``"gpt"`` (GP over time),
    ``"sq"``/``"qs"`` (sequential quadratic) or ``"q"`` (cumulative
    quadratic).
    """

    num_neurons: int = 10
    num_frames: int = 100
    size: Tuple[int, int, int] = (50, 50, 2)
    shape_std: float = 3.0
    density: float = 0.2
    bg_snr_db: float = -120.0
    traces: str = "exp"
    motion: str = "gp"
    # GP motion parameters (motion in {"gp", "gpt"}).
    gp_sigma: Tuple[float, float, float] = (5.0, 5.0, 0.01)
    gp_length_scale: Tuple[float, float, float] = (10.0, 10.0, 10.0)
    # Quadratic motion parameters (motion in {"sq", "qs", "q"}).
    motion_means: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    motion_snr_db: Tuple[float, float, float] = (-100.0, -100.0, -100.0)
    # Constraints on the random anchors (0 = the reference's behaviour,
    # which can place neurons arbitrarily close or at the border).
    min_separation: float = 0.0
    margin: float = 0.0
    seed: int = 0


def high_snr_registration(**overrides) -> RegistrationConfig:
    """The JAX package's fast-correlation preset for known-high-SNR
    recordings (``dft_precision="default"``; any field can be
    overridden).  The port accepts the field and stays in float32: on the
    card every option computes the transforms in float32 FMA, without
    TF32, so this preset changes no result of the port."""
    return RegistrationConfig(**{"dft_precision": "default", **overrides})


def reference_demo_model(parity: bool = False) -> ModelConfig:
    """The reference demo's model shapes.  ``parity=True`` selects the
    reference's exact numerics: pixel basis, resampled footprints and the
    detached regularizer (run with ``motion_mode="parity"`` for its
    serial mini-batch schedule)."""
    deform = (
        DeformationConfig(footprint_mode="resample", basis_scaling="pixel",
                          detach_regularizer=True)
        if parity
        else DeformationConfig()
    )
    return ModelConfig(size=(50, 50, 2), num_neurons=10, num_frames=100,
                       shape_std=3.0, deformation=deform)


def reference_demo_optimizer() -> OptimizerConfig:
    """The reference demo's schedule."""
    return OptimizerConfig(learning_rate=1e-5, batch_size=4, outer_rounds=5,
                           motion_epochs=10, mu_iters=50, gamma_motion=1.0,
                           gamma_traces=0.0)


def reference_demo_simulator() -> SimulatorConfig:
    """The reference demo's fixture."""
    return SimulatorConfig(num_neurons=10, num_frames=100, size=(50, 50, 2),
                           shape_std=3.0, density=0.2, bg_snr_db=-120.0,
                           traces="exp", motion="gp",
                           gp_sigma=(5.0, 5.0, 0.01),
                           gp_length_scale=(10.0, 10.0, 10.0))


def baseline_workload(name: str):
    """Scaling configurations as (model, runtime) presets.

    ``demo``        — the reference demo scale.
    ``roi``         — 256x256x10, K=50, 500 frames.
    ``whole_brain`` — 512x512x20, K=200, 1k frames.
    ``long``        — 10k frames, K=500, frame-sharded mesh.
    ``multi``       — 32 recordings x K=200 (batched rounds).
    """
    presets = {
        "demo": (ModelConfig(size=(50, 50, 2), num_neurons=10,
                             num_frames=100),
                 RuntimeConfig(frame_block=16)),
        "roi": (ModelConfig(size=(256, 256, 10), num_neurons=50,
                            num_frames=500),
                RuntimeConfig(frame_block=8)),
        "whole_brain": (ModelConfig(size=(512, 512, 20), num_neurons=200,
                                    num_frames=1000),
                        RuntimeConfig(frame_block=2)),
        "long": (ModelConfig(size=(512, 512, 20), num_neurons=500,
                             num_frames=10240),
                 RuntimeConfig(frame_block=2, mesh_time=8)),
        "multi": (ModelConfig(size=(256, 256, 10), num_neurons=200,
                              num_frames=512),
                  RuntimeConfig(frame_block=4, mesh_batch=16)),
    }
    if name not in presets:
        raise KeyError(f"unknown workload {name!r}; "
                       f"choose from {sorted(presets)}")
    return presets[name]
