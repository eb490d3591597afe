"""Typed configuration dataclasses of the PyTorch port.

Field for field the same names and defaults as ``dnmf_tpu/config.py``,
so one configuration drives either package.  The one rename is
``RuntimeConfig.use_pallas`` -> ``RuntimeConfig.use_kernels``: the
hand-written CUDA kernels of :mod:`dnmf_tpu_torch.ops.fused` take the
place of the Pallas kernels.

``RegistrationConfig`` and ``SimulatorConfig`` come with the registration
and simulator slices of the port (ROADMAP Queue 1 items 7 and 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DeformationConfig:
    """Quadratic deformation model settings.

    ``footprint_mode``: ``"analytic"`` evaluates the Gaussians directly
    at deformed coordinates.  ``"resample"`` (trilinear resampling of a
    stored footprint volume, the reference-parity path) is not ported
    yet.
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
    # "parallel": per-frame independent Adam (ported).  "parity": the
    # reference's serial mini-batch schedule (not ported yet).
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
    # Mesh axis sizes (not ported yet: None is the only accepted value).
    mesh_time: Optional[int] = None
    mesh_batch: Optional[int] = None
    mesh_pixel: Optional[int] = None
    # Hand-written CUDA kernels for the motion, c1 and Gram passes.
    # None = kernels for CUDA tensors, the plain PyTorch versions for
    # CPU tensors; False = the plain versions everywhere.
    use_kernels: Optional[bool] = None
    # MU Gram computation: "auto" (closed form wherever valid, guarded
    # by the per-fit trust audit), "exact" (the O(P K^2) pixel
    # reduction) or "analytic" (closed form, O(K^2); only the c1 video
    # pass remains).
    gram_mode: str = "auto"
    # Trust gate for analytic Grams: the strongest-warp frame's exact
    # Gram is compared with the closed form once per fit; a larger max
    # relative error falls the fit back to "exact".  None disables it.
    gram_trust_tol: Optional[float] = 0.02
    # Raise on non-finite factors after each update phase.
    check_finite: bool = False
    profile_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None


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
