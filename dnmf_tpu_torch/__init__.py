"""PyTorch + CUDA port of dnmf_tpu (see README, "PyTorch/CUDA port").

Deformable NMF of calcium-imaging videos on an NVIDIA GPU: per-frame
quadratic warps of Gaussian neuron footprints alternated with
non-negative trace updates, with FFT registration, seeding, refinement,
streaming and a simulator around them.  The hand-written CUDA kernels of
``csrc/`` take the place of the JAX package's Pallas kernels.
"""

__version__ = "0.2.0"

from dnmf_tpu_torch.config import (
    DeformationConfig,
    ModelConfig,
    OptimizerConfig,
    RegistrationConfig,
    RuntimeConfig,
    SimulatorConfig,
    high_snr_registration,
)

__all__ = [
    "DeformationConfig",
    "ModelConfig",
    "OptimizerConfig",
    "RegistrationConfig",
    "RuntimeConfig",
    "SimulatorConfig",
    "high_snr_registration",
    "__version__",
]
