"""User-facing driver and the one-call pipeline."""

from dnmf_tpu_torch.engine.pipeline import (PipelineResult, detect_peaks,
                                            register_and_demix)
from dnmf_tpu_torch.engine.trainer import DeformableNMF, FitResult

__all__ = ["DeformableNMF", "FitResult", "PipelineResult", "detect_peaks",
           "register_and_demix"]
