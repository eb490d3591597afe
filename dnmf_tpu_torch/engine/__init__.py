"""Engine: the user-facing alternating-optimization driver and the
register -> seed -> demix pipeline."""

from dnmf_tpu_torch.engine.pipeline import (PipelineResult, detect_peaks,
                                            register_and_demix)
from dnmf_tpu_torch.engine.trainer import (DeformableNMF, FitResult,
                                           StaticFootprintNMF)
from dnmf_tpu_torch.ops.seeding import detect_peaks_summary, summary_images

__all__ = ["DeformableNMF", "FitResult", "PipelineResult",
           "StaticFootprintNMF", "detect_peaks", "detect_peaks_summary",
           "register_and_demix", "summary_images"]
