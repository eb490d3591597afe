"""Trace post-processing: histogram matching and trace cleanup."""

from dnmf_tpu_torch.traces.postprocess import clean_traces, histogram_match

__all__ = ["clean_traces", "histogram_match"]
