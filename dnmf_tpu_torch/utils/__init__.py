"""Host-side utilities: volume/patch helpers, accuracy metrics and the
profiler spans (:mod:`~dnmf_tpu_torch.utils.trace`)."""

from dnmf_tpu_torch.utils.metrics import r_squared, trace_correlations
from dnmf_tpu_torch.utils.volume import (
    max_project,
    pairwise_distances,
    placement,
    subcube,
    superpose,
)

__all__ = [
    "r_squared",
    "trace_correlations",
    "max_project",
    "pairwise_distances",
    "placement",
    "subcube",
    "superpose",
]
