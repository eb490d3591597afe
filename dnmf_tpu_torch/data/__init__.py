"""Data layer: the ground-truthed synthetic video simulator, dataset
wrappers for simulated and real recordings, and host-streamed video
sources."""

from dnmf_tpu_torch.data.datasets import (
    NeuroPALVideoDataset,
    SimulatedVideoDataset,
    VideoDataset,
)
from dnmf_tpu_torch.data.simulator import (
    exponential_traces,
    generate_video,
    gp_motion,
    quadratic_sequential_trajectory,
    quadratic_trajectory,
    render_video,
    roi_signals,
)
from dnmf_tpu_torch.data.streaming import (
    RawFileVideo,
    SpatialView,
    StreamingVideo,
    open_memmap_video,
    open_raw_video,
)

__all__ = [
    "NeuroPALVideoDataset",
    "RawFileVideo",
    "SimulatedVideoDataset",
    "SpatialView",
    "StreamingVideo",
    "VideoDataset",
    "open_memmap_video",
    "open_raw_video",
    "exponential_traces",
    "generate_video",
    "gp_motion",
    "quadratic_sequential_trajectory",
    "quadratic_trajectory",
    "render_video",
    "roi_signals",
]
