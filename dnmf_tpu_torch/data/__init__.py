"""Host-streamed video sources (:mod:`dnmf_tpu_torch.data.streaming`)."""

from dnmf_tpu_torch.data.streaming import (
    RawFileVideo,
    SpatialView,
    StreamingVideo,
    open_memmap_video,
    open_raw_video,
)

__all__ = [
    "RawFileVideo",
    "SpatialView",
    "StreamingVideo",
    "open_memmap_video",
    "open_raw_video",
]
