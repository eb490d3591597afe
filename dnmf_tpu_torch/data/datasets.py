"""Dataset wrappers: video sources on a device, with ground truth.

Counterpart of ``dnmf_tpu/data/datasets.py``: frames live time-major
(``[T, M, N, Z]``) on the dataset's device (the card unless the caller
says otherwise), and batching is index-based.  The simulated and NeuroPAL
datasets clamp negative voxels to zero when they are built, as the
reference does at access; the base class clamps nothing, and neither
does :class:`dnmf_tpu_torch.engine.trainer.DeformableNMF` when it takes a
dataset's ``frames_flat()``.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from dnmf_tpu_torch.config import SimulatorConfig
from dnmf_tpu_torch.data import simulator


class VideoDataset:
    """Base: time-major video with optional ground truth."""

    video: torch.Tensor  # [T, M, N, Z]
    positions: Optional[torch.Tensor] = None  # [K, 3, T]
    traces: Optional[torch.Tensor] = None  # [K, T]

    def __len__(self) -> int:
        return int(self.video.shape[0])

    @property
    def size(self) -> Tuple[int, int, int]:
        return tuple(int(s) for s in self.video.shape[1:])

    def __getitem__(self, idx):
        return self.video[idx], idx

    def frames_flat(self) -> torch.Tensor:
        """``[T, P]`` flattened voxels."""
        return self.video.reshape(self.video.shape[0], -1)

    def batches(
        self, batch_size: int, *, shuffle: bool = False,
        generator: Optional[torch.Generator] = None,
        drop_remainder: bool = False,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Yield ``(frames [B, M, N, Z], times [B])`` blocks; ``shuffle``
        permutes the frames with ``generator``."""
        t = len(self)
        dev = self.video.device
        if shuffle:
            if generator is None:
                raise ValueError("shuffle requires a torch.Generator")
            order = torch.randperm(t, generator=generator,
                                   device=generator.device).to(dev)
        else:
            order = torch.arange(t, device=dev)
        stop = t - t % batch_size if drop_remainder else t
        for start in range(0, stop, batch_size):
            idx = order[start:start + batch_size]
            yield self.video[idx], idx


class SimulatedVideoDataset(VideoDataset):
    """Ground-truthed synthetic video
    (:func:`dnmf_tpu_torch.data.simulator.generate_video`), negatives
    clamped."""

    def __init__(self, config: SimulatorConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        video, positions, traces = simulator.generate_video(
            config, generator=generator, device=device)
        self.video = torch.clamp_min(video, 0.0)
        self.positions = positions
        self.traces = traces
        self.config = config


class NeuroPALVideoDataset(VideoDataset):
    """Real NeuroPAL recording loaded from ``data.mat`` / ``traces_n.mat``:
    the video downsampled by ``downsample`` and cut to ``max_frames``,
    time-major and clamped; positions from MATLAB's 1-based indices to
    0-based, rescaled per axis by the downsampling; ``names``."""

    def __init__(self, directory: str, downsample=(2, 2, 10),
                 max_frames: int = 100, device="cuda"):
        from scipy.io import loadmat

        dx, dy, dz = downsample
        vid_mat = loadmat(os.path.join(directory, "data.mat"))
        video = np.asarray(
            vid_mat["data"][::dx, ::dy, ::dz, :max_frames], dtype=np.float32)
        self.video = torch.clamp_min(torch.as_tensor(
            np.ascontiguousarray(np.transpose(video, (3, 0, 1, 2))),
            device=device), 0.0)

        pos_mat = loadmat(os.path.join(directory, "traces_n.mat"))
        positions = np.asarray(pos_mat["positions"], dtype=np.float32) - 1.0
        positions[:, 0, :] /= dx
        positions[:, 1, :] /= dy
        positions[:, 2, :] /= dz
        self.positions = torch.as_tensor(
            np.ascontiguousarray(positions[:, :, :max_frames]), device=device)
        self.names = [str(n[0]) for n in pos_mat["neuron_names"][0]]
