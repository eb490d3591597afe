"""Host-streamed video sources for recordings larger than device memory.

Counterpart of ``dnmf_tpu/data/streaming.py``.  A source holds a
``[T, M, N, Z]`` or ``[T, P]`` recording on the host (an array, a memmap
or a raw float32 file) and hands the engine fixed-size frame blocks:
``blocks()`` yields ``(frames [block, P] on the source's device, start,
valid)``, the last block zero-padded to the block size; a run of frames
and of voxels (a rank's shard) narrows it.  ``read`` gives clamped host
frames (the NMF non-negativity clamp), ``read_raw`` the recording's own
values (registration reads).

On a CUDA device each host block is staged in one of two pinned buffers
and copied with ``non_blocking=True`` on a side stream, one block ahead of
the compute: block ``i + 1`` is read and copied while the card computes
on block ``i``, and the compute stream waits on the copy's event before
it touches the frames; one side stream serves every pass of a source.
:class:`RawFileVideo` also reads the next block on native threads
(:mod:`dnmf_tpu_torch.native`).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


def _frame_range(start: int, stop: int, block: int):
    return [(s, min(s + block, stop)) for s in range(start, stop, block)]


class _BlockSource:
    """Shared block staging of :class:`StreamingVideo` and
    :class:`RawFileVideo`; subclasses fill host blocks in ``_fill``."""

    block: int
    num_frames: int
    num_voxels: int
    device: torch.device

    def __len__(self) -> int:
        return self.num_frames

    def num_blocks(self) -> int:
        return -(-self.num_frames // self.block)

    def _fill(self, start: int, stop: int, out: np.ndarray,
              voxels: slice) -> None:
        """Write clamped frames ``[start, stop)``, voxels ``voxels`` only,
        into ``out [n, voxels.stop - voxels.start]``."""
        raise NotImplementedError

    def _prefetch(self, start: int, stop: int) -> None:
        """Hint that whole frames ``[start, stop)`` are read next."""

    def blocks(self, start: int = 0, stop=None, voxels: slice = None
               ) -> Iterator[Tuple[torch.Tensor, int, int]]:
        """Yield ``(frames [block, P] on the device, start, valid)`` over
        frames ``[start, stop)`` (default: all).  ``voxels`` (a slice of
        the flat voxels) reads only that run: frames ``[block,
        voxels.stop - voxels.start]``."""
        ranges = _frame_range(start, self.num_frames if stop is None
                              else stop, self.block)
        voxels = voxels or slice(0, self.num_voxels)
        # The prefetch reads whole frames; a run of voxels is read directly.
        whole = voxels == slice(0, self.num_voxels)
        if ranges and whole:
            self._prefetch(*ranges[0])
        width = voxels.stop - voxels.start
        if self.device.type != "cuda":
            for i, (start, stop) in enumerate(ranges):
                host = np.zeros((self.block, width), np.float32)
                self._fill(start, stop, host[:stop - start], voxels)
                if i + 1 < len(ranges) and whole:
                    self._prefetch(*ranges[i + 1])
                yield torch.from_numpy(host).to(self.device), start, stop - start
            return
        yield from self._cuda_blocks(ranges, voxels, whole)

    def _side_stream(self) -> torch.cuda.Stream:
        """The source's copy stream, one for all its passes: the caching
        allocator keeps a freed block for the stream it was allocated on,
        so a stream per pass (``torch.cuda.Stream()`` cycles through a pool
        of 32) left each pass's frame blocks cached on a stream of their
        own, reserved and unused."""
        if getattr(self, "_side", None) is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _cuda_blocks(self, ranges, voxels, whole):
        shape = (self.block, voxels.stop - voxels.start)
        pinned = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                  for _ in range(min(2, len(ranges)))]
        copied = [None] * len(pinned)  # copy-done event per pinned buffer
        side = self._side_stream()

        def issue(i):
            start, stop = ranges[i]
            slot = i % len(pinned)
            if copied[slot] is not None:
                copied[slot].synchronize()  # its last copy has left it
            host = pinned[slot].numpy()
            self._fill(start, stop, host[:stop - start], voxels)
            host[stop - start:] = 0.0
            if i + 1 < len(ranges) and whole:
                self._prefetch(*ranges[i + 1])
            with torch.cuda.stream(side):
                frames = torch.empty(shape, dtype=torch.float32,
                                     device=self.device)
                frames.copy_(pinned[slot], non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            copied[slot] = done
            return frames, done

        pending = issue(0) if ranges else None
        for i, (start, stop) in enumerate(ranges):
            frames, done = pending
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            # Allocated on the side stream, used on the compute stream.
            frames.record_stream(compute)
            yield frames, start, stop - start
            if i + 1 < len(ranges):
                pending = issue(i + 1)


class StreamingVideo(_BlockSource):
    """Frame-block iterator over a host-resident (or memmapped) video.

    Args:
      array: ``[T, M, N, Z]`` or ``[T, P]`` NumPy-like array (memmap ok).
      block: frames per device transfer; the last block is zero-padded to
        this size and comes with its count of valid frames.
      device: where ``blocks()`` puts the frames (default: the card).
    """

    def __init__(self, array, block: int = 64, device="cuda"):
        self.array = array
        self.block = int(block)
        self.device = torch.device(device)
        self.num_frames = int(array.shape[0])
        # Spatial shape; None for flat [T, P] sources.
        self.size = (tuple(int(s) for s in array.shape[1:])
                     if array.ndim == 4 else None)
        self.num_voxels = int(np.prod(array.shape[1:]))

    def read(self, start: int, stop: int) -> np.ndarray:
        """Host frames ``[start, stop)`` as clamped float32 ``[n, P]``."""
        return np.maximum(self.read_raw(start, stop), 0.0)

    def read_raw(self, start: int, stop: int) -> np.ndarray:
        """Host frames without the non-negativity clamp (registration must
        see the recording's own values, negative baselines included)."""
        return np.asarray(self.array[start:stop],
                          dtype=np.float32).reshape(stop - start, -1)

    def _fill(self, start, stop, out, voxels):
        # Sliced before the copy: a memmap reads just the run's bytes.
        flat = self.array[start:stop].reshape(stop - start, -1)
        np.maximum(np.asarray(flat[:, voxels], dtype=np.float32), 0.0,
                   out=out)


def open_memmap_video(path: str, shape, dtype=np.float32, block: int = 64,
                      device="cuda") -> StreamingVideo:
    """Open a raw binary volume sequence as a streaming source."""
    mm = np.memmap(path, dtype=dtype, mode="r", shape=tuple(shape))
    return StreamingVideo(mm, block=block, device=device)


class RawFileVideo(_BlockSource):
    """Streaming source over a raw float32 ``[T, ...spatial]`` file, read
    by the native threaded block reader: reads and clamps run on native
    threads, and the next block is read while the card computes on the
    current one.  Same interface as :class:`StreamingVideo`."""

    def __init__(self, path: str, shape, block: int = 64,
                 num_threads: int = 4, prefetch: bool = True,
                 device="cuda"):
        from dnmf_tpu_torch.native import BlockReader

        shape = tuple(int(s) for s in shape)
        self.path = str(path)
        self.num_frames = shape[0]
        self.size = shape[1:] if len(shape) == 4 else None
        self.num_voxels = int(np.prod(shape[1:]))
        self.block = int(block)
        self.prefetch = bool(prefetch)
        self.device = torch.device(device)
        self._reader = BlockReader(self.path, self.num_frames,
                                   self.num_voxels, num_threads=num_threads)
        self._inflight = None  # frame range of the reader's prefetch
        self._raw_map = None

    def read(self, start: int, stop: int) -> np.ndarray:
        self._drain()
        return self._reader.read(start, stop)

    def read_raw(self, start: int, stop: int) -> np.ndarray:
        """Unclamped host read for registration (the native reader clamps
        as it copies, so raw reads go through a memmap of the file)."""
        return np.asarray(self._raw()[start:stop], dtype=np.float32)

    def _raw(self) -> np.memmap:
        if self._raw_map is None:
            self._raw_map = np.memmap(self.path, dtype=np.float32, mode="r",
                                      shape=(self.num_frames,
                                             self.num_voxels))
        return self._raw_map

    def _drain(self) -> None:
        """Join a prefetch that no block will collect (an abandoned
        ``blocks()`` loop); the reader takes one request at a time."""
        if self._inflight is not None:
            self._reader.wait(*self._inflight)
            self._inflight = None

    def _prefetch(self, start, stop):
        if self.prefetch and self._inflight != (start, stop):
            self._drain()
            self._reader.prefetch(start, stop)
            self._inflight = (start, stop)

    def _fill(self, start, stop, out, voxels):
        if voxels != slice(0, self.num_voxels):
            # A run of voxels (a pixel shard) reads through the memmap.
            np.maximum(self._raw()[start:stop, voxels], 0.0, out=out)
            return
        if self._inflight == (start, stop):
            self._reader.wait(start, stop, out=out)
            self._inflight = None
        else:
            self._drain()
            self._reader.read(start, stop, out=out)


class SpatialView:
    """NumPy-like ``[T, M, N, Z]`` read view over a streaming source.

    Registration (:class:`dnmf_tpu_torch.registration.MotionCorrect`)
    reads host arrays through ``shape`` and ``__getitem__`` only; this view
    turns integer, slice and index-array reads (NumPy semantics:
    negatives count from the end, anything outside ``[-T, T)`` raises)
    into grouped contiguous ``read_raw`` calls, so a recording that does
    not fit in memory can be registered.  Reads are unclamped.
    """

    def __init__(self, source):
        if getattr(source, "size", None) is None:
            raise ValueError(
                "registration needs the spatial shape — wrap a "
                "[T, M, N, Z] source, not a flat [T, P] one")
        self.source = source
        self.shape = (source.num_frames,) + tuple(source.size)
        self.ndim = 4
        self._read = getattr(source, "read_raw", source.read)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, key) -> np.ndarray:
        t = self.shape[0]
        squeeze = False
        if isinstance(key, slice):
            idx = np.arange(*key.indices(t))
        elif np.isscalar(key) or (isinstance(key, np.ndarray)
                                  and key.ndim == 0):
            idx = np.asarray([int(key)])
            squeeze = True
        else:
            idx = np.asarray(key).reshape(-1)
        if len(idx) and (idx.min() < -t or idx.max() >= t):
            raise IndexError(f"frame index out of range for {t} frames: "
                             f"[{idx.min()}, {idx.max()}]")
        idx = np.where(idx < 0, idx + t, idx)
        out = np.empty((len(idx),) + self.shape[1:], np.float32)
        i = 0
        while i < len(idx):  # group ascending contiguous runs
            j = i
            while j + 1 < len(idx) and idx[j + 1] == idx[j] + 1:
                j += 1
            chunk = self._read(int(idx[i]), int(idx[j]) + 1)
            out[i:j + 1] = chunk.reshape((j - i + 1,) + self.shape[1:])
            i = j + 1
        return out[0] if squeeze else out


def open_raw_video(path: str, shape, block: int = 64, num_threads: int = 4,
                   prefetch: bool = True, device="cuda"):
    """Open a raw float32 recording with the native prefetching reader,
    or as a memmapped :class:`StreamingVideo` where no C++ compiler is
    found (a host reader either way)."""
    from dnmf_tpu_torch.native import load_blockreader

    if load_blockreader() is not None:
        return RawFileVideo(path, shape, block=block,
                            num_threads=num_threads, prefetch=prefetch,
                            device=device)
    return open_memmap_video(path, shape, block=block, device=device)
