"""Neuron seeding from summary images: local correlation x PNR.

Counterpart of ``dnmf_tpu/ops/seeding.py``.

* :func:`summary_images` makes one pass over the recording, a frame block
  at a time on the device: per-voxel centred moments (the reference level
  ``ref`` is the first block's mean, set once), the products with the +1
  neighbour along each axis (``torch.roll``), squared temporal first
  differences chained across blocks through the previous block's last
  valid frame, and the running max.  The host finishes in float64: the
  mean Pearson correlation with the in-bounds +-1 neighbours and the
  peak-to-noise ratio ``(max - mean) / (std(diff) / sqrt(2))``.  With
  rigid ``shifts`` each block is first translated into the template's
  gauge (``fft_reg.apply_shifts_fourier``, edge-replicated borders).
  Each block is one step (:func:`fold_block`), which the pass runs
  through :func:`~dnmf_tpu_torch.models.graphs.summary_blocks`: one
  captured CUDA graph per block shape, shifted or not, as the JAX package
  jits ``_accum_block`` and ``_accum_block_shifted``.
* :func:`detect_peaks_summary` picks the seeds on the ``corr * pnr``
  score (NumPy and SciPy on the host).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import fft_reg


def _accum_block(carry, frames: torch.Tensor, valid: torch.Tensor, size):
    """Fold one ``[B, P]`` frame block into the running moments ``carry =
    (ref, s1, s2, sxy [3, P], sdiff2, vmax, prev, count)``: sums of ``x' =
    x - ref``, ``x'^2`` and ``x'`` times its +1 neighbour along each axis,
    of squared first differences, the max, the last valid frame and the
    frame count.  Centring keeps the one-pass variance cancellation-free
    in float32.  ``count`` and ``valid`` (the block's real frames) are
    int64 device scalars, as JAX traces them: nothing is read back."""
    ref, s1, s2, sxy, sdiff2, vmax, prev, count = carry
    b = frames.shape[0]
    mask = (torch.arange(b, device=frames.device) < valid).to(frames.dtype)
    fr = frames * mask[:, None]
    # The first block's mean, times the reciprocal of the frame count (the
    # product that a division by a host number makes on the card).
    first_mean = fr.sum(dim=0) * torch.reciprocal(
        torch.clamp_min(valid, 1).to(frames.dtype))
    ref = torch.where(count == 0, first_mean, ref)
    frc = (frames - ref[None]) * mask[:, None]
    s1 = s1 + frc.sum(dim=0)
    s2 = s2 + (frc * frc).sum(dim=0)
    vmax = torch.maximum(vmax, torch.where(
        mask[:, None] > 0, frames, -torch.inf).amax(dim=0))
    vol = frc.reshape((b,) + tuple(size))
    sxy = sxy + torch.stack([
        (vol * torch.roll(vol, -1, dims=1 + d)).reshape(b, -1).sum(dim=0)
        for d in range(3)])
    # Temporal first differences, chained through prev across blocks; the
    # first frame of the recording has no predecessor.
    shifted = torch.cat([prev[None], fr[:-1]])
    first = (count > 0).to(frames.dtype).reshape(1)
    dmask = mask * torch.cat([first, mask[:-1]])
    diff = (fr - shifted) * dmask[:, None]
    sdiff2 = sdiff2 + (diff * diff).sum(dim=0)
    last = torch.clamp(valid - 1, 0, b - 1).reshape(1)
    prev = fr.index_select(0, last)[0]
    return (ref, s1, s2, sxy, sdiff2, vmax, prev, count + valid)


def _shifted(frames: torch.Tensor, shifts: torch.Tensor, size):
    """Rigid-correct a ``[B, P]`` block by per-frame ``shifts [B, 3]``
    (edge-replicated borders), clamped at 0."""
    vol = frames.reshape((-1,) + tuple(size))
    vol = fft_reg.apply_shifts_fourier(vol, shifts, 0.0, border_nan="copy")
    return torch.clamp_min(vol.reshape(frames.shape[0], -1), 0.0)


def fold_block(carry, frames, valid, shifts, size, clamp: bool):
    """One block of the pass: ``frames`` clamped at 0 (``clamp``, array
    inputs), rigid-corrected by ``shifts [B, 3]`` where given
    (:func:`_shifted`), then folded into ``carry`` (:func:`_accum_block`).
    Returns the new carry."""
    if clamp:
        frames = torch.clamp_min(frames, 0.0)
    if shifts is not None:
        frames = _shifted(frames, shifts, size)
    return _accum_block(carry, frames, valid, size)


def summary_images(video, size, frame_block: int = 16, shifts=None,
                   device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Local-correlation and PNR volumes from one pass.

    Args:
      video: ``[T, P]`` / ``[T, M, N, Z]`` NumPy array or tensor (a tensor
        is sliced per block on its own device; NumPy blocks go to
        ``device``), or a streaming source with ``blocks()``, whose blocks
        arrive on the source's device.
      size: spatial shape ``(M, N, Z)``.
      frame_block: block size for array inputs.
      shifts: optional ``[T, 3]`` rigid correction shifts (the
        registration's ``shifts_rig`` convention); each block is then
        corrected on the device before it is folded in, so that the
        volumes, and the peaks found on them, sit in template space.

    Returns ``(corr [M, N, Z], pnr [M, N, Z])`` float32 host arrays.
    """
    size = tuple(int(s) for s in size)
    p = int(np.prod(size))
    streamed = hasattr(video, "blocks") and not hasattr(video, "frames_flat")

    def array_blocks():
        t = int(video.shape[0])
        if isinstance(video, torch.Tensor):
            arr = video.reshape(t, -1).to(torch.float32)
        else:  # host blocks, copied to the device by the step's entry
            arr = torch.from_numpy(
                np.asarray(video, np.float32).reshape(t, -1))
        for s in range(0, t, frame_block):
            blk = arr[s:s + frame_block]
            valid = int(blk.shape[0])
            if valid < frame_block:
                blk = torch.nn.functional.pad(
                    blk, (0, 0, 0, frame_block - valid))
            yield blk, s, valid

    source = video.blocks() if streamed else array_blocks()
    first = next(source)
    dev = (first[0].device if streamed or isinstance(video, torch.Tensor)
           else torch.device(device))
    if shifts is not None:
        shifts = np.asarray(shifts, np.float32)
        if shifts.shape[1] < 3:
            shifts = np.pad(shifts, ((0, 0), (0, 3 - shifts.shape[1])))
        # On the device once, with zero rows past the end for a padded tail
        # block; each block reads its rows in place.
        shifts = torch.from_numpy(np.pad(
            shifts, ((0, first[0].shape[0]), (0, 0)))).to(dev)
    valids = {}  # valid -> its device scalar, made once per pass

    def blocks():
        for frames, start, valid in itertools.chain([first], source):
            if valid not in valids:
                valids[valid] = torch.full((), valid, dtype=torch.int64,
                                           device=dev)
            sh = (None if shifts is None
                  else shifts[start:start + frames.shape[0]])
            yield frames, valids[valid], sh

    zeros = torch.zeros(p, dtype=torch.float32, device=dev)
    carry = (zeros, zeros, zeros, torch.zeros((3, p), device=dev), zeros,
             torch.full((p,), -torch.inf, device=dev), zeros,
             torch.zeros((), dtype=torch.int64, device=dev))
    carry = graphs.summary_blocks(carry, blocks(), size, clamp=not streamed)

    ref, s1, s2, sxy, sdiff2, vmax, _prev = (c.cpu().numpy()
                                              for c in carry[:7])
    t = float(carry[7])
    # The host finish in float64, term for term as the JAX package's.
    mean_c = (s1 / t).astype(np.float64)  # centred mean E[x - ref]
    mean = ref + mean_c
    var = np.maximum(s2 / t - mean_c * mean_c, 0.0)
    std = np.sqrt(var)

    meanc_v = mean_c.reshape(size)
    std_v = std.reshape(size)
    corr_sum = np.zeros(size, np.float64)
    corr_cnt = np.zeros(size, np.float64)
    for d in range(3):
        exy = sxy[d].reshape(size) / t  # E[x' y'] (centred)
        std_nb = np.roll(std_v, -1, axis=d)
        cov = exy - meanc_v * np.roll(meanc_v, -1, axis=d)
        denom = std_v * std_nb
        c = np.where(denom > 1e-12, cov / np.maximum(denom, 1e-12), 0.0)
        sl = [slice(None)] * 3
        sl[d] = slice(0, size[d] - 1)  # the wrapped last plane is invalid
        sl = tuple(sl)
        corr_sum[sl] += c[sl]
        corr_cnt[sl] += 1.0
        sr = [slice(None)] * 3
        sr[d] = slice(1, size[d])  # the same pair, seen from the +1 side
        corr_sum[tuple(sr)] += c[sl]
        corr_cnt[tuple(sr)] += 1.0
    corr = (corr_sum / np.maximum(corr_cnt, 1.0)).astype(np.float32)

    noise = np.sqrt(np.maximum(sdiff2 / (2.0 * max(t - 1.0, 1.0)), 1e-12))
    pnr = ((vmax - mean) / noise).reshape(size).astype(np.float32)
    pnr = np.where(np.isfinite(pnr), pnr, 0.0)
    return corr, pnr


def detect_peaks_summary(corr: np.ndarray, pnr: np.ndarray, num_peaks: int,
                         min_distance: float = 4.0, min_corr: float = 0.5,
                         min_pnr: float = 2.0, smooth_sigma: float = 1.0
                         ) -> np.ndarray:
    """Top-``num_peaks`` seeds on the ``corr * pnr`` image.

    Candidates are the local maxima of the smoothed score within a
    ``min_distance`` window that clear both thresholds; distance
    suppression runs over that set.  When it falls short, confirmed peaks
    keep their slots and the rest come from weaker tiers: sub-threshold
    maxima with a positive score, then a bounded score-ranked voxel scan
    (degenerate volumes).  Returns ``[K', 3]`` float coordinates,
    score-sorted within tiers, ``K' <= num_peaks``.
    """
    from scipy.ndimage import gaussian_filter, maximum_filter

    score = gaussian_filter(
        np.asarray(corr, np.float64) * np.asarray(pnr, np.float64),
        smooth_sigma)
    w = max(int(np.floor(min_distance)), 1)
    local_max = score >= maximum_filter(score, size=2 * w + 1,
                                        mode="nearest")
    good = local_max & (corr >= min_corr) & (pnr >= min_pnr)

    def ranked(mask):
        cand = np.argwhere(mask)
        order = np.argsort(score[tuple(cand.T)])[::-1]
        return cand[order].astype(np.float64)

    def suppress(chosen, cand):
        for c in cand:
            if len(chosen) == num_peaks:
                break
            if len(chosen) == 0 or (
                    np.linalg.norm(np.asarray(chosen) - c[None], axis=1)
                    >= min_distance).all():
                chosen.append(c)
        return chosen

    chosen = suppress([], ranked(good))
    if len(chosen) < num_peaks:
        # Tier 2: sub-threshold local maxima with a positive score.
        chosen = suppress(chosen, ranked(local_max & ~good & (score > 0)))
    if len(chosen) < num_peaks:
        # Tier 3 (flat or blank score): the best remaining voxels, with a
        # bounded scan.
        flat = np.argsort(score.reshape(-1))[::-1]
        flat = flat[:max(200 * num_peaks, 10_000)]
        cand = np.stack(np.unravel_index(flat, score.shape),
                        axis=1).astype(np.float64)
        chosen = suppress(chosen, cand)
    if not chosen:
        return np.empty((0, 3), np.float64)
    return np.stack(chosen)
