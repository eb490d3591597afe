"""Rigid & piecewise-rigid motion correction (2-D and 3-D): the port of
``dnmf_tpu/registration/motion_correct.py`` (NoRMCorre-style).

* Rigid: FFT phase correlation of each frame against a template, subpixel
  matrix-DFT refinement, Fourier (or Keys cubic) shift application.
* Piecewise-rigid: a static patch grid (strides + overlaps), per-patch
  registration bounded by ``max_deviation_rigid`` around the rigid
  estimate, then either the remap path (cubic upsampling of the patch
  shift field + resampling: ``remap_mode`` ``"exact"``, ``"separable"``
  or ``"fused"``) or the DFT path (per-patch Fourier shifts + feathered
  blending, with the shear guard that switches to hard ownership).
* Template iteration: register chunks -> per-chunk mean templates ->
  NaN-aware median consensus (averaging the middle pair, as numpy).
* ``apply_shifts_points`` / ``template_points_to_frame0``: per-patch
  shifts propagated onto neuron coordinates.

Every per-frame operation of the JAX package runs here on a frame block
``[B, ...spatial]`` at once.  On the piecewise-rigid block path
(:func:`tile_and_correct_block`), ``phasecorr_impl`` picks kernel F
(:mod:`dnmf_tpu_torch.ops.phasecorr`) or the plain per-patch correlation,
and ``remap_mode="fused"`` picks kernel G (:mod:`dnmf_tpu_torch.ops.warp`).
Videos are time-major ``[T, ...spatial]`` and stay on the host (NumPy or
memmap); frame blocks go to the device ``frame_block`` at a time.

A frame block's correction (:func:`rigid_block`, :func:`pwrigid_block`)
and its finite sums (:func:`block_sums`) are one step, which the passes
run through :func:`~dnmf_tpu_torch.models.graphs.rigid_block` and
:func:`~dnmf_tpu_torch.models.graphs.pwrigid_block`: one captured CUDA
graph per block shape and static settings (:data:`RIGID_STATICS`,
:data:`PWRIGID_STATICS`), as the JAX package jits them.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dnmf_tpu_torch.config import RegistrationConfig
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import fft_reg, phasecorr, warp
from dnmf_tpu_torch.ops.basis import device_vector, voxel_grid
from dnmf_tpu_torch.ops.resample import separable_warp, trilinear_resample
from dnmf_tpu_torch.ops.resize import upsample_field


# ----------------------------------------------------------------------
# Patch geometry (static)
# ----------------------------------------------------------------------
def _axis_starts(dim: int, window: int, stride: int) -> List[int]:
    """Patch start offsets along one axis: strided + one flush-end patch."""
    if window >= dim:
        return [0]
    starts = list(range(0, dim - window, stride))
    starts.append(dim - window)
    return starts


def patch_grid(dims, overlaps, strides):
    """``(starts [n_patches, nd] int32, grid_shape, window)``; windows are
    clamped to the axis length."""
    window = tuple(min(o + s, d) for o, s, d in zip(overlaps, strides, dims))
    axes = [_axis_starts(d, w, s) for d, w, s in zip(dims, window, strides)]
    grid_shape = tuple(len(a) for a in axes)
    starts = np.array(list(itertools.product(*axes)), dtype=np.int32)
    return starts, grid_shape, window


def _patch_slices(start, window):
    return (Ellipsis,) + tuple(slice(int(s), int(s) + w)
                               for s, w in zip(start, window))


def _extract_patches(img: torch.Tensor, starts: np.ndarray, window):
    """``[*batch, *dims] -> [*batch, n_patches, *window]``."""
    return torch.stack([img[_patch_slices(s, window)] for s in starts],
                       dim=img.ndim - len(window))


def _blend_patches(patches, weights, starts, window, dims):
    """Feather-blend shifted patches ``[*batch, n_patches, *window]`` back
    into volumes (weights broadcast against them).  NaNs in a patch are
    excluded from both the sum and the weight mass; voxels no patch
    covers are NaN."""
    nd = len(window)
    valid = (~torch.isnan(patches)).to(patches.dtype)
    patches = torch.nan_to_num(patches, nan=0.0)
    weights = weights.expand(patches.shape)
    batch = tuple(patches.shape[:-nd - 1])
    num = torch.zeros(batch + tuple(dims), dtype=patches.dtype,
                      device=patches.device)
    den = torch.zeros_like(num)
    for p, s in enumerate(starts):
        sl = _patch_slices(s, window)
        w = weights.select(-nd - 1, p)
        v = valid.select(-nd - 1, p)
        num[sl] += patches.select(-nd - 1, p) * w * v
        den[sl] += w * v
    blended = num / torch.where(den > 0, den, 1.0)
    return torch.where(den > 0, blended, math.nan)


def _feather_weights(window, overlaps, grid_pos, grid_shape) -> np.ndarray:
    """Linear feathering of patch overlaps (extended to 3-D)."""
    w = np.ones(window, dtype=np.float32)
    for ax, (win, ov, pos, g) in enumerate(
            zip(window, overlaps, grid_pos, grid_shape)):
        prof = np.ones(win, dtype=np.float32)
        if ov > 0:
            if pos > 0:
                prof[:ov] = np.minimum(prof[:ov], np.linspace(0, 1, ov))
            if pos < g - 1:
                prof[-ov:] = np.minimum(prof[-ov:], np.linspace(1, 0, ov))
        shape = [1] * len(window)
        shape[ax] = win
        w = w * prof.reshape(shape)
    return w


@functools.cache  # unbounded: captured graphs read these tensors
def _blend_weights(window, overlaps, grid_shape, dtype, device):
    """``(feather, owner)``, each ``[n_patches, *window]`` on ``device``:
    :func:`_feather_weights` and :func:`_ownership_weights` of every patch
    of the grid, made once per grid."""
    positions = list(itertools.product(*[range(g) for g in grid_shape]))
    return tuple(torch.as_tensor(np.stack([
        weights(window, overlaps, pos, grid_shape) for pos in positions]),
        dtype=dtype, device=device)
        for weights in (_feather_weights, _ownership_weights))


def _ownership_weights(window, overlaps, grid_pos, grid_shape) -> np.ndarray:
    """Hard-stitch weights: each patch owns its interior half-overlap."""
    w = np.ones(window, dtype=np.float32)
    for ax, (win, ov, pos, g) in enumerate(
            zip(window, overlaps, grid_pos, grid_shape)):
        prof = np.ones(win, dtype=np.float32)
        half = ov // 2
        if ov > 0:
            if pos > 0:
                prof[:half] = 0.0
            if pos < g - 1:
                prof[win - (ov - half):] = 0.0
        shape = [1] * len(window)
        shape[ax] = win
        w = w * prof.reshape(shape)
    return w


# ----------------------------------------------------------------------
# 1p high-pass filter
# ----------------------------------------------------------------------
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel-compatible 1-D kernel."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


@functools.cache  # unbounded: captured graphs read these tensors
def _high_pass_kernel(sigma: int, dtype, device) -> torch.Tensor:
    """The mean-subtracted square Gaussian kernel ``[1, 1, k, k]`` of
    ``gSig_filt[0] = sigma``, made once per width, dtype and device."""
    ksize = (3 * sigma) // 2 * 2 + 1
    ker1 = _gaussian_kernel_1d(ksize, sigma)
    ker2d = np.outer(ker1, ker1)
    peak_col = ker2d[:, 0].max()
    nz = ker2d >= peak_col
    ker2d[nz] -= ker2d[nz].mean()
    ker2d[~nz] = 0.0
    return torch.as_tensor(ker2d, dtype=dtype, device=device)[None, None]


def _high_pass(frames: torch.Tensor, gSig_filt) -> torch.Tensor:
    """:func:`high_pass_filter_space` of a block of 2-D frames
    ``[B, M, N]``.  cuDNN convolutions default to TF32: it is off here."""
    if frames.ndim != 3:
        raise ValueError("gSig_filt high-pass filtering is 2-D only "
                         f"(got {frames.ndim - 1}-D frame)")
    x = frames.to(fft_reg._real_dtype(frames))[:, None]
    w = _high_pass_kernel(gSig_filt[0], x.dtype, x.device)
    pad = w.shape[-1] // 2
    x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, w)[:, 0]


def high_pass_filter_space(img: torch.Tensor, gSig_filt) -> torch.Tensor:
    """Mean-subtracted Gaussian kernel filtering of one 2-D image (1p
    data): the square kernel from ``gSig_filt[0]``, reflect padding."""
    if img.ndim != 2:
        raise ValueError("gSig_filt high-pass filtering is 2-D only "
                         f"(got {img.ndim}-D frame)")
    return _high_pass(img[None], gSig_filt)[0]


# ----------------------------------------------------------------------
# Per-block estimation and application
# ----------------------------------------------------------------------
def _register(src, target_freq, lb, ub, upsample_factor, nd):
    """Batched phase correlation of real ``src [*batch, *dims]`` against a
    full template spectrum: ``(shifts [*batch, nd], phasediff [*batch],
    integer shifts [*batch, nd])``."""
    src_freq = torch.fft.fftn(src, dim=fft_reg._dims(nd))
    shifts, ccmax, coarse = fft_reg.correlate(src_freq, target_freq, lb, ub,
                                              upsample_factor, nd)
    return shifts, torch.atan2(ccmax.imag, ccmax.real), coarse


def _pool(x: torch.Tensor, d: int, nd: int) -> torch.Tensor:
    """``d x d`` mean pooling of the first two spatial axes."""
    m, n = x.shape[x.ndim - nd] // d, x.shape[x.ndim - nd + 1] // d
    x = x.narrow(x.ndim - nd, 0, m * d).narrow(x.ndim - nd + 1, 0, n * d)
    lead = tuple(x.shape[:x.ndim - nd])
    rest = tuple(x.shape[x.ndim - nd + 2:])
    y = x.reshape(lead + (m, d, n, d) + rest)
    return y.mean(dim=(len(lead) + 1, len(lead) + 3))


def _rigid_estimate(reg_frames, template, max_shifts, upsample_factor_fft,
                    rigid_decimate):
    """Global rigid shift of each frame of ``[B, *dims]`` (it bounds the
    per-patch search): ``[B, nd]``."""
    nd = template.ndim
    kw = dict(dtype=torch.float32, device=template.device)
    if rigid_decimate > 1:
        # Symmetric decimated window [-m, m]; the clamp restores the
        # |rigid| <= ceil(max_shifts) + 1 bound the warp bases rely on.
        d = int(rigid_decimate)
        dec_ms = tuple(max(1.0, float(ms) / d)
                       for ms in max_shifts[:2]) + tuple(max_shifts[2:])
        lb = device_vector([-m for m in dec_ms], **kw)
        ub = device_vector([m + 1.0 for m in dec_ms], **kw)
        tgt = torch.fft.fftn(_pool(template, d, nd), dim=fft_reg._dims(nd))
        rigid_dec = _register(_pool(reg_frames, d, nd), tgt, lb, ub,
                              upsample_factor_fft, nd)[0]
        scale = device_vector((float(d), float(d)) + (1.0,) * (nd - 2), **kw)
        bound = device_vector([float(np.ceil(ms)) + 1.0 for ms in max_shifts],
                              **kw)
        return torch.minimum(torch.maximum(rigid_dec * scale, -bound), bound)
    m = device_vector(max_shifts, **kw)
    tgt = torch.fft.fftn(template, dim=fft_reg._dims(nd))
    return _register(reg_frames, tgt, -m, m, upsample_factor_fft, nd)[0]


def _apply_remap_field(img, rigid_shts, patch_shifts, grid_shape,
                       remap_mode, max_shifts, max_deviation_rigid):
    """Upsample the patch shift fields and resample each frame of
    ``[B, *dims]`` at ``x + shift(x)`` (``"exact"`` trilinear gather or
    ``"separable"`` passes relative to the frame's rigid shift)."""
    b = img.shape[0]
    dims = tuple(img.shape[1:])
    nd = len(dims)
    fields = [upsample_field(patch_shifts[..., d], grid_shape, dims)
              for d in range(nd)]  # each [B, *dims]
    dims3 = dims if nd == 3 else dims + (1,)
    vol = img.reshape((b,) + dims3)
    zeros = ([torch.zeros((b,) + dims3, dtype=img.dtype, device=img.device)]
             if nd == 2 else [])
    if remap_mode == "separable":
        rb = int(max_deviation_rigid) + 2
        bound = (rb,) * nd + ((0,) if nd == 2 else ())
        base = rigid_shts.to(img.dtype)
        if nd == 2:
            base = torch.cat([base, torch.zeros_like(base[:, :1])], dim=1)
        base_bound = tuple(int(np.ceil(ms)) + 1 for ms in max_shifts[:nd]
                           ) + ((0,) if nd == 2 else ())
        shifts4 = torch.stack([f.reshape((b,) + dims3) for f in fields]
                              + zeros, dim=-1)
        corrected = separable_warp(vol, shifts4, bound, base=base,
                                   base_bound=base_bound)
    elif remap_mode == "exact":
        grid = voxel_grid(dims3, dtype=img.dtype, device=img.device)
        corrected = torch.stack([
            trilinear_resample(vol[i], grid + torch.stack(
                [f[i].reshape(-1) for f in fields]
                + [z[i].reshape(-1) for z in zeros], dim=-1),
                padding="edge")
            for i in range(b)])
    else:
        raise ValueError(f"unknown remap_mode: {remap_mode!r}")
    return corrected.reshape(img.shape)


def rigid_correct_frames(frames, template, max_shifts,
                         upsample_factor: int = 10, border_nan=True,
                         add_to_movie: float = 0.0,
                         apply_mode: str = "fourier"):
    """Rigid-register a block of frames ``[B, ...spatial]`` against a
    template.

    ``apply_mode``: ``"fourier"`` (phase-ramp apply) or ``"cubic"``
    (separable Keys cubic convolution with the ``"min"`` border policy).
    Returns ``(corrected [B, ...], shifts [B, nd])``; ``shifts`` is the
    correction applied.
    """
    if apply_mode not in ("fourier", "cubic"):
        raise ValueError(f"unknown apply_mode: {apply_mode!r}")
    nd = frames.ndim - 1
    template = template + add_to_movie
    tgt = torch.fft.fftn(template.to(fft_reg._real_dtype(template)),
                         dim=fft_reg._dims(nd))
    frames = frames + add_to_movie
    m = device_vector(max_shifts, torch.float32, frames.device)
    shifts, phasediff, _ = _register(frames, tgt, -m, m, upsample_factor,
                                     nd)
    if apply_mode == "cubic":
        corrected = fft_reg.apply_shifts_cubic(frames, -shifts,
                                               border_nan="min")
    else:
        corrected = fft_reg.apply_shifts_fourier(frames, -shifts, phasediff,
                                                 border_nan=border_nan)
    return corrected - add_to_movie, -shifts


def _tile_and_correct_plain(frames, template, strides, overlaps, max_shifts,
                            max_deviation_rigid, upsample_factor_grid,
                            upsample_factor_fft, use_remap, remap_mode,
                            border_nan, add_to_movie, gSig_filt,
                            rigid_decimate, rigid_shifts=None,
                            estimates=False):
    """Piecewise-rigid correction of ``[B, *dims]`` with the plain per-patch
    correlation (the JAX package's per-frame ``tile_and_correct``); the
    last two arguments as :func:`tile_and_correct_block`'s."""
    b = frames.shape[0]
    dims = tuple(frames.shape[1:])
    nd = len(dims)
    img = frames + add_to_movie
    template = template + add_to_movie
    if gSig_filt is not None:
        if not use_remap:
            raise ValueError("gSig_filt with the DFT blending path is "
                             "unsupported (the reference raises here too)")
        reg = _high_pass(img - add_to_movie, gSig_filt) + add_to_movie
    else:
        reg = img

    rigid_shts = (_rigid_estimate(reg, template, max_shifts,
                                  upsample_factor_fft, rigid_decimate)
                  if rigid_shifts is None else rigid_shifts)
    starts, grid_shape, window = patch_grid(dims, overlaps, strides)
    tgt = torch.fft.fftn(_extract_patches(template, starts, window),
                         dim=fft_reg._dims(nd))
    lb = torch.ceil(rigid_shts - max_deviation_rigid)[:, None]
    ub = torch.floor(rigid_shts + max_deviation_rigid)[:, None]
    patch_shifts, patch_phases, coarse = _register(
        _extract_patches(reg, starts, window), tgt, lb, ub,
        upsample_factor_fft, nd)  # [B, NP, nd], [B, NP], [B, NP, nd]
    est = ({"rigid": rigid_shts, "integer": coarse},) if estimates else ()

    if use_remap:
        corrected = _apply_remap_field(img, rigid_shts, patch_shifts,
                                       grid_shape, remap_mode, max_shifts,
                                       max_deviation_rigid)
        return (corrected - add_to_movie, -patch_shifts) + est

    # DFT path: upsampled patch grid, per-patch Fourier shifts, blending.
    new_strides = tuple(int(round(s / upsample_factor_grid))
                        for s in strides)
    new_starts, new_grid_shape, new_window = patch_grid(dims, overlaps,
                                                        new_strides)
    up_shifts = torch.stack([
        upsample_field(patch_shifts[..., d], grid_shape,
                       new_grid_shape).reshape(b, -1)
        for d in range(nd)], dim=-1)  # [B, n_new, nd]
    up_phases = upsample_field(patch_phases, grid_shape,
                               new_grid_shape).reshape(b, -1)
    shifted = fft_reg.apply_shifts_fourier(
        _extract_patches(img, new_starts, new_window), -up_shifts,
        up_phases, border_nan=border_nan)

    # Shear guard: feather vs hard ownership.
    shear_terms = []
    for d in range(nd if nd == 2 else 2):
        f = up_shifts[..., d].reshape((b,) + new_grid_shape)
        for ax in range(len(new_grid_shape)):
            if new_grid_shape[ax] > 1:
                shear_terms.append(
                    torch.diff(f, dim=1 + ax).abs().flatten(1).amax(1))
    max_shear = (torch.quantile(torch.stack(shear_terms, dim=-1), 0.75,
                                dim=-1)
                 if shear_terms else torch.zeros(b, device=img.device))
    feather, owner = _blend_weights(new_window, tuple(overlaps),
                                    new_grid_shape, img.dtype, img.device)
    keep = (max_shear < 0.5).reshape((b,) + (1,) * (nd + 1))
    weights = torch.where(keep, feather, owner)
    corrected = _blend_patches(shifted, weights, new_starts, new_window,
                               dims)
    return (corrected - add_to_movie, -patch_shifts) + est


def tile_and_correct(img, template, strides, overlaps, max_shifts,
                     max_deviation_rigid: int = 3,
                     upsample_factor_grid: int = 4,
                     upsample_factor_fft: int = 10, use_remap: bool = True,
                     remap_mode: str = "exact", border_nan=True,
                     add_to_movie: float = 0.0, gSig_filt=None,
                     rigid_decimate: int = 1):
    """One piecewise-rigid correction of one frame (2-D or 3-D).

    With ``gSig_filt`` (1p data) registration runs on the high-pass
    filtered frame and the shifts apply to the raw one.  ``remap_mode``
    ``"exact"`` (trilinear gather) or ``"separable"`` (three hat-weighted
    passes).  Returns ``(corrected, patch_shifts [n_patches, nd])``, the
    applied corrections on the patch grid.  It runs as a frame block of
    one through :func:`~dnmf_tpu_torch.models.graphs.pwrigid_block` with
    the plain per-patch correlation.
    """
    cfg = RegistrationConfig(
        max_shifts=tuple(max_shifts), strides=tuple(strides),
        overlaps=tuple(overlaps), max_deviation_rigid=max_deviation_rigid,
        upsample_factor_grid=upsample_factor_grid,
        upsample_factor_fft=upsample_factor_fft, use_remap=use_remap,
        remap_mode=remap_mode, border_nan=border_nan, gSig_filt=gSig_filt,
        rigid_decimate=rigid_decimate, phasecorr_impl="xla")
    corrected, shifts, _, _ = graphs.pwrigid_block(
        img[None], template, add_to_movie, cfg, collect=True)
    return corrected[0], shifts[0]


def tile_and_correct_block(frames, template, strides, overlaps, max_shifts,
                           max_deviation_rigid: int = 3,
                           upsample_factor_grid: int = 4,
                           upsample_factor_fft: int = 10,
                           use_remap: bool = True, remap_mode: str = "exact",
                           border_nan=True, add_to_movie: float = 0.0,
                           gSig_filt=None, rigid_decimate: int = 1,
                           phasecorr_impl: str = "auto",
                           dft_precision: str = "high", rigid_shifts=None,
                           estimates: bool = False):
    """Piecewise-rigid correction of a ``[B, ...spatial]`` frame block.

    ``phasecorr_impl``: ``"fused"`` runs the per-patch correlation of the
    whole ``[B, n_patches]`` grid as kernel F (its plain version on CPU
    tensors), ``"xla"`` the plain per-patch correlation, ``"auto"`` kernel
    F for 3-D remap blocks on CUDA tensors.  On the fused path,
    ``remap_mode="fused"`` applies the field with kernel G; elsewhere it
    means ``"separable"``.  ``dft_precision`` changes nothing on the card
    (float32 FMA throughout).  Returns ``(corrected, patch_shifts
    [B, n_patches, nd])``.

    For checking a run: ``rigid_shifts [B, nd]`` stands in for the rigid
    estimate (to redo a block's piecewise-rigid estimation from a given
    one, in float64 say), and ``estimates=True`` adds a third value,
    ``{"rigid": [B, nd], "integer": [B, n_patches, nd]}``: the rigid
    estimate and the integer patch shifts before the subpixel refinement
    (estimates, the negated corrections).
    """
    dims = tuple(frames.shape[1:])
    nd = len(dims)
    impl = phasecorr_impl
    if impl == "auto":
        impl = ("fused" if nd == 3 and use_remap
                and frames.device.type == "cuda" else "xla")
    if impl != "fused" or not use_remap:
        frame_remap = "separable" if remap_mode == "fused" else remap_mode
        return _tile_and_correct_plain(
            frames, template, strides, overlaps, max_shifts,
            max_deviation_rigid, upsample_factor_grid, upsample_factor_fft,
            use_remap, frame_remap, border_nan, add_to_movie, gSig_filt,
            rigid_decimate, rigid_shifts, estimates)
    if nd != 3:
        raise ValueError("fused phase correlation is 3-D only")
    if gSig_filt is not None:
        raise ValueError("gSig_filt high-pass filtering is 2-D only "
                         "(got 3-D frames on the fused path)")
    frames = frames + add_to_movie
    template = template + add_to_movie
    rigid_shts = (_rigid_estimate(frames, template, max_shifts,
                                  upsample_factor_fft, rigid_decimate)
                  if rigid_shifts is None else rigid_shifts)
    starts, grid_shape, window = patch_grid(dims, overlaps, strides)
    wm, wn, wz = window
    tre, tim = phasecorr.patch_spectra(_extract_patches(template, starts,
                                                        window))
    pats = phasecorr.to_zm_n(_extract_patches(frames, starts, window))
    lb = torch.ceil(rigid_shts - max_deviation_rigid)
    ub = torch.floor(rigid_shts + max_deviation_rigid)
    bounds = torch.cat([lb, ub, torch.zeros_like(lb[:, :2])], dim=1)
    # ub - lb <= 2 max_deviation_rigid bounds every axis's candidates.
    cap = max(1, int(math.floor(2 * max_deviation_rigid)))
    sh_int, pre, pim = phasecorr.phase_corr_block(
        pats, tre, tim, bounds.float(), z=wz, precision=dft_precision,
        max_window=(cap, cap, cap))
    if upsample_factor_fft > 1:
        prod = torch.complex(pre, pim).reshape(pre.shape[:2] + (wz, wm, wn))
        patch_shifts, _ = fft_reg.subpixel_refine(
            prod, sh_int, upsample_factor_fft, window, prod_layout=(2, 0, 1))
    else:
        patch_shifts = sh_int
    # Singleton axes carry no shift information.
    sizes = fft_reg.shape_vectors(window, patch_shifts.dtype,
                                  patch_shifts.device)[1]
    patch_shifts = torch.where(sizes == 1, 0.0, patch_shifts)
    if remap_mode == "fused":
        corrected = warp.fused_separable_warp(
            frames, patch_shifts, rigid_shts, grid_shape, dims, max_shifts,
            max_deviation_rigid)
    else:
        corrected = _apply_remap_field(frames, rigid_shts, patch_shifts,
                                       grid_shape, remap_mode, max_shifts,
                                       max_deviation_rigid)
    est = ({"rigid": rigid_shts, "integer": sh_int},) if estimates else ()
    return (corrected - add_to_movie, -patch_shifts) + est


# The settings that a frame block's correction reads: with the block's
# shape, what the JAX package's jit takes as static (``static_argnames``);
# models/graphs.py keys its entries by them.
RIGID_STATICS = ("max_shifts", "upsample_factor_fft", "border_nan",
                 "gSig_filt")
PWRIGID_STATICS = ("strides", "overlaps", "max_shifts", "max_deviation_rigid",
                   "upsample_factor_grid", "upsample_factor_fft", "use_remap",
                   "remap_mode", "border_nan", "gSig_filt", "phasecorr_impl",
                   "dft_precision", "rigid_decimate")


def rigid_block(frames, template, cfg: RegistrationConfig,
                add_to_movie=0.0):
    """:func:`rigid_correct_frames` of a frame block with ``cfg``'s
    settings, as the rigid pass runs it: with ``cfg.gSig_filt`` (1p data)
    the shifts come from the high-passed frames and apply to the raw ones.
    Returns ``(corrected, shifts [B, nd])``."""
    kw = dict(upsample_factor=cfg.upsample_factor_fft,
              border_nan=cfg.border_nan, add_to_movie=add_to_movie)
    if cfg.gSig_filt is None:
        return rigid_correct_frames(frames, template, cfg.max_shifts, **kw)
    shifts = rigid_correct_frames(_high_pass(frames, cfg.gSig_filt),
                                  template, cfg.max_shifts, **kw)[1]
    corrected = fft_reg.apply_shifts_fourier(frames, shifts, 0.0,
                                             border_nan=cfg.border_nan)
    return corrected, shifts


def block_sums(corrected: torch.Tensor):
    """``(sum, count)`` over the frames of a corrected block, per voxel, of
    its finite values: the parts of a chunk template."""
    finite = torch.isfinite(corrected)
    return torch.where(finite, corrected, 0.0).sum(dim=0), finite.sum(dim=0)


def pwrigid_block(frames, template, cfg: RegistrationConfig,
                  add_to_movie=0.0, **kwargs):
    """:func:`tile_and_correct_block` of a frame block with ``cfg``'s
    settings, as the piecewise-rigid pass runs it; ``kwargs``
    (``rigid_shifts``, ``estimates``) go to it as well."""
    nd = frames.ndim - 1
    return tile_and_correct_block(
        frames, template, tuple(cfg.strides[:nd]), tuple(cfg.overlaps[:nd]),
        cfg.max_shifts, max_deviation_rigid=cfg.max_deviation_rigid,
        upsample_factor_grid=cfg.upsample_factor_grid,
        upsample_factor_fft=cfg.upsample_factor_fft,
        use_remap=cfg.use_remap, remap_mode=cfg.remap_mode,
        border_nan=cfg.border_nan, add_to_movie=add_to_movie,
        gSig_filt=cfg.gSig_filt, phasecorr_impl=cfg.phasecorr_impl,
        dft_precision=cfg.dft_precision, rigid_decimate=cfg.rigid_decimate,
        **kwargs)


# ----------------------------------------------------------------------
# Batch template iteration + user-facing class
# ----------------------------------------------------------------------
class MotionCorrect:
    """Motion correction with the reference's API surface.

    Args:
      video: ``[T, M, N]`` or ``[T, M, N, Z]`` array (or a list of them),
        kept on the host; NumPy arrays and memmaps are read as they are.
      config: RegistrationConfig (``is3d`` inferred from the video rank).
      device: where the frame blocks are registered.  The default is the
        CUDA device; pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, video, config: Optional[RegistrationConfig] = None,
                 device="cuda", **overrides):
        if not isinstance(video, (list, tuple)):
            video = [video]
        self.video = [_host_video(v) for v in video]
        self.device = torch.device(device)
        cfg = config or RegistrationConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        nd = self.video[0].ndim - 1
        if nd == 3 and not cfg.is3d:
            cfg = dataclasses.replace(cfg, is3d=True)
        if len(cfg.max_shifts) != nd:
            cfg = dataclasses.replace(
                cfg, max_shifts=tuple(cfg.max_shifts)
                + (1,) * (nd - len(cfg.max_shifts)))
        # 3-D inputs default to one full-depth patch along z.
        if len(cfg.strides) < nd:
            z_dim = int(self.video[0].shape[3])
            cfg = dataclasses.replace(
                cfg,
                strides=tuple(cfg.strides) + (z_dim,) * (
                    nd - len(cfg.strides)),
                overlaps=tuple(cfg.overlaps) + (0,) * (
                    nd - len(cfg.overlaps)))
        self.config = cfg
        self.min_mov = cfg.min_mov

    # -- public API ----------------------------------------------------
    def motion_correct(self, template=None):
        """Rigid or pw-rigid correction per ``config.pw_rigid``; computes
        ``border_to_0`` from the largest applied shift."""
        if self.min_mov is None:
            # Registration of high-passed (zero-mean) frames needs no
            # offset; otherwise the full-movie min, streamed.
            self.min_mov = (_streamed_min(self.video[0])
                            if self.config.gSig_filt is None else 0.0)
        if self.config.pw_rigid:
            self.motion_correct_pwrigid(template=template)
            shift_mats = [np.abs(np.asarray(s)) for s in
                          (self.x_shifts_els, self.y_shifts_els)]
            if self.config.is3d:
                shift_mats.append(np.abs(np.asarray(self.z_shifts_els)))
            b0 = np.ceil(max(s.max() for s in shift_mats))
        else:
            self.motion_correct_rigid(template=template)
            b0 = np.ceil(np.max(np.abs(np.asarray(self.shifts_rig))))
        self.border_to_0 = int(b0)
        return self

    def _template(self, template):
        if template is None:
            return None
        if isinstance(template, torch.Tensor):
            return template.to(self.device, torch.float32)
        return torch.tensor(np.asarray(template, dtype=np.float32),
                            device=self.device)

    def motion_correct_rigid(self, template=None) -> None:
        self.total_template_rig = self._template(template)
        self.templates_rig: List = []
        self.shifts_rig: List = []
        self.mc: List = []
        for vid in self.video:
            tot, templates, shifts, mc = _batch_rigid(
                vid, self.config, self.device,
                template=self.total_template_rig,
                add_to_movie=-self.min_mov)
            if template is None:
                self.total_template_rig = tot
            self.templates_rig += templates
            self.shifts_rig += list(shifts)
            self.mc.append(mc)

    def motion_correct_pwrigid(self, template=None) -> None:
        if template is None:
            self.motion_correct_rigid()
            template = self.total_template_rig
        self.total_template_els = self._template(template)
        self.templates_els: List = []
        self.x_shifts_els: List = []
        self.y_shifts_els: List = []
        self.z_shifts_els: List = []
        self.coord_shifts_els: List = []
        self.mc_els: List = []
        for vid in self.video:
            (tot, templates, xs, ys, zs, coords, mc) = _batch_pwrigid(
                vid, self.config, self.device,
                template=self.total_template_els,
                add_to_movie=-self.min_mov)
            if bool(torch.isnan(tot.sum())):
                raise Exception("Template contains NaNs, something went "
                                "wrong. Reconsider the parameters")
            self.total_template_els = tot
            self.templates_els += templates
            self.x_shifts_els += xs
            self.y_shifts_els += ys
            self.z_shifts_els += zs
            self.coord_shifts_els += coords
            self.mc_els.append(mc)

    # -- shift propagation onto points ----------------------------------
    def _patch_centers(self):
        dims = self.video[0].shape[1:]
        starts, _, _ = patch_grid(dims, self.config.overlaps,
                                  self.config.strides)
        return starts + np.asarray(self.config.strides) / 2.0

    def apply_shifts_frame(self, points: np.ndarray, t: int) -> np.ndarray:
        """Forward-apply frame ``t``'s patch shifts to points."""
        centers = self._patch_centers()
        points = np.asarray(points, dtype=np.float64)
        d = np.linalg.norm(centers[:, None, :] - points[None, :, :], axis=-1)
        nearest = d.argmin(0)
        out = points.copy()
        out[:, 0] += np.asarray(self.x_shifts_els)[t][nearest]
        out[:, 1] += np.asarray(self.y_shifts_els)[t][nearest]
        if self.config.is3d:
            out[:, 2] += np.asarray(self.z_shifts_els)[t][nearest]
        return out

    def apply_shifts_points(self, points: np.ndarray) -> np.ndarray:
        """Per-frame neuron positions ``[K, 3, T]`` from the patch shifts
        (the reference's per-axis signs, including the opposite z sign)."""
        centers = self._patch_centers()
        points = np.asarray(points, dtype=np.float64)
        d = np.linalg.norm(
            centers[:, None, :points.shape[1]] - points[None, :, :], axis=-1)
        nearest = d.argmin(0)
        xs = np.asarray(self.x_shifts_els)
        ys = np.asarray(self.y_shifts_els)
        t_frames = xs.shape[0]
        p_t = np.zeros((points.shape[0], points.shape[1], t_frames))
        for t in range(t_frames):
            p_t[:, :, t] = points
            p_t[:, 0, t] += -xs[t][nearest] + xs[0][nearest]
            p_t[:, 1, t] += -ys[t][nearest] + ys[0][nearest]
            if self.config.is3d and points.shape[1] > 2:
                zs = np.asarray(self.z_shifts_els)
                p_t[:, 2, t] += zs[t][nearest] - zs[0][nearest]
        return p_t

    def template_points_to_frame0(self, points: np.ndarray) -> np.ndarray:
        """Template-space coordinates -> the frame-0 coordinates
        :meth:`apply_shifts_points` expects (removes the frame-0
        correction, opposite sign on z)."""
        points = np.array(points, dtype=np.float64, copy=True)
        if self.config.pw_rigid:
            centers = self._patch_centers()
            d = np.linalg.norm(
                centers[:, None, :points.shape[1]] - points[None], axis=-1)
            nearest = d.argmin(0)
            points[:, 0] -= np.asarray(self.x_shifts_els)[0][nearest]
            points[:, 1] -= np.asarray(self.y_shifts_els)[0][nearest]
            if self.config.is3d and points.shape[1] > 2:
                points[:, 2] += np.asarray(self.z_shifts_els)[0][nearest]
        else:
            s0 = np.asarray(self.shifts_rig)[0]
            points[:, :s0.shape[0]] -= s0[None, :points.shape[1]]
        return points

    def get_params(self) -> dict:
        cfg = self.config
        return {
            "max_shifts": cfg.max_shifts, "niter_rig": cfg.niter_rig,
            "niter_els": cfg.niter_els,
            "splits_rig": cfg.resolved_splits("rig"),
            "strides": cfg.strides, "overlaps": cfg.overlaps,
            "splits_els": cfg.resolved_splits("els"),
            "num_splits_to_process_rig":
                cfg.resolved_num_splits_to_process("rig"),
            "num_splits_to_process_els":
                cfg.resolved_num_splits_to_process("els"),
            "upsample_factor_grid": cfg.upsample_factor_grid,
            "max_deviation_rigid": cfg.max_deviation_rigid,
            "min_mov": self.min_mov, "border_nan": cfg.border_nan,
            "pw_rigid": cfg.pw_rigid, "is3D": cfg.is3d,
            "total_template_rig": getattr(self, "total_template_rig", None),
            "templates_rig": getattr(self, "templates_rig", []),
            "shifts_rig": getattr(self, "shifts_rig", []),
            "total_template_els": getattr(self, "total_template_els", None),
            "templates_els": getattr(self, "templates_els", []),
            "x_shifts_els": getattr(self, "x_shifts_els", []),
            "y_shifts_els": getattr(self, "y_shifts_els", []),
            "z_shifts_els": getattr(self, "z_shifts_els", []),
        }


# ----------------------------------------------------------------------
# Streamed batch loops: device memory is bounded by frame_block x frame
# size; the video stays on the host and the corrected movie (when kept)
# accumulates there.
# ----------------------------------------------------------------------
def _host_video(v):
    """NumPy arrays, memmaps and read views (``.shape`` + ``__getitem__``)
    pass through; tensors and sequences become float32 NumPy."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    if isinstance(v, np.ndarray) or (hasattr(v, "shape")
                                     and hasattr(v, "__getitem__")):
        return v
    return np.asarray(v, dtype=np.float32)


def _chunk_indices(t: int, splits: int):
    return np.array_split(np.arange(t), splits)


def _host_frames(video, idx) -> np.ndarray:
    """Host-side float32 frame gather (NumPy, memmap or read views); a
    run of consecutive frames is read as a slice, without a copy."""
    idx = np.asarray(idx)
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return np.asarray(video[int(idx[0]):int(idx[0]) + idx.size],
                          dtype=np.float32)
    return np.asarray(video[idx], dtype=np.float32)


def _host_tensor(frames: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(frames))


def _streamed_min(video, block: int = 256) -> float:
    """Min over the whole movie, one host frame block at a time."""
    lo = np.inf
    for i in range(0, video.shape[0], block):
        lo = min(lo, float(np.min(np.asarray(video[i:i + block]))))
    return float(lo)


def _streamed_bin_median(video, device, gSig_filt=None,
                         max_frames=None) -> torch.Tensor:
    """Template init: median over window-binned means, streamed (frame
    ``w * nw + n`` goes to window n, as ``fft_reg.bin_median``); at most
    ``window`` frames on the device at a time.  ``max_frames`` caps the
    frames read (None = all).  The median of the window means is taken
    on the device (``fft_reg.nanmedian``, numpy's even-count rule)."""
    t = video.shape[0] if max_frames is None else min(video.shape[0],
                                                      max_frames)
    window = min(10, t)
    num_windows = t // window
    means = []
    for n in range(num_windows):
        idx = np.arange(n, n + window * num_windows, num_windows)
        frames = _host_tensor(_host_frames(video, idx)).to(device)
        if gSig_filt is not None:
            frames = _high_pass(frames, gSig_filt)
        means.append(torch.nanmean(frames, dim=0))
    return fft_reg.nanmedian(torch.stack(means), dim=0)


def _iteration_chunks(chunks, cfg: RegistrationConfig, is_last: bool,
                      phase: str = "rig"):
    """Chunks of one template iteration: all on the final iteration,
    otherwise an evenly spaced subset of ``num_splits_to_process``."""
    n = cfg.resolved_num_splits_to_process(phase)
    if is_last or n is None or n >= len(chunks):
        return chunks
    sel = np.linspace(0, len(chunks) - 1, n).round().astype(int)
    return [chunks[i] for i in sorted(set(sel.tolist()))]


def _stream_chunk(video, idx, cfg: RegistrationConfig, block,
                  collect: bool):
    """Register one chunk in frame blocks.

    ``block(frames [B, ...] on the host, collect) -> (corrected [B, ...]
    or None without collect, shifts, finite sum, finite count)``.
    Returns ``(chunk_template, shifts [len(idx), ...], corrected on the
    host or None)``.
    """
    fb = max(1, cfg.frame_block)
    sum_img = cnt_img = None
    shifts_out = []
    mc = (np.empty((len(idx),) + tuple(video.shape[1:]), np.float32)
          if collect else None)
    for i in range(0, len(idx), fb):
        frames = _host_tensor(_host_frames(video, idx[i:i + fb]))
        corrected, shifts, s, c = block(frames, collect)
        sum_img = s if sum_img is None else sum_img + s
        cnt_img = c if cnt_img is None else cnt_img + c
        shifts_out.append(shifts.cpu().numpy())
        if collect:  # straight into the host movie, no staging copy
            torch.from_numpy(mc[i:i + len(frames)]).copy_(corrected)
    chunk_t = sum_img / torch.clamp_min(cnt_img, 1)
    chunk_t = torch.where(cnt_img > 0, chunk_t, math.nan)
    finite_vals = chunk_t[~torch.isnan(chunk_t)]
    fill = float(finite_vals.min()) if finite_vals.numel() else math.nan
    chunk_t = torch.nan_to_num(chunk_t, nan=fill)
    return chunk_t, np.concatenate(shifts_out), mc


def _iterate_templates(video, cfg, template, phase, num_iter, block_factory):
    """Template iteration shared by the rigid and pw-rigid passes:
    register the chunks, then the NaN-aware median of the chunk templates
    (high-passed again for 1p data).  ``block_factory(template)`` gives
    the block function of :func:`_stream_chunk`.  Returns ``(template,
    chunk templates, shifts, corrected movie or None)``."""
    new_templ = template
    chunks = _chunk_indices(video.shape[0], cfg.resolved_splits(phase))
    for it in range(num_iter):
        is_last = it == num_iter - 1
        chunk_templates, all_shifts, all_mc = [], [], []
        block = block_factory(new_templ)
        for idx in _iteration_chunks(chunks, cfg, is_last, phase=phase):
            chunk_t, shifts, mc = _stream_chunk(
                video, idx, cfg, block, collect=is_last and cfg.return_mc)
            chunk_templates.append(chunk_t)
            all_shifts.append(shifts)
            if mc is not None:
                all_mc.append(mc)
        new_templ = fft_reg.nanmedian(torch.stack(chunk_templates), dim=0)
        if cfg.gSig_filt is not None:
            new_templ = _high_pass(new_templ[None], cfg.gSig_filt)[0]
    shifts = np.concatenate(all_shifts)
    mc = (None if not all_mc else all_mc[0] if len(all_mc) == 1
          else np.concatenate(all_mc))
    return (new_templ, [t.cpu().numpy() for t in chunk_templates], shifts,
            mc)


def _batch_rigid(video, cfg: RegistrationConfig, device, template=None,
                 add_to_movie=0.0):
    """Template-iterated rigid registration, streamed in frame blocks."""
    if template is None:
        template = _streamed_bin_median(
            video, device, cfg.gSig_filt,
            max_frames=cfg.template_init_max_frames)
    if math.isnan(add_to_movie):
        raise Exception("The movie contains NaNs. NaNs are not allowed!")
    add = _offset(add_to_movie, device)

    def block_factory(templ):
        return lambda frames, collect: graphs.rigid_block(
            frames, templ, add, cfg, collect)

    return _iterate_templates(video, cfg, template, "rig",
                              max(cfg.niter_rig, 1), block_factory)


def _offset(add_to_movie: float, device) -> torch.Tensor:
    """``add_to_movie`` as a device scalar, made once per pass: an input
    of the block steps, as JAX traces it."""
    return torch.full((), float(add_to_movie), dtype=torch.float32,
                      device=device)


def _batch_pwrigid(video, cfg: RegistrationConfig, device, template,
                   add_to_movie=0.0):
    """Template-iterated pw-rigid registration, streamed in frame blocks
    (the elastic phase runs ``niter_els`` iterations, 1 by default)."""
    if template is None:
        raise Exception("You need to initialize the template with a good "
                        "estimate. See the motion_correct_batch_rigid "
                        "function")
    if math.isnan(add_to_movie):
        raise Exception("The template contains NaNs. NaNs are not allowed!")
    dims = video.shape[1:]
    nd = len(dims)
    starts, _, _ = patch_grid(dims, tuple(cfg.overlaps[:nd]),
                              tuple(cfg.strides[:nd]))

    add = _offset(add_to_movie, device)

    def block_factory(templ):
        return lambda frames, collect: graphs.pwrigid_block(
            frames, templ, add, cfg, collect)

    new_templ, templates, shifts, mc = _iterate_templates(
        video, cfg, template, "els", max(cfg.niter_els, 1), block_factory)
    xs = [shifts[t, :, 0] for t in range(shifts.shape[0])]
    ys = [shifts[t, :, 1] for t in range(shifts.shape[0])]
    zs = ([shifts[t, :, 2] for t in range(shifts.shape[0])] if nd == 3
          else [np.zeros(shifts.shape[1])] * shifts.shape[0])
    coords = [starts] * shifts.shape[0]
    return new_templ, templates, xs, ys, zs, coords, mc
