"""FFT phase-correlation registration primitives (2-D and 3-D) on
``torch.fft`` (cuFFT on the card).

The port of ``dnmf_tpu/ops/fft_reg.py``:

* integer shift from the argmax of the FFT cross-correlation, restricted
  to a shift window given as a mask over *signed wrapped indices*
  (``np.fix(n/2)`` midpoints, first-occurrence argmax);
* subpixel refinement by the Guizar-Sicairos matrix-multiply DFT on an
  ``upsample_factor``-fine grid around the integer peak;
* shift application by a Fourier phase ramp (:func:`apply_shifts_fourier`)
  or separable Keys cubic convolution (:func:`apply_shifts_cubic`), with
  the reference's border policies.

The JAX package evaluates patch-sized transforms as MXU matrix products
in permuted layouts to work around the TPU's FFT; the port computes every
spectrum with ``fftn`` in the standard layout, so ``fft_impl``,
``use_rfft`` and ``dft_precision`` are accepted and change nothing.  A
spectrum passed with ``target_is_freq`` or ``space="fourier"`` is the full
``fftn`` spectrum.

The internal helpers (:func:`correlate`, :func:`subpixel_refine`,
:func:`apply_shifts_fourier`, :func:`apply_shifts_cubic`) take leading
batch dimensions, so that a block of frames x patches is one set of
transforms and products.  Inputs keep their floating dtype: float64 in
gives the float64 oracle.

The constants of the transforms (frequency indices, axis lengths) are
made once per length, dtype and device and kept: after the first call
nothing here makes a tensor from host data, so a step that uses these
functions can be captured as a CUDA graph
(:mod:`dnmf_tpu_torch.models.graphs`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dnmf_tpu_torch.ops.basis import device_vector


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    if x.is_complex():
        return x.real.dtype
    return x.dtype if x.dtype == torch.float64 else torch.float32


def _dims(nd: int) -> Tuple[int, ...]:
    return tuple(range(-nd, 0))


def _axis_view(v: torch.Tensor, d: int, nd: int) -> torch.Tensor:
    """``[*batch, n]`` -> ``[*batch, 1.., n, ..1]`` along spatial axis d."""
    return v.reshape(v.shape[:-1] + (1,) * d + (v.shape[-1],)
                     + (1,) * (nd - d - 1))


def _spatial_view(v: torch.Tensor, nd: int) -> torch.Tensor:
    """``[*batch]`` -> ``[*batch, 1, ..., 1]`` (nd trailing singletons)."""
    return v.reshape(v.shape + (1,) * nd)


def _take_axis(x: torch.Tensor, idx: torch.Tensor, d: int,
               nd: int) -> torch.Tensor:
    """``x`` gathered along spatial axis ``d`` at ``idx [*batch, n_out]``
    (per batch element; no batch dimensions = shared)."""
    ax = x.ndim - nd + d
    index = _axis_view(idx, d, nd)
    shape = list(x.shape)
    shape[ax] = idx.shape[-1]
    return torch.gather(x, ax, index.expand(shape))


def _nanreduce(x: torch.Tensor, nd: int, largest: bool) -> torch.Tensor:
    """Per-batch ``nanmin`` / ``nanmax`` over the last ``nd`` axes (NaN
    where every value is NaN, as ``jnp.nanmin``)."""
    nan = torch.isnan(x)
    fill = -math.inf if largest else math.inf
    flat = x.masked_fill(nan, fill).flatten(-nd)
    out = flat.amax(-1) if largest else flat.amin(-1)
    return torch.where(nan.flatten(-nd).all(-1),
                       torch.full_like(out, math.nan), out)


def nanmedian(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """NaN-aware median that averages the two middle values of an even
    count, as ``np.nanmedian`` / ``jnp.nanmedian`` do
    (``torch.nanmedian`` returns the lower one).  All-NaN -> NaN."""
    srt = torch.sort(x, dim=dim).values  # NaNs sort last
    cnt = (~torch.isnan(x)).sum(dim=dim, keepdim=True)
    lo = torch.gather(srt, dim, ((cnt - 1).clamp_min(0)) // 2)
    hi = torch.gather(srt, dim, cnt // 2)
    med = ((lo + hi) / 2).squeeze(dim)
    return torch.where(cnt.squeeze(dim) > 0, med,
                       torch.full_like(med, math.nan))


# Unbounded: a captured graph reads these tensors at their addresses, so
# none may be dropped while the process runs (a few per array shape).
@functools.cache
def _signed_freq_index(n: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """``[n]`` signed wrapped indices: 0, 1, ..., mid, -(n-mid-1), ..., -1
    (index ``i`` is shift ``i`` if ``i <= fix(n/2)`` else ``i - n``)."""
    idx = np.arange(n)
    mid = np.fix(n / 2.0)
    return torch.as_tensor(np.where(idx > mid, idx - n, idx), dtype=dtype,
                           device=device)


@functools.cache
def _centred_freqs(n: int, dtype, device) -> torch.Tensor:
    """``[n]`` ``ifftshift(arange(n)) - floor(n / 2)``: the DFT frequency
    of each index, ``fftfreq(n) * n``."""
    return torch.as_tensor(np.fft.ifftshift(np.arange(n)) - np.floor(n / 2.0),
                           dtype=dtype, device=device)


@functools.cache
def _ramp_freqs(n: int, half: bool, dtype, device) -> torch.Tensor:
    """The frequencies of a phase ramp along an axis of length ``n``: the
    ``n // 2 + 1`` of an ``rfftn`` last axis (``half``), else the full
    ``ifftshift`` order."""
    freqs = (np.arange(n // 2 + 1) if half
             else np.fft.ifftshift(np.arange(-np.fix(n / 2.0),
                                             np.ceil(n / 2.0))))
    return torch.as_tensor(freqs, dtype=dtype, device=device)


@functools.cache
def shape_vectors(shape: tuple, dtype, device):
    """``(mid, sizes)``, each ``[nd]``: ``fix(n / 2)`` and ``n`` per axis
    of ``shape``."""
    return (torch.as_tensor([np.fix(s / 2.0) for s in shape], dtype=dtype,
                            device=device),
            torch.as_tensor(shape, dtype=dtype, device=device))


def _last_axis(x: torch.Tensor, order) -> torch.Tensor:
    """``x[..., order]`` for a static ``order``, without an index tensor
    made from host data."""
    return torch.stack([x[..., i] for i in order], dim=-1)


def _shift_window_mask(shape, lb: torch.Tensor,
                       ub: torch.Tensor) -> torch.Tensor:
    """Mask keeping signed shifts in ``[lb_d, ub_d - 1]`` per dim.

    ``lb``, ``ub``: ``[*batch, nd]``; returns ``[*batch, *shape]`` bool.
    """
    nd = len(shape)
    mask = None
    for d, n in enumerate(shape):
        s = _signed_freq_index(n, lb.dtype, lb.device)
        keep = (s >= lb[..., d:d + 1]) & (s <= ub[..., d:d + 1] - 1)
        keep = _axis_view(keep, d, nd)
        mask = keep if mask is None else (mask & keep)
    return mask


def _unravel(flat: torch.Tensor, shape) -> torch.Tensor:
    """Flat indices -> ``[..., nd]`` coordinates (row-major)."""
    coords = []
    for n in reversed(shape):
        coords.append(flat % n)
        flat = flat // n
    return torch.stack(coords[::-1], dim=-1)


def _upsampled_dft(data: torch.Tensor, region_size: int,
                   upsample_factor: int,
                   axis_offsets: torch.Tensor) -> torch.Tensor:
    """Matrix-multiply DFT of ``data`` on an upsampled sub-region.

    Evaluates the inverse DFT of the frequency-domain ``data [*batch,
    *shape]`` at ``region_size`` points per axis spaced
    ``1/upsample_factor`` apart, starting at ``axis_offsets [*batch, nd]``;
    returns ``[*batch, region_size, ..., region_size]``.  Axes contract
    last to first, each as one batched matrix product (``nd >= 2``).
    """
    nd = axis_offsets.shape[-1]
    batch = axis_offsets.shape[:-1]
    rdt = axis_offsets.dtype
    out = data
    for d in range(nd - 1, -1, -1):
        n = data.shape[data.ndim - nd + d]
        freqs = _centred_freqs(n, rdt, data.device)
        pts = (torch.arange(region_size, dtype=rdt, device=data.device)
               - axis_offsets[..., d:d + 1])  # [*batch, R]
        ang = (-2.0 * math.pi / (n * upsample_factor)) * (
            pts[..., :, None] * freqs)  # [*batch, R, n]
        kern = torch.polar(torch.ones_like(ang), ang).transpose(-1, -2)
        kern = kern.reshape(batch + (1,) * (nd - 2) + (n, region_size))
        ax = out.ndim - nd + d
        out = torch.matmul(out.movedim(ax, -1), kern).movedim(-1, ax)
    return out


def subpixel_refine(image_product: torch.Tensor, shifts: torch.Tensor,
                    upsample_factor: int, shape, prod_layout=None):
    """Refine integer ``shifts [*batch, nd]`` to ``1/upsample_factor``
    resolution around the coarse peak (Guizar-Sicairos).

    ``image_product [*batch, *spatial]``: full cross-power spectra whose
    axes map to the dims of ``shape`` via ``prod_layout`` (data axis ``d``
    holds shape dim ``prod_layout[d]``; None = identity).  Returns
    ``(shifts, ccmax)``: refined shifts and the complex correlation at the
    refined peak.
    """
    nd = len(shape)
    usf = int(upsample_factor)
    shifts = torch.round(shifts * usf) / usf
    region_size = int(np.ceil(usf * 1.5))
    dftshift = float(np.fix(region_size / 2.0))
    offset = dftshift - shifts * usf
    if prod_layout is not None:
        offset = _last_axis(offset, prod_layout)
    cc_up = torch.conj(_upsampled_dft(
        torch.conj(image_product), region_size, usf, offset)) / (
        float(np.prod(shape)) * usf ** 2)
    flat = cc_up.flatten(-nd)
    up_idx = torch.argmax(flat.abs(), dim=-1)  # first occurrence
    coords = _unravel(up_idx, (region_size,) * nd).to(shifts.dtype)
    if prod_layout is not None:
        coords = _last_axis(coords, [prod_layout.index(d) for d in range(nd)])
    shifts = shifts + (coords - dftshift) / usf
    ccmax = torch.gather(flat, -1, up_idx[..., None])[..., 0]
    return shifts, ccmax


def correlate(src_freq: torch.Tensor, target_freq: torch.Tensor,
              lb: torch.Tensor, ub: torch.Tensor, upsample_factor: int,
              nd: int):
    """Batched phase correlation of full spectra ``[*batch, *shape]``
    within the window ``[lb, ub - 1]`` (``[*batch, nd]``, broadcast).

    Returns ``(shifts [*batch, nd], ccmax [*batch], integer shifts
    [*batch, nd])``, the last before the subpixel refinement.
    """
    shape = tuple(src_freq.shape[-nd:])
    product = src_freq * torch.conj(target_freq)
    cross = torch.fft.ifftn(product, dim=_dims(nd))
    mag = torch.where(_shift_window_mask(shape, lb, ub), cross.abs(), 0.0)
    flat_cc = cross.flatten(-nd)
    flat_idx = torch.argmax(mag.flatten(-nd), dim=-1)  # first occurrence
    rdt = mag.dtype
    maxima = _unravel(flat_idx, shape).to(rdt)
    mid, sizes = shape_vectors(shape, rdt, mag.device)
    shifts = torch.where(maxima > mid, maxima - sizes, maxima)
    ccmax = torch.gather(flat_cc, -1, flat_idx[..., None])[..., 0]
    coarse = shifts
    if upsample_factor > 1:
        shifts, ccmax = subpixel_refine(product, shifts, upsample_factor,
                                        shape)
    # Singleton axes carry no shift information.
    shifts, coarse = (torch.where(sizes == 1, torch.zeros_like(s), s)
                      for s in (shifts, coarse))
    return shifts, ccmax, coarse


def window_bounds(shape, max_shifts=None, shifts_lb=None, shifts_ub=None,
                  dtype=torch.float32, device=None):
    """``(lb, ub)`` tensors of the shift window: explicit bounds, else
    ``[-max_shifts, max_shifts]``, else the whole axes."""
    def t(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=dtype)
        return device_vector(np.ravel(v), dtype, device).reshape(np.shape(v))

    if shifts_lb is not None or shifts_ub is not None:
        return t(shifts_lb), t(shifts_ub)
    if max_shifts is not None:
        m = t(max_shifts)
        return -m, m
    s = t(list(shape))
    return -s, s


def phase_cross_correlation(
    src_image: torch.Tensor,
    target_image: torch.Tensor,
    upsample_factor: int = 1,
    max_shifts: Optional[Sequence[float]] = None,
    shifts_lb: Optional[torch.Tensor] = None,
    shifts_ub: Optional[torch.Tensor] = None,
    space: str = "real",
    target_is_freq: bool = False,
    use_rfft: bool = True,
    fft_impl: str = "auto",
    dft_precision: str = "highest",
):
    """Subpixel FFT registration of ``src`` against ``target`` (one image).

    Returns ``(shifts, src_freq, phasediff)``: the displacement of the
    source content relative to the target (apply ``-shifts`` to correct),
    the source's full ``fftn`` spectrum, and the global phase difference.
    Shift bounds: ``max_shifts`` (the reference's asymmetric ``[-m, m-1]``
    window) or explicit ``shifts_lb``/``shifts_ub``.
    """
    del use_rfft, fft_impl, dft_precision  # one FFT path on torch
    if space == "fourier":
        src_freq, target_freq = src_image, target_image
    else:
        rdt = _real_dtype(src_image)
        src_freq = torch.fft.fftn(src_image.to(rdt))
        target_freq = (target_image if target_is_freq
                       else torch.fft.fftn(target_image.to(rdt)))
    nd = src_freq.ndim
    lb, ub = window_bounds(src_freq.shape, max_shifts, shifts_lb, shifts_ub,
                           src_freq.real.dtype, src_freq.device)
    shifts, ccmax, _ = correlate(src_freq, target_freq, lb, ub,
                                 upsample_factor, nd)
    return shifts, src_freq, torch.atan2(ccmax.imag, ccmax.real)


def apply_shifts_fourier(src: torch.Tensor, shifts, diffphase=0.0,
                         is_freq: bool = False, border_nan=True,
                         rfft_shape=None) -> torch.Tensor:
    """Translate images by (fractional) ``shifts [*batch, nd]`` with a
    Fourier phase ramp: ``out[x] = src[x - s]``.

    ``border_nan``: ``True`` (NaN borders), ``False`` (leave wrapped),
    ``"min"`` (fill with the min), ``"copy"`` (replicate edge).
    Real-space inputs run through real FFTs, the constant phase applied
    as ``cos(diffphase)`` after the inverse (the ramped half-spectrum is
    Hermitian).  ``is_freq``: ``src`` is a full spectrum, or an ``rfftn``
    half-spectrum of the real shape ``rfft_shape``.
    """
    if is_freq:
        rdt = src.real.dtype
    else:
        rdt = _real_dtype(src)
    shifts = torch.as_tensor(shifts, dtype=rdt, device=src.device)
    nd = shifts.shape[-1]
    if is_freq:
        rfft = rfft_shape is not None
        src_freq = src
        shape = tuple(rfft_shape) if rfft else tuple(src.shape[-nd:])
    else:
        rfft = True
        shape = tuple(src.shape[-nd:])
        src_freq = torch.fft.rfftn(src.to(rdt), dim=_dims(nd))
    ramp = 0.0
    for d in range(nd):
        n = shape[d]
        freqs = _ramp_freqs(n, rfft and d == nd - 1, rdt, src.device)
        ramp = ramp + _spatial_view(shifts[..., d], nd) * _axis_view(
            freqs, d, nd) / n
    greg = src_freq * torch.polar(torch.ones_like(ramp), -2.0 * math.pi * ramp)
    dp = (diffphase.to(device=src.device, dtype=rdt)
          if isinstance(diffphase, torch.Tensor)
          else torch.full((), float(diffphase), dtype=rdt,
                          device=src.device))
    dp = _spatial_view(dp, nd)
    if rfft:
        out = torch.fft.irfftn(greg, s=shape, dim=_dims(nd)) * torch.cos(dp)
    else:
        greg = greg * torch.polar(torch.ones_like(dp), dp)
        out = torch.fft.ifftn(greg, dim=_dims(nd)).real

    if border_nan is not False:
        lo_w = torch.ceil(shifts.clamp_min(0.0)).long()
        hi_w = torch.floor(shifts.clamp_max(0.0)).long()
        if border_nan == "copy":
            for d in range(nd):
                n = shape[d]
                idx = torch.arange(n, device=src.device)
                idx = torch.clamp(idx, lo_w[..., d:d + 1],
                                  n - 1 + hi_w[..., d:d + 1])
                out = _take_axis(out, idx, d, nd)
        else:
            fill = (math.nan if border_nan is True
                    else _spatial_view(_nanreduce(out, nd, False), nd))
            mask = None
            for d in range(nd):
                n = shape[d]
                idx = torch.arange(n, device=src.device)
                bad = (idx < lo_w[..., d:d + 1]) | (
                    idx >= n + hi_w[..., d:d + 1])
                bad = _axis_view(bad, d, nd)
                mask = bad if mask is None else (mask | bad)
            out = torch.where(mask, fill, out)
    return out


def _keys_cubic_weights(f: torch.Tensor) -> torch.Tensor:
    """``[4, *f.shape]`` Keys cubic (``a = -0.5``) weights of the taps at
    lattice offsets ``{-1, 0, 1, 2}`` around fractional offset ``f``."""
    a = -0.5
    d = torch.stack([f + 1.0, f, 1.0 - f, 2.0 - f])
    near = (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    far = a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a
    return torch.where(d <= 1.0, near, far)


def apply_shifts_cubic(src: torch.Tensor, shifts, border_nan="min",
                       clamp_range: bool = True) -> torch.Tensor:
    """Translate images by fractional ``shifts [*batch, nd]`` with
    separable Keys cubic convolution (``out[x] = src[x - s]``).

    ``border_nan``: ``"min"`` (fill with the frame min), ``True`` (NaN
    wherever a tap leaves the image), ``"copy"`` (replicate edge),
    ``"reflect"`` (mirror with the edge sample duplicated), ``False``
    (wrap around).  ``clamp_range`` clips the output into the input's
    ``[nanmin, nanmax]``.
    """
    out = src.to(_real_dtype(src))
    shifts = torch.as_tensor(shifts, dtype=out.dtype, device=out.device)
    nd = shifts.shape[-1]
    if clamp_range:
        lo_v = _spatial_view(_nanreduce(out, nd, False), nd)
        hi_v = _spatial_view(_nanreduce(out, nd, True), nd)
    if border_nan == "min":
        fill = _spatial_view(out.flatten(-nd).amin(-1), nd)
    elif border_nan is True:
        fill = math.nan
    else:
        fill = None  # "copy" / "reflect" / False need no constant
    for d in range(nd):
        n = out.shape[out.ndim - nd + d]
        s = shifts[..., d]
        base = torch.floor(-s)
        w = _keys_cubic_weights(-s - base)  # [4, *batch]
        idx0 = torch.arange(n, device=out.device) + base.long()[..., None]
        acc = torch.zeros_like(out)
        fill_w = torch.zeros(idx0.shape, dtype=out.dtype, device=out.device)
        fill_any = torch.zeros_like(fill_w)
        for m in range(-1, 3):
            idx = idx0 + m
            wm = w[m + 1][..., None]  # [*batch, 1]
            if border_nan is False:
                tap = _take_axis(out, torch.remainder(idx, n), d, nd)
            elif border_nan == "copy":
                tap = _take_axis(out, idx.clamp(0, n - 1), d, nd)
            elif border_nan == "reflect":
                period = 2 * n
                im = torch.remainder(idx, period)
                im = torch.where(im >= n, period - 1 - im, im)
                tap = _take_axis(out, im, d, nd)
            else:
                # Constant border: the out-of-range weight is gathered
                # separately and the fill added once (0 * nan = nan).
                valid = (idx >= 0) & (idx < n)
                tap = _take_axis(out, idx.clamp(0, n - 1), d, nd)
                tap = torch.where(_axis_view(valid, d, nd), tap, 0.0)
                fill_w = fill_w + torch.where(valid, 0.0, wm)
                fill_any = fill_any + torch.where(valid, 0.0, wm.abs())
            acc = acc + _spatial_view(w[m + 1], nd) * tap
        if fill is not None:
            if border_nan is True:
                acc = torch.where(_axis_view(fill_any > 0, d, nd),
                                  math.nan, acc)
            else:
                acc = acc + _axis_view(fill_w, d, nd) * fill
        out = acc
    if clamp_range:
        out = torch.minimum(torch.maximum(out, lo_v), hi_v)
    return out


def bin_median(video: torch.Tensor, window: int = 10,
               exclude_nans: bool = True) -> torch.Tensor:
    """Template initializer: median over window-binned means of
    ``video [T, ...spatial]`` (frame ``w * nw + n`` goes to window n)."""
    t = video.shape[0]
    window = min(window, t)
    num_windows = t // window
    binned = video[:num_windows * window].reshape(
        (window, num_windows) + tuple(video.shape[1:]))
    if exclude_nans:
        return nanmedian(torch.nanmean(binned, dim=0), dim=0)
    means = torch.mean(binned, dim=0)
    med = nanmedian(means, dim=0)
    return torch.where(torch.isnan(means).any(dim=0),
                       torch.full_like(med, math.nan), med)


def registration_error(cross_correlation_max, src_amp, target_amp):
    """Translation-invariant normalized RMS error between registered
    images (reference ``_compute_error``)."""
    err = 1.0 - (cross_correlation_max * torch.conj(cross_correlation_max)
                 / (src_amp * target_amp))
    return torch.sqrt(torch.abs(err))
