"""Kernel F: integer-shift phase correlation of a frame block's patches.

:func:`phase_corr_block` has the JAX signature and layout
(``dnmf_tpu/ops/pallas_phasecorr.py``): patches ``[B, NP, z*m, n]`` in
the z-major layout of :func:`to_zm_n`, template spectra ``[NP, z*m, n]``
from :func:`patch_spectra`, bounds ``[B, 8]`` rows ``(lb_m, lb_n, lb_z,
ub_m, ub_n, ub_z, 0, 0)`` keeping signed shifts in ``[lb, ub - 1]``.  It
returns ``(shifts [B, NP, 3], prod_re, prod_im [B, NP, z*m, n])``: the
integer (m, n, z) shifts of the first-occurrence argmax over the window
and the cross-power spectra ``S * conj(T)`` for the subpixel refinement.

A CUDA tensor launches ``csrc/phasecorr.cu`` (or raises); a CPU tensor
takes :func:`phase_corr_block_plain` (``torch.fft``; float64 inputs give
the oracle).  ``precision`` is accepted for the JAX signature: the kernel
computes in float32 FMA whatever it says.

The kernel's forward transforms are mixed-radix Stockham FFTs in shared
memory.  :func:`fft_plan` factors each axis length into the radices of
its stages and :func:`fft_twiddles` gives the one twiddle table per
length (float64, cast to float32, cached on the device).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dnmf_tpu_torch.ops import fft_reg

MAX_STAGES = 20  # csrc/phasecorr.cu MAX_STAGES
SPECIALISED = (8, 4, 2, 11, 5, 3)  # radices with their own butterfly
# Shared memory one block may use on an H100 (the opt-in maximum).
SMEM_BYTES = 232448
ROW_ELEMS = 8192  # real elements per block of the n pass (two rows a line)
COLS = 16  # columns per block of the m pass
Z_TILE_ELEMS = 3072  # complex elements per block of the z pass, at most
                     # (n is cut into equal runs to stay under it)
_TWIDDLES: dict = {}


def to_zm_n(patches: torch.Tensor) -> torch.Tensor:
    """``[..., m, n, z] -> [..., z*m, n]`` kernel layout."""
    m, n, z = patches.shape[-3:]
    lead = tuple(patches.shape[:-3])
    return patches.movedim(-1, -3).reshape(lead + (z * m, n))


def patch_spectra(tmpl_patches: torch.Tensor):
    """``(tmpl_re, tmpl_im)``, each ``[NP, z*m, n]``: the full DFT of the
    template patches ``[NP, m, n, z]`` in the kernel layout."""
    np_, m, n, z = tmpl_patches.shape
    spec = torch.fft.fftn(tmpl_patches.movedim(-1, 1), dim=(-3, -2, -1))
    spec = spec.reshape(np_, z * m, n)
    return spec.real.contiguous(), spec.imag.contiguous()


def _signed(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where(idx > n // 2, idx - n, idx)


def phase_corr_block_plain(patches, tmpl_re, tmpl_im, bounds, z: int,
                           precision: str = "highest"):
    """Plain version of :func:`phase_corr_block`: ``fftn``, product,
    ``ifftn``, magnitude, window mask (-1 outside) and argmax."""
    del precision
    b, np_, zm, n = patches.shape
    m = zm // z
    spec = torch.fft.fftn(patches.reshape(b, np_, z, m, n), dim=(-3, -2, -1))
    tmpl = torch.complex(tmpl_re, tmpl_im).reshape(np_, z, m, n)
    prod = spec * torch.conj(tmpl)
    mag = torch.fft.ifftn(prod, dim=(-3, -2, -1)).abs()
    bnd = bounds.to(mag.dtype)
    lb = fft_reg._last_axis(bnd, (2, 0, 1))[:, None]  # (z, m, n), [B, 1, 3]
    ub = fft_reg._last_axis(bnd, (5, 3, 4))[:, None]
    keep = fft_reg._shift_window_mask((z, m, n), lb, ub)
    flat = torch.where(keep, mag, -1.0).flatten(2).argmax(-1)
    shifts = torch.stack([_signed((flat // n) % m, m),
                          _signed(flat % n, n),
                          _signed(flat // (m * n), z)], dim=-1)
    prod = prod.reshape(b, np_, zm, n)
    return shifts.to(mag.dtype), prod.real, prod.imag


def window_counts(bounds: torch.Tensor, shape) -> torch.Tensor:
    """``[B, 3]`` candidate counts of the shift windows of ``bounds [B,
    8]`` on axes ``shape = (m, n, z)``: the signed shifts in ``[lb, ub -
    1]`` that each axis length has (the kernel lists them per frame)."""
    cols = []
    for d, n in enumerate(shape):
        s = fft_reg._signed_freq_index(n, bounds.dtype, bounds.device)
        keep = (s >= bounds[:, d:d + 1]) & (s <= bounds[:, 3 + d:4 + d] - 1)
        cols.append(keep.sum(dim=1))
    return torch.stack(cols, dim=1)


@functools.lru_cache(maxsize=None)
def fft_plan(length: int) -> tuple:
    """Radices of the kernel's FFT of ``length`` points, in stage order:
    8s, then a 4 or a 2, then 11s, 5s and 3s (the specialised
    butterflies), then any other prime factor ascending (the generic
    radix-p butterfly).  Length 1 has no stage."""
    if length < 1:
        raise ValueError(f"fft_plan: length {length} < 1")
    rad, rest = [], length
    while rest % 8 == 0:
        rad.append(8)
        rest //= 8
    for r in (4, 2):
        if rest % r == 0:
            rad.append(r)
            rest //= r
    for r in (11, 5, 3):
        while rest % r == 0:
            rad.append(r)
            rest //= r
    p = 7
    while rest > 1:
        if p * p > rest:
            rad.append(rest)
            break
        while rest % p == 0:
            rad.append(p)
            rest //= p
        p += 2
    if len(rad) > MAX_STAGES:
        raise ValueError(f"fft_plan: {length} needs {len(rad)} stages "
                         f"(at most {MAX_STAGES})")
    return tuple(rad)


def fft_twiddles(length: int, device) -> torch.Tensor:
    """``[length, 2]`` float32 table of ``exp(-2 pi i x / length)``,
    made in float64 and cached per (length, device): after the first call
    no host copy is made."""
    key = (length, torch.device(device))
    tw = _TWIDDLES.get(key)
    if tw is None:
        ang = torch.arange(length, dtype=torch.float64) * (-2.0 * math.pi
                                                           / length)
        tw = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).to(
            device=device, dtype=torch.float32)
        _TWIDDLES[key] = tw
    return tw


def fft_tiles(m: int, n: int, z: int):
    """``(rb, cc, cw)``: rows per block of the kernel's n pass, columns per
    block of its m pass and of its z pass, each within a block's shared
    memory (the twiddles, two complex buffers (the n pass: of row pairs)
    and, in the z pass, the template spectra)."""
    per = SMEM_BYTES // 8  # complex elements
    rb = max(1, min(ROW_ELEMS // n, 2 * ((per - n) // (2 * n))))
    cc = max(1, min(COLS, n, (per - m) // (2 * m)))
    room = max(per - z - n, 1)
    cw = -(-n // max(-(-z * n // Z_TILE_ELEMS), -(-3 * z * n // room)))
    if (n + 2 * (-(-rb // 2)) * n > per or m + 2 * m * cc > per
            or z + n + 3 * z * cw > per):
        raise ValueError(f"phase_corr_block: a {m}x{n}x{z} patch does not "
                         "fit the kernel's shared-memory tiles")
    return rb, cc, cw


def phase_corr_block(patches: torch.Tensor, tmpl_re: torch.Tensor,
                     tmpl_im: torch.Tensor, bounds: torch.Tensor, z: int,
                     precision: str = "highest", max_window=None):
    """Integer-shift phase correlation of a frame-block patch stack (see
    the module docstring for the layout).

    ``max_window``: ``(m, n, z)`` bounds on every frame's candidate count
    per axis (``ub - lb`` bounds it), which size the windowed inverse; the
    kernel keeps no more than these.  None reads the counts from
    ``bounds`` (one device-to-host copy)."""
    if patches.device.type == "cpu":
        return phase_corr_block_plain(patches, tmpl_re, tmpl_im, bounds, z)
    b, np_, zm, n = patches.shape
    if tuple(tmpl_re.shape) != (np_, zm, n) or tmpl_im.shape != tmpl_re.shape:
        raise ValueError("phase_corr_block: template spectra do not match "
                         "the patches")
    if zm % z:
        raise ValueError(f"phase_corr_block: z={z} does not divide "
                         f"z*m={zm}")
    if tuple(bounds.shape) != (b, 8):
        raise ValueError(f"phase_corr_block: bounds {tuple(bounds.shape)} "
                         f"for {b} frames")
    for t in (patches, tmpl_re, tmpl_im):
        if t.device != patches.device:
            raise ValueError("phase_corr_block: all inputs must be on "
                             f"{patches.device}")
        if t.dtype != torch.float32:
            raise TypeError("phase_corr_block: the kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("phase_corr_block: inputs must be contiguous")
    from dnmf_tpu_torch.ops import _build

    m = zm // z
    rb, cc, cw = fft_tiles(m, n, z)
    row = 2 + MAX_STAGES
    plans = (ctypes.c_int * (3 * row))()
    for i, length in enumerate((m, n, z)):
        rad = fft_plan(length)
        plans[i * row:i * row + 2 + len(rad)] = [length, len(rad), *rad]
    lib = _build.load()
    dev = patches.device
    tw = [fft_twiddles(length, dev) for length in (m, n, z)]
    bounds = bounds.to(dev, torch.float32).contiguous()
    if max_window is None:
        max_window = window_counts(bounds, (m, n, z)).amax(dim=0).tolist()
    wm, wn, wz = (max(1, min(int(c), ax)) for c, ax in zip(max_window,
                                                         (m, n, z)))
    f32 = dict(dtype=torch.float32, device=dev)
    bp = b * np_
    prod_re = torch.empty((b, np_, zm, n), **f32)
    prod_im = torch.empty((b, np_, zm, n), **f32)
    r1 = torch.empty((bp, -(-n // cw), zm, wn, 2), **f32)
    r2 = torch.empty((bp, z, wm, wn, 2), **f32)
    shifts = torch.empty((b, np_, 3), **f32)
    err = lib.dnmf_phasecorr(
        patches.data_ptr(), tmpl_re.data_ptr(), tmpl_im.data_ptr(),
        bounds.data_ptr(), prod_re.data_ptr(), prod_im.data_ptr(),
        r1.data_ptr(), r2.data_ptr(), shifts.data_ptr(), tw[0].data_ptr(),
        tw[1].data_ptr(), tw[2].data_ptr(),
        ctypes.cast(plans, ctypes.c_void_p), b, np_, z, m, n, wm, wn, wz,
        rb, cc, cw, torch.cuda.current_stream(dev).cuda_stream)
    phase_corr_block.launches += 1
    _build.check(err, "dnmf_phasecorr")
    return shifts, prod_re, prod_im


phase_corr_block.launches = 0
