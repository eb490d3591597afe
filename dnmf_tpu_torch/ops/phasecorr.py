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
"""

from __future__ import annotations

import torch

from dnmf_tpu_torch.ops import fft_reg


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
    lb = bnd[:, [2, 0, 1]][:, None]  # (z, m, n) order, [B, 1, 3]
    ub = bnd[:, [5, 3, 4]][:, None]
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

    lib = _build.load()
    m = zm // z
    dev = patches.device
    bounds = bounds.to(dev, torch.float32).contiguous()
    if max_window is None:
        max_window = window_counts(bounds, (m, n, z)).amax(dim=0).tolist()
    wm, wn, wz = (max(1, min(int(c), ax)) for c, ax in zip(max_window,
                                                         (m, n, z)))
    f32 = dict(dtype=torch.float32, device=dev)
    bp = b * np_
    prod_re = torch.empty((b, np_, zm, n), **f32)
    prod_im = torch.empty((b, np_, zm, n), **f32)
    buf = torch.empty((2, bp, zm, n), **f32)
    r1 = torch.empty((2, bp, zm, wn), **f32)
    r2 = torch.empty((2, bp * z, wm, wn), **f32)
    cc = torch.empty((2, bp, wz, wm * wn), **f32)
    shifts = torch.empty((b, np_, 3), **f32)
    err = lib.dnmf_phasecorr(
        patches.data_ptr(), tmpl_re.data_ptr(), tmpl_im.data_ptr(),
        bounds.data_ptr(), prod_re.data_ptr(),
        prod_im.data_ptr(), buf[0].data_ptr(), buf[1].data_ptr(),
        r1[0].data_ptr(), r1[1].data_ptr(), r2[0].data_ptr(),
        r2[1].data_ptr(), cc[0].data_ptr(), cc[1].data_ptr(),
        shifts.data_ptr(), b, np_, z, m, n, wm, wn, wz,
        torch.cuda.current_stream(dev).cuda_stream)
    phase_corr_block.launches += 1
    _build.check(err, "dnmf_phasecorr")
    return shifts, prod_re, prod_im


phase_corr_block.launches = 0
