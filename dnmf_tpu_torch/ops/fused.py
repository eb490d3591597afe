"""The video passes of a demixing round and of position refinement.

Each public function has the JAX package's signature and output layout
(``dnmf_tpu/ops/pallas_kernels.py``, ``dnmf_tpu/ops/pallas_culled.py``)
and a ``*_plain`` PyTorch version beside it:

* ``motion_block -> (mse [B], dbeta [B, 10, 3])``: per-frame data term
  ``sum_p (w sum_k c_k A_k - y)^2 / P`` and its beta gradient;
* ``c1_block -> c1 [B, K]``: ``sum_p w A_k y``;
* ``gram_block -> (G [B, K, K], c1 [B, K])``: ``sum_p (w A)(w A)^T``;
* ``refine_block -> (mse [B], dpos [B, K, 3][, dsigma])``: the data term
  with per-frame positions and its gradient with respect to them (and,
  with ``want_dsigma``, to the widths).

``c1_block`` and ``gram_block`` take shared anchors ``pos [K, 3]`` or
per-frame positions ``pos [B, K, 3]``; the latter go to
``c1_block_tracked`` and ``gram_block_tracked``, which launch the same
kernels with one neuron table per frame.

A CUDA tensor launches the hand-written kernel of ``csrc/`` (or raises);
a CPU tensor takes the plain version.  There is no fallback from one to
the other.  Each wrapper counts its kernel launches in ``.launches``.

The plain versions stream the pixels in chunks (the footprint tensor
``[B, P, K]`` does not fit in memory at whole-brain size), compute in
the inputs' dtype (float64 inputs give the oracle), and take gradients
by autograd, whose ``minimum``/``maximum`` subgradients at the fade's
ties are JAX's.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.ops import footprints as fp_ops

KB = 32  # neurons per culling block (csrc/footprint.cuh)
REFINE_SUB = 8  # neurons per thread block of the refine moments pass
REACH_SIGMAS = 6.0  # exp(-36) ~ 2e-16: below float32 resolution
LOG2E = 1.4426950408889634
THREADS = 256  # pixels per step of the motion, c1 and refine kernels
GRAM_TILE = 64  # pixels per step of the Gram kernel
TARGET_BLOCKS = 1056  # 8 thread blocks per SM of an H100
# Gram grids hold many pair-culled blocks that exit at once: ask for more.
GRAM_TARGET_BLOCKS = 4 * TARGET_BLOCKS
_CHUNK_ELEMS = 1 << 25  # plain versions: elements of the [B, chunk, K, 3] diff


# ---------------------------------------------------------------- plain
def _chunks(p: int, per_pixel: int):
    step = max(1, _CHUNK_ELEMS // max(per_pixel, 1))
    for start in range(0, p, step):
        yield start, min(start + step, p)


def _warped(betas, size, scaling, start, stop):
    """Deformed pixel-space coordinates of pixels ``[start, stop)``:
    ``[B, C, 3]``."""
    m, n, z = size
    idx = torch.arange(start, stop, device=betas.device)
    grid = torch.stack([idx // (n * z), (idx // z) % n, idx % z],
                       dim=-1).to(betas.dtype)
    if scaling == "normalized":
        grid = basis_ops.normalize_points(grid, size)
    return basis_ops.warp_voxel_coords(
        basis_ops.quadratic_basis_points(grid), betas, size, scaling)


def _footprints(betas, pos, sigma, size, scaling, start, stop):
    """Warped, faded footprints of pixels ``[start, stop)``: ``[B, C, K]``
    for ``pos [K, 3]`` or per-frame ``pos [B, K, 3]``."""
    psi = _warped(betas, size, scaling, start, stop)
    if pos.ndim == 3:
        pos = pos[:, None]  # [B, 1, K, 3] against psi [B, C, 1, 3]
    return fp_ops.evaluate_footprints(psi, pos, sigma, size=size)


def motion_block_plain(betas, pos, sigma, c_block, y, size,
                       scaling: str = "normalized"):
    """Plain version of :func:`motion_block` (autograd gradient)."""
    bsz, p = y.shape
    sse = torch.zeros(bsz, dtype=betas.dtype, device=betas.device)
    grad = torch.zeros_like(betas)
    with torch.enable_grad():
        b = betas.detach().requires_grad_(True)
        for start, stop in _chunks(p, bsz * pos.shape[0] * 3):
            a = _footprints(b, pos, sigma, size, scaling, start, stop)
            recon = torch.bmm(a, c_block[:, :, None])[..., 0]
            r = recon - y[:, start:stop]
            s = torch.sum(r * r, dim=1)
            (g,) = torch.autograd.grad(s.sum(), b)
            sse += s.detach()
            grad += g
    return sse / p, grad / p


def c1_block_plain(betas, pos, sigma, y, size, scaling: str = "normalized"):
    """Plain version of :func:`c1_block` (``pos [K, 3]`` or ``[B, K, 3]``)."""
    bsz, p = y.shape
    k = pos.shape[-2]
    c1 = torch.zeros((bsz, k), dtype=betas.dtype, device=betas.device)
    for start, stop in _chunks(p, bsz * k * 3):
        a = _footprints(betas, pos, sigma, size, scaling, start, stop)
        c1 += torch.bmm(y[:, None, start:stop], a)[:, 0]
    return c1


def gram_block_plain(betas, pos, sigma, y, size, scaling: str = "normalized"):
    """Plain version of :func:`gram_block` (``pos [K, 3]`` or
    ``[B, K, 3]``)."""
    bsz, p = y.shape
    k = pos.shape[-2]
    g = torch.zeros((bsz, k, k), dtype=betas.dtype, device=betas.device)
    c1 = torch.zeros((bsz, k), dtype=betas.dtype, device=betas.device)
    for start, stop in _chunks(p, bsz * k * 3):
        a = _footprints(betas, pos, sigma, size, scaling, start, stop)
        g += torch.bmm(a.transpose(1, 2), a)
        c1 += torch.bmm(y[:, None, start:stop], a)[:, 0]
    return g, c1


# The plain Gram takes per-frame positions as they are (so does c1's).
gram_block_tracked_plain = gram_block_plain


def refine_block_plain(betas, pos_t, sigma, c_block, y, size,
                       scaling: str = "normalized", want_dsigma: bool = False):
    """Plain version of :func:`refine_block`: autograd over pixel chunks.

    The widths enter as one copy per frame, so autograd gives each
    frame's own ``dsigma``; an isotropic width is expanded over the three
    axes inside the graph, which sums the axis terms.
    """
    bsz, p = y.shape
    k = pos_t.shape[1]
    sse = torch.zeros(bsz, dtype=betas.dtype, device=betas.device)
    dpos = torch.zeros_like(pos_t)
    dsig = torch.zeros((bsz,) + sigma.shape, dtype=sigma.dtype,
                       device=sigma.device)
    with torch.enable_grad():
        pt = pos_t.detach().requires_grad_(True)
        sg = sigma.detach().expand((bsz,) + sigma.shape).clone()
        sg.requires_grad_(want_dsigma)
        leaves = (pt, sg) if want_dsigma else (pt,)
        for start, stop in _chunks(p, bsz * k * 3):
            psi = _warped(betas, size, scaling, start, stop)
            s3 = sg if sigma.ndim == 2 else sg[..., None].expand(bsz, k, 3)
            d = psi[:, :, None, :] - pt[:, None]  # [B, C, K, 3]
            a = torch.exp(-torch.sum(d * d / (s3 * s3)[:, None], dim=-1))
            a = a * fp_ops._bounds_mask(psi, size)
            r = torch.bmm(a, c_block[:, :, None])[..., 0] - y[:, start:stop]
            s = torch.sum(r * r, dim=1)
            grads = torch.autograd.grad(s.sum(), leaves)
            sse += s.detach()
            dpos += grads[0]
            if want_dsigma:
                dsig += grads[1]
    if want_dsigma:
        return sse / p, dpos / p, dsig / p
    return sse / p, dpos / p


# -------------------------------------------------------- kernel inputs
def per_axis_inv_s2(sigma: torch.Tensor) -> torch.Tensor:
    """``[K, 3]`` per-axis ``1 / sigma^2`` from ``sigma [K]`` or
    ``[K, 3]``."""
    sig = sigma.to(torch.float32)
    if sig.ndim == 1:
        sig = sig[:, None].expand(sig.shape + (3,))
    return 1.0 / (sig * sig)


def sorted_params_tracked(pos_t: torch.Tensor, sigma: torch.Tensor,
                          kb: int = KB, c_block=None):
    """Sort neurons by their mean m over frames and build the kernels'
    per-frame neuron tables.

    ``pos_t [B, K, 3]`` holds each frame's own positions.  Returns
    ``(perm, params [B, K_pad, 8], blocks [nkb, 2])``: params rows
    ``(p_m, p_n, p_z, log2e/s_m^2, log2e/s_n^2, log2e/s_z^2, c, 0)`` in
    sorted order (``c`` from ``c_block [B, K]``, else 0), padded neurons
    at 1e4 with unit scales (exactly zero footprints); ``blocks`` holds
    each block's m-interval over all frames, widened by ``REACH_SIGMAS``
    times its widest m-sigma.
    """
    bsz, k = pos_t.shape[0], pos_t.shape[1]
    nkb = -(-k // kb)
    k_pad = nkb * kb
    perm = torch.argsort(torch.mean(pos_t[:, :, 0], dim=0), stable=True)
    pos_s = pos_t[:, perm].to(torch.float32)
    sig_s = sigma[perm].to(torch.float32)
    params = torch.zeros((bsz, k_pad, 8), dtype=torch.float32,
                         device=pos_t.device)
    params[:, :, :3] = 1e4
    params[:, :k, :3] = pos_s
    params[:, :, 3:6] = 1.0
    params[:, :k, 3:6] = per_axis_inv_s2(sig_s) * LOG2E
    if c_block is not None:
        params[:, :k, 6] = c_block[:, perm]
    inf = torch.full((k_pad - k,), math.inf, device=pos_t.device)
    m_lo = torch.cat([pos_s[:, :, 0].min(dim=0).values, inf]).reshape(nkb, kb)
    m_hi = torch.cat([pos_s[:, :, 0].max(dim=0).values, -inf]).reshape(nkb, kb)
    sig_m = sig_s[:, 0] if sig_s.ndim == 2 else sig_s
    s_pad = torch.cat([sig_m, torch.zeros_like(inf)]).reshape(nkb, kb)
    reach = REACH_SIGMAS * s_pad.max(dim=1).values
    blocks = torch.stack([m_lo.min(dim=1).values - reach,
                          m_hi.max(dim=1).values + reach], dim=1)
    return perm, params, blocks.contiguous()


def sorted_params(pos: torch.Tensor, sigma: torch.Tensor, kb: int = KB):
    """:func:`sorted_params_tracked` for shared anchors ``pos [K, 3]``:
    ``(perm, params [K_pad, 8], blocks [nkb, 2])``."""
    perm, params, blocks = sorted_params_tracked(pos[None], sigma, kb)
    return perm, params[0], blocks


def motion_weights(pos, sigma, c_block, perm, k_pad):
    """``[B, K_pad, 8]`` per-frame trace weights in sorted order:
    ``c, 2 c p_d / s_d^2 (3), 2 c / s_d^2 (3), 0``."""
    k = pos.shape[0]
    inv_s2 = per_axis_inv_s2(sigma[perm])
    c_s = c_block[:, perm].to(torch.float32)
    w = torch.zeros((c_block.shape[0], k_pad, 8), dtype=torch.float32,
                    device=pos.device)
    w[:, :k, 0] = c_s
    w[:, :k, 1:4] = 2.0 * c_s[:, :, None] * (pos[perm] * inv_s2)[None]
    w[:, :k, 4:7] = 2.0 * c_s[:, :, None] * inv_s2[None]
    return w


def _n_chunks(p: int, tile: int, blocks_per_chunk: int,
              target: int = TARGET_BLOCKS) -> int:
    """Pixel chunks per (frame, neuron block or pair): about ``target``
    thread blocks in all, at most one chunk per tile of ``tile`` pixels.
    The kernels deal the tiles to the chunks round-robin."""
    n_tiles = -(-p // tile)
    return min(n_tiles, max(1, -(-target // max(blocks_per_chunk, 1))))


def _check(name, size, scaling, y, betas, pos, *tensors):
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    for t in (y, betas, pos) + tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all inputs must be on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if not y.is_contiguous():
        raise ValueError(f"{name}: y must be contiguous")
    if y.shape[1] != size[0] * size[1] * size[2]:
        raise ValueError(f"{name}: y has {y.shape[1]} voxels, size "
                         f"{tuple(size)} has {size[0] * size[1] * size[2]}")
    bsz = y.shape[0]
    if tuple(betas.shape) != (bsz, 10, 3):
        raise ValueError(f"{name}: betas {tuple(betas.shape)} for {bsz} "
                         "frames")
    if pos.ndim == 3 and (pos.shape[0] != bsz or pos.shape[2] != 3):
        raise ValueError(f"{name}: per-frame positions {tuple(pos.shape)} "
                         f"for {bsz} frames")
    if scaling not in ("normalized", "pixel"):
        raise ValueError(f"{name}: unknown scaling {scaling!r}")


def _common(betas, size, scaling):
    m, n, z = (int(s) for s in size)
    return (betas.reshape(-1, 30).contiguous(), m, n, z,
            int(scaling == "normalized"))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# -------------------------------------------------------------- wrappers
def motion_block(betas, pos, sigma, c_block, y, size,
                 scaling: str = "normalized"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-frame ``mse [B]`` and analytic ``dbeta [B, 10, 3]`` for
    ``betas [B, 10, 3]``, ``c_block [B, K]`` and ``y [B, P]``."""
    if y.device.type == "cpu":
        return motion_block_plain(betas, pos, sigma, c_block, y, size, scaling)
    _check("motion_block", size, scaling, y, betas, pos, sigma, c_block)
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz = y.shape[0]
    perm, params, blocks = sorted_params(pos, sigma)
    nkb = blocks.shape[0]
    wts = motion_weights(pos, sigma, c_block, perm, nkb * KB)
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    n_chunks = _n_chunks(y.shape[1], THREADS, bsz)
    partial = torch.empty((bsz, n_chunks, 32), dtype=torch.float32,
                          device=y.device)
    mse = torch.empty(bsz, dtype=torch.float32, device=y.device)
    dbeta = torch.empty((bsz, 10, 3), dtype=torch.float32, device=y.device)
    err = lib.dnmf_motion(
        beta_rows.data_ptr(), params.data_ptr(), wts.data_ptr(),
        blocks.data_ptr(), y.data_ptr(), partial.data_ptr(), mse.data_ptr(),
        dbeta.data_ptr(), bsz, m, n, z, norm, nkb, n_chunks, _stream())
    motion_block.launches += 1
    _build.check(err, "dnmf_motion")
    return mse, dbeta


def _c1_launch(betas, params, blocks, y, size, scaling):
    """Run csrc/c1.cu on a neuron table ``params [K_pad, 8]`` (shared) or
    ``[B, K_pad, 8]`` (per frame); ``c1 [B, K_pad]`` in sorted order."""
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz = y.shape[0]
    nkb = blocks.shape[0]
    stride = nkb * KB * 8 if params.ndim == 3 else 0
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    n_chunks = _n_chunks(y.shape[1], THREADS, bsz * nkb)
    partial = torch.empty((bsz, nkb, n_chunks, KB), dtype=torch.float32,
                          device=y.device)
    c1 = torch.empty((bsz, nkb * KB), dtype=torch.float32, device=y.device)
    err = lib.dnmf_c1(
        beta_rows.data_ptr(), params.data_ptr(), blocks.data_ptr(),
        y.data_ptr(), partial.data_ptr(), c1.data_ptr(), bsz, m, n, z, norm,
        nkb, n_chunks, stride, _stream())
    return err, c1


def c1_block(betas, pos, sigma, y, size,
             scaling: str = "normalized") -> torch.Tensor:
    """``c1 [B, K] = sum_p w A y`` for ``betas [B, 10, 3]``, ``y [B, P]``;
    ``pos [B, K, 3]`` goes to :func:`c1_block_tracked`."""
    if pos.ndim == 3:
        return c1_block_tracked(betas, pos, sigma, y, size, scaling)
    if y.device.type == "cpu":
        return c1_block_plain(betas, pos, sigma, y, size, scaling)
    _check("c1_block", size, scaling, y, betas, pos, sigma)
    from dnmf_tpu_torch.ops import _build

    perm, params, blocks = sorted_params(pos, sigma)
    err, c1 = _c1_launch(betas, params, blocks, y, size, scaling)
    c1_block.launches += 1
    _build.check(err, "dnmf_c1")
    return c1[:, :pos.shape[0]][:, torch.argsort(perm)]


def c1_block_tracked(betas, pos_t, sigma, y, size,
                     scaling: str = "normalized") -> torch.Tensor:
    """:func:`c1_block` with per-frame positions ``pos_t [B, K, 3]``."""
    if y.device.type == "cpu":
        return c1_block_plain(betas, pos_t, sigma, y, size, scaling)
    _check("c1_block_tracked", size, scaling, y, betas, pos_t, sigma)
    from dnmf_tpu_torch.ops import _build

    perm, params, blocks = sorted_params_tracked(pos_t, sigma)
    err, c1 = _c1_launch(betas, params, blocks, y, size, scaling)
    c1_block_tracked.launches += 1
    _build.check(err, "dnmf_c1")
    return c1[:, :pos_t.shape[1]][:, torch.argsort(perm)]


def _gram_launch(betas, params, blocks, y, size, scaling):
    """Run csrc/gram.cu on a shared or per-frame neuron table; ``(G, c1)``
    padded and in sorted order."""
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz = y.shape[0]
    nkb = blocks.shape[0]
    stride = nkb * KB * 8 if params.ndim == 3 else 0
    n_pairs = nkb * (nkb + 1) // 2
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    n_chunks = _n_chunks(y.shape[1], GRAM_TILE, bsz * n_pairs,
                         GRAM_TARGET_BLOCKS)
    f32 = dict(dtype=torch.float32, device=y.device)
    gpart = torch.empty((bsz, n_pairs, n_chunks, KB * KB), **f32)
    cpart = torch.empty((bsz, nkb, n_chunks, KB), **f32)
    g = torch.empty((bsz, nkb * KB, nkb * KB), **f32)
    c1 = torch.empty((bsz, nkb * KB), **f32)
    err = lib.dnmf_gram(
        beta_rows.data_ptr(), params.data_ptr(), blocks.data_ptr(),
        y.data_ptr(), gpart.data_ptr(), cpart.data_ptr(), g.data_ptr(),
        c1.data_ptr(), bsz, m, n, z, norm, nkb, n_chunks, stride, _stream())
    return err, g, c1


def _unpermute_grams(g, c1, perm, k):
    inv = torch.argsort(perm)
    return g[:, :k, :k][:, inv][:, :, inv], c1[:, :k][:, inv]


def gram_block(betas, pos, sigma, y, size, scaling: str = "normalized"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(G [B, K, K], c1 [B, K])`` for ``betas [B, 10, 3]``, ``y [B, P]``;
    ``pos [B, K, 3]`` goes to :func:`gram_block_tracked`."""
    if pos.ndim == 3:
        return gram_block_tracked(betas, pos, sigma, y, size, scaling)
    if y.device.type == "cpu":
        return gram_block_plain(betas, pos, sigma, y, size, scaling)
    _check("gram_block", size, scaling, y, betas, pos, sigma)
    from dnmf_tpu_torch.ops import _build

    perm, params, blocks = sorted_params(pos, sigma)
    err, g, c1 = _gram_launch(betas, params, blocks, y, size, scaling)
    gram_block.launches += 1
    _build.check(err, "dnmf_gram")
    return _unpermute_grams(g, c1, perm, pos.shape[0])


def gram_block_tracked(betas, pos_t, sigma, y, size,
                       scaling: str = "normalized"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gram_block` with per-frame positions ``pos_t [B, K, 3]``."""
    if y.device.type == "cpu":
        return gram_block_plain(betas, pos_t, sigma, y, size, scaling)
    _check("gram_block_tracked", size, scaling, y, betas, pos_t, sigma)
    from dnmf_tpu_torch.ops import _build

    perm, params, blocks = sorted_params_tracked(pos_t, sigma)
    err, g, c1 = _gram_launch(betas, params, blocks, y, size, scaling)
    gram_block_tracked.launches += 1
    _build.check(err, "dnmf_gram")
    return _unpermute_grams(g, c1, perm, pos_t.shape[1])


def refine_block(betas, pos_t, sigma, c_block, y, size,
                 scaling: str = "normalized", want_dsigma: bool = False):
    """Per-frame ``mse [B]`` and ``dpos [B, K, 3]`` for per-frame
    positions ``pos_t [B, K, 3]``, ``c_block [B, K]`` and ``y [B, P]``.

    ``want_dsigma`` also returns each frame's ``dsigma``: ``[B, K]`` for
    ``sigma [K]`` (the three axis terms summed) or ``[B, K, 3]`` for
    ``sigma [K, 3]``.  Data term only: callers add the anchor tether.
    """
    if y.device.type == "cpu":
        return refine_block_plain(betas, pos_t, sigma, c_block, y, size,
                                  scaling, want_dsigma)
    _check("refine_block", size, scaling, y, betas, pos_t, sigma, c_block)
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz, p = y.shape
    k = pos_t.shape[1]
    perm, params, blocks = sorted_params_tracked(pos_t, sigma,
                                                 c_block=c_block)
    nkb = blocks.shape[0]
    n_sb = nkb * (KB // REFINE_SUB)
    nmom = 6 if want_dsigma else 3
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    n_res = _n_chunks(p, THREADS, bsz)
    n_mom = _n_chunks(p, THREADS, bsz * n_sb)
    f32 = dict(dtype=torch.float32, device=y.device)
    rw = torch.empty((bsz, p), **f32)
    sse_part = torch.empty((bsz, n_res), **f32)
    sse = torch.empty(bsz, **f32)
    mom_part = torch.empty((bsz, n_sb, n_mom, REFINE_SUB * nmom), **f32)
    mom = torch.empty((bsz, nkb * KB, nmom), **f32)
    err = lib.dnmf_refine(
        beta_rows.data_ptr(), params.data_ptr(), blocks.data_ptr(),
        y.data_ptr(), rw.data_ptr(), sse_part.data_ptr(), sse.data_ptr(),
        mom_part.data_ptr(), mom.data_ptr(), bsz, m, n, z, norm, nkb, n_res,
        n_mom, int(want_dsigma), _stream())
    refine_block.launches += 1
    _build.check(err, "dnmf_refine")
    mom = mom[:, :k][:, torch.argsort(perm)]
    inv_s2 = per_axis_inv_s2(sigma)  # [K, 3]
    coeff = (4.0 / p) * c_block[:, :, None] * inv_s2  # 4 c / (P s^2)
    dpos = coeff * mom[..., :3]
    if not want_dsigma:
        return sse / p, dpos
    dsig = coeff * torch.sqrt(inv_s2) * mom[..., 3:]  # 4 c / (P s^3)
    return sse / p, dpos, dsig if sigma.ndim == 2 else dsig.sum(dim=-1)


KERNELS = (motion_block, c1_block, gram_block, refine_block,
           c1_block_tracked, gram_block_tracked)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
