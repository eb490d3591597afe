"""The video passes of a demixing round and of position refinement.

Each public function has the JAX package's signature and output layout
(``dnmf_tpu/ops/pallas_kernels.py``, ``dnmf_tpu/ops/pallas_culled.py``)
and a ``*_plain`` PyTorch version beside it:

* ``motion_block -> (mse [B], dbeta [B, 10, 3])``: per-frame data term
  ``sum_p (w sum_k c_k A_k - y)^2 / P`` and its beta gradient;
* ``c1_block -> c1 [B, K]``: ``sum_p w A_k y``;
* ``gram_block -> (G [B, K, K], c1 [B, K])``: ``sum_p (w A)(w A)^T``;
  with ``psi_source="stream"`` the warped coordinates and fades come from
  :func:`psi_rows` (or the caller) and go to :func:`gram_block_rows`;
* ``refine_block -> (mse [B], dpos [B, K, 3][, dsigma])``: the data term
  with per-frame positions and its gradient with respect to them (and,
  with ``want_dsigma``, to the widths).

``c1_block`` and ``gram_block`` take shared anchors ``pos [K, 3]`` or
per-frame positions ``pos [B, K, 3]``; the latter go to
``c1_block_tracked`` and ``gram_block_tracked``, which launch the same
kernels with one neuron table per frame.

A CUDA tensor launches the hand-written kernel of ``csrc/`` (or raises);
a CPU tensor takes the plain version.  There is no fallback from one to
the other.  Each wrapper counts its kernel launches in ``.launches``;
:func:`launch_counts` also reads the registration kernels' counters
(:mod:`~dnmf_tpu_torch.ops.phasecorr`, :mod:`~dnmf_tpu_torch.ops.warp`).

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
from dnmf_tpu_torch.ops import phasecorr, warp

KB = 32  # neurons per block of sorted_params' tables
REFINE_BRICK_MN = 8  # brick kernels: brick extent in m and in n
REFINE_ROW = 16  # floats per neuron row of the brick kernels' tables
REFINE_PART_FLOATS = 1 << 20  # refine kernel: partial sums per frame
# Motion and c1 kernels: at most this many brick groups per frame, and
# their partial sums within 1/PART_SHARE of the frame's video.
BRICK_GROUPS = 512
PART_SHARE = 16
REACH_SIGMAS = 6.0  # exp(-36) ~ 2e-16: below float32 resolution
LOG2E = 1.4426950408889634
TARGET_BLOCKS = 1056  # 8 thread blocks per SM of an H100
# Gram kernel: partial sums per frame (k (k + 1) / 2 per brick group),
# table rows per split's block (csrc/gram.cu GROWS), at most this many
# splits per group, and the thread blocks per frame they aim for (one per
# SM of an H100).
GRAM_PART_FLOATS = 1 << 22
GRAM_ROWS = 64
GRAM_SPLITS = 64
GRAM_SPLIT_BLOCKS = 132
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


def psi_rows(betas, size, scaling: str = "normalized"):
    """Pixel-space deformed coordinates ``psi [B, P, 3]`` of every voxel
    and their border fades ``w [B, P]``: the rows that
    :func:`gram_block_rows` takes."""
    vb = (basis_ops.voxel_basis_normalized(size, device=betas.device)
          if scaling == "normalized"
          else basis_ops.voxel_basis(size, device=betas.device))
    psi = basis_ops.warp_voxel_coords(vb.to(betas.dtype), betas, size,
                                      scaling)
    return psi, fp_ops._bounds_mask(psi, size)[..., 0]


def gram_block_rows_plain(psi, w, pos, sigma, y):
    """Plain version of :func:`gram_block_rows`."""
    bsz, p = y.shape
    k = pos.shape[0]
    g = torch.zeros((bsz, k, k), dtype=psi.dtype, device=psi.device)
    c1 = torch.zeros((bsz, k), dtype=psi.dtype, device=psi.device)
    for start, stop in _chunks(p, bsz * k * 3):
        a = (fp_ops.gaussian_footprints(psi[:, start:stop], pos, sigma)
             * w[:, start:stop, None])
        g += torch.bmm(a.transpose(1, 2), a)
        c1 += torch.bmm(y[:, None, start:stop], a)[:, 0]
    return g, c1


def refine_block_plain(betas, pos_t, sigma, c_block, y, size,
                       scaling: str = "normalized", want_dsigma: bool = False,
                       mask_out_of_bounds: bool = True):
    """Plain version of :func:`refine_block`: autograd over pixel chunks.

    The widths enter as one copy per frame, so autograd gives each
    frame's own ``dsigma``; an isotropic width is expanded over the three
    axes inside the graph, which sums the axis terms.
    ``mask_out_of_bounds=False`` drops the border fade (a function the
    kernel does not compute).
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
            if mask_out_of_bounds:
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
                          kb: int = KB):
    """Sort neurons by their mean m over frames and build the Gram
    kernel's per-frame neuron tables.

    ``pos_t [B, K, 3]`` holds each frame's own positions.  Returns
    ``(perm, params [B, K_pad, 8], blocks [nkb, 2])``: params rows
    ``(p_m, p_n, p_z, log2e/s_m^2, log2e/s_n^2, log2e/s_z^2, 0, 0)`` in
    sorted order, padded neurons at 1e4 with unit scales (exactly zero
    footprints); ``blocks`` holds each block's m-interval over all
    frames, widened by ``REACH_SIGMAS`` times its widest m-sigma.
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
    ``c, 2 c p_d / s_d^2 (3), 2 c / s_d^2 (3), 0``: the Pallas motion
    kernels' weight rows.  The motion kernel forms its own from the table
    (``2 c / s_d^2``, centred on each neuron)."""
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
    """Pixel chunks per (frame, neuron-block pair) of the Gram kernel:
    about ``target`` thread blocks in all, at most one chunk per tile of
    ``tile`` pixels.  The kernel deals the tiles to the chunks
    round-robin."""
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
def brick_groups(size, floats_per_group: int,
                 budget=None) -> Tuple[int, int]:
    """``(bricks per group, groups)`` of the brick kernels for a volume
    ``size``: at most ``BRICK_GROUPS`` groups per frame, and at most
    ``budget`` partial floats per frame (default ``P / PART_SHARE``) for
    groups that write ``floats_per_group`` each (32 for the motion kernel,
    K for c1; :func:`gram_groups`).  The count depends on the volume and K
    only, so a frame's result does not depend on the other frames of the
    call."""
    m, n, z = (int(s) for s in size)
    n_bricks = brick_count(size)
    budget = m * n * z // PART_SHARE if budget is None else int(budget)
    cap = max(1, min(BRICK_GROUPS, budget // max(1, floats_per_group)))
    per_group = -(-n_bricks // cap)
    return per_group, -(-n_bricks // per_group)


def _plain_counts(out, betas, pos, sigma, size, scaling):
    """``out`` with the plain rule's candidate count per brick appended:
    what ``brick_counts=True`` gives on CPU tensors."""
    counts = brick_candidates_plain(betas, pos, sigma, size, scaling)
    out = out if isinstance(out, tuple) else (out,)
    return out + (counts.sum(-1).to(torch.int32),)


def _counts_out(bsz, size, device, wanted):
    """``(counts [B, n_bricks] int32 or None, its pointer or None)``."""
    if not wanted:
        return None, None
    counts = torch.empty((bsz, brick_count(size)), dtype=torch.int32,
                         device=device)
    return counts, counts.data_ptr()


def motion_block(betas, pos, sigma, c_block, y, size,
                 scaling: str = "normalized", brick_counts: bool = False):
    """Per-frame ``mse [B]`` and analytic ``dbeta [B, 10, 3]`` for
    ``betas [B, 10, 3]``, ``c_block [B, K]`` and ``y [B, P]``.

    ``brick_counts`` appends the kernel's candidate count of every brick,
    ``[B, n_bricks]`` int32 (on CPU tensors: from
    :func:`brick_candidates_plain`)."""
    if y.device.type == "cpu":
        out = motion_block_plain(betas, pos, sigma, c_block, y, size, scaling)
        return (_plain_counts(out, betas, pos, sigma, size, scaling)
                if brick_counts else out)
    _check("motion_block", size, scaling, y, betas, pos, sigma, c_block)
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz = y.shape[0]
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    table, order, rmax = neuron_table(pos[None], sigma)
    c_rows = c_block.index_select(1, order[0])  # the traces in table order
    per_group, n_groups = brick_groups(size, 32)
    partial = torch.empty(bsz * n_groups * 32, dtype=torch.float32,
                          device=y.device)
    out = torch.empty(bsz * 31, dtype=torch.float32, device=y.device)
    counts, counts_ptr = _counts_out(bsz, size, y.device, brick_counts)
    err = lib.dnmf_motion(
        beta_rows.data_ptr(), table.data_ptr(), rmax.data_ptr(),
        c_rows.data_ptr(), y.data_ptr(), partial.data_ptr(), out.data_ptr(),
        counts_ptr, bsz, m, n, z, norm, pos.shape[0],
        *refine_bricks(size), per_group, _stream())
    _build.check(err, "dnmf_motion")
    motion_block.launches += 1
    res = (out[:bsz], out[bsz:].view(bsz, 10, 3))
    return res + (counts,) if brick_counts else res


def _c1_launch(fn, betas, pos, sigma, y, size, scaling, brick_counts):
    """Run csrc/c1.cu for the wrapper ``fn`` on shared anchors ``pos [K,
    3]`` or per-frame positions ``[B, K, 3]``: ``c1 [B, K]`` (and the
    candidate count per brick)."""
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz, k = y.shape[0], pos.shape[-2]
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    tracked = pos.ndim == 3
    table, order, rmax = neuron_table(pos if tracked else pos[None], sigma)
    per_group, n_groups = brick_groups(size, k)
    partial = torch.empty(bsz * n_groups * k, dtype=torch.float32,
                          device=y.device)
    c1 = torch.empty((bsz, k), dtype=torch.float32, device=y.device)
    counts, counts_ptr = _counts_out(bsz, size, y.device, brick_counts)
    err = lib.dnmf_c1(
        beta_rows.data_ptr(), table.data_ptr(), order.data_ptr(),
        rmax.data_ptr(), y.data_ptr(), partial.data_ptr(), c1.data_ptr(),
        counts_ptr, bsz, m, n, z, norm, k, int(tracked), *refine_bricks(size),
        per_group, _stream())
    _build.check(err, "dnmf_c1")
    fn.launches += 1
    return (c1, counts) if brick_counts else c1


def c1_block(betas, pos, sigma, y, size, scaling: str = "normalized",
             brick_counts: bool = False):
    """``c1 [B, K] = sum_p w A y`` for ``betas [B, 10, 3]``, ``y [B, P]``;
    ``pos [B, K, 3]`` goes to :func:`c1_block_tracked`.  ``brick_counts``
    as in :func:`motion_block`."""
    if pos.ndim == 3:
        return c1_block_tracked(betas, pos, sigma, y, size, scaling,
                                brick_counts)
    if y.device.type == "cpu":
        out = c1_block_plain(betas, pos, sigma, y, size, scaling)
        return (_plain_counts(out, betas, pos, sigma, size, scaling)
                if brick_counts else out)
    _check("c1_block", size, scaling, y, betas, pos, sigma)
    return _c1_launch(c1_block, betas, pos, sigma, y, size, scaling,
                      brick_counts)


def c1_block_tracked(betas, pos_t, sigma, y, size,
                     scaling: str = "normalized", brick_counts: bool = False):
    """:func:`c1_block` with per-frame positions ``pos_t [B, K, 3]``."""
    if y.device.type == "cpu":
        out = c1_block_plain(betas, pos_t, sigma, y, size, scaling)
        return (_plain_counts(out, betas, pos_t, sigma, size, scaling)
                if brick_counts else out)
    _check("c1_block_tracked", size, scaling, y, betas, pos_t, sigma)
    return _c1_launch(c1_block_tracked, betas, pos_t, sigma, y, size,
                      scaling, brick_counts)


def gram_groups(size, k: int) -> Tuple[int, int]:
    """``(bricks per group, groups)`` of the Gram kernel for a volume
    ``size`` and ``k`` neurons: each group keeps the upper triangle of a
    ``k x k`` partial in table order (``k (k + 1) / 2`` floats, of which it
    touches only its window of table rows), at most ``GRAM_PART_FLOATS``
    per frame where a group per frame allows it; the count depends on the
    volume and K only."""
    return brick_groups(size, k * (k + 1) // 2, GRAM_PART_FLOATS)


def gram_splits(size, k: int) -> int:
    """Thread blocks per group of the Gram kernel: where the ``K x K``
    partials leave fewer than ``GRAM_SPLIT_BLOCKS`` groups per frame (large
    K), enough splits to make up the difference, at most one per
    ``GRAM_ROWS`` table rows and ``GRAM_SPLITS``.  A split walks the
    group's bricks and takes the pairs whose first row lies in its own
    blocks of rows.  The count depends on the volume and K only."""
    _, n_groups = gram_groups(size, k)
    return max(1, min(GRAM_SPLITS, -(-int(k) // GRAM_ROWS),
                      -(-GRAM_SPLIT_BLOCKS // n_groups)))


def _gram_launch(fn, betas, pos, sigma, y, size, scaling, brick_counts,
                 rows=None):
    """Run csrc/gram.cu for the wrapper ``fn`` on shared anchors ``pos [K,
    3]`` or per-frame positions ``[B, K, 3]``, from the warp (``betas``) or
    from precomputed ``rows = (psi, w)``: ``(G [B, K, K], c1 [B, K])`` in
    the caller's order (and the candidate count per brick)."""
    from dnmf_tpu_torch.ops import _build

    lib = _build.load()
    bsz, k = y.shape[0], pos.shape[-2]
    m, n, z = (int(s) for s in size)
    tracked = pos.ndim == 3
    table, order, rmax = neuron_table(pos if tracked else pos[None], sigma)
    per_group, n_groups = gram_groups(size, k)
    f32 = dict(dtype=torch.float32, device=y.device)
    gpart = torch.empty(bsz * n_groups * (k * (k + 1) // 2), **f32)
    cpart = torch.empty(bsz * n_groups * k, **f32)
    windows = torch.empty(bsz * n_groups * 2, dtype=torch.int32,
                          device=y.device)
    g = torch.empty((bsz, k, k), **f32)
    c1 = torch.empty((bsz, k), **f32)
    counts, counts_ptr = _counts_out(bsz, size, y.device, brick_counts)
    scratch = (table.data_ptr(), order.data_ptr(), rmax.data_ptr(),
               y.data_ptr(), gpart.data_ptr(), cpart.data_ptr(),
               windows.data_ptr(), g.data_ptr(), c1.data_ptr(), counts_ptr)
    if rows is None:
        beta_rows, _, _, _, norm = _common(betas, size, scaling)
        err = lib.dnmf_gram(beta_rows.data_ptr(), *scratch, bsz, m, n, z,
                            norm, k, int(tracked), *refine_bricks(size),
                            per_group, gram_splits(size, k), _stream())
        _build.check(err, "dnmf_gram")
    else:
        psi, w = rows
        err = lib.dnmf_gram_rows(psi.data_ptr(), w.data_ptr(), *scratch, bsz,
                                 m, n, z, k, *refine_bricks(size), per_group,
                                 gram_splits(size, k), _stream())
        _build.check(err, "dnmf_gram_rows")
    fn.launches += 1
    return (g, c1, counts) if brick_counts else (g, c1)


def gram_block(betas, pos, sigma, y, size, scaling: str = "normalized",
               psi_source: str = "kernel", rows=None,
               brick_counts: bool = False):
    """``(G [B, K, K], c1 [B, K])`` for ``betas [B, 10, 3]``, ``y [B, P]``;
    ``pos [B, K, 3]`` goes to :func:`gram_block_tracked`.

    ``psi_source="stream"`` computes the deformed coordinates and fades
    outside the kernel (:func:`psi_rows`, or ``rows = (psi [B, P, 3], w
    [B, P])`` from the caller: the hook for coordinate fields computed
    elsewhere) and hands them to :func:`gram_block_rows`.  ``brick_counts``
    appends the kernel's candidate count of every brick, ``[B, n_bricks]``
    int32 (on CPU tensors: from :func:`brick_candidates_plain`); a brick
    sums the ``n (n + 1) / 2`` pairs of its ``n`` candidates
    (:func:`gram_block_bricks_plain`).
    """
    if psi_source == "stream":
        if pos.ndim == 3:
            raise ValueError("psi_source='stream' takes shared anchors "
                             "pos [K, 3]")
        psi, w = rows if rows is not None else psi_rows(betas, size, scaling)
        return gram_block_rows(psi, w, pos, sigma, y, size, brick_counts)
    if psi_source != "kernel":
        raise ValueError(f"unknown psi_source: {psi_source!r}")
    if pos.ndim == 3:
        return gram_block_tracked(betas, pos, sigma, y, size, scaling,
                                  brick_counts)
    if y.device.type == "cpu":
        out = gram_block_plain(betas, pos, sigma, y, size, scaling)
        return (_plain_counts(out, betas, pos, sigma, size, scaling)
                if brick_counts else out)
    _check("gram_block", size, scaling, y, betas, pos, sigma)
    return _gram_launch(gram_block, betas, pos, sigma, y, size, scaling,
                        brick_counts)


def gram_block_rows(psi, w, pos, sigma, y, size,
                    brick_counts: bool = False):
    """``(G [B, K, K], c1 [B, K])`` from precomputed rows: pixel-space
    deformed coordinates ``psi [B, P, 3]`` and fades ``w [B, P]`` of
    ``y [B, P]``, for shared anchors ``pos [K, 3]``; the kernel culls by
    the bricks of the volume ``size`` the rows come from.
    ``brick_counts`` as in :func:`gram_block`."""
    bsz, p = y.shape
    size = tuple(int(s) for s in size)
    if y.device.type == "cpu":
        out = gram_block_rows_plain(psi, w, pos, sigma, y)
        return (out + (brick_candidates_plain(
            None, pos, sigma, size, psi=psi).sum(-1).to(torch.int32),)
            if brick_counts else out)
    if (tuple(psi.shape) != (bsz, p, 3) or tuple(w.shape) != (bsz, p)
            or size[0] * size[1] * size[2] != p):
        raise ValueError(f"gram_block_rows: psi {tuple(psi.shape)}, w "
                         f"{tuple(w.shape)} and size {size} for y "
                         f"{tuple(y.shape)}")
    if pos.ndim != 2:
        raise ValueError("gram_block_rows takes shared anchors pos [K, 3]")
    for t in (psi, w, pos, sigma, y):
        if t.device != y.device:
            raise ValueError(f"gram_block_rows: all inputs must be on "
                             f"{y.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"gram_block_rows: the kernel takes float32, got "
                            f"{t.dtype}")
    rows = (psi.contiguous(), w.contiguous())
    return _gram_launch(gram_block_rows, None, pos, sigma, y.contiguous(),
                        size, "pixel", brick_counts, rows)


def gram_block_tracked(betas, pos_t, sigma, y, size,
                       scaling: str = "normalized",
                       brick_counts: bool = False):
    """:func:`gram_block` with per-frame positions ``pos_t [B, K, 3]``."""
    if y.device.type == "cpu":
        out = gram_block_plain(betas, pos_t, sigma, y, size, scaling)
        return (_plain_counts(out, betas, pos_t, sigma, size, scaling)
                if brick_counts else out)
    _check("gram_block_tracked", size, scaling, y, betas, pos_t, sigma)
    return _gram_launch(gram_block_tracked, betas, pos_t, sigma, y, size,
                        scaling, brick_counts)


def refine_bricks(size):
    """``(bm, bn, bz)``: the brick of the motion, c1 and refine kernels
    for a volume ``size = (M, N, Z)`` (csrc/cull.cuh): 8 x 8 voxels in
    (m, n) by the z extent cut into equal runs of at most 32; bricks at
    the far faces are clipped."""
    z = int(size[2])
    return REFINE_BRICK_MN, REFINE_BRICK_MN, -(-z // -(-z // 32))


def brick_count(size) -> int:
    """The number of bricks of a volume ``size``."""
    m, n, z = (int(s) for s in size)
    bm, bn, bz = refine_bricks(size)
    return -(-m // bm) * -(-n // bn) * -(-z // bz)


def brick_ids(size, device=None) -> Tuple[torch.Tensor, int]:
    """``([P] brick number of every voxel, number of bricks)``; bricks
    are numbered ``((im * nbn) + in) * nbz + iz``."""
    m, n, z = (int(s) for s in size)
    bm, bn, bz = refine_bricks(size)
    nbn, nbz = -(-n // bn), -(-z // bz)
    idx = torch.arange(m * n * z, device=device)
    ids = (((idx // (n * z)) // bm) * nbn + ((idx // z) % n) // bn) * nbz \
        + (idx % z) // bz
    return ids, brick_count(size)


def brick_candidates_plain(betas, pos, sigma, size,
                           scaling: str = "normalized",
                           psi=None) -> torch.Tensor:
    """The brick kernels' culling rule in plain torch: ``[B, n_bricks,
    K]``, True where neuron k's per-axis box ``pos[k] +- 6 sigma_k`` meets
    the exact per-axis range of frame b's deformed coordinates over the
    brick (on all three axes), for shared anchors ``pos [K, 3]`` or
    per-frame positions ``pos [B, K, 3]``.  Any other neuron's footprint
    is below ``exp(-36)`` at every voxel of the brick.  ``psi [B, P, 3]``
    gives the deformed coordinates in place of ``betas``' warp (the Gram
    from rows)."""
    ids, nb = brick_ids(size, pos.device)
    if psi is None:
        psi = _warped(betas, size, scaling, 0, ids.numel())  # [B, P, 3]
    bsz = psi.shape[0]
    idx = ids[None, :, None].expand_as(psi)
    lo = torch.full((bsz, nb, 3), math.inf, dtype=psi.dtype,
                    device=psi.device).scatter_reduce(1, idx, psi, "amin")
    hi = torch.full((bsz, nb, 3), -math.inf, dtype=psi.dtype,
                    device=psi.device).scatter_reduce(1, idx, psi, "amax")
    sig3 = sigma if sigma.ndim == 2 else sigma[:, None].expand(-1, 3)
    reach = REACH_SIGMAS * sig3
    pt = pos[None] if pos.ndim == 2 else pos[:, None]  # [B|1, 1, K, 3]
    meets = (pt + reach >= lo[:, :, None]) & (pt - reach <= hi[:, :, None])
    return meets.all(dim=-1)


def gram_block_bricks_plain(betas, pos, sigma, y, size,
                            scaling: str = "normalized", rows=None):
    """The Gram kernel's pair rule in plain torch: ``(G, c1)`` summed, at
    each voxel, over the pairs of its brick's candidates only
    (:func:`brick_candidates_plain`: a brick with ``n`` candidates sums
    their ``n (n + 1) / 2`` pairs, and c1 over the ``n``), from the warp
    of ``betas`` or from ``rows = (psi [B, P, 3], w [B, P])``.  Equal to
    :func:`gram_block_plain` up to the dropped terms, below ``exp(-36)``
    of a footprint's peak."""
    ids, _ = brick_ids(size, pos.device)
    if rows is None:
        mask = brick_candidates_plain(betas, pos, sigma, size, scaling)
        a = _footprints(betas, pos, sigma, size, scaling, 0, ids.numel())
    else:
        psi, w = rows
        mask = brick_candidates_plain(None, pos, sigma, size, psi=psi)
        a = fp_ops.gaussian_footprints(psi, pos, sigma) * w[..., None]
    a = a * mask[:, ids].to(a.dtype)  # [B, P, K]
    return (torch.bmm(a.transpose(1, 2), a),
            torch.bmm(y[:, None], a)[:, 0])


def neuron_table_plain(pos_t, sigma):
    """Plain version of :func:`neuron_table`."""
    order = torch.argsort(pos_t[:, :, 0], dim=1, stable=True)
    sig = sigma.to(torch.float32)
    reach = REACH_SIGMAS * (sig if sig.ndim == 2
                            else sig[:, None].expand(-1, 3))
    inv_s2 = per_axis_inv_s2(sigma)
    zero = torch.zeros_like(reach[:, :1])
    rows = torch.cat([zero, zero, zero, inv_s2 * LOG2E, zero, zero, reach,
                      zero, inv_s2, zero], dim=1)[order]  # [F, K, 16]
    rows[..., :3] = torch.take_along_dim(pos_t, order[..., None], dim=1)
    rmax = reach[:, 0].amax().clamp(min=0.0).reshape(1)
    return rows, order, rmax


def neuron_table(pos_t, sigma):
    """The brick kernels' neuron tables, one per frame of positions
    ``pos_t [F, K, 3]`` (shared anchors: ``F = 1``), each sorted by the
    frame's own m coordinate (stable): ``(table [F, K, 16], order [F, K]
    int64, rmax [1])``; rows ``(p_m, p_n, p_z, log2e/s_m^2, log2e/s_n^2,
    log2e/s_z^2, 0, 0, 6 s_m, 6 s_n, 6 s_z, 0, 1/s_m^2, 1/s_n^2, 1/s_z^2,
    0)`` for ``sigma [K]`` or ``[K, 3]``; ``order[f, i]`` is row i's
    neuron; ``rmax`` the largest m reach ``6 s_m`` (on the device: no
    sync).  CUDA tensors: ``build_table`` (csrc/table.cu), which the
    motion, c1 and refine wrappers launch before their kernel."""
    if pos_t.device.type == "cpu":
        return neuron_table_plain(pos_t, sigma)
    for t in (pos_t, sigma):
        if t.device != pos_t.device or t.dtype != torch.float32:
            raise TypeError("neuron_table: the kernel takes float32 tensors "
                            f"on one device, got {t.dtype} on {t.device}")
    from dnmf_tpu_torch.ops import _build

    f, k = pos_t.shape[0], pos_t.shape[1]
    pos_t, sigma = pos_t.contiguous(), sigma.contiguous()
    buf = torch.empty(f * k * REFINE_ROW + 1, dtype=torch.float32,
                      device=pos_t.device)
    table = buf[:-1].view(f, k, REFINE_ROW)
    order = torch.empty((f, k), dtype=torch.int64, device=pos_t.device)
    err = _build.load().dnmf_table(
        pos_t.data_ptr(), sigma.data_ptr(), table.data_ptr(),
        order.data_ptr(), buf[-1:].data_ptr(), f, k, int(sigma.ndim == 2),
        _stream())
    _build.check(err, "dnmf_table")
    return table, order, buf[-1:]


def refine_block(betas, pos_t, sigma, c_block, y, size,
                 scaling: str = "normalized", want_dsigma: bool = False,
                 brick_counts: bool = False):
    """Per-frame ``mse [B]`` and ``dpos [B, K, 3]`` for per-frame
    positions ``pos_t [B, K, 3]``, ``c_block [B, K]`` and ``y [B, P]``.

    ``want_dsigma`` also returns each frame's ``dsigma``: ``[B, K]`` for
    ``sigma [K]`` (the three axis terms summed) or ``[B, K, 3]`` for
    ``sigma [K, 3]``.  ``brick_counts`` appends the kernel's candidate
    count of every brick, ``[B, n_bricks]`` int32 (on CPU tensors: from
    :func:`brick_candidates_plain`).  Data term only: callers add the
    anchor tether.
    """
    if y.device.type == "cpu":
        out = refine_block_plain(betas, pos_t, sigma, c_block, y, size,
                                 scaling, want_dsigma)
        return (_plain_counts(out, betas, pos_t, sigma, size, scaling)
                if brick_counts else out)
    _check("refine_block", size, scaling, y, betas, pos_t, sigma, c_block)
    from dnmf_tpu_torch.ops import _build

    bsz, p = y.shape
    k = pos_t.shape[1]
    nmom = 6 if want_dsigma else 3
    lib = _build.load()
    table, order, rmax = neuron_table(pos_t, sigma)
    c_rows = torch.take_along_dim(c_block, order, dim=1)  # in table order
    beta_rows, m, n, z, norm = _common(betas, size, scaling)
    bm, bn, bz = refine_bricks(size)
    n_bricks = brick_count(size)
    # Groups of bricks per thread block: the partial sums stay within
    # REFINE_PART_FLOATS per frame; the count depends on the volume and K
    # only, so a frame's result does not depend on the call's other frames.
    per_group = max(1, -(-n_bricks * k * 6 // REFINE_PART_FLOATS))
    n_groups = -(-n_bricks // per_group)
    f32 = dict(dtype=torch.float32, device=y.device)
    sse_part = torch.empty((bsz, n_groups), **f32)
    mom_part = torch.empty((bsz, n_groups, k, nmom), **f32)
    mse = torch.empty(bsz, **f32)
    dpos = torch.empty((bsz, k, 3), **f32)
    dsig = (torch.empty((bsz, k) + tuple(sigma.shape[1:]), **f32)
            if want_dsigma else dpos)
    counts = torch.empty((bsz, n_bricks), dtype=torch.int32, device=y.device)
    err = lib.dnmf_refine(
        beta_rows.data_ptr(), table.data_ptr(), order.data_ptr(),
        rmax.data_ptr(), c_rows.data_ptr(), y.data_ptr(),
        sse_part.data_ptr(), mom_part.data_ptr(), mse.data_ptr(),
        dpos.data_ptr(), dsig.data_ptr(), counts.data_ptr(), bsz, m, n, z,
        norm, k, bm, bn, bz, per_group, int(want_dsigma),
        int(sigma.ndim == 2), _stream())
    _build.check(err, "dnmf_refine")
    refine_block.launches += 1
    out = (mse, dpos, dsig) if want_dsigma else (mse, dpos)
    return out + (counts,) if brick_counts else out


KERNELS = (motion_block, c1_block, gram_block, refine_block,
           c1_block_tracked, gram_block_tracked, gram_block_rows,
           phasecorr.phase_corr_block, warp.fused_separable_warp)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
