"""The least time the card could take for a kernel's work: the yardstick of
the ``*_roofline`` metrics, frozen here from the port's kernel checks.

``bound`` takes the larger of the bytes over the memory rate and the
float32 operations over the float32 rate, at an H100 SXM's published
peaks (NVIDIA's data sheet, 700 W): 3.35 TB/s and 67 TFLOP/s outside the
tensor cores, where the demixing kernels compute.  ``active_pairs``
counts, from the run's own warps and anchors (or per-frame positions,
for the refinement), the (frame, voxel, neuron) triples whose footprint
clears float32 resolution (``|psi - p|^2 / s^2 < 36``), with the warp of
each voxel computed in plain PyTorch, so the count is the work the
function needs whatever implements it.
``footprint_flops`` is the operations a kernel of the family must do on
that work.  Bytes count each input read once and each output written
once.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
REACH = 36.0
_CHUNK_ELEMS = 1 << 25


def bound(nbytes: float, flops: float):
    """``(seconds, "bytes" or "operations")``: the least time to move
    ``nbytes`` and do ``flops`` float32 operations, and which bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _warped(betas, size, start, stop):
    """Pixel-space deformed coordinates of the voxels ``[start, stop)``
    (flat ``m n z`` order) under normalized warps ``betas [B, 10, 3]``:
    ``[B, C, 3]``."""
    m, n, z = (int(s) for s in size)
    idx = torch.arange(start, stop, device=betas.device)
    grid = torch.stack([idx // (n * z), (idx // z) % n, idx % z],
                       dim=-1).to(betas.dtype)
    hi = torch.tensor([max(float(s) - 1.0, 1.0) for s in size],
                      dtype=betas.dtype, device=betas.device)
    u = 2.0 * grid / hi - 1.0
    x, y, w = u[..., 0], u[..., 1], u[..., 2]
    phi = torch.stack([torch.ones_like(x), x, y, w, x * x, y * y, w * w,
                       x * y, x * w, y * w], dim=-1)
    psi = torch.einsum("cj,bjd->bcd", phi, betas)
    return (psi + 1.0) * 0.5 * hi


def active_pairs(betas, pos, sigma: float, size):
    """``(n1, n2)``: the (frame, voxel, neuron) triples of ``betas [B, 10,
    3]`` and anchors ``pos [K, 3]`` (or per-frame positions ``[B, K, 3]``)
    whose footprint clears float32 resolution, and the sum over (frame,
    voxel) of their count squared."""
    p = int(size[0]) * int(size[1]) * int(size[2])
    k = pos.shape[-2]
    step = max(1, _CHUNK_ELEMS // (betas.shape[0] * k * 3))
    n1 = n2 = 0.0
    for start in range(0, p, step):
        psi = _warped(betas, size, start, min(start + step, p))[:, :, None]
        d = psi - (pos if pos.ndim == 2 else pos[:, None])
        act = ((d * d).sum(-1) / (sigma * sigma) < REACH).sum(-1).double()
        n1 += float(act.sum())
        n2 += float((act * act).sum())
    return n1, n2


def footprint_flops(kernel: str, frames: int, p: int, n1: float,
                    n2: float) -> float:
    """Float32 operations a kernel of the demixing family must do: per
    voxel and frame the warp (10 basis values, 30 FMAs, the fade: 70); per
    active (voxel, neuron) the Gaussian once (12) and its use; the Gram
    one FMA per unordered active pair; the refinement the residual's FMA
    and the 3 position moments per pair."""
    warp_ops, gauss = 70.0 * frames * p, 12.0 * n1
    return {
        "motion_block": warp_ops + gauss + 8.0 * n1 + 64.0 * frames * p,
        "c1_block": warp_ops + gauss + 2.0 * n1,
        "gram_block": warp_ops + gauss + 2.0 * n1 + n2 + n1,
        "refine_block": warp_ops + gauss + 8.0 * n1,
    }[kernel]


def kernel_bytes(kernel: str, frames: int, p: int, k: int) -> float:
    """Bytes of one pass of ``frames`` frames: the frames ``[B, P]``, the
    warps, anchors, widths (and traces) read; the outputs written.  The
    refinement reads per-frame positions ``[B, K, 3]``, the traces and
    the widths, and writes ``mse [B]`` and ``dpos [B, K, 3]``."""
    if kernel == "refine_block":
        reads = frames * p + frames * 30 + frames * k * 4 + k
        return 4.0 * (reads + frames * (1 + 3 * k))
    reads = frames * p + frames * 30 + k * 4
    writes = {"motion_block": frames * 31, "c1_block": frames * k,
              "gram_block": frames * (k * k + k)}[kernel]
    if kernel == "motion_block":
        reads += frames * k
    return 4.0 * (reads + writes)
