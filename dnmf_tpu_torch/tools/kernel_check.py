"""Kernel checks shared by ``chip_smoke.py`` and the measuring tools.

Each kernel of :mod:`dnmf_tpu_torch.ops.fused`, :mod:`~dnmf_tpu_torch.ops.
phasecorr` and :mod:`~dnmf_tpu_torch.ops.warp` against its plain PyTorch
version in float32 and against the plain version in float64 (the oracle,
one frame at a time), with times beside the least time the card could
take (:func:`bound`: bytes over the memory rate, float32 operations over
the float32 rate, counted from this run's data: :func:`active_pairs`,
:func:`footprint_flops`).  A check that misses raises
:class:`KernelCheckError`.  On CPU tensors the wrappers run their plain
versions, so the checks run there too (the host clock stands in for CUDA
events).  The timers (:func:`host_seconds`, :func:`event_seconds`,
:func:`time_ms`) are the measuring tools' too.
"""

from __future__ import annotations

import functools
import math
import statistics
import time

import numpy as np
import torch

from dnmf_tpu_torch.ops import fused, phasecorr, warp
from dnmf_tpu_torch.registration import motion_correct as mc_lib

SEED = 0
KERNEL_TOL = 1e-4  # max|kernel - float64| / max|float64|
SHAPES = {  # name: (size, K, frames, position margin as bench.py draws it)
    "roi": ((256, 256, 10), 50, 8, 10.0),
    "whole_brain": ((512, 512, 20), 200, 2, 20.0),
}
REG_BLOCK = 16  # frames per registration kernel check (the frame_block)
REG_NOISE = 0.02  # noise std of the registration recordings
# bench.py's piecewise-rigid settings (its 512x512x20 registration timing).
BENCH_PW = dict(strides=(128, 128, 10), overlaps=(32, 32, 0),
                max_shifts=(6, 6, 2), max_deviation_rigid=3,
                upsample_factor_grid=4, upsample_factor_fft=10,
                use_remap=True, border_nan=False, rigid_decimate=4)
# The pipeline's default registration (``register_and_demix``) at
# 512x512x20: strides of half the frame, max_deviation_rigid 3.
PIPE_REG = dict(max_shifts=(8, 8, 2), strides=(256, 256, 20),
                overlaps=(8, 8, 0))
REG_SHAPES = {  # name: (size, strides, overlaps, max_shifts, max_dev)
    "roi": ((256, 256, 10), (96, 96, 10), (32, 32, 0), (6, 6, 2), 3),
    "whole_brain": ((512, 512, 20), BENCH_PW["strides"],
                    BENCH_PW["overlaps"], BENCH_PW["max_shifts"], 3),
    "pipeline": ((512, 512, 20), PIPE_REG["strides"], PIPE_REG["overlaps"],
                 PIPE_REG["max_shifts"], 3),
}
# Peak rates of an H100 SXM (NVIDIA's data sheet, at 700 W): device memory,
# and float32 outside the tensor cores, where every kernel here computes.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
REACH = 36.0  # |psi - p|^2 / sigma^2 past which exp() is below float32
# Times of the redesigned kernels before their redesign (PERF.md section
# 6; NVIDIA H100 80GB HBM3, 700.00 W), ms: printed beside the new ones.
EARLIER_MS = {("refine_block", "roi"): 1.3885,
              ("refine_block", "whole_brain"): 5.9111,
              ("phase_corr_block", "roi"): 5.7497,
              ("phase_corr_block", "whole_brain"): 31.2069,
              ("phase_corr_block", "pipeline"): 32.8219,
              ("motion_block", "roi"): 1.3252,
              ("motion_block", "whole_brain"): 1.7000,
              ("c1_block", "roi"): 0.9059,
              ("c1_block", "whole_brain"): 1.9410,
              ("c1_block_tracked", "roi"): 0.9004,
              ("c1_block_tracked", "whole_brain"): 1.9809,
              ("gram_block", "roi"): 3.5434,
              ("gram_block", "whole_brain"): 11.4524,
              ("gram_block_tracked", "roi"): 3.5782,
              ("gram_block_tracked", "whole_brain"): 11.1116,
              ("gram_block_rows", "roi"): 3.4963,
              ("gram_block_rows", "whole_brain"): 9.7140,
              ("fused_separable_warp", "roi"): 0.9263,
              ("fused_separable_warp", "whole_brain"): 10.8616}


WARMUP = 1  # untimed calls before each timed series


class KernelCheckError(Exception):
    """A kernel disagrees with its float64 oracle (or its plain table)."""


_checks = {"n": 0}


def reset_check_count() -> None:
    _checks["n"] = 0


def check_count() -> int:
    """Gated comparisons made since :func:`reset_check_count`."""
    return _checks["n"]


def gate(ok: bool, msg: str) -> None:
    """Count one gated comparison; raise :class:`KernelCheckError` with
    ``msg`` when it misses."""
    _checks["n"] += 1
    if not ok:
        raise KernelCheckError(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1e-300))


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def host_seconds(fn, reps: int, device) -> list:
    """Seconds of ``reps`` calls of ``fn`` after :data:`WARMUP` calls,
    each on the host clock ending in a device synchronize."""
    for _ in range(WARMUP):
        fn()
        sync(device)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append(time.perf_counter() - t0)
    return out


def event_seconds(fn, reps: int, device) -> list:
    """Seconds of ``reps`` calls of ``fn`` after :data:`WARMUP` calls: CUDA
    events on the card (the host clock elsewhere)."""
    if torch.device(device).type != "cuda":
        return host_seconds(fn, reps, device)
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e-3)
    return out


def summary(samples) -> dict:
    """Median, quartiles and count of ``samples``."""
    q1, med, q3 = np.percentile(np.asarray(samples, np.float64), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3),
            "n": len(samples)}


def time_ms(fn, reps: int = 5, device="cuda") -> float:
    """Median ms of ``reps`` calls (:func:`event_seconds`)."""
    return 1e3 * statistics.median(event_seconds(fn, reps, device))


def earlier(kname, name):
    """`` (earlier X ms)`` for a kernel this slice redesigned."""
    ms = EARLIER_MS.get((kname.split("[")[0], name))
    return "" if ms is None else f" (earlier {ms:.4f} ms)"


def bound(nbytes, flops):
    """``(bound_ms, bound_by)``: the least time the card could take to
    move ``nbytes`` (each input read once, each output written once) and
    do ``flops`` float32 operations, at its published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def active_pairs(betas, pos, sigma, size, scaling="normalized", lo=0,
                 hi=None):
    """``(n1, n2)`` of this run's data: the (frame, pixel, neuron) triples
    whose footprint clears float32 resolution on all three axes, and the
    sum over (frame, pixel) of their count squared (the Gram's neuron
    pairs), over the voxels ``[lo, hi)`` (default all).  ``pos [K, 3]`` or
    per-frame ``[B, K, 3]``."""
    sig = sigma if sigma.ndim == 2 else sigma[:, None].expand(-1, 3)
    inv = 1.0 / (sig * sig)
    bsz, k = betas.shape[0], pos.shape[-2]
    p = size[0] * size[1] * size[2] if hi is None else hi
    n1 = n2 = 0.0
    for start, stop, _, _ in fused._range_chunks(lo, p - lo, bsz * k * 3):
        psi = fused._warped(betas, size, scaling, start, stop)[:, :, None]
        d = psi - (pos if pos.ndim == 2 else pos[:, None])
        act = (((d * d) * inv).sum(-1) < REACH).sum(-1).double()
        n1 += float(act.sum())
        n2 += float((act * act).sum())
    return n1, n2


def footprint_flops(kname, bsz, p, n1, n2):
    """Float32 operations a kernel of the demixing family must do on this
    data: per pixel and frame the warp (10 basis values, 30 FMAs, the
    fade: 70); per active (pixel, neuron) the Gaussian, evaluated once (3
    differences, 3 products, 3 FMAs, exp2, the fade weight: 12) and its
    use; the Gram is symmetric, so one FMA per unordered active pair,
    diagonal included: ``n(n + 1) / 2`` per pixel, ``n2 + n1`` operations
    in all."""
    warp_ops, gauss = 70.0 * bsz * p, 12.0 * n1
    gram_pairs = n2 + n1
    return {
        # recon FMA and the 3 position moments per pair; dbeta: 30 FMAs
        # and the residual per pixel
        "motion_block": warp_ops + gauss + 8.0 * n1 + 64.0 * bsz * p,
        "c1_block": warp_ops + gauss + 2.0 * n1,
        "gram_block": warp_ops + gauss + 2.0 * n1 + gram_pairs,
        # the rows are given: no warp
        "gram_block_rows": gauss + 2.0 * n1 + gram_pairs,
        # the residual's FMA and the 3 position moments per pair
        "refine_block": warp_ops + gauss + 8.0 * n1,
    }[kname]


def kernel_inputs(dev, size, k, frames, margin, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    extent = torch.tensor(size, dtype=torch.float32, device=dev)
    pos = margin + rand(k, 3) * (extent - 2.0 * margin)
    sigma = torch.full((k,), 3.0, device=dev)
    betas = torch.zeros((frames, 10, 3), device=dev)
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    betas += 0.005 * torch.randn((frames, 10, 3), generator=gen, device=dev)
    y = rand(frames, size[0] * size[1] * size[2])
    c = 0.2 + 0.8 * rand(frames, k)
    return betas, pos, sigma, c, y


def check_kernels(name, frames, cases):
    """Each case's kernel against plain float32 and the float64 oracle.

    ``cases``: {label: (kernel, plain, output labels, args, per-frame
    flags of the args, float32 operations)}; the oracle runs one frame at
    a time ([P, K] float64).  Returns {label: {"max_abs_err",
    "max_rel_err" (the gated max|kernel - float64| / max|float64|), "ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms"}}: no one PyTorch
    call computes these functions, so ``library_ms`` is None.
    """
    out = {}
    for kname, (kern, plain, labels, args, framed, flops) in cases.items():
        def call(f, sl=slice(None), dtype=torch.float32):
            res = f(*(a[sl].to(dtype) if fr else a.to(dtype)
                      for a, fr in zip(args, framed)))
            return res if isinstance(res, tuple) else (res,)

        got = call(kern)
        p32 = call(plain)
        oracle = [[] for _ in labels]
        for b in range(frames):
            for i, o in enumerate(call(plain, slice(b, b + 1), torch.float64)):
                oracle[i].append(o)
        oracle = [torch.cat(o) for o in oracle]
        worst_abs = worst_rel = 0.0
        for label, g, p, o in zip(labels, got, p32, oracle):
            e_k, e_p = rel_err(g, o), rel_err(p, o)
            worst_abs = max(worst_abs, float((g.double() - o).abs().max()))
            worst_rel = max(worst_rel, e_k)
            say(f"kernel {kname} {name} {label}: kernel-vs-float64 "
                f"{e_k:.3e}, plain32-vs-float64 {e_p:.3e}, "
                f"kernel-vs-plain32 {rel_err(g, p):.3e}")
            gate(e_k <= KERNEL_TOL,
                 f"{kname} {name} {label}: {e_k:.3e} > {KERNEL_TOL}")
        dev = args[0].device
        ms = time_ms(lambda: call(kern), device=dev)
        plain_ms = time_ms(lambda: call(plain), device=dev)
        bound_ms, bound_by = bound(nbytes(*args, *got), flops)
        say(f"time {kname} {name}: kernel {ms:.4f} ms{earlier(kname, name)}"
            f", plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by};"
            f" {flops:.4e} ops) ({frames} frames)")
        out[kname] = {"max_abs_err": worst_abs, "max_rel_err": worst_rel,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}
    return out


def kernel_phase(dev, name, size, k, frames, margin, seed=SEED):
    """The demixing round's kernels at shared anchors."""
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames,
                                            margin, seed)
    p = y.shape[1]
    n1, n2 = active_pairs(betas, pos, sigma, size)
    cases = {}
    for kname, labels, args, framed in (
            ("motion_block", ("mse", "dbeta"), (betas, pos, sigma, c, y),
             (1, 0, 0, 1, 1)),
            ("c1_block", ("c1",), (betas, pos, sigma, y), (1, 0, 0, 1)),
            ("gram_block", ("G", "c1"), (betas, pos, sigma, y),
             (1, 0, 0, 1))):
        cases[kname] = (functools.partial(getattr(fused, kname), size=size),
                        functools.partial(getattr(fused, kname + "_plain"),
                                          size=size),
                        labels, args, framed,
                        footprint_flops(kname, frames, p, n1, n2))
    out = check_kernels(name, frames, cases)
    check_table(name, pos[None], sigma)
    # A and B cull by spatial bricks: the (frame, voxel, neuron) triples
    # each evaluates (the kernel's own count per brick), against the active
    # ones (n1) that the bounds count.
    for kname, counts in (
            ("motion_block", fused.motion_block(betas, pos, sigma, c, y, size,
                                                brick_counts=True)[2]),
            ("c1_block", fused.c1_block(betas, pos, sigma, y, size,
                                        brick_counts=True)[1])):
        say_candidates(kname, name, counts, size, n1)
    say_pairs("gram_block", name, fused.gram_block(
        betas, pos, sigma, y, size, brick_counts=True)[2], size, n1, n2)
    return out


def check_table(name, pos_t, sigma):
    """``build_table`` (csrc/table.cu), which the motion, c1 and refine
    wrappers launch before their kernels, against its plain version: the
    same order and largest reach, rows within 1e-6 relative."""
    table, order, rmax = fused.neuron_table(pos_t, sigma)
    t_ref, o_ref, r_ref = fused.neuron_table_plain(pos_t.cpu(), sigma.cpu())
    ok = (torch.equal(order.cpu(), o_ref) and torch.equal(rmax.cpu(), r_ref)
          and torch.allclose(table.cpu(), t_ref, rtol=1e-6, atol=0.0))
    say(f"table {name} {tuple(pos_t.shape)} sigma {tuple(sigma.shape)}: "
        f"order and reach equal the plain table, rows within 1e-6: {ok}")
    gate(ok, f"neuron table {name}: differs from neuron_table_plain")


def say_candidates(kname, name, counts, size, n1):
    """Print the (frame, voxel, neuron) triples that a brick kernel's
    counts per brick ``[B, n_bricks]`` stand for, beside the active ones."""
    ids, nb = fused.brick_ids(size, counts.device)
    vox = torch.bincount(ids, minlength=nb).double()
    pairs = float((counts.double() * vox).sum())
    say(f"kernel {kname} {name}: candidate pairs {pairs:.4e} (mean "
        f"{float(counts.double().mean()):.3f} neurons per brick of "
        f"{fused.refine_bricks(size)}), active pairs n1 {n1:.4e} (ratio "
        f"{pairs / max(n1, 1.0):.3f})")


def say_pairs(kname, name, counts, size, n1, n2):
    """Print the (frame, voxel, neuron pair) triples that the Gram kernel
    sums, from its own candidate counts per brick ``[B, n_bricks]`` (a
    brick of ``n`` candidates sums their ``n (n + 1) / 2`` pairs at each
    voxel), beside the active pairs, ``(n2 + n1) / 2``."""
    ids, nb = fused.brick_ids(size, counts.device)
    vox = torch.bincount(ids, minlength=nb).double()
    n = counts.double()
    pairs = float((n * (n + 1.0) / 2.0 * vox).sum())
    active = (n2 + n1) / 2.0
    say(f"kernel {kname} {name}: candidate pairs {pairs:.4e} (mean "
        f"{float(n.mean()):.3f} candidates per brick), active pairs "
        f"{active:.4e} (ratio {pairs / max(active, 1.0):.3f})")


def tracked_kernel_phase(dev, name, size, k, frames, margin, seed=SEED):
    """The refinement kernels at per-frame positions: the anchors plus
    ~1 px of seeded jitter.  The "refine_block" entry is the plain
    data-term gradient; the dsigma variants are checked alongside."""
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames,
                                            margin, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pos_t = pos[None] + torch.randn((frames, k, 3), generator=gen,
                                    device=dev)
    sigma3 = 3.0 * (0.8 + 0.4 * torch.rand((k, 3), generator=gen,
                                           device=dev))
    refine_args = (1, 1, 0, 1, 1)
    p = y.shape[1]
    n1, n2 = active_pairs(betas, pos_t, sigma, size)
    cases = {}
    for label, sig, want in (("refine_block", sigma, False),
                             ("refine_block[dsigma]", sigma, True),
                             ("refine_block[aniso,dsigma]", sigma3, True)):
        labels = ("mse", "dpos", "dsigma")[:2 + want]
        m1 = n1 if sig is sigma else active_pairs(betas, pos_t, sig, size)[0]
        # dsigma: 3 more moments per pair
        flops = footprint_flops("refine_block", frames, p, m1, 0.0) + (
            6.0 * m1 if want else 0.0)
        cases[label] = (
            functools.partial(fused.refine_block, size=size,
                              want_dsigma=want),
            functools.partial(fused.refine_block_plain, size=size,
                              want_dsigma=want),
            labels, (betas, pos_t, sig, c, y), refine_args, flops)
    check_table(name, pos_t, sigma)
    check_table(name, pos_t, sigma3)
    # D and the tracked c1 cull by spatial bricks: their own counts.
    say_candidates("refine_block", name, fused.refine_block(
        betas, pos_t, sigma, c, y, size, brick_counts=True)[2], size, n1)
    say_candidates("c1_block_tracked", name, fused.c1_block_tracked(
        betas, pos_t, sigma, y, size, brick_counts=True)[1], size, n1)
    say_pairs("gram_block_tracked", name, fused.gram_block_tracked(
        betas, pos_t, sigma, y, size, brick_counts=True)[2], size, n1, n2)
    cases["c1_block_tracked"] = (
        functools.partial(fused.c1_block_tracked, size=size),
        functools.partial(fused.c1_block_plain, size=size),
        ("c1",), (betas, pos_t, sigma, y), (1, 1, 0, 1),
        footprint_flops("c1_block", frames, p, n1, n2))
    cases["gram_block_tracked"] = (
        functools.partial(fused.gram_block_tracked, size=size),
        functools.partial(fused.gram_block_tracked_plain, size=size),
        ("G", "c1"), (betas, pos_t, sigma, y), (1, 1, 0, 1),
        footprint_flops("gram_block", frames, p, n1, n2))
    return check_kernels(name, frames, cases)


def rows_kernel_phase(dev, name, size, k, frames, margin, c_ms, seed=SEED):
    """Kernel C4, the Gram from precomputed rows: ``gram_block(...,
    psi_source="stream")`` against ``gram_block_rows_plain`` on the same
    rows in float32, against the float64 oracle (rows and Gram in float64,
    one frame at a time), and against the in-kernel-rows Gram kernel C on
    the same inputs.  ``ms`` is the kernel on given rows; the op entry's
    time (rows made by :func:`fused.psi_rows`, then the kernel) is printed
    beside it and C's (``c_ms``)."""
    betas, pos, sigma, _, y = kernel_inputs(dev, size, k, frames, margin,
                                            seed)
    psi, w = fused.psi_rows(betas, size)

    def kern():
        return fused.gram_block_rows(psi, w, pos, sigma, y, size)

    def plain():
        return fused.gram_block_rows_plain(psi, w, pos, sigma, y)

    got = fused.gram_block(betas, pos, sigma, y, size, psi_source="stream")
    p32 = plain()
    in_kernel = fused.gram_block(betas, pos, sigma, y, size)
    oracle = [[], []]
    for b in range(frames):
        psi64, w64 = fused.psi_rows(betas[b:b + 1].double(), size)
        for i, o in enumerate(fused.gram_block_rows_plain(
                psi64, w64, pos.double(), sigma.double(),
                y[b:b + 1].double())):
            oracle[i].append(o)
        del psi64, w64
    oracle = [torch.cat(o) for o in oracle]
    worst_abs = worst_rel = 0.0
    for label, g, p_, c_, o in zip(("G", "c1"), got, p32, in_kernel, oracle):
        e_k = rel_err(g, o)
        worst_abs = max(worst_abs, float((g.double() - o).abs().max()))
        worst_rel = max(worst_rel, e_k)
        e_c = rel_err(g, c_)
        say(f"kernel gram_block_rows {name} {label}: kernel-vs-float64 "
            f"{e_k:.3e}, plain32-vs-float64 {rel_err(p_, o):.3e}, "
            f"kernel-vs-plain32 {rel_err(g, p_):.3e}, vs the in-kernel-rows "
            f"Gram kernel {e_c:.3e}")
        gate(e_k <= KERNEL_TOL and e_c <= KERNEL_TOL,
             f"gram_block_rows {name} {label}: {e_k:.3e} / {e_c:.3e} > "
             f"{KERNEL_TOL}")
    del oracle, p32, in_kernel
    n1, n2 = active_pairs(betas, pos, sigma, size)
    say_pairs("gram_block_rows", name, fused.gram_block_rows(
        psi, w, pos, sigma, y, size, brick_counts=True)[2], size, n1, n2)
    ms, plain_ms = time_ms(kern, device=dev), time_ms(plain, device=dev)
    op_ms = time_ms(lambda: fused.gram_block(betas, pos, sigma, y, size,
                                             psi_source="stream"), device=dev)
    bound_ms, bound_by = bound(
        nbytes(psi, w, pos, sigma, y, *got),
        footprint_flops("gram_block_rows", frames, y.shape[1], n1, n2))
    say(f"time gram_block_rows {name}: kernel {ms:.4f} ms on given rows"
        f"{earlier('gram_block_rows', name)}, "
        f"op entry with psi_rows {op_ms:.4f} ms, in-kernel-rows Gram "
        f"{c_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}) ({frames} frames)")
    return {"gram_block_rows": {
        "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "op_ms": op_ms}}



def textured(gen, size, corr, dev):
    """Periodic Gaussian-filtered noise of unit std with correlation
    length ``corr`` (px, per axis), made in Fourier space."""
    spec = torch.fft.rfftn(torch.randn(size, generator=gen, device=dev))
    k2 = 0.0
    for d, (n, c) in enumerate(zip(size, corr)):
        f = (torch.fft.rfftfreq(n, device=dev) if d == len(size) - 1
             else torch.fft.fftfreq(n, device=dev))
        shape = [1] * len(size)
        shape[d] = f.numel()
        k2 = k2 + ((2.0 * math.pi * c) * f).reshape(shape) ** 2
    out = torch.fft.irfftn(spec * torch.exp(-0.5 * k2), s=size)
    return out / out.std()


def registration_inputs(dev, size, strides, overlaps, max_shifts, max_dev,
                        seed=SEED):
    """F's inputs on a 16-frame block: a textured volume rolled by known
    integer shifts plus noise, cut into the patch grid; the bounds are the
    known shift (blurred by up to half a pixel, as a rigid estimate is)
    +- ``max_dev``.  Returns a dict; ``gen`` goes on to draw G's inputs."""
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    b = REG_BLOCK
    kw = dict(generator=gen, device=dev)
    tmpl = textured(gen, size, (2.0, 2.0, 1.0), dev)
    lim = torch.tensor([ms - 1.0 for ms in max_shifts], device=dev)
    true = torch.floor(torch.rand((b, 3), **kw) * (2 * lim + 1)) - lim
    frames = torch.stack([torch.roll(tmpl, tuple(int(s) for s in true[i]),
                                     (0, 1, 2)) for i in range(b)])
    frames += REG_NOISE * torch.randn(frames.shape, **kw)
    starts, grid_shape, window = mc_lib.patch_grid(size, overlaps, strides)
    pats = phasecorr.to_zm_n(
        mc_lib._extract_patches(frames, starts, window)).contiguous()
    t_pats = mc_lib._extract_patches(tmpl, starts, window)
    tre, tim = phasecorr.patch_spectra(t_pats)
    rigid = true + torch.rand((b, 3), **kw) - 0.5
    bounds = torch.cat([torch.ceil(rigid - max_dev),
                        torch.floor(rigid + max_dev),
                        torch.zeros((b, 2), device=dev)], dim=1)
    return dict(gen=gen, frames=frames, true=true, starts=starts,
                grid_shape=grid_shape, window=window, pats=pats, tre=tre,
                tim=tim, t_pats=t_pats, bounds=bounds)


def warp_shifts(inp, max_shifts, max_dev):
    """G's inputs for a block of :func:`registration_inputs`: rigid shifts
    ``rs [B, 3]`` within ``max_shifts`` and patch shifts ``ps [B, G, 3]``
    spread ``max_dev + 3`` px around them, so that the field clip is
    active."""
    gen, dev = inp["gen"], inp["gen"].device
    kw = dict(generator=gen, device=dev)
    b = REG_BLOCK
    rs = (torch.rand((b, 3), **kw) * 2.0 - 1.0) * torch.tensor(
        [float(ms) for ms in max_shifts], device=dev)
    ps = rs[:, None] + (torch.rand((b, len(inp["starts"]), 3), **kw) * 2.0
                        - 1.0) * (max_dev + 3.0)
    return rs, ps


def registration_kernel_phase(dev, name, size, strides, overlaps,
                              max_shifts, max_dev, with_warp=True, seed=SEED):
    """Kernels F and G (G only ``with_warp``) on a 16-frame block against
    their plain versions in float32 and float64 (the oracle).

    The frames are those of :func:`registration_inputs`.  G warps them by
    patch shifts spread ``max_dev + 3`` px around rigid shifts, so that
    its field clipping is active."""
    inp = registration_inputs(dev, size, strides, overlaps, max_shifts,
                              max_dev, seed)
    gen, frames, true, starts = (inp["gen"], inp["frames"], inp["true"],
                                 inp["starts"])
    grid_shape, window, pats, tre, tim, bounds = (
        inp["grid_shape"], inp["window"], inp["pats"], inp["tre"],
        inp["tim"], inp["bounds"])
    tre64, tim64 = phasecorr.patch_spectra(inp["t_pats"].double())
    del inp
    b = REG_BLOCK
    z = window[2]

    # The registration path's call: ub - lb <= 2 max_dev bounds the
    # windows (motion_correct.tile_and_correct_block), so no sync.
    cap = max(1, int(2 * max_dev))

    def f_kernel():
        return phasecorr.phase_corr_block(pats, tre, tim, bounds, z=z,
                                          max_window=(cap, cap, cap))

    def f_plain():
        return phasecorr.phase_corr_block_plain(pats, tre, tim, bounds, z=z)

    got, p32 = f_kernel(), f_plain()
    oracle = phasecorr.phase_corr_block_plain(pats.double(), tre64, tim64,
                                              bounds, z=z)
    sync(dev)
    same = bool(torch.equal(got[0].double(), oracle[0]))
    planted = float((got[0] == true[:, None]).all(-1).double().mean())
    p32_miss = int((p32[0].double() != oracle[0]).any(-1).sum())
    e_prod = max(rel_err(g, o) for g, o in zip(got[1:], oracle[1:]))
    abs_f = max(float((g.double() - o).abs().max())
                for g, o in zip(got[1:], oracle[1:]))
    say(f"kernel phase_corr_block {name} ({len(starts)} patches of "
        f"{window}): integer shifts equal float64 {same}, equal the "
        f"planted shift in {planted:.4f} of (frame, patch); plain32 "
        f"differs from float64 in {p32_miss}; product kernel-vs-float64 "
        f"{e_prod:.3e} (max abs {abs_f:.3e} of "
        f"{float(oracle[1].abs().max()):.3e}), plain32-vs-float64 "
        f"{max(rel_err(p, o) for p, o in zip(p32[1:], oracle[1:])):.3e}")
    gate(same, f"phase_corr_block {name}: integer shifts differ from "
         "float64")
    gate(e_prod <= KERNEL_TOL,
         f"phase_corr_block {name}: {e_prod:.3e} > {KERNEL_TOL}")
    del p32, oracle, tre64, tim64
    # F's least work: a real-input forward FFT of every patch (2.5 N log2
    # N) and the cross-power product (6 per complex bin); the inverse is
    # needed only at the window's few lattice points.
    n_vox = window[0] * window[1] * window[2]
    f_flops = b * len(starts) * (2.5 * n_vox * math.log2(n_vox)
                                 + 3.0 * n_vox)
    f_bytes = nbytes(pats, tre, tim, bounds, *got)
    del got
    pats5 = pats.reshape(b, len(starts), z, -1, pats.shape[-1])
    tconj = torch.conj(torch.complex(tre, tim).reshape(pats5.shape[1:]))

    def f_library():  # cuFFT cross-correlation: forward, product, inverse
        return torch.fft.ifftn(torch.fft.fftn(pats5, dim=(-3, -2, -1))
                               * tconj, dim=(-3, -2, -1))

    timed = [("phase_corr_block", f_kernel, f_plain, abs_f, e_prod,
              f_bytes, f_flops, f_library)]
    if not with_warp:
        return time_kernels(name, b, timed, dev)

    rs, ps = warp_shifts(dict(gen=gen, starts=starts), max_shifts, max_dev)
    g_args = (grid_shape, size, max_shifts, max_dev)

    def g_kernel():
        return warp.fused_separable_warp(frames, ps, rs, *g_args)

    def g_plain():
        return warp.fused_separable_warp_plain(frames, ps, rs, *g_args)

    got, p32 = g_kernel(), g_plain()
    oracle = warp.fused_separable_warp_plain(frames.double(), ps.double(),
                                             rs.double(), *g_args)
    e_g = rel_err(got, oracle)
    say(f"kernel fused_separable_warp {name} (grid {grid_shape}): "
        f"kernel-vs-float64 {e_g:.3e}, plain32-vs-float64 "
        f"{rel_err(p32, oracle):.3e}")
    gate(e_g <= KERNEL_TOL,
         f"fused_separable_warp {name}: {e_g:.3e} > {KERNEL_TOL}")
    abs_g = float((got.double() - oracle).abs().max())
    # G's least work: per voxel the field (the cubic upsampling of the
    # patch grid, ~8 operations per axis) and a two-tap lerp per axis.
    g_bytes = nbytes(frames, ps, rs, got)
    g_flops = 3 * 12.0 * frames.numel()
    del got, p32, oracle
    timed.append(("fused_separable_warp", g_kernel, g_plain, abs_g, e_g,
                  g_bytes, g_flops, None))
    return time_kernels(name, b, timed, dev)


def time_kernels(name, frames, timed, dev="cuda"):
    """Kernel, plain and library times of ``(kname, kernel, plain,
    max_abs_err, max_rel_err, bytes, operations, library call or
    None)``."""
    out = {}
    for kname, kern, plain, err, rel, n_bytes, flops, library in timed:
        ms = time_ms(kern, device=dev)
        plain_ms = time_ms(plain, device=dev)
        library_ms = (time_ms(library, device=dev) if library is not None
                      else None)
        bound_ms, bound_by = bound(n_bytes, flops)
        lib = ("none" if library_ms is None
               else f"{library_ms:.4f} ms (kernel / library "
               f"{ms / library_ms:.4f})")
        say(f"time {kname} {name}: kernel {ms:.4f} ms{earlier(kname, name)}"
            f", plain {plain_ms:.4f} ms, library {lib}, bound "
            f"{bound_ms:.4f} ms ({bound_by}) ({frames} frames)")
        out[kname] = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms}
    return out
