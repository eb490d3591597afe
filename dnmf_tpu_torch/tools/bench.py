"""Measuring tool of the PyTorch + CUDA port on one GPU: the benchmark.

    python -m dnmf_tpu_torch.tools.bench [--seed S] [--reps N]
        [--sections a,b] [--quick]

Counterpart of the JAX package's ``bench.py``, section by section (the
shapes and schedules are its own; the draws come from a
``torch.Generator`` seeded with ``--seed``, so no JAX figure is a target):

* ``roi_round``: one alternation round (a motion epoch, the Grams, 50 MU
  iterations; ``models.dnmf.fused_rounds``) at 256x256x10, K=50, T=256,
  analytic and exact Grams;
* ``wb_passes``: the round's passes at 512x512x20, K=200, T=64 (exact and
  analytic Grams, the motion epoch, 50 MU, one refine epoch) and the exact
  Gram's share of its roofline;
* ``correctness``: every kernel against a float64 redo of its plain
  version at ``chip_smoke.py``'s ROI shapes (:mod:`.kernel_check`);
* ``registration``: rigid and piecewise-rigid estimate + apply of 16
  frames of 512x512x20;
* ``pipeline_recovery`` and ``aniso_recovery``: the recovery witnesses of
  :mod:`.wb_recovery`;
* ``streamed_io``: motion epochs from a raw file (``RawFileVideo`` with
  and without prefetch) against the resident video, factor for factor;
* ``streamed_pipeline``: ``register_and_demix`` on a NumPy recording and
  on ``open_raw_video`` of the same file, factor for factor;
* ``reference_baseline``: the reference's round (``grid_sample`` motion
  step, Gram einsums on the host), once on the CPU and once on the card.

Each section is two functions: ``<section>_fixture(seed, device,
**shape)`` draws its inputs, and ``run_<section>(fixture, reps)``
measures them and returns the JAX section's keys wherever a key means the
same thing here.  A time key holds the median of ``reps`` samples taken
after one warm-up call (:data:`kernel_check.WARMUP`, which absorbs the
kernels' build); ``timing`` gives each one's quartiles and sample count.
A section's work ends in ``torch.cuda.synchronize()`` on the host clock;
a single call is timed with CUDA events (the timers of
:mod:`.kernel_check`).

``main`` needs a CUDA device and exits at once without one.  It builds
the kernels (a line of its own with the build seconds), then prints one
JSON line per section as soon as it finishes, with the kernel launches
the section made (``launches``, counted by the wrappers) beside the
kernels it should make (``kernels_expected``), and last a headline line.
Every line carries the card's name and power limit.  A section that
raises prints its line with ``error`` and the run goes on; a section that
errs, launches none of an expected kernel or misses a gate
(:func:`gate_failures`) makes ``main`` return 1.  ``--quick`` takes one
timed repetition per section.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig, OptimizerConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.tools import kernel_check as kc
from dnmf_tpu_torch.tools import wb_recovery

SIZE = (256, 256, 10)
K = 50
T = 256
FRAME_BLOCK = 8
MU_ITERS = 50
GAMMA = 0.1  # Jacobian regularizer weight of the motion epochs
LEARNING_RATE = 1e-3
BASELINE_FRAMES = 2  # frames of the reference-equivalent round
WB_SIZE = (512, 512, 20)
WB_K = 200
# The 50-iteration MU update costs the same at any T, so the per-frame
# passes are measured at a workload-like T and the MU total is reported
# beside its per-frame share.
WB_T = 64
REG_FRAMES = 16  # frames of one registration block (its frame_block)
STREAM_SIZE, STREAM_K, STREAM_T, STREAM_BLOCK = (128, 128, 10), 30, 48, 8
PIPE_SIZE, PIPE_K, PIPE_T, PIPE_BLOCK = (128, 128, 8), 24, 48, 8
STREAM_TOL = 1e-5  # streamed vs resident epochs: beta, traces (relative)
PIPE_TOL = 1e-4  # streamed vs resident pipeline: beta, traces (relative)
PIPE_CORR_MEAN = 0.9  # pipeline recovery: trace corr mean vs the truth
# What each section's path should launch (the wrappers' names).
EXPECTED = {
    "roi_round": ("motion_block", "c1_block", "gram_block"),
    "wb_passes": ("motion_block", "c1_block", "gram_block", "refine_block"),
    "correctness": tuple(fn.__name__ for fn in fused.KERNELS),
    "registration": ("phase_corr_block", "fused_separable_warp"),
    "pipeline_recovery": ("motion_block", "c1_block"),
    "streamed_io": ("motion_block", "gram_block"),
    "aniso_recovery": ("motion_block", "c1_block", "refine_block"),
    # The pipeline's default registration applies the field exactly (no
    # G), and its fit audits the closed form with one exact Gram (C).
    "streamed_pipeline": ("phase_corr_block", "motion_block", "c1_block",
                          "gram_block"),
    "reference_baseline": (),
}


# ----------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------
def timed(out: dict, key: str, samples, scale: float = 1.0) -> float:
    """Put the median of ``samples * scale`` under ``out[key]`` and its
    quartiles and count under ``out["timing"][key]``; return the median."""
    s = kc.summary([x * scale for x in samples])
    out[key] = s.pop("median")
    out.setdefault("timing", {})[key] = s
    return out[key]


def _rel_max(a, b) -> float:
    return float(torch.max(torch.abs(a - b))
                 / torch.clamp_min(torch.max(torch.abs(b)), 1e-30))


def uniform(gen, shape, device):
    """U[0, 1) draws of ``gen`` (on its own device), moved to ``device``."""
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def seeded_generator(seed: int, device) -> torch.Generator:
    """The sections' draws: a generator on ``device`` seeded with ``seed``."""
    return torch.Generator(torch.device(device)).manual_seed(seed)


def demix_fixture(seed, device, size, k, t, margin):
    """A timing fixture: positions ``margin + U * (size - 2 margin)``,
    uniform random frames, the initial state (identity warps, random
    traces from a CPU generator)."""
    model = ModelConfig(size=size, num_neurons=k, num_frames=t,
                        shape_std=3.0)
    gen = seeded_generator(seed, device)
    extent = torch.tensor(size, dtype=torch.float32, device=device)
    pos = margin + uniform(gen, (k, 3), device) * (extent - 2.0 * margin)
    video = uniform(gen, (t, model.num_voxels), device)
    state = model_lib.init_state(
        model, positions=pos, generator=torch.Generator().manual_seed(seed),
        device=device)
    return {"model": model, "state": state, "video": video,
            "device": torch.device(device)}


def motion_optimizer():
    """Adam on the warps at the sections' learning rate."""
    return model_lib.make_motion_optimizer(
        OptimizerConfig(learning_rate=LEARNING_RATE))


# ----------------------------------------------------------------------
# roi_round
# ----------------------------------------------------------------------
def roi_round_fixture(seed, device, size=SIZE, k=K, t=T,
                      frame_block=FRAME_BLOCK, mu_iters=MU_ITERS):
    fx = demix_fixture(seed, device, size, k, t, 10.0)
    fx.update(frame_block=frame_block, mu_iters=mu_iters)
    return fx


def run_roi_round(fx, reps) -> dict:
    """Seconds per alternation round (the state carried from round to
    round), analytic Grams (the production default) and exact."""
    model, video, dev = fx["model"], fx["video"], fx["device"]
    size, t = model.size, model.num_frames
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={model.num_neurons}"
                       f" T={t} 1 motion epoch + grams + {fx['mu_iters']} MU"}
    optimizer = motion_optimizer()
    for mode, sfx in (("analytic", ""), ("exact", "_exact")):
        box = {"state": fx["state"]}

        def one_round():
            box["state"], box["m"] = model_lib.fused_rounds(
                box["state"], video, model, optimizer, rounds=1, epochs=1,
                mu_iters=fx["mu_iters"], gamma=GAMMA,
                frame_block=fx["frame_block"], use_kernels=True,
                gram_mode=mode)

        secs = kc.host_seconds(one_round, reps, dev)
        med = timed(out, "round_seconds" + sfx, secs)
        out["round_seconds_min" + sfx] = min(secs)
        out["round_seconds_max" + sfx] = max(secs)
        out["frames_per_sec" + sfx] = t / med
        out["recon_mse" + sfx] = float(box["m"]["recon_mse"][-1])
    return out


# ----------------------------------------------------------------------
# wb_passes
# ----------------------------------------------------------------------
def wb_passes_fixture(seed, device, size=WB_SIZE, k=WB_K, t=WB_T,
                      frame_block=FRAME_BLOCK, mu_iters=MU_ITERS):
    # The face-hugging draw (margin 20) sets the culled kernels' activity
    # pattern: neurons near the borders, as in real recordings.
    fx = demix_fixture(seed, device, size, k, t, 20.0)
    fx.update(frame_block=frame_block, mu_iters=mu_iters)
    return fx


def gram_roofline(betas, pos, sigma, y, size, outputs, seconds) -> dict:
    """The exact Gram's share of its roofline on this run's data: the
    least time the card could take (:func:`kernel_check.bound`: each input
    read and each output written once over the memory rate, and the
    operations of :func:`kernel_check.footprint_flops` over the float32
    rate, with one FMA per active unordered neuron pair) over ``seconds``,
    the measured time of the same work.  ``gram_active_pairs`` is that
    pair count, (frame, voxel, unordered pair incl. the diagonal);
    ``gram_flops_algorithmic`` the dense ``2 P K^2`` per frame, a count
    only."""
    bsz, p = betas.shape[0], y.shape[1]
    n1, n2 = kc.active_pairs(betas, pos, sigma, size)
    flops = kc.footprint_flops("gram_block", bsz, p, n1, n2)
    bound_ms, bound_by = kc.bound(kc.nbytes(betas, pos, sigma, y, *outputs),
                                  flops)
    return {"gram_roofline_share": bound_ms * 1e-3 / seconds,
            "gram_bound_by": bound_by, "gram_bound_ms": bound_ms,
            "gram_active_pairs": (n2 + n1) / 2.0,
            "gram_flops_algorithmic": 2.0 * p * pos.shape[-2] ** 2 * bsz}


def run_wb_passes(fx, reps) -> dict:
    """Per-frame times of the round's passes (each pass over all T frames
    in frame blocks, timed with CUDA events), the closed-form Grams' max
    relative error against the exact ones, and the exact Gram's share of
    its roofline."""
    model, state, video, dev = (fx["model"], fx["state"], fx["video"],
                                fx["device"])
    size, k, t = model.size, model.num_neurons, model.num_frames
    fb = fx["frame_block"]
    optimizer = motion_optimizer()
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={t}"}
    box = {}

    def grams(mode):
        def run():
            box[mode] = model_lib.compute_grams(
                state, video, model, frame_block=fb, use_kernels=True,
                gram_mode=mode)
        return run

    g_s = timed(out, "gram_s", kc.event_seconds(grams("exact"), reps, dev))
    ga_s = timed(out, "gram_analytic_s", kc.event_seconds(
        grams("analytic"), reps, dev))
    out["gram_analytic_max_rel_err"] = _rel_max(box["analytic"][0],
                                                box["exact"][0])
    m_s = timed(out, "motion_s", kc.event_seconds(
        lambda: model_lib.motion_epoch_parallel(
            state, video, model, optimizer, GAMMA, frame_block=fb,
            use_kernels=True), reps, dev))
    mu_s = timed(out, "mu50_s", kc.event_seconds(
        lambda: model_lib.footprint_update(state, *box["exact"],
                                           iters=fx["mu_iters"]),
        reps, dev))
    r_s = timed(out, "refine_epoch_s", kc.event_seconds(
        lambda: refine_lib.refine_positions(state, None, video, model,
                                            epochs=1, use_kernels=True),
        reps, dev))
    for key, secs in (("gram_ms_per_frame", g_s),
                      ("gram_analytic_ms_per_frame", ga_s),
                      ("motion_ms_per_frame", m_s),
                      ("mu50_ms_per_frame", mu_s),
                      ("refine_epoch_ms_per_frame", r_s)):
        out[key] = secs / t * 1e3
    out["mu50_ms_total_fixed"] = mu_s * 1e3
    out["round_frames_per_sec"] = t / (g_s + m_s + mu_s)
    out["round_analytic_frames_per_sec"] = t / (ga_s + m_s + mu_s)
    out.update(gram_roofline(state.beta, state.pos, state.sigma, video,
                             size, box["exact"], g_s))
    return out


# ----------------------------------------------------------------------
# correctness
# ----------------------------------------------------------------------
def correctness_fixture(seed, device, shape=None, reg=None):
    """``shape``: (size, K, frames, margin) of the demixing kernels;
    ``reg``: (size, strides, overlaps, max_shifts, max_dev) of F and G;
    by default ``chip_smoke.py``'s ROI shapes."""
    return {"seed": seed, "device": torch.device(device),
            "shape": shape or kc.SHAPES["roi"],
            "reg": reg or kc.REG_SHAPES["roi"]}


def run_correctness(fx, reps=1) -> dict:
    """Every kernel against its float64 oracle within
    :data:`kernel_check.KERNEL_TOL` (and the neuron tables against their
    plain twin): pass, the number of gated comparisons made, the first
    failure, and each kernel's gated error and ms beside its plain
    version's.  The checks' own lines go to stderr."""
    del reps  # the checks time themselves (median of 5)
    dev, seed = fx["device"], fx["seed"]
    size, k, frames, margin = fx["shape"]
    results, failed = {}, []
    kc.reset_check_count()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            results.update(kc.kernel_phase(dev, "roi", size, k, frames, margin,
                                           seed))
            results.update(kc.tracked_kernel_phase(dev, "roi", size, k, frames,
                                                   margin, seed))
            results.update(kc.rows_kernel_phase(
                dev, "roi", size, k, frames, margin,
                results["gram_block"]["ms"], seed))
            results.update(kc.registration_kernel_phase(dev, "roi", *fx["reg"],
                                                        seed=seed))
    except kc.KernelCheckError as e:
        failed.append(str(e))
    return {"pass": not failed, "checks": kc.check_count(), "failed": failed,
            "tol": kc.KERNEL_TOL,
            "max_rel_err": {n: r["max_rel_err"] for n, r in results.items()},
            "kernel_ms": {n: r["ms"] for n, r in results.items()},
            "plain_ms": {n: r["plain_ms"] for n, r in results.items()}}


# ----------------------------------------------------------------------
# registration
# ----------------------------------------------------------------------
def registration_fixture(seed, device, size=WB_SIZE, frames=REG_FRAMES,
                         pw=None):
    """Uniform random frames and template; ``pw``: the piecewise-rigid
    settings (:data:`kernel_check.BENCH_PW`)."""
    gen = seeded_generator(seed, device)
    return {"frames": uniform(gen, (frames,) + tuple(size), device),
            "template": uniform(gen, tuple(size), device),
            "pw": dict(pw or kc.BENCH_PW), "device": torch.device(device)}


def run_registration(fx, reps) -> dict:
    """Rigid and piecewise-rigid estimate + apply, ms per frame of one
    block (the fused path: F for the patch correlations, G for the
    field's apply)."""
    from dnmf_tpu_torch.registration.motion_correct import (
        rigid_correct_frames, tile_and_correct_block)

    frames, template, pw, dev = (fx["frames"], fx["template"], fx["pw"],
                                 fx["device"])
    b = frames.shape[0]
    out = {}
    timed(out, "rigid_est_apply_ms_per_frame", kc.event_seconds(
        lambda: rigid_correct_frames(frames, template, pw["max_shifts"],
                                     upsample_factor=10, border_nan=False),
        reps, dev), 1e3 / b)
    timed(out, "pwrigid_est_apply_ms_per_frame", kc.event_seconds(
        lambda: tile_and_correct_block(frames, template, remap_mode="fused",
                                       **pw),
        reps, dev), 1e3 / b)
    out["pwrigid_config"] = (
        f"strides {pw['strides']}, overlaps {pw['overlaps']}, max_shifts "
        f"{pw['max_shifts']}, kernel F phase correlation, kernel G warp, "
        f"rigid_decimate={pw['rigid_decimate']}, {b}-frame blocks")
    return out


# ----------------------------------------------------------------------
# pipeline_recovery and aniso_recovery
# ----------------------------------------------------------------------
def _witness_fixture(name, seed, device, size=None, k=None, t=None,
                     rounds=None, epochs=None, mu_iters=None):
    w = wb_recovery.WITNESSES[name]
    fx = wb_recovery.recovery_fixture(
        size or w["size"], k or w["k"], t or w["t"],
        sigma_aniso=w["sigma_aniso"], seed=seed, device=device)
    fx.update(rounds=rounds or w["rounds"], epochs=epochs or w["epochs"],
              mu_iters=mu_iters or w["mu_iters"], fit=dict(w["fit"]))
    return fx


def pipeline_recovery_fixture(seed, device, **shape):
    """The whole-brain witness's fixture (512x512x20, K=200, T=32) and
    schedule (6 x (12 epochs + 50 MU)); ``shape`` overrides ``size``,
    ``k``, ``t``, ``rounds``, ``epochs``, ``mu_iters``."""
    return _witness_fixture("pipeline", seed, device, **shape)


def _schedule(fx) -> str:
    return f"{fx['rounds']}x({fx['epochs']}ep+{fx['mu_iters']}MU)"


def run_pipeline_recovery(fx, reps=1) -> dict:
    """Register -> seed -> demix on the synthesized recording: trace
    correlation with the truth, warp error and seconds per round (the
    rounds after the first are the samples)."""
    del reps  # the protocol runs once; its rounds are the samples
    size, (k, t) = fx["size"], fx["c_gt"].shape
    r = wb_recovery.recover(fx, fx["rounds"], fx["epochs"], fx["mu_iters"],
                            **fx["fit"])
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={t} "
                       f"{_schedule(fx)}, rigid-seeded, analytic grams",
           "trace_corr_mean": float(np.mean(r["corr"])),
           "trace_corr_min": float(np.min(r["corr"])),
           "warp_err_px": r["warp_err_px"],
           "registration_seed_s": r["reg_s"]}
    steady = timed(out, "round_s_steady", r["round_s"][1:] or r["round_s"])
    out["frames_per_sec_full_round"] = t / steady
    return out


def aniso_recovery_fixture(seed, device, **shape):
    """The anisotropic witness's fixture (256x256x10, K=100, T=32, per-axis
    widths in the truth) and schedule (6 x (8 epochs + 50 MU), widths
    fitted every round, 4 steps x 16 frames)."""
    return _witness_fixture("aniso", seed, device, **shape)


def run_aniso_recovery(fx, reps=1) -> dict:
    """Both arms on the same truth: per-axis widths and the isotropic
    control; width error, trace correlations and seconds per round."""
    del reps
    size, (k, t) = fx["size"], fx["c_gt"].shape
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={t}, aniso "
                       "GT (z-flattened 0.6x, +-25%/axis), "
                       f"{_schedule(fx)}+fit_sigma (every round, 4 steps x "
                       "16 frames)"}
    for axes, arm in ((3, "aniso"), (1, "iso")):
        r = wb_recovery.recover(fx, fx["rounds"], fx["epochs"],
                                fx["mu_iters"], fit_sigma_axes=axes,
                                **fx["fit"])
        out[f"sigma_err_px_{arm}_fit"] = r["sigma_err"]
        out[f"trace_corr_mean_{arm}"] = float(np.mean(r["corr"]))
        out[f"trace_corr_min_{arm}"] = float(np.min(r["corr"]))
        timed(out, f"round_s_{arm}", r["round_s"][1:] or r["round_s"])
    return out


# ----------------------------------------------------------------------
# streamed_io
# ----------------------------------------------------------------------
def streamed_io_fixture(seed, device, size=STREAM_SIZE, k=STREAM_K,
                        t=STREAM_T, block=STREAM_BLOCK):
    fx = demix_fixture(seed, device, size, k, t, 10.0)
    fx["block"] = block
    return fx


def _evict(path: str) -> None:
    """Drop the file's pages from the host page cache."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def _resident_share(path: str) -> float:
    """The share of the file's pages that sit in the host page cache
    (``mincore(2)`` over a shared read-only mapping)."""
    size = os.path.getsize(path)
    pages = -(-size // os.sysconf("SC_PAGE_SIZE"))
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, 1, 1, fd, 0)  # PROT_READ, MAP_SHARED
        if addr in (None, ctypes.c_void_p(-1).value):
            raise OSError(ctypes.get_errno(), "mmap failed", path)
        vec = (ctypes.c_ubyte * pages)()
        try:
            if libc.mincore(addr, size, vec) != 0:
                raise OSError(ctypes.get_errno(), "mincore failed", path)
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)
    return sum(v & 1 for v in vec) / pages


def _raw_file(video: torch.Tensor) -> str:
    """The frames as a raw float32 file (the block reader's format) in
    the temporary directory, flushed to the disk (dirty pages would
    survive the eviction); the caller deletes it."""
    host = video.detach().cpu().numpy().astype(np.float32)
    with tempfile.NamedTemporaryFile(suffix=".raw", delete=False) as f:
        host.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    return f.name


def run_streamed_io(fx, reps) -> dict:
    """Seconds per motion epoch, resident and streamed from a raw file
    through the native block reader (with and without prefetch), the
    reader's rate with the page cache evicted before each read (one
    ``read`` of every frame into host memory, no copy to the card) beside
    the largest share of the file still cached when a read began (1.0
    where the file system keeps its pages anyway, as one in memory or
    over 9P may: then the rate is not a disk's), and the streamed
    factors against the resident ones (beta after the same epochs; traces
    after 30 MU on each one's Grams)."""
    from dnmf_tpu_torch.data.streaming import RawFileVideo

    model, video, dev, blk = (fx["model"], fx["video"], fx["device"],
                              fx["block"])
    size, k, t = model.size, model.num_neurons, model.num_frames
    optimizer = motion_optimizer()
    path = _raw_file(video)
    try:
        def epochs(step):
            box = {"state": fx["state"]}

            def one():
                box["state"], _m = step(box["state"])

            return box, kc.host_seconds(one, reps, dev)

        def streamed(src):
            return lambda state: model_lib.motion_epoch_streaming(
                state, src, model, optimizer, GAMMA, use_kernels=True)

        res, sec_res = epochs(lambda s: model_lib.motion_epoch_parallel(
            s, video, model, optimizer, GAMMA, frame_block=blk,
            use_kernels=True))
        src_pf = RawFileVideo(path, (t,) + size, block=blk, prefetch=True,
                              device=dev)
        pf, sec_pf = epochs(streamed(src_pf))
        src_np = RawFileVideo(path, (t,) + size, block=blk, prefetch=False,
                              device=dev)
        _, sec_np = epochs(streamed(src_np))
        read_s, resident = [], 0.0
        for _ in range(reps):
            _evict(path)
            resident = max(resident, _resident_share(path))
            t0 = time.perf_counter()
            src_np.read(0, t)
            read_s.append(time.perf_counter() - t0)

        st_res, st_pf = res["state"], pf["state"]
        beta_err = float(torch.max(torch.abs(st_res.beta - st_pf.beta)))
        grams_r, c1_r = model_lib.compute_grams(
            st_res, video, model, frame_block=blk, use_kernels=True)
        grams_s, c1_s = model_lib.compute_grams_streaming(
            st_pf, src_pf, model, use_kernels=True)
    finally:
        os.unlink(path)
    c_res = model_lib.footprint_update(st_res, grams_r, c1_r, iters=30).c
    c_str = model_lib.footprint_update(st_pf, grams_s, c1_s, iters=30).c
    c_err = _rel_max(c_str, c_res)
    mb = t * model.num_voxels * 4 / 1e6
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={t} raw-f32 "
                       f"file ({mb:.1f} MB per epoch), native block reader"}
    s_res = timed(out, "resident_epoch_s", sec_res)
    s_pf = timed(out, "streamed_epoch_s_prefetch", sec_pf)
    timed(out, "streamed_epoch_s_noprefetch", sec_np)
    out["native_read_mb_s_cold"] = mb / timed(out, "native_read_s_cold",
                                              read_s)
    out["native_read_cached_share"] = resident
    # The rate at which streaming adds time to an epoch: the megabytes of
    # one pass over the extra seconds (None when it adds none).
    out["streamed_overhead_mb_s"] = (mb / (s_pf - s_res) if s_pf > s_res
                                     else None)
    out.update(beta_max_abs_diff=beta_err, traces_max_rel_diff=c_err,
               factors_match=bool(beta_err < STREAM_TOL
                                  and c_err < STREAM_TOL))
    return out


# ----------------------------------------------------------------------
# streamed_pipeline
# ----------------------------------------------------------------------
def streamed_pipeline_fixture(seed, device, size=PIPE_SIZE, k=PIPE_K,
                              t=PIPE_T, block=PIPE_BLOCK, rounds=3,
                              epochs=8, mu_iters=MU_ITERS):
    """A recording of the recovery harness's synthesis (interior neurons,
    smooth warps, exponential traces, noise) held on the host."""
    model = ModelConfig(size=size, num_neurons=k, num_frames=t,
                        shape_std=3.0)
    gen = seeded_generator(seed, device)
    pos_gt = wb_recovery.interior_positions(gen, k, size, margin=12.0,
                                            device=device)
    sigma_gt = torch.full((k,), model.shape_std, device=device)
    _betas, c_gt, video, _ = wb_recovery.synthesize(model, pos_gt, sigma_gt,
                                                    gen)
    host = np.maximum(video.cpu().numpy().astype(np.float32), 0.0)
    return {"model": model, "host": host.reshape((t,) + tuple(size)),
            "c_gt": c_gt, "pos_gt": pos_gt, "block": block,
            "optimizer": OptimizerConfig(learning_rate=LEARNING_RATE,
                                         outer_rounds=rounds,
                                         motion_epochs=epochs,
                                         mu_iters=mu_iters,
                                         gamma_motion=GAMMA),
            "device": torch.device(device)}


def run_streamed_pipeline(fx, reps) -> dict:
    """``register_and_demix`` (pw-rigid registration, points given, the
    fit) on the NumPy recording and on ``open_raw_video`` of the same
    file: seconds of each, the factors against each other and the traces
    against the truth."""
    from dnmf_tpu_torch.data.streaming import open_raw_video
    from dnmf_tpu_torch.engine.pipeline import register_and_demix
    from dnmf_tpu_torch.utils.metrics import trace_correlations

    model, host, dev, blk = (fx["model"], fx["host"], fx["device"],
                             fx["block"])
    size, k, t = model.size, model.num_neurons, model.num_frames
    pts = fx["pos_gt"].cpu().numpy().astype(np.float64)
    box = {}

    def run(source, key):
        def call():
            box[key] = register_and_demix(source(), points=pts, model=model,
                                          optimizer=fx["optimizer"],
                                          device=dev)
        return call

    path = _raw_file(torch.from_numpy(host))
    try:
        sec_r = kc.host_seconds(run(lambda: host, "resident"), reps, dev)
        sec_s = kc.host_seconds(run(lambda: open_raw_video(
            path, (t,) + tuple(size), block=blk, device=dev), "streamed"),
            reps, dev)
    finally:
        os.unlink(path)
    res_r, res_s = box["resident"], box["streamed"]
    beta_err = float(torch.max(torch.abs(res_s.fit.state.beta
                                         - res_r.fit.state.beta)))
    tr_r, tr_s = res_r.traces, res_s.traces
    c_err = float(np.max(np.abs(tr_s - tr_r))
                  / max(float(np.max(np.abs(tr_r))), 1e-30))
    corr = trace_correlations(tr_s, fx["c_gt"])
    out = {"workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={t} raw-f32 "
                       f"file, block={blk}, pw-rigid register->demix "
                       "one call, points given"}
    timed(out, "pipeline_s_resident", sec_r)
    timed(out, "pipeline_s_streamed", sec_s)
    out.update(trace_corr_mean=float(np.mean(corr)),
               corr_note="light schedule: the gate here is streamed == "
                         "resident; recovery is pipeline_recovery's",
               beta_max_abs_diff=beta_err, traces_max_rel_diff=c_err,
               factors_match=bool(beta_err < PIPE_TOL and c_err < PIPE_TOL))
    return out


# ----------------------------------------------------------------------
# reference_baseline
# ----------------------------------------------------------------------
def reference_baseline_fixture(seed, device, size=SIZE, k=K,
                               frames=BASELINE_FRAMES):
    """The reference-equivalent round's inputs, drawn on the host: a
    stored footprint volume ``a_vol [m, n, z, K]`` (Gaussians, sigma 3),
    identity warps, random traces and frames.  ``device`` is where the
    second run goes (the first is on the CPU)."""
    m, n, z = size
    gen = torch.Generator().manual_seed(seed)
    grid = torch.stack(torch.meshgrid(
        torch.arange(m, dtype=torch.float32),
        torch.arange(n, dtype=torch.float32),
        torch.arange(z, dtype=torch.float32), indexing="ij"), dim=-1)
    pos = 10.0 + torch.rand((k, 3), generator=gen) * (
        torch.tensor(size, dtype=torch.float32) - 20.0)
    a_vol = torch.exp(-((grid[:, :, :, None, :] - pos) ** 2).sum(-1) / 9.0)
    return {"size": tuple(size), "grid": grid, "a_vol": a_vol,
            "c": torch.rand((k, frames), generator=gen),
            "y": torch.rand((frames, m, n, z), generator=gen),
            "device": torch.device(device)}


def reference_mu_line(a_np, y_np, c_np):
    """One MU line of the reference on the host (NumPy einsums, which the
    reference recomputes in each of its 50 iterations): ``a_np [m, n, z,
    K, t]`` warped footprints, ``y_np [m, n, z, t]`` frames, ``c_np [K,
    t]`` traces.  Returns ``(grams [K, K, t], c1 [K, t], c_new [K, t])``."""
    a_ts = np.einsum("mnzkt,mnzlt->klt", a_np, a_np)
    c1 = np.einsum("mnzkt,mnzt->kt", a_np, y_np)
    c2 = np.einsum("klt,lt->kt", a_ts, c_np)
    return a_ts, c1, c_np * c1 / (c2 + 1e-32)


def _reference_round(fx, dev, reps) -> dict:
    """The reference's motion step (``grid_sample`` of the stored volume,
    autograd, Adam) on ``dev`` and its MU line on the host: seconds of
    each and the per-frame round ``(motion + 50 MU lines) / frames``."""
    import torch.nn.functional as F

    m, n, z = fx["size"]
    grid, c = fx["grid"].to(dev), fx["c"].to(dev)
    a_vol, y = fx["a_vol"].to(dev), fx["y"].to(dev)
    tb = y.shape[0]
    beta = torch.zeros((tb, 10, 3), device=dev)
    beta[:, 1, 0] = beta[:, 2, 1] = beta[:, 3, 2] = 1.0
    beta.requires_grad_(True)
    opt = torch.optim.Adam([beta], lr=1e-3)
    sizes = torch.tensor(fx["size"], dtype=torch.float32, device=dev)
    basis = torch.cat([torch.ones((m, n, z, 1), device=dev), grid, grid ** 2,
                       (grid[..., 0] * grid[..., 1])[..., None],
                       (grid[..., 0] * grid[..., 2])[..., None],
                       (grid[..., 1] * grid[..., 2])[..., None]], dim=-1)
    a_in = a_vol.permute(3, 2, 1, 0)[None].expand(tb, -1, -1, -1, -1)
    box = {}

    def motion_step():
        opt.zero_grad()
        g = torch.einsum("mnza,tab->tmnzb", basis, beta)
        g = 2 * g / (sizes - 1) - 1
        warped = F.grid_sample(a_in, g.permute(0, 3, 2, 1, 4),
                               align_corners=True).permute(0, 1, 4, 3, 2)
        recon = torch.einsum("tkmnz,kt->tmnz", warped, c)
        F.mse_loss(recon, y).backward()
        opt.step()
        box["warped"] = warped

    motion = kc.host_seconds(motion_step, reps, dev)
    a_np = box["warped"].detach().cpu().numpy().transpose(2, 3, 4, 1, 0)
    y_np = y.cpu().numpy().transpose(1, 2, 3, 0)
    c_np = c.cpu().numpy()
    mu = kc.host_seconds(lambda: reference_mu_line(a_np, y_np, c_np), reps,
                         "cpu")
    out = {}
    mot, mu_once = timed(out, "motion_step_s", motion), timed(
        out, "mu_line_s", mu)
    out["per_frame_s"] = (mot + MU_ITERS * mu_once) / tb
    return out


def run_reference_baseline(fx, reps) -> dict:
    """The reference-equivalent round per frame, on the CPU as the JAX
    package measures it, then with the motion step on the card (the MU
    einsums stay on the host, where the reference runs them), and each
    extrapolated to the ROI round's T frames."""
    out = {"workload": f"{fx['size'][0]}x{fx['size'][1]}x{fx['size'][2]} "
                       f"K={fx['c'].shape[0]}, {fx['y'].shape[0]} frames, "
                       f"motion step + {MU_ITERS} x MU line, per frame"}
    for label, dev in (("cpu", torch.device("cpu")), ("card", fx["device"])):
        if label == "card" and dev.type != "cuda":
            continue
        r = _reference_round(fx, dev, reps)
        out.setdefault("timing", {}).update(
            {f"{key}_{label}": s for key, s in r.pop("timing").items()})
        out.update({f"{key}_{label}": v for key, v in r.items()})
        out[f"baseline_round_s_extrapolated_{label}"] = (
            r["per_frame_s"] * T)
    return out


# ----------------------------------------------------------------------
# The run
# ----------------------------------------------------------------------
SECTIONS = {
    "roi_round": (roi_round_fixture, run_roi_round),
    "wb_passes": (wb_passes_fixture, run_wb_passes),
    "correctness": (correctness_fixture, run_correctness),
    "registration": (registration_fixture, run_registration),
    "pipeline_recovery": (pipeline_recovery_fixture, run_pipeline_recovery),
    "streamed_io": (streamed_io_fixture, run_streamed_io),
    "aniso_recovery": (aniso_recovery_fixture, run_aniso_recovery),
    "streamed_pipeline": (streamed_pipeline_fixture, run_streamed_pipeline),
    "reference_baseline": (reference_baseline_fixture,
                           run_reference_baseline),
}


def gate_failures(name: str, line: dict) -> list:
    """The gates a section's line misses: an error, an expected kernel
    never launched, and the section's recovery and equality gates
    (``factors_match``; the pipeline witness's trace corr mean; the
    kernels' correctness)."""
    failed = []
    if "error" in line:
        failed.append("error")
    if line.get("kernels_missing"):
        failed.append(f"kernels not launched: {line['kernels_missing']}")
    if "factors_match" in line and not line["factors_match"]:
        failed.append("factors_match")
    if name == "pipeline_recovery" and "trace_corr_mean" in line and not (
            line["trace_corr_mean"] >= PIPE_CORR_MEAN):
        failed.append(f"trace_corr_mean < {PIPE_CORR_MEAN}")
    if name == "correctness" and "pass" in line and not line["pass"]:
        failed.append("correctness")
    return failed


def run_section(name: str, seed: int, device, reps: int) -> dict:
    """One section's line: its results, the launches of its run (counted
    from 0 after its fixture), the kernels it should launch, and on a
    raise the error instead of the results."""
    fixture_fn, run_fn = SECTIONS[name]
    line = {"section": name}
    t0 = time.perf_counter()
    try:
        fx = fixture_fn(seed, device)
        fused.reset_launch_counts()
        line.update(run_fn(fx, reps))
        launches = fused.launch_counts()
        line["launches"] = {kn: n for kn, n in launches.items() if n}
        line["kernels_expected"] = list(EXPECTED[name])
        if torch.device(device).type == "cuda":
            line["kernels_missing"] = [kn for kn in EXPECTED[name]
                                       if not launches[kn]]
    except Exception as e:  # noqa: BLE001 - the run goes on to the next
        line["error"] = f"{type(e).__name__}: {e}"
        line["traceback"] = traceback.format_exc(limit=4)
    line["section_s"] = time.perf_counter() - t0
    failed = gate_failures(name, line)
    if failed:
        line["gates_failed"] = failed
    return line


def headline(lines: dict) -> dict:
    """The last line: frames per second of the production round (analytic
    Grams) at the ROI shape and its speed-up over the reference-equivalent
    round on the CPU (and with its motion step on the card)."""
    roi, base = lines.get("roi_round", {}), lines.get("reference_baseline",
                                                      {})
    out = {"metric": "frames/sec/chip", "value": None, "unit": "frames/s",
           "vs_baseline": None, "workload": roi.get("workload"),
           "gram_mode": "analytic (the production default; exact beside)"}
    if "round_seconds" not in roi:
        out["error"] = "roi_round did not run"
        return out
    rs = roi["round_seconds"]
    timing = roi["timing"]["round_seconds"]
    out.update(value=roi["frames_per_sec"],
               round_ms=rs * 1e3, round_ms_q1=timing["q1"] * 1e3,
               round_ms_q3=timing["q3"] * 1e3, samples=timing["n"],
               round_ms_min=roi["round_seconds_min"] * 1e3,
               round_ms_max=roi["round_seconds_max"] * 1e3,
               round_ms_exact=roi["round_seconds_exact"] * 1e3,
               frames_per_sec_exact=roi["frames_per_sec_exact"])
    for label, key in (("", "cpu"), ("_card", "card")):
        b = base.get(f"baseline_round_s_extrapolated_{key}")
        if b is not None:
            out[f"vs_baseline{label}"] = b / rs
            out[f"baseline_round_s_extrapolated{label}"] = b
    return out


def device_info() -> dict:
    """The card's name (``torch.cuda.get_device_name(0)``), power limit in
    W (``nvidia-smi``) and the device count."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    limit = smi.rsplit(",", 1)[1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": float(limit), "count": torch.cuda.device_count(),
            "nvidia_smi": smi}


def build_line() -> dict:
    """Build the kernels and the native block reader (each a no-op when
    its build exists), with the seconds each took."""
    from dnmf_tpu_torch.native import load_blockreader
    from dnmf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    t1 = time.perf_counter()
    native = load_blockreader()
    return {"build_s": t1 - t0, "library": _build.library_path().name,
            "native_build_s": time.perf_counter() - t1,
            "native_reader": native is not None}


def emit(line: dict, device: dict) -> None:
    print(json.dumps({**line, "device": device}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed repetitions per section (after one "
                         "warm-up)")
    ap.add_argument("--sections", default="all",
                    help="comma list from " + ",".join(SECTIONS))
    ap.add_argument("--quick", action="store_true",
                    help="one timed repetition per section")
    args = ap.parse_args(argv)
    names = (list(SECTIONS) if args.sections == "all"
             else args.sections.split(","))
    unknown = [n for n in names if n not in SECTIONS]
    if unknown:
        ap.error(f"unknown sections {unknown}")
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr, flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reps = 1 if args.quick else args.reps
    info = device_info()
    emit(build_line(), info)
    dev = torch.device("cuda")
    lines, ok = {}, True
    for name in names:
        line = run_section(name, args.seed, dev, reps)
        line["seed"] = args.seed
        emit(line, info)
        lines[name] = line
        ok = ok and not line.get("gates_failed")
    emit(headline(lines), info)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
