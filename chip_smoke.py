"""Drive the PyTorch + CUDA port's main path once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # only the kernel breakdowns

``--profile`` prints the ``torch.profiler`` device time of one serial
Adam step of the parity epoch at the ROI shape (plain PyTorch, by kernel
name), then, launch by launch, of the phase-correlation kernel F at the
pipeline's patch grid,
of the fused warp G at ``bench.py``'s whole-brain patch grid (16
frames), and of the Gram kernel (C at shared anchors, E at per-frame
positions, C4 from rows), the motion kernel A, the c1 kernel B (shared
anchors and per-frame positions) and the refine kernel D (with and
without dsigma) at the whole-brain shape with 2 and 16 frames, each
beside its time per call and the host's share of it, and stops.

Phases, each of which exits non-zero on failure:

1. device: a CUDA device is required (there is no CPU path);
2. card: name and power limit from nvidia-smi;
3. build: nvcc builds the kernels of ``dnmf_tpu_torch/csrc`` into
   ``dnmf_tpu_torch/_build/``;
4. kernels: the motion, c1 and Gram kernels, and the refine kernel (with
   and without dsigma, [K] and [K, 3] widths) and the tracked c1 and Gram
   kernels at per-frame positions (anchors plus ~1 px of jitter), against
   their plain PyTorch versions in float32 and against the plain versions
   in float64 (the oracle, one frame at a time) at the ROI shape
   (256x256x10, K=50, 8 frames) and the whole-brain shape (512x512x20,
   K=200, 2 frames), with times (median of 5 after a warm-up); the
   brick kernels (motion, c1 at shared anchors and per-frame positions,
   refine) also report the (frame, voxel, neuron) triples their brick
   culling evaluates (each kernel's own count per brick) beside the
   active ones the bounds count, the Gram kernels (C, E, C4) the neuron
   pairs they sum beside the active pairs, and their neuron table
   (csrc/table.cu) is held against its plain version;
5. main path: ``DeformableNMF.fit`` on a seeded synthetic ground-truth
   video at the ROI shapes with T=256 (2 rounds, gram_mode="auto", so the
   closed-form Grams, the c1 pass and the exact-Gram audit all run; then
   one round with gram_mode="exact"), with the kernels and again with
   ``use_kernels=False``; the launch counters must show every kernel ran,
   and the two fits must agree;
6. refine path at full width: on a seeded whole-brain recording
   (512x512x20, K=200, T=32) whose neurons jitter independently per
   frame, ``fit`` for 2 rounds with ``fit_sigma=True, sigma_every=1``,
   then ``refine()`` at its defaults, once with gram_mode="auto" and once
   with "exact"; the refine, tracked c1 and tracked Gram kernels must
   have run, and refine must lower the reconstruction error;
7. refine agreement: the same schedule cut to 1 fit round and
   ``refine(rounds=1, epochs=4)`` at the ROI shape with T=256, with the
   kernels and with ``use_kernels=False``; the two must agree, and so must
   the refinement alone run both ways from one fitted state;
8. registration kernels (part of phase 4): the phase-correlation kernel
   F and the fused warp G on 16 frames of a seeded textured volume
   rolled by known integer shifts, at the ROI patch grid (256x256x10,
   3x3x1 patches of 128x128x10) and at ``bench.py``'s whole-brain one
   (512x512x20, 4x4x2 patches of 160x160x10), and F alone at the
   pipeline's default grid (512x512x20, 2x2x1 patches of 264x264x20):
   F's integer shifts equal the float64 oracle's in every (frame, patch)
   and its product spectra and G's output lie within ``KERNEL_TOL`` of
   float64; F is timed beside one cuFFT call for the same correlation,
   and the redesigned kernels (F, D, A, B) beside their earlier times;
9. registration path at full width: ``MotionCorrect(video,
   cfg).motion_correct()`` on a seeded 512x512x20, T=64 recording (200
   Gaussian neurons on a textured background, each frame warped by a
   planted rigid + quadratic field), with ``bench.py``'s piecewise-rigid
   settings and ``remap_mode="fused"``: F and G must have run, the patch
   shifts must follow the planted field and the corrected movie must be
   still (after a 16-frame warm-up run); then the pipeline's default
   registration (2x2x1 patches of 264x264x20, ``remap_mode="exact"``) on
   the first 32 frames: F ran, G did not, the movie is still;
10. registration agreement: the full-width run again with
   ``phasecorr_impl="xla"`` (the plain per-patch path, where "fused"
   remap means "separable"); each frame block of both runs redone through
   the same block entry and, from the kernel run's rigid estimates, in
   float64: the kernel run's corrected movie, every frame, equals G's
   plain version given the run's own shifts; integer shifts equal except
   at float64 near-ties; final shifts as close to float64 as the plain
   path's (``registration_agreement``);
11. kernel C4 (part of phase 4): the Gram from precomputed coordinate
   and fade rows, ``gram_block(..., psi_source="stream")``, against its
   plain version in float32 and float64 and against the in-kernel-rows
   Gram kernel, at both kernel shapes;
12. pipeline at full width, streamed from disk: a seeded 512x512x20,
   T=64 recording of 200 planted neurons with seeded traces, moved by a
   planted in-plane rigid + quadratic field, written to a raw float32
   file and opened as ``RawFileVideo(path, shape, block=16)``;
   ``register_and_demix(source, num_neurons=200, refine_positions=True)``
   at the pipeline's defaults.  The motion, c1, Gram, refine, tracked c1
   and F kernels must have run, 90% of the planted neurons must have a
   seed within ``SEED_PX`` in frame 0, the matched traces must correlate
   with the truth (mean >= 0.9), refine must lower the reconstruction
   error, all factors finite; stage seconds, one streamed pass's read
   rate, C4 on the fitted state's first block (its op entry), and the
   idle share of one more streamed fit round under ``torch.profiler``;
13. streamed == resident: ``register_and_demix`` at the ROI shape (T=64,
   points pinned) on a NumPy recording and on a ``StreamingVideo`` over
   it: positions equal, traces within rtol 2e-4 / atol 1e-6, beta within
   1e-5;
14. dataset path at the ROI shape: ``SimulatedVideoDataset`` (the port's
   simulator on the card: 256x256x10, K=50, T=256, temporally smooth GP
   motion, its noise at 0.1 of the normalized clean render's RMS), then
   ``DeformableNMF.fit(dataset)`` from the fixture's frame-0 positions (2
   rounds, gram_mode="auto"), with the kernels and with
   ``use_kernels=False``: the motion, c1 and Gram kernels ran, the two
   fits agree, ``fit(dataset)`` equals ``fit(dataset.video)`` bit for bit,
   and the traces correlate with the fixture's (mean >= 0.9);
   ``roi_signals`` at the true positions is printed beside them;
15. whole-brain pipeline witness (BASELINE.md:43, bench.py's protocol):
   ``dnmf_tpu_torch.tools.wb_recovery.seeded_recovery`` at 512x512x20,
   K=200, T=32, rigid-seeded, 6 x (12 epochs + 50 MU), analytic Grams:
   trace corr mean >= 0.999, min >= 0.995, warp error <= 0.05 px, the
   motion and c1 kernels ran;
16. anisotropic-width witness (BASELINE.md:46): 256x256x10, K=100, T=32,
   per-axis widths in the truth, 6 x (8 epochs + 50 MU) with width
   fitting every round (4 steps x 16 frames), fitted with per-axis and
   with isotropic widths: the per-axis width error <= 0.2 px and under
   half the isotropic one, trace corr mean >= 0.999 per axis and >= 0.998
   isotropic, the refine kernel (with dsigma) ran in both;
17. parity path (a): ``motion_mode="parity"`` (serial Adam over shuffled
   batches of 4 against the full beta) at the ROI shape, T=256, one round
   of 2 epochs (128 steps), gram_mode="auto", with the kernels and with
   ``use_kernels=False``: the c1 and Gram kernels ran (the closed form's
   c1 pass and the audit), the motion kernel did not (the parity epoch is
   plain PyTorch), and the two fits agree within the main path's gates;
18. reference parity (b): ``reference_demo_model(parity=True)`` (resampled
   footprints, pixel basis, detached regularizer) with the demo's
   schedule in parity mode at 50x50x2, K=10, T=100, on a seeded simulator
   fixture whose anchors sit ``REF_MARGIN`` px inside: one round on the
   card and on the CPU, beta and C within ``REF_BETA_TOL`` / ``REF_C_TOL``;
   then ``demo_torch.py --parity --rounds 1``, its summary printed;
19. checkpoint/resume (c): ROI shape, T=64, ``fit`` 2 rounds with
   ``checkpoint_dir``; a fresh engine restores ``round_0.pt`` and fits 1
   round: beta, C, sigma, the Adam moments and count bit-equal;
20. ``fit_fused`` (d) against ``fit`` at the same shape: the main path's
   gates, two audits;
21. ``profile_dir`` (e): the last round's ``torch.profiler`` trace names the
   motion and c1 kernels;
22. ``StaticFootprintNMF`` (f) at the ROI shape, T=64: ``STATIC_ITERS``
   alternations against the same iterations in float64;
23. the parallel layer, (a) voxel-range kernels: the motion kernel A and
   the Gram kernel C over the voxel ranges of 4 shards (slabs of 128 m
   rows) and of 5 (runs that cut m row 102.4) of the whole-brain volume
   (512x512x20, K=200, 2 frames): each shard against its plain version in
   float32 and float64, A's mean and C's sum over the shards against the
   unsharded kernel, within ``KERNEL_TOL``; each shard's time beside the
   unsharded call's, and the worst errors in the kernels line;
24. (b) ``python -m dnmf_tpu_torch.tools.pod_check --cuda 4``: the 14
   sharded == single equalities on 4 ranks that share the card;
25. (c) sharded fits at full width: a seeded whole-brain fixture of the
   recovery harness (512x512x20, K=200, T=32, registration-seeded warps)
   on 4 ranks that share the card (a ``gloo`` group whose ranks keep CUDA
   tensors: NCCL refuses two ranks on one device), each run against the
   same run in this process: time 2 x pixel 2 with exact Grams (2
   rounds; A and C over voxel ranges); time 4 with ``gram_mode="auto"``,
   the audit and the MU halo, then ``refine(rounds=1, epochs=4)``; time 4
   ``refine`` with exact Grams.  Every rank's launch counters must show
   the path's kernels (A, B, C, D, B-tracked, E; the audit's C on the
   rank that owns its frame);
26. (d) ``sharded_register_pwrigid`` at the ROI patch grid on 2 time
   shards (time 2 x batch 2) against the single-process chunked run:
   F and G ran on every rank;
27. (e) a one-rank NCCL group: collectives on the card and a
   ``mesh_time=1`` fit equal to the fit without a mesh.
   Ranks that share one card measure correctness, not scaling;
28. the benchmark: ``dnmf_tpu_torch.tools.bench.main(["--quick",
   "--sections", ...])``, every section but ``correctness`` (phases 1-4
   hold the same kernel checks at the same shapes) at its own shapes and
   schedule with one warm-up and one timed repetition, each printing its
   JSON line: no section may err, launch none of the kernels its path
   should launch or miss a gate (``factors_match``, the pipeline
   witness's trace corr mean >= 0.9).

Every phase prints its seconds with the card's name and power limit.
The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data import simulator
from dnmf_tpu_torch.data.datasets import SimulatedVideoDataset
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.ops import (_build, basis, footprints, fused, phasecorr,
                                warp)
from dnmf_tpu_torch.ops.resample import trilinear_resample
from dnmf_tpu_torch.registration import MotionCorrect
from dnmf_tpu_torch.registration import motion_correct as mc_lib
from dnmf_tpu_torch.tools import wb_recovery
from dnmf_tpu_torch.tools.kernel_check import (
    BENCH_PW, KERNEL_TOL, PIPE_REG, REG_BLOCK, REG_NOISE, REG_SHAPES, SEED,
    SHAPES, KernelCheckError, active_pairs, bound, footprint_flops,
    kernel_inputs, kernel_phase, nbytes, registration_inputs,
    registration_kernel_phase, rel_err, rows_kernel_phase, say, textured,
    time_ms, tracked_kernel_phase, warp_shifts)

FIT_MSE_TOL = 1e-3  # kernel vs plain fit, relative, per phase metric
FIT_CORR_MIN = 0.999  # kernel vs plain fit, per-neuron trace correlation
SIGMA_TOL = 1e-3  # kernel vs plain fit, fitted widths, relative
POS_TOL = 1e-3  # kernel vs plain refine, per-frame positions, pixels
REFINE_FRAMES = 32  # frames of the whole-brain refine recording
MAIN_FRAMES = 256  # frames of the main-path recording at the ROI shape
SOURCES = {
    "motion_block": ("dnmf_tpu_torch/csrc/motion.cu",
                     "dnmf_tpu/ops/pallas_kernels.py:522"),
    "c1_block": ("dnmf_tpu_torch/csrc/c1.cu",
                 "dnmf_tpu/ops/pallas_culled.py:648"),
    "gram_block": ("dnmf_tpu_torch/csrc/gram.cu",
                   "dnmf_tpu/ops/pallas_kernels.py:330"),
    "refine_block": ("dnmf_tpu_torch/csrc/refine.cu",
                     "dnmf_tpu/ops/pallas_culled.py:1131"),
    "c1_block_tracked": ("dnmf_tpu_torch/csrc/c1.cu",
                         "dnmf_tpu/ops/pallas_culled.py:648"),
    "gram_block_tracked": ("dnmf_tpu_torch/csrc/gram.cu",
                           "dnmf_tpu/ops/pallas_culled.py:944"),
    "gram_block_rows": ("dnmf_tpu_torch/csrc/gram.cu",
                        "dnmf_tpu/ops/pallas_culled.py:508"),
    "phase_corr_block": ("dnmf_tpu_torch/csrc/phasecorr.cu",
                         "dnmf_tpu/ops/pallas_phasecorr.py:176"),
    "fused_separable_warp": ("dnmf_tpu_torch/csrc/warp.cu",
                             "dnmf_tpu/ops/pallas_warp.py:163"),
}
REG_FRAMES = 64  # frames of the full-width registration recording
PIPE_FRAMES = 32  # frames registered with the pipeline's default settings
SHIFT_MEAN_TOL = 0.25  # px, mean |patch shift - planted| in m and n
SHIFT_MAX_TOL = 1.0  # px, the same, max
STILL_RATIO = 0.2  # corrected vs raw interior temporal variance, less noise
TIE_GAP = 1e-5  # float64 relative gap under which float32 picks may part
AGREE_PX = 1e-3  # final patch shifts "agree" within this, px
AGREE_SHARE_F64 = 0.98  # kernel path vs float64 estimation, share agreeing
AGREE_SLACK = 0.005  # ... and no worse than the plain path's share less this
AGREE_MOVIE = 1e-3  # kernel run's corrected movie vs G's plain version
# The whole-brain pipeline, streamed from a raw file on disk.
PIPE_T = 64  # frames
PIPE_BLOCK = 16  # frames per streamed block
PIPE_NOISE = 0.05  # noise std (a neuron's peak is 0.3 to ~3)
# A planted neuron counts as seeded within this, frame 0.  Seeds are
# integer peaks (up to 0.87 px off), and the frame-0 conversion of a 2x2
# patch grid misses up to ~1 px of the planted quadratic field: at 2 px
# the share measured 0.88 on an H100 (PERF.md).
SEED_PX = 2.5
SEED_SHARE = 0.9  # share of planted neurons that must be seeded
TRACE_CORR_MEAN = 0.9  # mean correlation with the truth, matched neurons
# The dataset path: a fixture of the port's simulator at the ROI shape,
# temporally smooth GP motion of ~0.7 px per neuron (no global warp).
DATASET_SIM = dict(size=(256, 256, 10), num_neurons=50, num_frames=256,
                   motion="gpt", gp_sigma=(0.5, 0.5, 0.01),
                   gp_length_scale=(20.0, 20.0, 20.0), min_separation=8.0,
                   margin=8.0)
DATASET_NOISE = 0.1  # noise std over the normalized clean render's RMS
DATASET_CORR_MEAN = 0.9  # fitted traces vs the fixture's (PERF.md section 2)
# The round-5 recovery witnesses (BASELINE.md:43 and :46) with bench.py's
# protocols (wb_recovery.WITNESSES), on fixtures of the port's harness.
WITNESS_WB_CORR = (0.999, 0.995)  # trace corr vs the truth, mean and min
WITNESS_WB_WARP_PX = 0.05  # mean warp error, px
WITNESS_ANISO_SIGMA_PX = 0.2  # per-axis width error, px (and < half iso's)
# Trace corr vs the truth, mean, per-axis arm and isotropic control.  The
# control's varies with the draw: 0.998473-0.999300 over the harness's
# seeds 0-4 on an H100 (seed 0 plants two neurons 0.98 px apart),
# 0.999649 on the JAX package's own fixture; the per-axis arm's
# 0.999103-0.999820.  The JAX package's fit of the seed-0 fixture, from
# the port's registration seed and initial state, reads the same
# 0.998473 / 0.999103 (tests/jax_recovery_fixture.py --fit; PERF.md
# section 6), so the control's gate is the draw's, not the port's.
WITNESS_ANISO_CORR_MEAN = {3: 0.999, 1: 0.998}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)

def ground_truth(dev, size, k, t, seed):
    """Seeded synthetic recording rendered on the card: interior
    positions, traces in [0.2, 1], small random quadratic warps, noise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([12.0, 12.0, 2.0], device=dev)
    hi = torch.tensor([size[0] - 13.0, size[1] - 13.0, size[2] - 3.0],
                      device=dev)
    pos = lo + torch.rand((k, 3), generator=gen, device=dev) * (hi - lo)
    sigma = torch.full((k,), 3.0, device=dev)
    c_true = 0.2 + 0.8 * torch.rand((k, t), generator=gen, device=dev)
    beta = basis.identity_beta(t, device=dev)
    scale = torch.tensor([0.01] + [0.004] * 3 + [0.001] * 6, device=dev)
    beta += scale[None, :, None] * torch.randn((t, 10, 3), generator=gen,
                                               device=dev)
    vb = basis.voxel_basis_normalized(size, device=dev)
    video = torch.empty((t, vb.shape[0]), device=dev)
    for i in range(t):
        psi = basis.warp_voxel_coords(vb, beta[i], size, "normalized")
        a = footprints.evaluate_footprints(psi, pos, sigma, size=size)
        video[i] = a @ c_true[:, i]
    video += 0.05 * torch.randn(video.shape, generator=gen, device=dev)
    return pos, c_true, video


def trace_corr(a, b):
    a = a - a.mean(dim=1, keepdim=True)
    b = b - b.mean(dim=1, keepdim=True)
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)


def run_fit(model, pos, video, use_kernels, gram_mode, rounds):
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=rounds,
                               motion_epochs=2, mu_iters=50, seed=SEED)
    rt = tcfg.RuntimeConfig(frame_block=8, gram_mode=gram_mode,
                            use_kernels=use_kernels)
    dnmf = ttr.DeformableNMF(model, opt, rt, positions=pos,
                             device=video.device)
    return dnmf.fit(video)  # fit synchronizes the device after each round


def main_path(dev, model):
    pos, c_true, video = ground_truth(dev, model.size,
                                      model.num_neurons, model.num_frames,
                                      SEED)
    say(f"main path: video {tuple(video.shape)} float32 "
        f"({video.numel() * 4 / 1e6:.0f} MB) on the card")

    fused.reset_launch_counts()
    res_k = run_fit(model, pos, video, None, "auto", 2)
    launches = fused.launch_counts()
    say(f"launches during fit(gram_mode='auto'): {launches}")
    fused.reset_launch_counts()
    ex_k = run_fit(model, pos, video, None, "exact", 1)
    exact_launches = fused.launch_counts()
    say(f"launches during fit(gram_mode='exact'): {exact_launches}")
    res_p = run_fit(model, pos, video, False, "auto", 2)
    ex_p = run_fit(model, pos, video, False, "exact", 1)
    for kname in ("motion_block", "c1_block", "gram_block"):
        if launches[kname] <= 0:
            fail(f"{kname} was not launched during fit")
    if exact_launches["gram_block"] <= 0:
        fail("gram_mode='exact' fit did not launch the Gram kernel")

    for label, res in (("auto", res_k), ("exact", ex_k)):
        c, beta = res.state.c, res.state.beta
        if not (torch.isfinite(c).all() and torch.isfinite(beta).all()):
            fail(f"non-finite factors ({label})")
        if float(c.min()) < 0.0:
            fail(f"negative traces ({label})")
    rounds = [m for m in res_k.metrics if m["phase"] == "round"]
    mse0, mse1 = rounds[0]["motion_recon_mse"], rounds[1]["motion_recon_mse"]
    say(f"motion recon_mse: round 0 {mse0:.6e}, round 1 {mse1:.6e}")
    if not mse1 < mse0:
        fail("motion recon_mse did not fall from round 0 to round 1")
    audit = [m for m in res_k.metrics if m["phase"] == "gram_audit"]
    say(f"gram audit: {audit}")

    for label, rk, rp in (("auto", res_k, res_p), ("exact", ex_k, ex_p)):
        mk = [m for m in rk.metrics if m["phase"] == "motion"]
        mp = [m for m in rp.metrics if m["phase"] == "motion"]
        worst = max(abs(a["recon_mse"] - b["recon_mse"]) / abs(b["recon_mse"])
                    for a, b in zip(mk, mp))
        corr = trace_corr(rk.state.c, rp.state.c)
        secs_k = [m["seconds"] for m in rk.metrics if m["phase"] == "round"]
        secs_p = [m["seconds"] for m in rp.metrics if m["phase"] == "round"]
        say(f"fit {label}: kernel-vs-plain recon_mse max rel diff "
            f"{worst:.3e}; trace corr min {float(corr.min()):.6f}; "
            f"seconds per round kernels {secs_k}, plain {secs_p}")
        if len(mk) != len(mp) or not worst <= FIT_MSE_TOL:
            fail(f"fit {label}: recon_mse differs by {worst:.3e}")
        if not float(corr.min()) >= FIT_CORR_MIN:
            fail(f"fit {label}: trace correlation {float(corr.min()):.6f}")
        gt = trace_corr(rk.state.c, c_true)
        say(f"fit {label}: trace corr vs ground truth mean "
            f"{float(gt.mean()):.6f}, min {float(gt.min()):.6f}")
    return launches


def jittered_recording(dev, size, k, t, seed):
    """Seeded recording whose neurons jitter independently per frame
    (0.8 px in m and n, 0.4 px in z): no global warp expresses it.  Small
    random quadratic warps (within ~0.5 px, so that the fit's global warp
    leaves mostly the jitter to refine), traces in [0.2, 1], noise.  Rendered in pixel
    chunks: the dense [P, K, 3] offsets would not fit at whole-brain size."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = torch.tensor([12.0, 12.0, 2.0], device=dev)
    hi = torch.tensor([size[0] - 13.0, size[1] - 13.0, size[2] - 3.0],
                      device=dev)
    anchors = lo + torch.rand((k, 3), generator=gen, device=dev) * (hi - lo)
    scale = torch.tensor([0.8, 0.8, 0.4], device=dev)
    pos_t = anchors + scale * torch.randn((t, k, 3), generator=gen,
                                          device=dev)
    sigma = torch.full((k,), 3.0, device=dev)
    c_true = 0.2 + 0.8 * torch.rand((k, t), generator=gen, device=dev)
    beta = basis.identity_beta(t, device=dev)
    wscale = torch.tensor([0.002] + [0.001] * 3 + [0.0002] * 6, device=dev)
    beta += wscale[None, :, None] * torch.randn((t, 10, 3), generator=gen,
                                                device=dev)
    p = size[0] * size[1] * size[2]
    video = torch.empty((t, p), device=dev)
    for start, stop in fused._chunks(p, t * k * 3):
        a = fused._footprints(beta, pos_t, sigma, size, "normalized",
                              start, stop)
        video[:, start:stop] = torch.bmm(a, c_true.T[:, :, None])[..., 0]
    video += 0.05 * torch.randn(video.shape, generator=gen, device=dev)
    return anchors, c_true, video


def run_refine(model, anchors, video, use_kernels, gram_mode, fit_rounds,
               **refine_kw):
    """``fit`` with width fitting every round, then ``refine``; returns
    the engine, the state the fit left and the refine result."""
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=fit_rounds,
                               motion_epochs=2, mu_iters=50, fit_sigma=True,
                               sigma_every=1, seed=SEED)
    rt = tcfg.RuntimeConfig(frame_block=8, gram_mode=gram_mode,
                            use_kernels=use_kernels)
    dnmf = ttr.DeformableNMF(model, opt, rt, positions=anchors,
                             device=video.device)
    fitted = dnmf.fit(video).state
    res = dnmf.refine(video, **refine_kw)  # synchronizes the device
    return dnmf, fitted, res


def refine_path(dev, model, gram_mode):
    """Whole-brain fit(fit_sigma) + refine(); returns the launch counts."""
    anchors, c_true, video = jittered_recording(
        dev, model.size, model.num_neurons, model.num_frames, SEED)
    fused.reset_launch_counts()
    dnmf, fitted, res = run_refine(model, anchors, video, None, gram_mode, 2)
    launches = fused.launch_counts()
    say(f"launches during fit(fit_sigma) + refine (gram_mode="
        f"{gram_mode!r}): {launches}")
    tracked = "c1_block_tracked" if gram_mode == "auto" else "gram_block_tracked"
    for kname in ("refine_block", tracked):
        if launches[kname] <= 0:
            fail(f"{kname} was not launched during refine ({gram_mode})")
    c, pos_t = res.state.c, dnmf.pos_t
    if not (torch.isfinite(c).all() and torch.isfinite(pos_t).all()
            and torch.isfinite(res.state.sigma).all()):
        fail(f"non-finite factors after refine ({gram_mode})")
    if float(c.min()) < 0.0:
        fail(f"negative traces after refine ({gram_mode})")
    motion = [m for m in res.metrics if m["phase"] == "motion"]
    ref = [m for m in res.metrics if m["phase"] == "refine"][-1]
    sig = [m for m in res.metrics if m["phase"] == "sigma"]
    say(f"refine ({gram_mode}): fit's last motion recon_mse "
        f"{motion[-1]['recon_mse']:.6e}, refine recon_mse "
        f"{ref['recon_mse']:.6e}; sigma fits {sig}")
    if not ref["recon_mse"] < motion[-1]["recon_mse"]:
        fail(f"refine did not lower recon_mse ({gram_mode})")
    before = trace_corr(fitted.c, c_true)
    after = trace_corr(c, c_true)
    epochs = ref["rounds"] * ref["epochs"]
    say(f"refine ({gram_mode}): trace corr vs ground truth before "
        f"{float(before.mean()):.6f} mean / {float(before.min()):.6f} min, "
        f"after {float(after.mean()):.6f} / {float(after.min()):.6f}; "
        f"{ref['seconds']:.3f} s for {epochs} epochs of "
        f"{model.num_frames} frames, {ref['seconds'] / epochs / model.num_frames * 1e3:.4f} "
        "ms per epoch per frame (tracked Grams and trace updates included)")
    return launches


def refine_agreement(dev, model):
    """Kernel vs plain fit(fit_sigma) + refine at the ROI shape, and the
    refinement alone from one fitted state.

    End to end, positions are held at their 99.9th percentile: the two
    fits leave states ~1e-6 apart, and a neuron whose gradient on some
    axis is near zero follows that gap through Adam's normalized steps
    (the max is reported).  From one state, every position is held.
    """
    anchors, _, video = jittered_recording(dev, model.size,
                                           model.num_neurons,
                                           model.num_frames, SEED)
    kw = dict(rounds=1, epochs=4, learning_rate=0.08, prior=3e-4)
    runs = {}
    for use_kernels in (None, False):
        t0 = time.perf_counter()
        runs[use_kernels] = run_refine(model, anchors, video, use_kernels,
                                       "auto", 1, **kw)
        say(f"refine agreement: use_kernels={use_kernels} "
            f"{time.perf_counter() - t0:.3f} s")
    (dk, fitted, rk), (dp, _, rp) = runs[None], runs[False]

    def mses(res):
        return [m.get("recon_mse", m.get("mse")) for m in res.metrics
                if m["phase"] in ("motion", "sigma", "refine")]

    mk, mp = mses(rk), mses(rp)
    worst = max(abs(a - b) / abs(b) for a, b in zip(mk, mp))
    corr = float(trace_corr(rk.state.c, rp.state.c).min())
    sig = rel_err(rk.state.sigma, rp.state.sigma)
    diff = (dk.pos_t - dp.pos_t).abs()
    p999 = float(torch.quantile(diff.flatten()[:1 << 24], 0.999))
    # The refinement alone: the plain versions from the kernel fit's state
    # (the engine's refine runs refine_positions once per round).
    pos_p, _ = refine_lib.refine_positions(
        fitted, None, torch.clamp_min(video, 0.0), model, epochs=kw["epochs"],
        learning_rate=kw["learning_rate"], prior=kw["prior"],
        frame_block=dk.runtime.frame_block, use_kernels=False)
    alone = float((dk.pos_t - pos_p).abs().max())
    say(f"refine agreement: recon_mse max rel diff {worst:.3e}; trace corr "
        f"min {corr:.6f}; sigma rel diff {sig:.3e}; pos_t diff 99.9th "
        f"percentile {p999:.3e} px, max {float(diff.max()):.3e} px; refine "
        f"alone from one state: pos_t max diff {alone:.3e} px")
    if len(mk) != len(mp) or not worst <= FIT_MSE_TOL:
        fail(f"refine agreement: recon_mse differs by {worst:.3e}")
    if not corr >= FIT_CORR_MIN:
        fail(f"refine agreement: trace correlation {corr:.6f}")
    if not sig <= SIGMA_TOL:
        fail(f"refine agreement: sigma differs by {sig:.3e}")
    if not p999 <= POS_TOL:
        fail(f"refine agreement: pos_t differs by {p999:.3e} px (99.9th "
             "percentile)")
    if not alone <= POS_TOL:
        fail(f"refine agreement: refine alone, pos_t differs by {alone:.3e} px")




def device_breakdown(label, run, reps=5, each_launch=True):
    """Print the device time of ``run()`` by kernel name under
    ``torch.profiler`` (launches and ms per call), its time per call by
    CUDA events, and the host time per call (the call's return, nothing
    synchronized: the wrapper's own work and its launches); with
    ``each_launch``, one call's launches in order too."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(run, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / reps * 1e-3, e.count / reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    say(f"profile {label}: {ms:.4f} ms per call (CUDA events), device "
        f"{busy:.4f} ms in {sum(r[1] for r in rows):g} launches per call, "
        f"host {host_ms:.4f} ms per call")
    for t, n, key in rows:
        if t >= 0.005 * busy:
            say(f"profile {label}:   {t:.4f} ms ({100 * t / busy:.1f}%) in "
                f"{n:g} launches: {key[:90]}")
    if not each_launch:
        return
    # One call's launches in order (key_averages merges a kernel's calls).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end - e.time_range.start,
                    e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    for _, us, key in spans:
        say(f"profile {label}:   launch {us * 1e-3:.4f} ms: {key[:90]}")


def profile_kernels(dev):
    """Device breakdowns of kernel F (at the pipeline's patch grid), of G
    (at ``bench.py``'s whole-brain patch grid, 16 frames) and of kernels C,
    E and C4 (the Gram), A (motion), B (c1 at shared anchors and at
    per-frame positions) and D (refine, with and without dsigma) at the
    whole-brain shape with 2 and 16 frames (16: the pipeline's frame
    block), after one serial Adam step of the parity epoch at the ROI
    shape (plain PyTorch): ``python3 chip_smoke.py --profile``."""
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=PARITY_FRAMES,
                             shape_std=roi.shape_std)
    pos, _, video = ground_truth(dev, model.size, model.num_neurons,
                                 PARITY_FRAMES, SEED)
    state = model_lib.init_state(model, positions=pos, device=dev)
    batch = (torch.arange(4, device=dev)[None], torch.ones((1, 4),
                                                           device=dev))
    device_breakdown(
        f"parity step ROI (4 frames of {PARITY_FRAMES})",
        lambda: model_lib.motion_epoch_parity(state, video, *batch, model,
                                              model_lib.Adam(1e-3), 1.0),
        each_launch=False)
    del state, video
    inp = registration_inputs(dev, *REG_SHAPES["pipeline"])
    z = inp["window"][2]
    cap = max(1, int(2 * REG_SHAPES["pipeline"][4]))
    device_breakdown(
        f"F pipeline ({len(inp['starts'])} patches of {inp['window']}, "
        f"{REG_BLOCK} frames)",
        lambda: phasecorr.phase_corr_block(inp["pats"], inp["tre"],
                                           inp["tim"], inp["bounds"], z=z,
                                           max_window=(cap, cap, cap)))
    del inp
    size, strides, overlaps, max_shifts, max_dev = REG_SHAPES["whole_brain"]
    inp = registration_inputs(dev, size, strides, overlaps, max_shifts,
                              max_dev)
    rs, ps = warp_shifts(inp, max_shifts, max_dev)
    device_breakdown(
        f"G whole-brain (grid {inp['grid_shape']}, {REG_BLOCK} frames)",
        lambda: warp.fused_separable_warp(inp["frames"], ps, rs,
                                          inp["grid_shape"], size,
                                          max_shifts, max_dev))
    del inp, rs, ps
    size, k, _, margin = SHAPES["whole_brain"]
    for frames in (2, 16):
        betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames, margin,
                                                SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        pos_t = pos[None] + torch.randn((frames, k, 3), generator=gen,
                                        device=dev)
        wb = f"whole-brain {frames} frames"
        device_breakdown(f"C {wb}", lambda: fused.gram_block(
            betas, pos, sigma, y, size))
        device_breakdown(f"E {wb}", lambda: fused.gram_block_tracked(
            betas, pos_t, sigma, y, size))
        psi, w = fused.psi_rows(betas, size)
        device_breakdown(f"C4 {wb}", lambda: fused.gram_block(
            betas, pos, sigma, y, size, psi_source="stream", rows=(psi, w)))
        del psi, w
        device_breakdown(f"A {wb}", lambda: fused.motion_block(
            betas, pos, sigma, c, y, size))
        device_breakdown(f"B1 {wb}", lambda: fused.c1_block(
            betas, pos, sigma, y, size))
        device_breakdown(f"B-tracked {wb}", lambda: fused.c1_block_tracked(
            betas, pos_t, sigma, y, size))
        for want in (False, True):
            device_breakdown(
                f"D {wb} dsigma={want}",
                lambda: fused.refine_block(betas, pos_t, sigma, c, y, size,
                                           want_dsigma=want))
    # The Gram where every brick lists thousands of neurons: K = 6000
    # crowd a 24x16x6 volume (one call after a warm-up).
    size, k = (24, 16, 6), 6000
    betas, pos, sigma, _, y = kernel_inputs(dev, size, k, 2, 0.0, SEED)
    ms = time_ms(lambda: fused.gram_block(betas, pos, sigma, y, size), 1)
    say(f"profile C crowded ({size}, K={k}, 2 frames): {ms:.4f} ms per call "
        "(CUDA events)")




def neuron_volume(gen, size, k, dev):
    """``k`` Gaussian neurons (std 3, 3, 1.5 px; amplitudes in [0.5, 1])
    at seeded interior positions, rendered separably."""
    kw = dict(generator=gen, device=dev)
    lo = torch.tensor([12.0, 12.0, 2.0], device=dev)
    hi = torch.tensor([size[0] - 13.0, size[1] - 13.0, size[2] - 3.0],
                      device=dev)
    pos = lo + torch.rand((k, 3), **kw) * (hi - lo)
    amp = 0.5 + 0.5 * torch.rand(k, **kw)
    prof = [torch.exp(-0.5 * ((torch.arange(s, device=dev) - pos[:, d:d + 1])
                              / sd) ** 2)
            for d, (s, sd) in enumerate(zip(size, (3.0, 3.0, 1.5)))]
    nz = (prof[1][:, :, None] * prof[2][:, None, :]).reshape(k, -1)
    return (prof[0].T @ (amp[:, None] * nz)).reshape(size)


def planted_recording(dev, size, k, t, starts, window, seed):
    """Seeded recording ``[T, M, N, Z]`` on the host, and the planted
    field averaged over each patch window ``[T, n_patches, 3]``.

    The template is ``k`` Gaussian neurons plus a textured background
    (amplitude 0.3, Gaussian-filtered noise of filter width 2 px in m and
    n, 1 in z), so every patch has structure.  A smoother background
    would bias the shifts: the unwhitened cross-correlation of a patch
    with the template peaks short of the true shift by about (the
    texture's correlation length)^2 / (patch width), ~0.8 px at 8 px on
    160-px patches.  Frame t is the template sampled at ``x +
    d_t(x)`` (``trilinear_resample``, edge padding): a rigid part (up to
    4 px in m and n, 1 px in z) plus a quadratic one in the normalized
    coordinates (up to 1 px in m and n, 0.5 px in z), then noise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=gen, device=dev)
    tmpl = neuron_volume(gen, size, k, dev) + 0.3 * textured(
        gen, size, (2.0, 2.0, 1.0), dev)
    grid = basis.voxel_grid(size, device=dev)
    half = (torch.tensor(size, dtype=torch.float32, device=dev) - 1) / 2
    u = grid / half - 1.0
    mono = torch.stack([u[:, 0] ** 2, u[:, 1] ** 2, u[:, 0] * u[:, 1]], -1)
    axis_scale = torch.tensor([1.0, 1.0, 0.5], device=dev)
    rigid = (torch.rand((t, 3), **kw) * 2 - 1) * torch.tensor(
        [4.0, 4.0, 1.0], device=dev)
    quad = (torch.rand((t, 3, 3), **kw) * 2 - 1) / 3 * axis_scale
    video = np.empty((t,) + tuple(size), np.float32)
    planted = np.empty((t, len(starts), 3))
    for i in range(t):
        d = rigid[i] + mono @ quad[i]  # [P, 3]
        frame = trilinear_resample(tmpl, grid + d, padding="edge")
        frame = frame.reshape(size) + REG_NOISE * torch.randn(size, **kw)
        video[i] = frame.cpu().numpy()
        d = d.reshape(tuple(size) + (3,))
        planted[i] = torch.stack([
            d[s0:s0 + window[0], s1:s1 + window[1], s2:s2 + window[2]]
            .mean(dim=(0, 1, 2)) for s0, s1, s2 in starts]).cpu().numpy()
    return video, planted


def interior(movie, dev, rows=32):
    """Device float64 chunks of the interior of a host movie ``[T, M, N,
    Z]`` (16 px in from the m and n borders, 3 planes from the z ones)."""
    m, n, z = movie.shape[1:]
    for r in range(16, m - 16, rows):
        yield torch.from_numpy(np.ascontiguousarray(
            movie[:, r:min(r + rows, m - 16), 16:n - 16, 3:z - 3])).to(
            dev, torch.float64)


def stillness(dev, raw, corrected):
    """Interior temporal variance, less the noise variance, of the
    corrected movie over that of the raw one."""
    def excess(movie):
        tot = cnt = 0.0
        for c in interior(movie, dev):
            tot += float(c.var(dim=0, unbiased=False).sum())
            cnt += c[0].numel()
        return tot / cnt - REG_NOISE ** 2
    return excess(corrected) / excess(raw)


def run_motion_correct(dev, video, cfg, label, time_rigid=False):
    """``MotionCorrect(video, cfg).motion_correct()`` and the launch counts
    of the run; prints ms per frame.  With ``time_rigid`` a rigid-only run
    of the same recording first times the rigid phase, and the
    piecewise-rigid phase is the full run less that."""
    rigid_s = None
    if time_rigid:
        t0 = time.perf_counter()
        MotionCorrect(video, dataclasses.replace(cfg, pw_rigid=False),
                      device=dev).motion_correct()
        torch.cuda.synchronize()
        rigid_s = time.perf_counter() - t0
    mc = MotionCorrect(video, cfg, device=dev)
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc.motion_correct()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = fused.launch_counts()
    t = video.shape[0]
    phases = (f"rigid phase {rigid_s / t * 1e3:.4f} ms per frame (a "
              "rigid-only run), piecewise-rigid phase "
              f"{(total - rigid_s) / t * 1e3:.4f} ms per frame"
              if time_rigid else
              f"rigid + piecewise-rigid {total / t * 1e3:.4f} ms per frame")
    say(f"registration {label}: {phases} ({t} frames, frame_block "
        f"{cfg.frame_block}); launches {launches}")
    shifts = np.stack([np.asarray(mc.x_shifts_els),
                       np.asarray(mc.y_shifts_els),
                       np.asarray(mc.z_shifts_els)], axis=-1)
    if not (np.isfinite(shifts).all()
            and bool(torch.isfinite(mc.total_template_els).all())):
        fail(f"registration {label}: non-finite shifts or template")
    return mc, shifts, launches


def check_still(dev, label, raw, corrected):
    ratio = stillness(dev, raw, corrected)
    say(f"registration {label}: interior temporal variance less noise, "
        f"corrected over raw {ratio:.6f}")
    if not ratio <= STILL_RATIO:
        fail(f"registration {label}: corrected movie not still ({ratio:.4f} "
             f"> {STILL_RATIO})")


def pick_gap(src, tgt, a, b):
    """Relative gap between the correlation magnitudes of patch ``src``
    with ``tgt`` (float64) at the integer shifts ``a`` and ``b``."""
    cross = torch.fft.ifftn(torch.fft.fftn(src)
                            * torch.conj(torch.fft.fftn(tgt))).abs()
    va, vb = (float(cross[tuple(int(v) % n for v, n in
                                zip(s.tolist(), src.shape))])
              for s in (a, b))
    return abs(va - vb) / max(va, vb)


def registration_agreement(dev, video, mc_k, sh_k, mc_p, sh_p):
    """Kernel path (F + G) vs plain path (``phasecorr_impl="xla"``).

    Every frame block is redone through the block entry the runs use
    (``pwrigid_block``) with its check outputs, the rigid estimate and
    the integer patch shifts, and must give the run's shifts again; a
    third redo, in float64 from the kernel run's rigid estimate, is the
    oracle.  The registration surfaces are float32 sums over ~256,000
    voxels on top of a large constant (the recording's mean after the
    ``-min`` offset), so two float32 paths part where the float64 surface
    has a near-tie: at the integer peak (candidates within ``TIE_GAP``
    relative) and at the 0.1 px subpixel peak (about 1% of the entries
    for either path against float64).  The gates: the kernel run's
    corrected movie, every frame, within ``AGREE_MOVIE`` of G's plain
    version given the run's own rigid and patch shifts; integer shifts
    equal except at float64 near-ties; the kernel path's final shifts
    agree with float64 within ``AGREE_PX`` as often as the plain path's
    (``AGREE_SLACK``), and in at least ``AGREE_SHARE_F64`` of the entries;
    the two paths' shifts differ by at most one subpixel step."""
    cfg = mc_k.config
    xla = dataclasses.replace(cfg, phasecorr_impl="xla")
    add = -mc_k.min_mov
    dims = video.shape[1:]
    starts, grid_shape, window = mc_lib.patch_grid(dims, cfg.overlaps,
                                                   cfg.strides)
    tmpl_k, tmpl_p = mc_k.total_template_rig, mc_p.total_template_rig
    ints = {"kernel": [], "plain": [], "float64": []}
    fin64, gaps = [], []
    repro, num, den = True, 0.0, 0.0
    for i in range(0, video.shape[0], cfg.frame_block):
        frames = torch.from_numpy(video[i:i + cfg.frame_block]).to(dev)
        sl = slice(i, i + frames.shape[0])
        _, corr_k, est_k = mc_lib.pwrigid_block(frames, tmpl_k, cfg, add,
                                                estimates=True)
        _, corr_p, est_p = mc_lib.pwrigid_block(frames, tmpl_p, xla, add,
                                                estimates=True)
        _, corr_o, est_o = mc_lib.pwrigid_block(
            frames.double(), tmpl_k.double(), xla, add,
            rigid_shifts=est_k["rigid"].double(), estimates=True)
        repro &= (np.array_equal(corr_k.cpu().numpy(), sh_k[sl])
                  and np.array_equal(corr_p.cpu().numpy(), sh_p[sl]))
        ref = warp.fused_separable_warp_plain(
            frames + add, -torch.from_numpy(sh_k[sl]).to(dev),
            est_k["rigid"], grid_shape, dims, cfg.max_shifts,
            cfg.max_deviation_rigid) - add
        got = torch.from_numpy(mc_k.mc_els[0][sl]).to(dev)
        num = max(num, float((got - ref).abs().max()))
        den = max(den, float(ref.abs().max()))
        for key, est in (("kernel", est_k), ("plain", est_p),
                         ("float64", est_o)):
            ints[key].append(est["integer"].cpu())
        fin64.append(corr_o.cpu().numpy())
        parted = (est_k["integer"] != est_p["integer"]).any(-1)
        for b, p in torch.nonzero(parted).tolist():
            cut = tuple(slice(int(s0), int(s0) + w)
                        for s0, w in zip(starts[p], window))
            gaps.append(pick_gap(frames[b][cut].double() + add,
                                 tmpl_k[cut].double() + add,
                                 est_k["integer"][b, p],
                                 est_p["integer"][b, p]))
        del est_o, corr_o, ref, got
    int_k, int_p, int_o = (torch.cat(ints[k]) for k in ("kernel", "plain",
                                                         "float64"))
    fin64 = np.concatenate(fin64)
    movie = num / max(den, 1e-30)
    n_int = int((int_k != int_p).any(-1).sum())
    step = 1.0 / cfg.upsample_factor_fft
    share = {}
    for label, sh, ints_l in (("kernel", sh_k, int_k), ("plain", sh_p, int_p)):
        off = np.abs(sh - fin64)
        share[label] = float((off <= AGREE_PX).mean())
        say(f"registration agreement: {label} path vs float64 estimation: "
            f"integer shifts differ in {int((ints_l != int_o).any(-1).sum())}"
            f" of {ints_l.shape[0] * ints_l.shape[1]} (frame, patch); final "
            f"shifts within {AGREE_PX} px in {share[label]:.6f} of the "
            f"entries, max diff {off.max():.4f} px")
    diff = np.abs(sh_k - sh_p)
    say(f"registration agreement (kernel vs plain): block redos reproduce "
        f"the runs {repro}; integer shifts differ in {n_int}, float64 gaps "
        f"there {[f'{g:.2e}' for g in gaps]}; final shifts within "
        f"{AGREE_PX} px in {float((diff <= AGREE_PX).mean()):.6f}, max diff "
        f"{diff.max():.4f} px; kernel run's corrected movie vs G's plain "
        f"version at its own shifts, all {video.shape[0]} frames: max rel "
        f"diff {movie:.3e}")
    if not repro:
        fail("registration agreement: a block redo did not give the run's "
             "shifts again")
    if not movie <= AGREE_MOVIE:
        fail(f"registration agreement: corrected movie differs from G's "
             f"plain version by {movie:.3e}")
    if any(g > TIE_GAP for g in gaps):
        fail("registration agreement: integer shifts differ beyond a "
             f"float64 near-tie (gaps {gaps})")
    if not (share["kernel"] >= AGREE_SHARE_F64
            and share["kernel"] >= share["plain"] - AGREE_SLACK):
        fail(f"registration agreement: final shifts vs float64 {share}")
    if not diff.max() <= step + 1e-4:
        fail("registration agreement: final shifts differ by more than "
             "one subpixel step")


def registration_path(dev):
    """The full-width piecewise-rigid path, the pipeline's default
    registration, and the kernel-vs-plain agreement; returns the launch
    counts of the full-width run."""
    size = REG_SHAPES["whole_brain"][0]
    starts, _, window = mc_lib.patch_grid(size, BENCH_PW["overlaps"],
                                          BENCH_PW["strides"])
    t0 = time.perf_counter()
    video, planted = planted_recording(dev, size, 200, REG_FRAMES, starts,
                                       window, SEED + 3)
    say(f"registration recording {video.shape} float32 on the host "
        f"({video.nbytes / 1e9:.2f} GB, made in "
        f"{time.perf_counter() - t0:.3f} s)")
    cfg = tcfg.RegistrationConfig(**BENCH_PW, pw_rigid=True, is3d=True,
                                  remap_mode="fused", return_mc=True)
    # The first run in a process pays for cuFFT plans and module loads.
    run_motion_correct(dev, video[:REG_BLOCK], cfg, "warm-up")
    mc_k, sh_k, launches = run_motion_correct(dev, video, cfg, "fused",
                                              time_rigid=True)
    for kname in ("phase_corr_block", "fused_separable_warp"):
        if launches[kname] <= 0:
            fail(f"{kname} was not launched during motion_correct()")
    err = np.abs((sh_k - sh_k[:1]) - (planted - planted[:1]))
    say("registration fused: patch shifts relative to frame 0 vs the "
        "planted field averaged over each patch: mean |error| m "
        f"{err[..., 0].mean():.4f}, n {err[..., 1].mean():.4f}, z "
        f"{err[..., 2].mean():.4f} px; max m {err[..., 0].max():.4f}, n "
        f"{err[..., 1].max():.4f}, z {err[..., 2].max():.4f} px")
    if not (err[..., :2].mean(axis=(0, 1)) <= SHIFT_MEAN_TOL).all():
        fail("registration: mean patch shift error above "
             f"{SHIFT_MEAN_TOL} px")
    if not err[..., :2].max() <= SHIFT_MAX_TOL:
        fail(f"registration: patch shift error above {SHIFT_MAX_TOL} px")
    check_still(dev, "fused", video, mc_k.mc_els[0])

    pipe = tcfg.RegistrationConfig(**PIPE_REG, pw_rigid=True, is3d=True,
                                   border_nan=False, return_mc=True)
    mc_d, _, pipe_launches = run_motion_correct(
        dev, video[:PIPE_FRAMES], pipe, "pipeline default")
    if pipe_launches["phase_corr_block"] <= 0:
        fail("pipeline default: phase_corr_block was not launched")
    if pipe_launches["fused_separable_warp"] != 0:
        fail("pipeline default (remap_mode='exact') launched the fused warp")
    check_still(dev, "pipeline default", video[:PIPE_FRAMES],
                mc_d.mc_els[0])
    del mc_d

    plain = dataclasses.replace(cfg, phasecorr_impl="xla")
    mc_p, sh_p, plain_launches = run_motion_correct(dev, video, plain, "xla")
    if plain_launches["phase_corr_block"] or plain_launches[
            "fused_separable_warp"]:
        fail("phasecorr_impl='xla' launched a registration kernel")
    registration_agreement(dev, video, mc_k, sh_k, mc_p, sh_p)
    del mc_p
    return launches


def seeded_traces(rng, k, t):
    """Non-negative traces ``[K, T]``: a 0.3 baseline plus sparse
    transients (probability 0.15 per frame, exponential amplitudes of mean
    1) that decay by 0.7 per frame."""
    spikes = rng.exponential(1.0, (k, t)) * (rng.uniform(size=(k, t)) < 0.15)
    c = np.empty((k, t))
    level = np.zeros(k)
    for i in range(t):
        level = 0.7 * level + spikes[:, i]
        c[:, i] = 0.3 + level
    return c


def pipeline_recording(dev, size, k, t, seed, out=None):
    """Seeded recording of ``k`` Gaussian neurons with seeded traces,
    each frame warped by a planted rigid + quadratic field, plus noise.

    The neurons have the model's own form, ``exp(-|x - p|^2 / 9)``
    (``shape_std`` 3), at seeded positions at least 12 px apart inside a
    per-axis margin of ``min(20, (size - 1) / 4)`` px, as
    ``interior_positions`` in ``tools/wb_recovery.py`` places the
    whole-brain recovery neurons (the simulator's own clamp,
    ``(size - 1) / 2``, lets them reach the border).  A seed whose
    footprint leaves the volume in some frames gets a runaway trace in
    both packages, with closed-form or exact Grams alike
    (``test_border_plane_fit_matches_jax``; an open fault of the
    reference).
    Frame t is its template-space volume sampled at ``x + d_t(x)``
    (``trilinear_resample``, edge padding): a rigid part (up to 4 px in m
    and n) plus a quadratic one (up to 1 px in m and n), as
    :func:`planted_recording` draws them, with the z parts set to 0: the
    pipeline turns registration's z corrections into positions and warps
    with the opposite sign (``apply_shifts_points``, the reference's z
    convention, in both packages), so planted z motion would be doubled,
    not removed.  Frames go to ``out`` (a binary file) or into a host
    array.  Returns ``(video or None, positions in frame 0 [K, 3], traces
    [K, T])``."""
    rng = np.random.default_rng(seed)
    lo = np.minimum(20.0, (np.array(size, float) - 1.0) / 4)
    hi = np.array(size, float) - 1.0 - lo
    pos = []
    while len(pos) < k:
        cand = lo + rng.uniform(size=3) * (hi - lo)
        if all(np.linalg.norm(cand - q) >= 12.0 for q in pos):
            pos.append(cand)
    pos = np.array(pos)
    c = seeded_traces(rng, k, t)
    half = (np.array(size, float) - 1) / 2
    rigid = rng.uniform(-1, 1, (t, 3)) * np.array([4.0, 4.0, 0.0])
    quad = rng.uniform(-1, 1, (t, 3, 3)) / 3 * np.array([1.0, 1.0, 0.0])

    def field(x, i):  # d_t(x) for x [Q, 3]
        u = x / half - 1.0
        mono = np.stack([u[:, 0] ** 2, u[:, 1] ** 2, u[:, 0] * u[:, 1]], -1)
        return rigid[i] + mono @ quad[i]

    # Frame 0 shows the neuron at p where x0 + d_0(x0) = p.
    pos0 = pos.copy()
    for _ in range(20):
        pos0 = pos - field(pos0, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prof = [torch.exp(-(torch.arange(n, device=dev, dtype=torch.float32)
                        - torch.tensor(pos[:, d:d + 1], device=dev,
                                       dtype=torch.float32)) ** 2 / 9.0)
            for d, n in enumerate(size)]
    nz = (prof[1][:, :, None] * prof[2][:, None, :]).reshape(k, -1)
    grid = basis.voxel_grid(size, device=dev)
    u = grid / torch.tensor(half, device=dev, dtype=torch.float32) - 1.0
    mono = torch.stack([u[:, 0] ** 2, u[:, 1] ** 2, u[:, 0] * u[:, 1]], -1)
    c_dev = torch.tensor(c, device=dev, dtype=torch.float32)
    video = None if out is not None else np.empty((t,) + tuple(size),
                                                  np.float32)
    for i in range(t):
        vol = (prof[0].T @ (c_dev[:, i:i + 1] * nz)).reshape(size)
        d = (torch.tensor(rigid[i], device=dev, dtype=torch.float32)
             + mono @ torch.tensor(quad[i], device=dev, dtype=torch.float32))
        frame = trilinear_resample(vol, grid + d, padding="edge").reshape(
            size) + PIPE_NOISE * torch.randn(size, generator=gen, device=dev)
        host = frame.cpu().numpy()
        if out is None:
            video[i] = host
        else:
            out.write(host.tobytes())
    return video, pos0, c


def match_seeds(result, pos0, c_true):
    """Each planted neuron's nearest seed (frame-0 positions): the share
    seeded within ``SEED_PX`` and the trace correlations of those."""
    seeds = result.positions[:, :, 0]
    d = np.linalg.norm(pos0[:, None] - seeds[None], axis=-1)
    nearest = d.argmin(axis=1)
    dist = d[np.arange(len(pos0)), nearest]
    hit = dist <= SEED_PX
    say("pipeline: planted neuron to nearest seed, px: quantiles (50, 90, "
        "99, 100) " + ", ".join(f"{q:.3f}" for q in np.quantile(
            dist, [0.5, 0.9, 0.99, 1.0]))
        + f"; share within 2 px {float((dist <= 2.0).mean()):.4f}")
    traces = result.traces
    corr = np.array([np.corrcoef(traces[j], c_true[i])[0, 1]
                     for i, j in zip(np.flatnonzero(hit), nearest[hit])])
    return float(hit.mean()), corr


def idle_share(run):
    """Wall seconds, device-busy seconds and idle share of ``run()`` under
    ``torch.profiler`` (the union of the device's kernel and copy spans
    over the wall; the profiler inflates host time, so read shares), and
    the five largest device-time entries; busy None where the trace holds
    no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        return wall, None, None, []

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    top = sorted(prof.key_averages(), key=dev_us, reverse=True)[:5]
    return wall, busy * 1e-6, 1.0 - busy * 1e-6 / wall, [
        (e.key, dev_us(e) * 1e-3) for e in top]


def pipeline_path(dev, size, k):
    """``register_and_demix(RawFileVideo(...), num_neurons=k,
    refine_positions=True)`` at its defaults on a recording written to a
    raw file; the C4 op entry on the fitted state; one more streamed fit
    round under the profiler.  Returns the launch counts of the pipeline
    and of the C4 path."""
    import tempfile

    from dnmf_tpu_torch.data.streaming import RawFileVideo
    from dnmf_tpu_torch.engine.pipeline import register_and_demix

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        path = f"{tmp}/recording.raw"
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            _, pos0, c_true = pipeline_recording(dev, size, k, PIPE_T,
                                                 SEED + 4, out=f)
        shape = (PIPE_T,) + tuple(size)
        say(f"pipeline recording {shape} float32 written to a raw file "
            f"({PIPE_T * np.prod(size) * 4 / 1e9:.2f} GB, "
            f"{time.perf_counter() - t0:.3f} s)")
        src = RawFileVideo(path, shape, block=PIPE_BLOCK, device=dev)
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        res = register_and_demix(src, num_neurons=k, refine_positions=True)
        total = time.perf_counter() - t0
        launches = fused.launch_counts()
        say(f"pipeline: launches {launches}")
        say("pipeline seconds: " + ", ".join(
            f"{stage} {sec:.3f}" for stage, sec in res.seconds.items())
            + f"; total {total:.3f} ({PIPE_T} frames, "
            f"{total / PIPE_T * 1e3:.4f} ms per frame); fit rounds "
            + ", ".join(f"{m['seconds']:.3f}" for m in res.fit.metrics
                        if m["phase"] == "round") + " s")
        for kname in ("motion_block", "c1_block", "gram_block",
                      "refine_block", "c1_block_tracked", "phase_corr_block"):
            if launches[kname] <= 0:
                fail(f"pipeline: {kname} was not launched")
        # What one streamed pass costs with nothing to compute: the native
        # reader, and a memmap read on the calling thread.
        from dnmf_tpu_torch.data.streaming import open_memmap_video
        for label, s in (("RawFileVideo", src), ("memmap StreamingVideo",
                         open_memmap_video(path, shape, block=PIPE_BLOCK,
                                           device=dev))):
            t0 = time.perf_counter()
            for frames, _, _ in s.blocks():
                pass
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            say(f"one streamed pass, {label}: {sec:.3f} s "
                f"({PIPE_T * np.prod(size) * 4 / sec / 1e9:.3f} GB/s)")
        state = res.fit.state
        for name in ("beta", "c", "pos", "sigma"):
            if not bool(torch.isfinite(getattr(state, name)).all()):
                fail(f"pipeline: non-finite {name}")
        share, corr = match_seeds(res, pos0, c_true)
        motion = [m for m in res.fit.metrics if m["phase"] == "motion"]
        ref = [m for m in res.fit.metrics if m["phase"] == "refine"][-1]
        say(f"pipeline: {res.traces.shape[0]} seeds; planted neurons seeded "
            f"within {SEED_PX} px in frame 0: {share:.4f}; trace corr vs the "
            f"truth over {corr.size} matched: mean {corr.mean():.6f}, min "
            f"{corr.min():.6f}; fit's last motion recon_mse "
            f"{motion[-1]['recon_mse']:.6e}, refine recon_mse "
            f"{ref['recon_mse']:.6e}")
        if not share >= SEED_SHARE:
            fail(f"pipeline: {share:.4f} of planted neurons seeded")
        if not corr.mean() >= TRACE_CORR_MEAN:
            fail(f"pipeline: mean trace correlation {corr.mean():.6f}")
        if not ref["recon_mse"] < motion[-1]["recon_mse"]:
            fail("pipeline: refine did not lower the reconstruction error")

        # C4's path, its op entry: the first block's MU statistics at the
        # fitted state from rows computed outside the kernel.
        frames, start, valid = next(iter(src.blocks()))
        betas = state.beta[start:start + valid]
        fused.reset_launch_counts()
        g_rows, c1_rows = fused.gram_block(betas, state.pos, state.sigma,
                                           frames[:valid], size,
                                           psi_source="stream")
        c4_launches = fused.launch_counts()
        g_in, c1_in = fused.gram_block(betas, state.pos, state.sigma,
                                       frames[:valid], size)
        e_g, e_c = rel_err(g_rows, g_in), rel_err(c1_rows, c1_in)
        say(f"C4 path: launches {c4_launches}; fitted-state Grams from rows "
            f"vs the in-kernel-rows kernel: G {e_g:.3e}, c1 {e_c:.3e}")
        if c4_launches["gram_block_rows"] <= 0:
            fail("C4 path: gram_block_rows was not launched")
        if not (e_g <= KERNEL_TOL and e_c <= KERNEL_TOL):
            fail(f"C4 path: {e_g:.3e} / {e_c:.3e} > {KERNEL_TOL}")

        # One more streamed fit round, profiled: does the pinned prefetch
        # keep the card busy?
        model = tcfg.ModelConfig(size=tuple(size), num_neurons=state.c.shape[0],
                                 num_frames=PIPE_T, shape_std=3.0)
        engine = ttr.DeformableNMF(
            model, tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=1,
                                        motion_epochs=12),
            positions=state.pos, beta0=state.beta, device=dev)
        engine.state = engine.state.replace(c=state.c)
        wall, busy, idle, top = idle_share(lambda: engine.fit(src))
        if busy is None:
            say(f"streamed fit round (profiled): wall {wall:.3f} s; the "
                "trace held no device events: idle share not measured")
        else:
            say(f"streamed fit round (profiled): wall {wall:.3f} s, device "
                f"busy {busy:.3f} s, idle share {idle:.4f}; top device "
                "time: " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in top))
        del src, engine, res
    return launches, c4_launches


def streamed_equals_resident(dev, size, k):
    """``register_and_demix`` on an in-memory NumPy recording and on a
    ``StreamingVideo`` over it, points pinned: the JAX package's streamed
    == resident gates, on the card with the kernels."""
    from dnmf_tpu_torch.data.streaming import StreamingVideo
    from dnmf_tpu_torch.engine.pipeline import register_and_demix

    video, pos0, _ = pipeline_recording(dev, size, k, PIPE_T, SEED + 5)
    kw = dict(points=pos0, runtime=tcfg.RuntimeConfig(frame_block=PIPE_BLOCK))
    t0 = time.perf_counter()
    res_a = register_and_demix(video, **kw)
    t1 = time.perf_counter()
    res_b = register_and_demix(StreamingVideo(video, block=PIPE_BLOCK), **kw)
    t2 = time.perf_counter()
    same_pos = bool(np.array_equal(res_b.positions, res_a.positions))
    d_c = np.abs(res_b.traces - res_a.traces)
    ok_c = bool((d_c <= 1e-6 + 2e-4 * np.abs(res_a.traces)).all())
    d_b = float(np.abs(res_b.fit.beta - res_a.fit.beta).max())
    say(f"streamed == resident ({size}, K={k}, T={PIPE_T}): positions equal "
        f"{same_pos}; traces max diff {d_c.max():.3e} (within rtol 2e-4 / "
        f"atol 1e-6: {ok_c}); beta max diff {d_b:.3e}; resident "
        f"{t1 - t0:.3f} s, streamed {t2 - t1:.3f} s")
    if not (same_pos and ok_c and d_b <= 1e-5):
        fail("streamed != resident")


def dataset_noise(dev, cfg):
    """The fixture's positions and the RMS of its clean render after
    ``generate_video``'s division by the sum of squares, from the draws
    that ``SimulatedVideoDataset(cfg)`` will make (the same generator
    seed)."""
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    clean, pos, _ = simulator.clean_fixture(cfg, gen, dev)
    rms = float(torch.sqrt(torch.mean((clean / torch.sum(clean ** 2)) ** 2)))
    return pos, rms


def dataset_path(dev, sim=DATASET_SIM):
    """``DeformableNMF.fit(SimulatedVideoDataset(...))`` at the ROI shape:
    kernels vs plain, ``fit(ds)`` vs ``fit(ds.video)``, and the traces
    against the fixture's.  Returns the launch counts of the kernel fit."""
    cfg = tcfg.SimulatorConfig(**sim)
    t0 = time.perf_counter()
    pos, rms = dataset_noise(dev, cfg)
    # generate_video's noise std is sqrt(10^(bg_snr_db / 10)).
    bg_snr_db = 20.0 * math.log10(DATASET_NOISE * rms)
    cfg = dataclasses.replace(cfg, bg_snr_db=bg_snr_db)
    ds = SimulatedVideoDataset(cfg, device=dev)
    torch.cuda.synchronize()
    say(f"dataset: SimulatedVideoDataset {tuple(ds.video.shape)} on the card "
        f"({time.perf_counter() - t0:.3f} s with the noise-level render); "
        f"normalized signal RMS {rms:.6e}, noise std "
        f"{DATASET_NOISE * rms:.6e} (bg_snr_db {bg_snr_db:.4f})")
    if not torch.equal(ds.positions, pos):
        fail("dataset: the fixture's draws differ from the noise-level run")
    model = tcfg.ModelConfig(size=cfg.size, num_neurons=cfg.num_neurons,
                             num_frames=cfg.num_frames,
                             shape_std=cfg.shape_std)

    def fit(source, use_kernels):
        opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                                   motion_epochs=2, mu_iters=50, seed=SEED)
        rt = tcfg.RuntimeConfig(frame_block=8, gram_mode="auto",
                                use_kernels=use_kernels)
        return ttr.DeformableNMF(model, opt, rt,
                                 positions=ds.positions[:, :, 0],
                                 device=dev).fit(source)

    fused.reset_launch_counts()
    res_k = fit(ds, None)
    launches = fused.launch_counts()
    say(f"dataset: launches during fit(dataset): {launches}")
    for kname in ("motion_block", "c1_block", "gram_block"):
        if launches[kname] <= 0:
            fail(f"dataset: {kname} was not launched during fit(dataset)")
    res_v = fit(ds.video, None)
    res_p = fit(ds, False)
    same = all(torch.equal(getattr(res_k.state, f), getattr(res_v.state, f))
               for f in ("beta", "c", "sigma"))
    mk = [m for m in res_k.metrics if m["phase"] == "motion"]
    mp = [m for m in res_p.metrics if m["phase"] == "motion"]
    worst = max(abs(a["recon_mse"] - b["recon_mse"]) / abs(b["recon_mse"])
                for a, b in zip(mk, mp))
    agree = float(trace_corr(res_k.state.c, res_p.state.c).min())
    gt = trace_corr(res_k.state.c, ds.traces)
    roi = trace_corr(simulator.roi_signals(ds.video, ds.positions),
                     ds.traces)
    secs = [m["seconds"] for m in res_k.metrics if m["phase"] == "round"]
    say(f"dataset: fit(dataset) == fit(dataset.video) bit for bit: {same}; "
        f"kernel vs plain recon_mse max rel diff {worst:.3e}, trace corr min "
        f"{agree:.6f}; trace corr vs the fixture mean {float(gt.mean()):.6f}, "
        f"min {float(gt.min()):.6f}; roi_signals at the true positions "
        f"mean {float(roi.mean()):.6f}, min {float(roi.min()):.6f}; seconds "
        f"per round (kernels) {secs}")
    if not same:
        fail("dataset: fit(dataset) differs from fit(dataset.video)")
    if len(mk) != len(mp) or not worst <= FIT_MSE_TOL:
        fail(f"dataset: recon_mse differs by {worst:.3e}")
    if not agree >= FIT_CORR_MIN:
        fail(f"dataset: kernel vs plain trace correlation {agree:.6f}")
    if not float(gt.mean()) >= DATASET_CORR_MEAN:
        fail(f"dataset: mean trace correlation {float(gt.mean()):.6f}")
    return launches


def witness_wb(dev):
    """The whole-brain pipeline witness: ``seeded_recovery`` at bench.py's
    protocol (rigid-seeded, analytic Grams).  Returns the launch counts."""
    w = wb_recovery.WITNESSES["pipeline"]
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    r = wb_recovery.seeded_recovery(w["size"], w["k"], w["t"], w["rounds"],
                                    w["epochs"], w["mu_iters"], device=dev,
                                    **w["fit"])
    total = time.perf_counter() - t0
    launches = fused.launch_counts()
    corr = r["corr"]
    say(f"witness whole-brain ({w}): launches {launches}")
    say(f"witness whole-brain: trace corr mean {corr.mean():.6f}, min "
        f"{corr.min():.6f}; warp error {r['warp_err_px']:.6f} px; synth "
        f"{r['synth_s']:.3f} s, registration seed {r['reg_s']:.3f} s, round "
        f"{r['round_s_steady']:.3f} s (median after the first, "
        f"{w['t'] / r['round_s_steady']:.1f} frames/s); closest planted "
        f"pair {wb_recovery.closest_pair(r['pos_gt']):.4f} px; total "
        f"{total:.3f} s")
    for kname in ("motion_block", "c1_block"):
        if launches[kname] <= 0:
            fail(f"witness whole-brain: {kname} was not launched")
    if not bool(torch.isfinite(r["state"].c).all()):
        fail("witness whole-brain: non-finite traces")
    if not (corr.mean() >= WITNESS_WB_CORR[0]
            and corr.min() >= WITNESS_WB_CORR[1]):
        fail(f"witness whole-brain: trace corr {corr.mean():.6f} / "
             f"{corr.min():.6f}")
    if not r["warp_err_px"] <= WITNESS_WB_WARP_PX:
        fail(f"witness whole-brain: warp error {r['warp_err_px']:.6f} px")
    return launches


def witness_aniso(dev):
    """The anisotropic-width witness: one per-axis fixture, fitted with
    per-axis widths and with the isotropic control.  Returns the launch
    counts of the per-axis arm."""
    w = wb_recovery.WITNESSES["aniso"]
    t0 = time.perf_counter()
    fixture = wb_recovery.recovery_fixture(w["size"], w["k"], w["t"],
                                           sigma_aniso=True, device=dev)
    arms, launches = {}, {}
    for axes in w["arms"]:
        fused.reset_launch_counts()
        arms[axes] = wb_recovery.recover(fixture, w["rounds"], w["epochs"],
                                         w["mu_iters"], fit_sigma_axes=axes,
                                         **w["fit"])
        launches[axes] = fused.launch_counts()
    say(f"witness anisotropic ({w}): launches per-axis {launches[3]}, "
        f"isotropic {launches[1]}")
    for axes, r in arms.items():
        say(f"witness anisotropic, sigma_axes={axes}: width error "
            f"{r['sigma_err']:.6f} px; trace corr mean {r['corr'].mean():.6f},"
            f" min {r['corr'].min():.6f}; warp error {r['warp_err_px']:.6f} "
            f"px; round {r['round_s_steady']:.3f} s")
        if launches[axes]["refine_block"] <= 0:
            fail(f"witness anisotropic: refine_block was not launched "
                 f"(sigma_axes={axes})")
        if not r["corr"].mean() >= WITNESS_ANISO_CORR_MEAN[axes]:
            fail(f"witness anisotropic: trace corr {r['corr'].mean():.6f} "
                 f"(sigma_axes={axes})")
    err3, err1 = arms[3]["sigma_err"], arms[1]["sigma_err"]
    say(f"witness anisotropic: closest planted pair "
        f"{wb_recovery.closest_pair(fixture['pos_gt']):.4f} px; synth "
        f"{fixture['synth_s']:.3f} s; total {time.perf_counter() - t0:.3f} s")
    if not (err3 <= WITNESS_ANISO_SIGMA_PX and err3 < 0.5 * err1):
        fail(f"witness anisotropic: width error {err3:.6f} px against the "
             f"isotropic {err1:.6f} px")
    return launches[3]


# ----------------------------------------------------------------------
# The reference-parity path and the engine's remainder
# ----------------------------------------------------------------------
PARITY_FRAMES = 256  # parity motion at the ROI shape: 64 batches of 4
ENGINE_FRAMES = 64  # checkpoint/resume, fit_fused, profile_dir
# Reference demo fixture, its anchors kept 10 px inside the 50x50 plane:
# its GP offsets (2.56 px std) then stay inside too (ROADMAP Queue 3's
# runaway traces rule out the demo's own borderless fixture as a gate).
REF_MARGIN = 10.0
# Card vs CPU on the reference's numerics, relative to the CPU's max:
# float32 sums in another order on each device, and the trilinear
# gradient jumps where a coordinate crosses a cell face (a coordinate
# within an ulp of a face may round to either side).
REF_BETA_TOL = 1e-4
REF_C_TOL = 1e-3
STATIC_ITERS = 5
STATIC_TOL = 1e-4  # StaticFootprintNMF float32 vs float64, relative to max


def engine_fit(model, pos, video, use_kernels=None, rounds=2, **kw):
    """An engine at the main path's schedule; ``kw`` go to the runtime
    (e.g. ``checkpoint_dir``, ``profile_dir``)."""
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=rounds,
                               motion_epochs=2, mu_iters=50, seed=SEED)
    rt = tcfg.RuntimeConfig(frame_block=8, use_kernels=use_kernels, **kw)
    return ttr.DeformableNMF(model, opt, rt, positions=pos,
                             device=video.device)


def check_agree(label, rk, rp):
    """The main path's gates between two fits: the last motion epoch's
    recon_mse of every round within FIT_MSE_TOL, per-neuron trace
    correlation >= FIT_CORR_MIN."""
    mk, mp = ([m["motion_recon_mse"] for m in r.metrics
               if m["phase"] == "round"] for r in (rk, rp))
    worst = max((abs(a - b) / abs(b) for a, b in zip(mk, mp)),
                default=math.inf)
    corr = float(trace_corr(rk.state.c, rp.state.c).min())
    say(f"{label}: recon_mse max rel diff {worst:.3e} over {len(mk)} "
        f"rounds; trace corr min {corr:.6f}")
    if len(mk) != len(mp) or not worst <= FIT_MSE_TOL:
        fail(f"{label}: recon_mse differs by {worst:.3e}")
    if not corr >= FIT_CORR_MIN:
        fail(f"{label}: trace correlation {corr:.6f}")


def parity_path(dev, card):
    """(a) ``motion_mode="parity"`` at the ROI shape (T=256, batch_size=4,
    shuffled): one round of 2 epochs (128 serial Adam steps) with
    gram_mode="auto" and again with ``use_kernels=False``.  The c1 and
    Gram kernels ran (the closed form's c1 pass and the audit), the motion
    epoch is plain PyTorch, and the two fits agree.  Returns the kernel
    fit's launches."""
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=PARITY_FRAMES,
                             shape_std=roi.shape_std)
    pos, c_true, video = ground_truth(dev, model.size, model.num_neurons,
                                      model.num_frames, SEED)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=1,
                               motion_epochs=2, mu_iters=50, seed=SEED,
                               motion_mode="parity", batch_size=4,
                               shuffle=True)

    def fit(use_kernels):
        eng = ttr.DeformableNMF(model, opt, tcfg.RuntimeConfig(
            frame_block=8, use_kernels=use_kernels), positions=pos,
            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.fit(video)
        return res, time.perf_counter() - t0

    fused.reset_launch_counts()
    res_k, secs_k = fit(None)
    launches = fused.launch_counts()
    res_p, secs_p = fit(False)
    epochs = [m for m in res_k.metrics if m["phase"] == "motion"]
    rounds = [m for m in res_k.metrics if m["phase"] == "round"]
    motion_s = rounds[0]["seconds"]
    say(f"parity ({card}): launches {launches}; Adam steps "
        f"{int(res_k.state.count)}; fit {secs_k:.3f} s with kernels, "
        f"{secs_p:.3f} s plain; {1e3 * secs_k / len(epochs):.1f} ms per "
        f"parity epoch (round {motion_s:.3f} s, Grams and 50 MU included); "
        f"recon_mse per epoch {[round(m['recon_mse'], 9) for m in epochs]}")
    for kname in ("c1_block", "gram_block"):
        if launches[kname] <= 0:
            fail(f"parity: {kname} was not launched")
    if launches["motion_block"] != 0:
        fail("parity: the motion kernel ran in a parity epoch")
    if int(res_k.state.count) != 2 * PARITY_FRAMES // 4:
        fail(f"parity: {int(res_k.state.count)} Adam steps")
    check_agree("parity kernel vs plain", res_k, res_p)
    if not bool(torch.isfinite(res_k.state.beta).all()):
        fail("parity: non-finite warps")
    return launches


def reference_parity(dev, card):
    """(b) The reference's numerics (``reference_demo_model(parity=True)``:
    resampled footprints, pixel basis, detached regularizer; the demo's
    schedule, parity mode) at the demo's shape on a seeded simulator
    fixture whose anchors sit ``REF_MARGIN`` inside: one round on the card
    and the same round on the CPU from the same state; then ``demo_torch
    --parity --rounds 1``, its summary printed ungated."""
    sim = dataclasses.replace(tcfg.reference_demo_simulator(),
                              margin=REF_MARGIN, seed=SEED)
    ds = SimulatedVideoDataset(sim, device=dev)
    model = tcfg.reference_demo_model(parity=True)
    opt = dataclasses.replace(tcfg.reference_demo_optimizer(),
                              motion_mode="parity", outer_rounds=1)
    results, secs = {}, {}
    for role, device in (("card", dev), ("cpu", torch.device("cpu"))):
        eng = ttr.DeformableNMF(model, opt, positions=ds.positions[:, :, 0],
                                device=device)
        if eng._use_kernels:
            fail("reference parity: the kernels resolved for resampling")
        t0 = time.perf_counter()
        results[role] = eng.fit(ds.video.to(device))
        secs[role] = time.perf_counter() - t0
    card_res, cpu_res = results["card"], results["cpu"]
    beta_err = rel_err(card_res.state.beta.cpu(), cpu_res.state.beta)
    c_err = rel_err(card_res.state.c.cpu(), cpu_res.state.c)
    corr = trace_corr(card_res.state.c.cpu(), ds.traces.cpu())
    say(f"reference parity ({card}): 1 round (10 epochs x 25 batches, "
        f"50 MU) card {secs['card']:.3f} s, CPU {secs['cpu']:.3f} s; "
        f"card vs CPU beta {beta_err:.3e} (tol {REF_BETA_TOL:g}), C "
        f"{c_err:.3e} (tol {REF_C_TOL:g}), relative to the CPU's max; trace "
        f"corr vs the fixture mean {float(corr.mean()):.6f}, min "
        f"{float(corr.min()):.6f}")
    if not beta_err <= REF_BETA_TOL:
        fail(f"reference parity: beta card vs CPU {beta_err:.3e}")
    if not c_err <= REF_C_TOL:
        fail(f"reference parity: C card vs CPU {c_err:.3e}")
    import demo_torch

    t0 = time.perf_counter()
    summary = demo_torch.main(["--parity", "--rounds", "1"])
    if not isinstance(summary, dict):
        fail(f"demo_torch --parity --rounds 1 exited with {summary}")
    say(f"demo_torch --parity --rounds 1 ({card}): "
        f"{time.perf_counter() - t0:.3f} s; summary {json.dumps(summary)}")


def checkpoint_resume(dev, card, model, pos, video):
    """(c) ``fit`` 2 rounds with ``checkpoint_dir`` (parallel, kernels, no
    anneal); a fresh engine restores ``round_0`` and fits 1 round: beta,
    C, sigma, the Adam moments and count equal the unbroken run's, bit
    for bit."""
    import tempfile

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        fused.reset_launch_counts()
        t0 = time.perf_counter()
        unbroken = engine_fit(model, pos, video, checkpoint_dir=tmp).fit(
            video).state
        fit_s = time.perf_counter() - t0
        launches = fused.launch_counts()
        fresh = engine_fit(model, pos, video)
        t0 = time.perf_counter()
        fresh.restore(os.path.join(tmp, "round_0.pt"))
        restore_s = time.perf_counter() - t0
        resumed = fresh.fit(video, rounds=1).state
        size = os.path.getsize(os.path.join(tmp, "round_0.pt"))
    same = {f: torch.equal(getattr(resumed, f), getattr(unbroken, f))
            for f in ("beta", "c", "sigma", "mu", "nu", "count")}
    say(f"checkpoint/resume ({card}): fit 2 rounds with checkpoints "
        f"{fit_s:.3f} s, restore {restore_s:.3f} s ({size / 1e6:.3f} MB per "
        f"checkpoint); launches {launches}; resumed == unbroken: {same}")
    for kname in ("motion_block", "c1_block", "gram_block"):
        if launches[kname] <= 0:
            fail(f"checkpoint/resume: {kname} was not launched")
    if not all(same.values()):
        fail(f"checkpoint/resume: resumed run differs: {same}")
    return launches


def fused_vs_fit(dev, card, model, pos, video):
    """(d) ``fit_fused`` against ``fit`` from the same engine state, within
    the main path's gates."""
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    ff = engine_fit(model, pos, video).fit_fused(video)
    torch.cuda.synchronize()
    ff_s = time.perf_counter() - t0
    launches = fused.launch_counts()
    t0 = time.perf_counter()
    fit = engine_fit(model, pos, video).fit(video)
    fit_s = time.perf_counter() - t0
    same = all(torch.equal(getattr(ff.state, f), getattr(fit.state, f))
               for f in ("beta", "c", "mu", "nu"))
    audits = [m["rel_err"] for m in ff.metrics if m["phase"] == "gram_audit"]
    say(f"fit_fused ({card}): {ff_s:.3f} s, fit {fit_s:.3f} s; launches "
        f"{launches}; audits before/after {audits}; bit-equal to fit: "
        f"{same}")
    for kname in ("motion_block", "c1_block", "gram_block"):
        if launches[kname] <= 0:
            fail(f"fit_fused: {kname} was not launched")
    if len(audits) != 2:
        fail("fit_fused: the closed-form Grams were not audited twice")
    check_agree("fit_fused vs fit", ff, fit)
    return launches


def profile_round(dev, card, model, pos, video):
    """(e) ``profile_dir``: the trace of the last round names the motion
    and c1 kernels."""
    import tempfile

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        engine_fit(model, pos, video, profile_dir=tmp).fit(video)
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
        with open(os.path.join(tmp, files[-1])) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", [])
    found = {k: sum(k in e.get("name", "") for e in events)
             for k in ("motion_bricks", "c1_bricks")}
    kernels = sum(e.get("cat") == "kernel" for e in events)
    say(f"profile_dir ({card}): fit 2 rounds {secs:.3f} s; trace files "
        f"{files}; {len(events)} events, {kernels} kernel events; events "
        f"by name {found}")
    if files != ["round_1.trace.json"]:
        fail(f"profile_dir: wrote {files}")
    for k, n in found.items():
        if n <= 0:
            fail(f"profile_dir: the trace names no {k} kernel")


def static_footprint(dev, card, model, pos, video):
    """(f) ``StaticFootprintNMF`` at the ROI shape: ``STATIC_ITERS``
    alternations against the same iterations in float64."""
    from dnmf_tpu_torch.ops import mu as mu_ops

    eng = ttr.StaticFootprintNMF(model, pos, device=dev)
    a0, c0, d = eng.a.double(), eng.c.double(), eng.d.double()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, c = eng.fit(video, iters=STATIC_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    y = torch.clamp_min(video.double(), 0.0).T
    a_o, c_o = a0, c0
    for _ in range(STATIC_ITERS):
        c_o = c_o * (a_o.T @ y) / ((a_o.T @ a_o) @ c_o + mu_ops.EPS)
        a_o = mu_ops.mu_spatial_step(a_o, c_o, y, d=d, gamma=eng.gamma_a)
    ea, ec = rel_err(a, a_o), rel_err(c, c_o)
    say(f"StaticFootprintNMF ({card}): {STATIC_ITERS} iterations at "
        f"{tuple(video.shape)} {secs:.3f} s; vs float64 A {ea:.3e}, C "
        f"{ec:.3e} (tol {STATIC_TOL:g})")
    if not (ea <= STATIC_TOL and ec <= STATIC_TOL):
        fail(f"StaticFootprintNMF: float32 vs float64 A {ea:.3e}, C {ec:.3e}")


def engine_paths(dev, card):
    """Phases (a)-(f), each timed; returns the launches per phase."""
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=ENGINE_FRAMES,
                             shape_std=roi.shape_std)
    pos, _, video = ground_truth(dev, model.size, model.num_neurons,
                                 model.num_frames, SEED)
    launches = {}
    phases = (("parity path", lambda: parity_path(dev, card)),
              ("reference parity", lambda: reference_parity(dev, card)),
              ("checkpoint/resume", lambda: checkpoint_resume(
                  dev, card, model, pos, video)),
              ("fit_fused", lambda: fused_vs_fit(dev, card, model, pos,
                                                 video)),
              ("profile_dir", lambda: profile_round(dev, card, model, pos,
                                                    video)),
              ("StaticFootprintNMF", lambda: static_footprint(
                  dev, card, model, pos, video)))
    for label, phase in phases:
        t0 = time.perf_counter()
        launches[label] = phase()
        say(f"{label}: {time.perf_counter() - t0:.3f} s ({card})")
    return launches


# ------------------------------------------------------------------
# The parallel layer (phases 23-27): voxel-range kernels, then ranks of
# a process group that share the one card (gloo: NCCL refuses two ranks
# on one device).  They measure correctness, not scaling.
# ------------------------------------------------------------------
RANGE_NPIX = (4, 5)  # pixel shards of the whole-brain volume: slabs of 128
# m rows, and runs that cut m row 102.4
SHARD_WORLD = 4  # ranks on the card
SHARD_FRAMES = 32  # frames of the sharded whole-brain fits
SHARD_OPT = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=4,
                 mu_iters=50, seed=SEED)
SHARD_TIMEOUT_S = 420  # the sharded ranks, start-up included
SHARD_REG_CFG = dict(max_shifts=(6, 6, 2), strides=(96, 96, 10),
                     overlaps=(32, 32, 0), max_deviation_rigid=3,
                     pw_rigid=True, niter_rig=1, niter_els=1, splits=2,
                     frame_block=8, remap_mode="fused", border_nan=False)
# Sharded == single-process tolerances: those of the CPU tests
# (tests/test_torch_port_parallel*.py), rtol and atol.
SHARD_TOL = {"beta": (1e-5, 1e-6), "c": (1e-4, 1e-6),
             "pos_t": (1e-5, 1e-6), "shifts": (0.0, 1e-4),
             "template": (0.0, 1e-4), "corrected": (0.0, 1e-3)}


def _allclose(label, got, ref, key):
    rtol, atol = SHARD_TOL[key]
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(got - ref) - rtol * np.abs(ref)
    worst = float(np.max(np.abs(got - ref)))
    say(f"{label} {key}: max|sharded - single| {worst:.3e} (rtol {rtol:g}, "
        f"atol {atol:g})")
    if got.shape != ref.shape or not float(np.max(err)) <= atol:
        fail(f"{label}: {key} differs from the single-process run "
             f"(max abs {worst:.3e})")


def range_kernel_phase(dev):
    """(a) Kernels A and C over voxel ranges of the whole-brain volume
    (``RANGE_NPIX`` shards): each shard against its plain version in
    float32 and float64, the mean (A) or sum (C) over the shards against
    the unsharded kernel, and each shard's time beside the unsharded
    call's.  Returns the kernels-line entries of the range variants."""
    size, k, frames, margin = SHAPES["whole_brain"]
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames, margin,
                                            SEED)
    p = y.shape[1]
    kernels = {"motion_block": fused.motion_block,
               "gram_block": fused.gram_block}
    plains = {"motion_block": fused.motion_block_plain,
              "gram_block": fused.gram_block_plain}

    def call(fn, kn, ys, p0, sl=slice(None), dt=torch.float32):
        args = [betas[sl], pos, sigma] + (
            [c[sl]] if kn == "motion_block" else []) + [ys[sl]]
        return fn(*(a.to(dt) for a in args), size, p_offset=p0)

    whole = {kn: call(kernels[kn], kn, y, None) for kn in kernels}
    whole_ms = {kn: time_ms(lambda kn=kn: call(kernels[kn], kn, y, None))
                for kn in kernels}
    out = {}
    for npix in RANGE_NPIX:
        p_loc = p // npix
        sums = {kn: None for kn in kernels}
        for kn in kernels:
            worst_abs = worst_rel = 0.0
            shard_ms, bounds = [], []
            for i in range(npix):
                p0 = i * p_loc
                ys = y[:, p0:p0 + p_loc].contiguous()
                got = call(kernels[kn], kn, ys, p0)
                p32 = call(plains[kn], kn, ys, p0)
                o64 = [torch.cat(parts) for parts in zip(*(
                    call(plains[kn], kn, ys, p0, slice(b, b + 1),
                         torch.float64) for b in range(frames)))]
                for g, q, o in zip(got, p32, o64):
                    e_k = rel_err(g, o)
                    worst_rel = max(worst_rel, e_k)
                    worst_abs = max(worst_abs,
                                    float((g.double() - o).abs().max()))
                    if not e_k <= KERNEL_TOL:
                        fail(f"{kn} over voxels [{p0}, {p0 + p_loc}): "
                             f"kernel-vs-float64 {e_k:.3e} > {KERNEL_TOL}")
                    if not rel_err(q, o) <= KERNEL_TOL:
                        fail(f"{kn} plain over voxels [{p0}, {p0 + p_loc}) "
                             f"vs float64 {rel_err(q, o):.3e}")
                sums[kn] = (list(got) if sums[kn] is None else
                            [a + b for a, b in zip(sums[kn], got)])
                shard_ms.append(time_ms(lambda: call(kernels[kn], kn, ys,
                                                     p0)))
                n1, n2 = active_pairs(betas, pos, sigma, size, lo=p0,
                                      hi=p0 + p_loc)
                inputs = (betas, pos, sigma, ys) + (
                    (c,) if kn == "motion_block" else ())
                bounds.append(bound(nbytes(*inputs, *got),
                                    footprint_flops(kn, frames, p_loc, n1,
                                                    n2)))
            total = [t / npix for t in sums[kn]] if kn == "motion_block" \
                else sums[kn]
            e_sum = max(rel_err(t, w) for t, w in zip(total, whole[kn]))
            say(f"kernel {kn} voxel range, {npix} shards of {p_loc} voxels "
                f"({p_loc / (size[1] * size[2]):g} m rows): worst shard "
                f"kernel-vs-float64 {worst_rel:.3e}; "
                f"{'mean' if kn == 'motion_block' else 'sum'} over shards "
                f"vs unsharded kernel {e_sum:.3e}; ms per shard "
                f"{[round(m, 4) for m in shard_ms]} (sum "
                f"{sum(shard_ms):.4f}), unsharded {whole_ms[kn]:.4f} ms, "
                f"bound per shard {max(b[0] for b in bounds):.4f} ms "
                f"({bounds[0][1]}) ({frames} frames)")
            if not e_sum <= KERNEL_TOL:
                fail(f"{kn}: the {npix} shards' {e_sum:.3e} from the "
                     "unsharded kernel")
            out[f"{kn}[range {npix}]"] = {
                "max_abs_err": worst_abs, "max_rel_err": worst_rel,
                "ms": max(shard_ms), "unsharded_ms": whole_ms[kn],
                "bound_ms": max(b[0] for b in bounds)}
    return out


def pod_check_phase():
    """(b) ``python -m dnmf_tpu_torch.tools.pod_check --cuda 4``: the 14
    sharded == single equalities on 4 ranks that share the card, with
    the kernels where a check asks for them."""
    proc = subprocess.run(
        [sys.executable, "-m", "dnmf_tpu_torch.tools.pod_check", "--cuda",
         str(SHARD_WORLD)], capture_output=True, text=True,
        timeout=SHARD_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if "PASS" in ln or "FAIL" in ln or "pod_check" in ln]
    for ln in lines:
        say(f"pod_check --cuda {SHARD_WORLD}: {ln.strip()}")
    passes = sum(ln.strip().startswith("PASS") for ln in lines)
    if proc.returncode != 0 or passes != 14:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"pod_check --cuda {SHARD_WORLD}: rc {proc.returncode}, "
             f"{passes} of 14 checks passed")


def _shard_runs():
    """The sharded runs of phase (c): (label, runtime, optimizer, calls);
    the runtime's mesh options are dropped for the single-process run."""
    return [
        ("time 2 x pixel 2, exact", dict(mesh_time=2, mesh_pixel=2,
                                         gram_mode="exact"),
         dict(SHARD_OPT), [("fit", {})]),
        ("time 4, auto + halo + refine", dict(mesh_time=4, gram_mode="auto"),
         dict(SHARD_OPT, gamma_traces=0.01),
         [("fit", {}), ("refine", dict(rounds=1, epochs=4))]),
        ("time 4, exact refine", dict(mesh_time=4, gram_mode="exact"),
         dict(SHARD_OPT), [("refine", dict(rounds=1, epochs=4))]),
    ]


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _run_engine(model, rt, opt, calls, spec, video, device):
    """One run of :func:`_shard_runs` on ``device``: ``(engine, result,
    seconds)``."""
    eng = ttr.DeformableNMF(
        model, tcfg.OptimizerConfig(**opt),
        tcfg.RuntimeConfig(frame_block=8, **rt), positions=spec["pos"],
        device=device, beta0=spec["beta0"])
    _sync(device)
    t0 = time.perf_counter()
    res = None
    for method, kw in calls:
        res = getattr(eng, method)(video, **kw)
    _sync(device)
    return eng, res, time.perf_counter() - t0


def _shard_rank(rank, world, address, out, spec):
    """A rank of phases (c) and (d): the runs of :func:`_shard_runs` on
    its shard, then the sharded piecewise-rigid registration; puts
    ``(rank, label, launches, seconds, result file or None)``."""
    from dnmf_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    # The ranks share the host's cores, as they share the card.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    parallel.initialize_distributed(address, world, rank,
                                    local_device_ids=[0], backend="gloo")
    dev = torch.device(spec["device"])
    model = spec["model"]
    video = np.load(spec["video"], mmap_mode="c")
    for i, (label, rt, opt, calls) in enumerate(spec["runs"]):
        fused.reset_launch_counts()
        torch.distributed.barrier()
        eng, res, secs = _run_engine(model, rt, opt, calls, spec, video, dev)
        launches = fused.launch_counts()
        pos_t = eng._whole(eng.pos_t) if eng.pos_t is not None else None
        path = None
        if rank == 0:
            path = os.path.join(spec["dir"], f"run{i}.npz")
            np.savez(path, **model_lib.state_to_numpy(res.state),
                     **({} if pos_t is None else
                        {"pos_t": pos_t.cpu().numpy()}),
                     round_s=np.array([m["seconds"] for m in eng.metrics
                                       if m["phase"] == "round"]))
        out.put((rank, label, launches, secs, path))
    mesh = parallel.make_mesh(num_time=2, num_batch=world // 2)
    reg_video = np.load(spec["reg_video"])
    template = np.load(spec["reg_template"])
    cfg = tcfg.RegistrationConfig(**spec["reg_cfg"])
    fused.reset_launch_counts()
    torch.distributed.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    templ, corrected, shifts = parallel.sharded_register_pwrigid(
        reg_video, cfg, mesh, template=template, device=dev)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = fused.launch_counts()
    corrected = parallel.gather_time(torch.from_numpy(corrected).to(dev),
                                     mesh)
    shifts = parallel.gather_time(torch.as_tensor(shifts).to(dev), mesh)
    path = None
    if rank == 0:
        path = os.path.join(spec["dir"], "reg.npz")
        np.savez(path, template=templ.cpu().numpy(),
                 corrected=corrected.cpu().numpy(),
                 shifts=shifts.cpu().numpy())
    out.put((rank, "registration", launches, secs, path))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(fn, world, args, timeout):
    """``world`` spawned ranks of ``fn(rank, world, address, out,
    *args)``, joined within ``timeout`` seconds (killed past it); returns
    what the ranks put on ``out``, drained while they run."""
    import torch.multiprocessing as mp

    out = mp.get_context("spawn").SimpleQueue()
    address = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.start_processes(fn, args=(world, address, out) + tuple(args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    rows = []
    try:
        while True:
            while not out.empty():
                rows.append(out.get())
            if ctx.join(timeout=2):
                break
            if time.monotonic() > deadline:
                fail(f"{fn.__name__}: ranks ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    while not out.empty():
        rows.append(out.get())
    return rows


def sharded_paths(dev, card):
    """(c) the sharded whole-brain fits and (d) the sharded registration,
    on ``SHARD_WORLD`` ranks that share the card, each against the
    single-process run on the card; the launch counters of every rank."""
    import tempfile

    wb, _ = tcfg.baseline_workload("whole_brain")
    size, k = wb.size, wb.num_neurons
    model = tcfg.ModelConfig(size=size, num_neurons=k,
                             num_frames=SHARD_FRAMES, shape_std=3.0)
    fixture = wb_recovery.recovery_fixture(size, k, SHARD_FRAMES, seed=SEED,
                                           device=dev)
    video = fixture["video"]
    _, beta0 = wb_recovery.registration_seed(video, size)
    spec = {"model": model, "pos": fixture["pos_gt"].cpu().numpy(),
            "beta0": beta0.cpu().numpy(), "device": str(dev),
            "runs": _shard_runs(), "reg_cfg": SHARD_REG_CFG}
    reg_size, strides, overlaps, max_shifts, max_dev = REG_SHAPES["roi"]
    reg = registration_inputs(dev, reg_size, strides, overlaps, max_shifts,
                              max_dev)
    reg_template = reg["frames"].mean(0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        spec.update(dir=tmp, video=os.path.join(tmp, "video.npy"),
                    reg_video=os.path.join(tmp, "reg.npy"),
                    reg_template=os.path.join(tmp, "reg_template.npy"))
        host_video = video.cpu().numpy()
        np.save(spec["video"], host_video)
        np.save(spec["reg_video"], reg["frames"].cpu().numpy())
        np.save(spec["reg_template"], reg_template.cpu().numpy())
        singles = {}
        for label, rt, opt, calls in spec["runs"]:
            rt1 = {k_: v for k_, v in rt.items() if not k_.startswith("mesh")}
            eng, res, secs = _run_engine(model, rt1, opt, calls, spec,
                                         host_video, dev)
            singles[label] = (res, eng.pos_t, secs, [
                m["seconds"] for m in eng.metrics if m["phase"] == "round"])
        t0 = time.perf_counter()
        reg_single = mc_lib._batch_pwrigid(
            reg["frames"].cpu().numpy(),
            tcfg.RegistrationConfig(**SHARD_REG_CFG), dev, reg_template)
        reg_single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = _spawn(_shard_rank, SHARD_WORLD, (spec,), SHARD_TIMEOUT_S)
        say(f"sharded ranks: {SHARD_WORLD} processes on the card, "
            f"{time.perf_counter() - t0:.3f} s in all, start-up included "
            f"({card})")
        results = {}
        for rank, label, launches, secs, path in sorted(
                rows, key=lambda r: (r[1], r[0])):
            say(f"sharded {label} rank {rank}: {secs:.3f} s; launches "
                f"{ {kn: n for kn, n in launches.items() if n} }")
            results.setdefault(label, {"launches": [], "secs": []})
            results[label]["launches"].append(launches)
            results[label]["secs"].append(secs)
            if path is not None:
                results[label]["data"] = dict(np.load(path))
        _check_sharded(results, singles, reg_single, reg_single_s, card)


def _check_sharded(results, singles, reg_single, reg_single_s, card):
    """The gates of phases (c) and (d)."""
    need = {  # kernels that every rank, or some rank, must have launched
        "time 2 x pixel 2, exact": ({"motion_block", "gram_block"}, set()),
        "time 4, auto + halo + refine": (
            {"motion_block", "c1_block", "refine_block", "c1_block_tracked"},
            {"gram_block"}),  # the audit: the owner of the frame
        "time 4, exact refine": ({"refine_block", "gram_block_tracked"},
                                 set()),
        "registration": ({"phase_corr_block", "fused_separable_warp"},
                         set()),
    }
    for label, (every, some) in need.items():
        got = results.get(label)
        if got is None or len(got["launches"]) != SHARD_WORLD:
            fail(f"sharded {label}: not every rank reported")
        for kn in every:
            if min(ln[kn] for ln in got["launches"]) <= 0:
                fail(f"sharded {label}: a rank did not launch {kn}")
        for kn in some:
            if max(ln[kn] for ln in got["launches"]) <= 0:
                fail(f"sharded {label}: no rank launched {kn}")
    for label, (res, pos_t, secs, round_s) in singles.items():
        data = results[label]["data"]
        rank_round_s = [float(x) for x in data["round_s"]]
        say(f"sharded {label}: {max(results[label]['secs']):.3f} s (slowest "
            f"rank), seconds per round {rank_round_s}; single process "
            f"{secs:.3f} s, seconds per round {round_s} ({card})")
        _allclose(f"sharded {label}", data["beta"],
                  res.state.beta.cpu().numpy(), "beta")
        _allclose(f"sharded {label}", data["c"], res.state.c.cpu().numpy(),
                  "c")
        if pos_t is not None:
            _allclose(f"sharded {label}", data["pos_t"],
                      pos_t.cpu().numpy(), "pos_t")
        for name in ("beta", "c"):
            if not np.all(np.isfinite(data[name])):
                fail(f"sharded {label}: non-finite {name}")
    data = results["registration"]["data"]
    templ, _, xs, ys, zs, _, mc = reg_single
    shifts = np.stack([np.stack(s, -1) for s in zip(xs, ys, zs)])
    say(f"sharded registration (time 2 x batch 2): "
        f"{max(results['registration']['secs']):.3f} s (slowest rank); "
        f"single-process chunked run {reg_single_s:.3f} s ({card})")
    _allclose("sharded registration", data["shifts"], shifts, "shifts")
    _allclose("sharded registration", data["template"],
              templ.cpu().numpy(), "template")
    _allclose("sharded registration", data["corrected"], mc, "corrected")


def _nccl_rank(rank, world, address, out):
    """(e) a one-rank NCCL group: collectives on the card, and a mesh fit
    (``mesh_time=1``) against the same fit without a mesh."""
    from dnmf_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize_distributed(address, world, rank, backend="nccl")
    dev = torch.device("cuda")
    x = torch.arange(4.0, device=dev)
    torch.distributed.all_reduce(x)
    parts = [torch.empty_like(x)]
    torch.distributed.all_gather(parts, x)
    torch.distributed.barrier()
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=16, shape_std=roi.shape_std)
    pos, _, video = ground_truth(dev, model.size, model.num_neurons, 16, SEED)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=1,
                               motion_epochs=2, gamma_traces=0.01, seed=SEED)
    fits = [ttr.DeformableNMF(model, opt, tcfg.RuntimeConfig(
        frame_block=8, **kw), positions=pos, device=dev).fit(video).state
        for kw in ({"mesh_time": 1}, {})]
    same = all(torch.equal(getattr(fits[0], f), getattr(fits[1], f))
               for f in ("beta", "c"))
    out.put({"backend": torch.distributed.get_backend(),
             "all_reduce": x.tolist(), "all_gather": parts[0].tolist(),
             "mesh_fit_equal": same})
    torch.distributed.destroy_process_group()


def nccl_phase():
    """(e) the one-rank NCCL group."""
    rows = _spawn(_nccl_rank, 1, (), 180)
    if len(rows) != 1:
        fail(f"one-rank NCCL group: the rank reported {len(rows)} times")
    res = rows[0]
    say(f"one-rank NCCL group: {res}")
    if (res["backend"] != "nccl" or res["all_reduce"] != [0.0, 1.0, 2.0, 3.0]
            or res["all_gather"] != res["all_reduce"]
            or not res["mesh_fit_equal"]):
        fail(f"one-rank NCCL group: {res}")


def parallel_paths(dev, card):
    """Phases (a)-(e), each timed; returns the range kernels' entries."""
    results = {}
    for label, phase in (
            ("voxel-range kernels", lambda: results.update(
                range_kernel_phase(dev))),
            (f"pod_check --cuda {SHARD_WORLD}", pod_check_phase),
            ("sharded fits and registration", lambda: sharded_paths(
                dev, card)),
            ("one-rank NCCL group", nccl_phase)):
        t0 = time.perf_counter()
        phase()
        say(f"{label}: {time.perf_counter() - t0:.3f} s ({card})")
    return results


def bench_phase():
    """Phase 28: the benchmark's sections, once each, less ``correctness``:
    its kernel checks are phases 1-4's."""
    from dnmf_tpu_torch.tools import bench

    rc = bench.main(["--quick", "--sections", ",".join(
        n for n in bench.SECTIONS if n != "correctness")])
    if rc != 0:
        fail(f"bench --quick returned {rc}: a section erred, missed a gate "
             "or launched none of a kernel its path should launch (its "
             "line's gates_failed)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 1

    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profile_only = sys.argv[1:] == ["--profile"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.load()
    say(f"build: {time.perf_counter() - t0:.3f} s "
        f"({_build.library_path().name})")

    dev = torch.device("cuda")
    if profile_only:
        profile_kernels(dev)
        return 0
    results = {}
    for name, (size, k, frames, margin) in SHAPES.items():
        results[name] = kernel_phase(dev, name, size, k, frames,
                                     margin)
        results[name].update(tracked_kernel_phase(dev, name, size, k,
                                                  frames, margin))
        results[name].update(rows_kernel_phase(
            dev, name, size, k, frames, margin,
            results[name]["gram_block"]["ms"]))
        results[name].update(registration_kernel_phase(
            dev, name, *REG_SHAPES[name]))
    results["pipeline"] = registration_kernel_phase(
        dev, "pipeline", *REG_SHAPES["pipeline"], with_warp=False)
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=MAIN_FRAMES, shape_std=roi.shape_std)
    launches = main_path(dev, model)
    wb, _ = tcfg.baseline_workload("whole_brain")
    wb_model = tcfg.ModelConfig(size=wb.size, num_neurons=wb.num_neurons,
                                num_frames=REFINE_FRAMES,
                                shape_std=wb.shape_std)
    auto = refine_path(dev, wb_model, "auto")
    exact = refine_path(dev, wb_model, "exact")
    launches["refine_block"] = auto["refine_block"]
    launches["c1_block_tracked"] = auto["c1_block_tracked"]
    launches["gram_block_tracked"] = exact["gram_block_tracked"]
    refine_agreement(dev, model)
    reg = registration_path(dev)
    for kname in ("phase_corr_block", "fused_separable_warp"):
        launches[kname] = reg[kname]
    pipe, c4 = pipeline_path(dev, wb.size, wb.num_neurons)
    launches["gram_block_rows"] = c4["gram_block_rows"]
    say(f"launches on the pipeline path: {pipe}")
    streamed_equals_resident(dev, roi.size, roi.num_neurons)
    for label, phase in (("dataset path", dataset_path),
                         ("whole-brain witness", witness_wb),
                         ("anisotropic witness", witness_aniso)):
        t0 = time.perf_counter()
        phase(dev)
        say(f"{label}: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    engine_paths(dev, card)
    say(f"engine paths (a)-(f): {time.perf_counter() - t0:.3f} s ({card})")
    t0 = time.perf_counter()
    ranged = parallel_paths(dev, card)
    say(f"parallel paths (a)-(e): {time.perf_counter() - t0:.3f} s ({card})")
    t0 = time.perf_counter()
    bench_phase()
    say(f"bench --quick: {time.perf_counter() - t0:.3f} s ({card})")
    say(f"chip_smoke: {time.perf_counter() - started:.3f} s in all")

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        at = results["roi"][kname]
        # The worst error over a kernel's variants (refine: dsigma, [K, 3];
        # motion and Gram: over voxel ranges of the whole-brain volume).
        variants = [r for label, r in list(results["roi"].items())
                    + list(ranged.items()) if label.split("[")[0] == kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": max(r["max_abs_err"] for r in variants),
                        # the gated error: max|kernel - float64| over
                        # max|float64|, against "tol"
                        "max_rel_err": max(r["max_rel_err"] for r in variants),
                        "tol": KERNEL_TOL, "ms": at["ms"],
                        "plain_ms": at["plain_ms"],
                        "bound_ms": at["bound_ms"],
                        "bound_by": at["bound_by"],
                        "library_ms": at["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KernelCheckError as e:
        fail(str(e))
