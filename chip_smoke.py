"""Drive the PyTorch + CUDA port's main path once on one GPU.

    python3 chip_smoke.py

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
   K=200, 2 frames), with times (median of 5 after a warm-up);
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
   the refinement alone run both ways from one fitted state.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import torch

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.ops import _build, basis, footprints, fused

SEED = 0
KERNEL_TOL = 1e-4  # max|kernel - float64| / max|float64|
FIT_MSE_TOL = 1e-3  # kernel vs plain fit, relative, per phase metric
FIT_CORR_MIN = 0.999  # kernel vs plain fit, per-neuron trace correlation
SIGMA_TOL = 1e-3  # kernel vs plain fit, fitted widths, relative
POS_TOL = 1e-3  # kernel vs plain refine, per-frame positions, pixels
REFINE_FRAMES = 32  # frames of the whole-brain refine recording
MAIN_FRAMES = 256  # frames of the main-path recording at the ROI shape
SHAPES = {  # name: (size, K, frames, position margin as bench.py draws it)
    "roi": ((256, 256, 10), 50, 8, 10.0),
    "whole_brain": ((512, 512, 20), 200, 2, 20.0),
}
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
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max().clamp_min(1e-300))


def time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    flags of the args)}; the oracle runs one frame at a time ([P, K]
    float64).  Returns {label: {"max_abs_err", "ms", "plain_ms"}}.
    """
    out = {}
    for kname, (kern, plain, labels, args, framed) in cases.items():
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
        worst_abs = 0.0
        for label, g, p, o in zip(labels, got, p32, oracle):
            e_k, e_p = rel_err(g, o), rel_err(p, o)
            worst_abs = max(worst_abs, float((g.double() - o).abs().max()))
            say(f"kernel {kname} {name} {label}: kernel-vs-float64 "
                f"{e_k:.3e}, plain32-vs-float64 {e_p:.3e}, "
                f"kernel-vs-plain32 {rel_err(g, p):.3e}")
            if not e_k <= KERNEL_TOL:
                fail(f"{kname} {name} {label}: {e_k:.3e} > {KERNEL_TOL}")
        ms = time_ms(lambda: call(kern))
        plain_ms = time_ms(lambda: call(plain))
        say(f"time {kname} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms ({frames} frames)")
        out[kname] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}
    return out


def kernel_phase(dev, name, size, k, frames, margin):
    """The demixing round's kernels at shared anchors."""
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames,
                                            margin, SEED)
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
                        labels, args, framed)
    return check_kernels(name, frames, cases)


def tracked_kernel_phase(dev, name, size, k, frames, margin):
    """The refinement kernels at per-frame positions: the anchors plus
    ~1 px of seeded jitter.  The "refine_block" entry is the plain
    data-term gradient; the dsigma variants are checked alongside."""
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames,
                                            margin, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pos_t = pos[None] + torch.randn((frames, k, 3), generator=gen,
                                    device=dev)
    sigma3 = 3.0 * (0.8 + 0.4 * torch.rand((k, 3), generator=gen,
                                           device=dev))
    refine_args = (1, 1, 0, 1, 1)
    cases = {}
    for label, sig, want in (("refine_block", sigma, False),
                             ("refine_block[dsigma]", sigma, True),
                             ("refine_block[aniso,dsigma]", sigma3, True)):
        labels = ("mse", "dpos", "dsigma")[:2 + want]
        cases[label] = (
            functools.partial(fused.refine_block, size=size,
                              want_dsigma=want),
            functools.partial(fused.refine_block_plain, size=size,
                              want_dsigma=want),
            labels, (betas, pos_t, sig, c, y), refine_args)
    cases["c1_block_tracked"] = (
        functools.partial(fused.c1_block_tracked, size=size),
        functools.partial(fused.c1_block_plain, size=size),
        ("c1",), (betas, pos_t, sigma, y), (1, 1, 0, 1))
    cases["gram_block_tracked"] = (
        functools.partial(fused.gram_block_tracked, size=size),
        functools.partial(fused.gram_block_tracked_plain, size=size),
        ("G", "c1"), (betas, pos_t, sigma, y), (1, 1, 0, 1))
    return check_kernels(name, frames, cases)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path needs one",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    results = {}
    for name, (size, k, frames, margin) in SHAPES.items():
        results[name] = kernel_phase(dev, name, size, k, frames,
                                     margin)
        results[name].update(tracked_kernel_phase(dev, name, size, k,
                                                  frames, margin))
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

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        roi = results["roi"][kname]
        # The worst error over a kernel's variants (refine: dsigma, [K, 3]).
        err = max(r["max_abs_err"] for label, r in results["roi"].items()
                  if label.split("[")[0] == kname)
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": roi["ms"],
                        "plain_ms": roi["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
