"""Drive the PyTorch + CUDA port's main path once on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA device is required (there is no CPU path);
2. card: name and power limit from nvidia-smi;
3. build: nvcc builds the kernels of ``dnmf_tpu_torch/csrc`` into
   ``dnmf_tpu_torch/_build/``;
4. kernels: the motion, c1 and Gram kernels against their plain PyTorch
   versions in float32 and against the plain versions in float64 (the
   oracle) at the ROI shape (256x256x10, K=50, 8 frames) and the
   whole-brain shape (512x512x20, K=200, 2 frames; the float64 oracle
   one frame at a time), with times (median of 5 after a warm-up);
5. main path: ``DeformableNMF.fit`` on a seeded synthetic ground-truth
   video at the ROI shapes with T=256 (2 rounds, gram_mode="auto", so the
   closed-form Grams, the c1 pass and the exact-Gram audit all run; then
   one round with gram_mode="exact"), with the kernels and again with
   ``use_kernels=False``; the launch counters must show every kernel ran,
   and the two fits must agree.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.ops import _build, basis, footprints, fused

SEED = 0
KERNEL_TOL = 1e-4  # max|kernel - float64| / max|float64|
FIT_MSE_TOL = 1e-3  # kernel vs plain fit, relative, per phase metric
FIT_CORR_MIN = 0.999  # kernel vs plain fit, per-neuron trace correlation
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


def kernel_phase(dev, name, size, k, frames, margin):
    """Each kernel against plain float32 and the float64 oracle; returns
    {kernel: {"max_abs_err", "ms", "plain_ms"}}."""
    betas, pos, sigma, c, y = kernel_inputs(dev, size, k, frames,
                                            margin, SEED)
    calls = {
        "motion_block": (("mse", "dbeta"),
                         lambda f, b, p, s, cc, yy: f(b, p, s, cc, yy, size)),
        "c1_block": (("c1",), lambda f, b, p, s, cc, yy: (f(b, p, s, yy, size),)),
        "gram_block": (("G", "c1"),
                       lambda f, b, p, s, cc, yy: f(b, p, s, yy, size)),
    }
    out = {}
    for kname, (labels, call) in calls.items():
        kern = getattr(fused, kname)
        plain = getattr(fused, kname + "_plain")
        got = call(kern, betas, pos, sigma, c, y)
        p32 = call(plain, betas, pos, sigma, c, y)
        oracle = [[] for _ in labels]
        for b in range(frames):  # one frame at a time: [P, K] float64
            args = (betas[b:b + 1], pos, sigma, c[b:b + 1], y[b:b + 1])
            for i, o in enumerate(call(plain, *(a.double() for a in args))):
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
        ms = time_ms(lambda: call(kern, betas, pos, sigma, c, y))
        plain_ms = time_ms(lambda: call(plain, betas, pos, sigma, c, y))
        say(f"time {kname} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms ({frames} frames)")
        out[kname] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}
    return out


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
    for kname, n in launches.items():
        if n <= 0:
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
    roi, _ = tcfg.baseline_workload("roi")
    model = tcfg.ModelConfig(size=roi.size, num_neurons=roi.num_neurons,
                             num_frames=MAIN_FRAMES, shape_std=roi.shape_std)
    launches = main_path(dev, model)

    kernels = []
    for kname, (source, replaces) in SOURCES.items():
        roi = results["roi"][kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": roi["max_abs_err"], "ms": roi["ms"],
                        "plain_ms": roi["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
