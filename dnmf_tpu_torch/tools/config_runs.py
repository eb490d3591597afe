"""Measured runs of BASELINE configs 4 and 5 at one-card scale.

    python -m dnmf_tpu_torch.tools.config_runs [--config4] [--config5]
        [--frames 48] [--rounds 5] [--epochs 6] [--gram-mode analytic]
        [--fit-sigma] [--sigma-spread S] [--seed S]

Counterpart of the JAX repo's ``tools/config_runs.py`` (neither flag:
both configs; one JSON line per config, with the card):

* config 4: register -> seed -> demix (:mod:`.wb_recovery`) on a
  synthesized 512x512x20, K=500 recording, ``--rounds`` x (``--epochs``
  motion epochs + 50 MU), frame blocks of 4, with its recovery figures,
  seconds per round and the peak device memory;
* config 5: one alternation round (a motion epoch, exact Grams, 50 MU)
  of 4 recordings of 128x128x8, K=50, T=128 through
  ``parallel.batched_round`` against one recording's round, and the
  throughput ratio.  ``batched_round`` loops over the recordings (each
  has its own positions, so each kernel launch is one recording's), so
  the ratio measures that loop: near 1 where the JAX package's ``vmap``
  could batch.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.parallel.batched import batched_round, stack_states
from dnmf_tpu_torch.tools import bench, wb_recovery
from dnmf_tpu_torch.tools import kernel_check as kc

MU_ITERS = 50


def run_config4(frames: int = 48, rounds: int = 5, epochs: int = 6,
                mu_iters: int = MU_ITERS, gram_mode: str = "analytic",
                fit_sigma: bool = False, sigma_spread: float = 0.0,
                size=(512, 512, 20), k: int = 500, seed: int = 0,
                device="cuda") -> dict:
    dev = torch.device(device)
    fixture = wb_recovery.recovery_fixture(size, k, frames, seed=seed,
                                           device=dev,
                                           sigma_spread=sigma_spread)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fused.reset_launch_counts()
    r = wb_recovery.recover(fixture, rounds, epochs, mu_iters, frame_block=4,
                            gram_mode=gram_mode, fit_sigma=fit_sigma)
    corr = r["corr"]
    out = {
        "config": 4,
        "workload": f"{size[0]}x{size[1]}x{size[2]} K={k} T={frames} "
                    "(synthesized on the card)",
        "protocol": f"{rounds}x({epochs} epochs + {mu_iters} MU), "
                    f"rigid-seeded, grams={gram_mode}"
                    + (f", GT sigma spread {sigma_spread}"
                       if sigma_spread else "")
                    + (", fit_sigma" if fit_sigma
                       else (", sigma FROZEN (reference behavior)"
                             if sigma_spread else "")),
        "sigma_err_px": r["sigma_err"],
        "synth_s": fixture["synth_s"],
        "registration_seed_s": r["reg_s"],
        "trace_corr_mean": float(np.mean(corr)),
        "trace_corr_p10": float(np.percentile(corr, 10)),
        "trace_corr_min": float(np.min(corr)),
        "warp_err_px": r["warp_err_px"],
    }
    steady = bench.timed(out, "round_s_steady", r["round_s"][1:]
                         or r["round_s"])
    out["frames_per_sec_full_round"] = frames / steady
    if dev.type == "cuda":
        out["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
    out["launches"] = {n: c for n, c in
                       fused.launch_counts().items() if c}
    return out


def run_config5(recordings: int = 4, t: int = 128, size=(128, 128, 8),
                k: int = 50, reps: int = 3, seed: int = 0,
                device="cuda") -> dict:
    dev = torch.device(device)
    model = ModelConfig(size=size, num_neurons=k, num_frames=t,
                        shape_std=3.0)
    optimizer = bench.motion_optimizer()
    states, videos = [], []
    for i in range(recordings):
        fx = bench.demix_fixture(seed + i, dev, size, k, t, 10.0)
        states.append(fx["state"])
        videos.append(fx["video"])
    batched, videos_b = stack_states(states), torch.stack(videos)

    def single():
        state, _m = model_lib.motion_epoch_parallel(
            states[0], videos[0], model, optimizer, bench.GAMMA,
            frame_block=8, use_kernels=True)
        g, c1 = model_lib.compute_grams(state, videos[0], model,
                                        frame_block=8, use_kernels=True,
                                        gram_mode="exact")
        return model_lib.footprint_update(state, g, c1, iters=MU_ITERS)

    def batch():
        return batched_round(batched, videos_b, model, optimizer,
                             gamma=bench.GAMMA, mu_iters=MU_ITERS,
                             frame_block=8, use_kernels=True,
                             gram_mode="exact")

    out = {"config": 5,
           "workload": f"{recordings} recordings x {size[0]}x{size[1]}x"
                       f"{size[2]} K={k} T={t}, one alternation round "
                       "(kernels, exact Grams), batched_round's loop over "
                       "the recordings, one card"}
    fused.reset_launch_counts()
    single_s = bench.timed(out, "single_recording_round_s",
                           kc.host_seconds(single, reps, dev))
    batch_s = bench.timed(out, "batched_round_s",
                          kc.host_seconds(batch, reps, dev))
    out["throughput_vs_serial"] = recordings * single_s / batch_s
    out["frames_per_sec_batched"] = recordings * t / batch_s
    out["launches"] = {n: c for n, c in
                       fused.launch_counts().items() if c}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config4", action="store_true")
    ap.add_argument("--config5", action="store_true")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--gram-mode", type=str, default="analytic",
                    choices=["exact", "analytic"],
                    help="MU Gram computation for config 4 (analytic = "
                         "closed form, ops/gram_analytic)")
    ap.add_argument("--fit-sigma", action="store_true",
                    help="per-neuron width fitting in the alternation")
    ap.add_argument("--sigma-spread", type=float, default=0.0,
                    help="heterogeneous GT widths: shape_std * "
                         "U(1-s, 1+s)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (args.config4 or args.config5):
        args.config4 = args.config5 = True
    if not torch.cuda.is_available():
        print("config_runs: no CUDA device; it runs on the card only",
              file=sys.stderr, flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    info = bench.device_info()
    if args.config5:
        out = run_config5(seed=args.seed)
        print(json.dumps({**out, "seed": args.seed, "device": info}),
              flush=True)
    if args.config4:
        out = run_config4(frames=args.frames, rounds=args.rounds,
                          epochs=args.epochs, gram_mode=args.gram_mode,
                          fit_sigma=args.fit_sigma,
                          sigma_spread=args.sigma_spread, seed=args.seed)
        print(json.dumps({**out, "seed": args.seed, "device": info}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
