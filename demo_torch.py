"""End-to-end demo of the PyTorch + CUDA port: simulate a video of moving
neurons, demix it, report trace recovery, and render diagnostics.

    python demo_torch.py                    # the reference demo workload
    python demo_torch.py --parity           # the reference's numerics
    python demo_torch.py --small --cpu      # a quick run on the CPU

The counterpart of ``demo.py``, with the same flags and summary keys, on
``dnmf_tpu_torch``.  ``--small`` runs a quick configuration; the default
mirrors the reference demo workload (K=10, T=100, 50x50x2, GP motion, 5
rounds x (10 motion epochs + MU iterations)).  It runs on the CUDA
device and exits with code 1 when there is none, unless ``--cpu`` asks
for the CPU.  ``--outdir`` renders figures and videos with matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--small", action="store_true",
                    help="tiny fast config (CPU-friendly smoke run)")
    ap.add_argument("--parity", action="store_true",
                    help="reference-numerics mode (pixel basis, resampled "
                         "footprints, detached regularizer, lr=1e-5)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", type=str, default=None,
                    help="directory for rendered figures/videos")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    ap.add_argument("--gram-mode", type=str, default="auto",
                    choices=["auto", "exact", "analytic"],
                    help="MU Gram computation (auto = trust-audited "
                         "closed form where valid; analytic = closed "
                         "form; exact = pixel reduction)")
    ap.add_argument("--trace-solver", type=str, default="mu",
                    choices=["mu", "fista"],
                    help="trace-subproblem solver (mu = reference "
                         "multiplicative rule; fista = accelerated "
                         "projected gradient)")
    args = ap.parse_args(argv)
    if args.small and args.parity:
        ap.error("--parity applies to the reference demo workload; "
                 "drop --small")

    import numpy as np
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("demo_torch: no CUDA device (pass --cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    device = torch.device("cpu" if args.cpu else "cuda")

    from dnmf_tpu_torch import config as C
    from dnmf_tpu_torch.data.datasets import SimulatedVideoDataset
    from dnmf_tpu_torch.engine import DeformableNMF
    from dnmf_tpu_torch.utils.metrics import r_squared, trace_correlations

    if args.small:
        sim = C.SimulatorConfig(num_neurons=5, num_frames=20,
                                size=(24, 24, 2), shape_std=2.0,
                                density=0.3, bg_snr_db=-80.0,
                                motion="gpt", gp_sigma=(1.5, 1.5, 0.01),
                                gp_length_scale=(6.0, 6.0, 6.0),
                                seed=args.seed,
                                min_separation=5.0, margin=4.0)
        model = C.ModelConfig(size=sim.size, num_neurons=sim.num_neurons,
                              num_frames=sim.num_frames,
                              shape_std=sim.shape_std)
        opt = C.OptimizerConfig(learning_rate=args.lr or 1e-3,
                                motion_epochs=10, mu_iters=30,
                                outer_rounds=args.rounds or 15,
                                gamma_motion=0.01)
    else:
        sim = dataclasses.replace(C.reference_demo_simulator(),
                                  seed=args.seed)
        model = C.reference_demo_model(parity=args.parity)
        opt = C.reference_demo_optimizer()
        if args.parity:
            # The reference's serial mini-batch Adam at its lr (tuned for
            # the pixel-basis sensitivities).
            opt = dataclasses.replace(opt, motion_mode="parity")
        else:
            # The normalized-coordinate basis is well-conditioned at
            # ordinary learning rates.
            opt = dataclasses.replace(opt, learning_rate=1e-3,
                                      outer_rounds=10, gamma_motion=0.1)
        if args.lr:
            opt = dataclasses.replace(opt, learning_rate=args.lr)
        if args.rounds:
            opt = dataclasses.replace(opt, outer_rounds=args.rounds)
    opt = dataclasses.replace(opt, trace_solver=args.trace_solver)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    print(f"simulating K={sim.num_neurons} T={sim.num_frames} "
          f"size={sim.size} motion={sim.motion}")
    t0 = time.time()
    ds = SimulatedVideoDataset(sim, device=device)
    print(f"  simulated in {time.time() - t0:.1f}s")

    eng = DeformableNMF(model, opt, positions=ds.positions[:, :, 0],
                        runtime=C.RuntimeConfig(gram_mode=args.gram_mode),
                        device=device)
    t0 = time.time()
    result = eng.fit(ds)
    elapsed = time.time() - t0

    truth = ds.traces.cpu().numpy()
    corr = trace_correlations(result.traces, truth)
    r2 = r_squared(result.traces, truth)
    last_motion = [m for m in result.metrics if m["phase"] == "motion"][-1]
    summary = {
        "seconds": round(elapsed, 2),
        "final_recon_mse": last_motion["recon_mse"],
        "trace_corr_mean": float(corr.mean()),
        "trace_corr_min": float(corr.min()),
        "trace_r2_mean": float(r2.mean()),
    }
    print(json.dumps(summary, indent=2))
    if args.outdir:
        render(args.outdir, model, ds, eng, result)
    return summary


def render(outdir, model, ds, eng, result):
    """The demo's figures and videos (matplotlib): traces, trajectories,
    the footprint map at the identity warp, and the original,
    inverse-warped and reconstructed videos."""
    import numpy as np

    from dnmf_tpu_torch import viz
    from dnmf_tpu_torch.models import dnmf as model_lib
    from dnmf_tpu_torch.ops.basis import voxel_grid
    from dnmf_tpu_torch.ops.footprints import gaussian_footprints

    os.makedirs(outdir, exist_ok=True)
    viz.visualize_temporal(ds.traces.cpu().numpy(),
                           titlestr="C (ground truth)", save=True,
                           file=os.path.join(outdir, "temporal-gt"))
    viz.visualize_temporal(result.traces, titlestr="C (estimated)",
                           save=True, file=os.path.join(outdir, "temporal"))
    est_positions = eng.positions_all().transpose(1, 2, 0)  # [K, 3, T]
    viz.visualize_trajectory(ds.positions.cpu().numpy(), est_positions,
                             save=True,
                             file=os.path.join(outdir, "trajectory"))
    grid = voxel_grid(model.size, device=eng.device)
    a0 = gaussian_footprints(grid, eng.state.pos, eng.state.sigma)
    a0 = a0.cpu().numpy().reshape(model.size + (model.num_neurons,))
    viz.visualize_spatial(a0.max(2), save=True,
                          file=os.path.join(outdir, "spatial"))

    video_mnzt = np.transpose(ds.video.cpu().numpy(), (1, 2, 3, 0))
    viz.visualize_video(video=video_mnzt / video_mnzt.max(), save=True,
                        file=os.path.join(outdir, "original.mp4"))
    a_all, y_inv = model_lib.spatial_pushforward(
        eng.state, ds.frames_flat(), model, frame_block=4)
    y_inv = np.transpose(y_inv.cpu().numpy().reshape((-1,) + model.size),
                         (1, 2, 3, 0))
    viz.visualize_video(video=y_inv / (y_inv.max() + 1e-32), save=True,
                        file=os.path.join(outdir, "registered.mp4"))
    recon = np.einsum("tpk,kt->tp", a_all.cpu().numpy(), result.traces)
    recon_mnzt = np.transpose(recon.reshape((-1,) + model.size),
                              (1, 2, 3, 0))
    viz.visualize_video(video=recon_mnzt / (recon_mnzt.max() + 1e-32),
                        save=True,
                        file=os.path.join(outdir, "reconstruction.mp4"))
    print(f"wrote figures to {outdir}")


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
