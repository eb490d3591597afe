"""Pipeline min-corr tail: solver slack against model error, on one GPU.

    python -m dnmf_tpu_torch.tools.tail_experiment [--k 200] [--t 32]
        [--size 512 512 20] [--skip-polish] ...

Counterpart of the JAX repo's ``tools/tail_experiment.py``.  The
whole-brain recovery protocol (:mod:`.wb_recovery`, 3 x (6 epochs + 50
MU)) leaves a per-neuron tail of trace correlation whose worst neurons
have close neighbours.  Two hypotheses:

  (a) solver slack: 50 MU iterations have not converged the trace
      subproblem on correlated Gram columns; an exact solve (FISTA,
      ``ops.mu.nnls_temporal``) recovers the tail with the footprints
      fixed;
  (b) model error: the warped footprints themselves are off, so even the
      exact trace solution carries crosstalk; only per-frame positions
      (``models.refine``) can help.

The protocol runs once; then the correlation statistics (``mean``,
``p10``, ``min``, ``n_below_097``) after nothing (``baseline``), extra MU
(``extra_mu``), FISTA (``fista``), FISTA at the true warps
(``oracle_gt_warp``), refinement (``refine``: per-frame positions and
tracked Grams) and refinement + FISTA (``refine_fista``), one JSON line
each as it finishes and all of them last.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.models import refine as refine_lib
from dnmf_tpu_torch.tools import bench, wb_recovery
from dnmf_tpu_torch.tools.kernel_check import host_seconds
from dnmf_tpu_torch.utils.metrics import trace_correlations


def corr_stats(c, c_gt) -> dict:
    corr = trace_correlations(c, c_gt)
    return {"mean": float(np.mean(corr)),
            "p10": float(np.percentile(corr, 10)),
            "min": float(np.min(corr)),
            "n_below_097": int(np.sum(corr < 0.97))}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=200)
    ap.add_argument("--t", type=int, default=32)
    ap.add_argument("--size", type=int, nargs=3, default=[512, 512, 20])
    ap.add_argument("--mu-extra", type=int, default=500)
    ap.add_argument("--fista", type=int, default=200)
    ap.add_argument("--refine-rounds", type=int, default=2)
    ap.add_argument("--refine-epochs", type=int, default=20)
    ap.add_argument("--refine-lr", type=float, default=0.05)
    ap.add_argument("--refine-prior", type=float, default=1e-3)
    ap.add_argument("--refine-solver", type=str, default="mu")
    ap.add_argument("--skip-polish", action="store_true",
                    help="skip the extra-MU / FISTA / oracle variants "
                         "(refine probe only)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def run(args, device="cuda", say=print) -> dict:
    """The experiment of parsed ``args`` (:func:`parser`) on ``device``;
    ``say`` gets each variant's line.  Returns every variant's stats."""
    dev = torch.device(device)
    size, k, t = tuple(args.size), args.k, args.t
    r = wb_recovery.seeded_recovery(size, k, t, rounds=3, epochs=6,
                                    mu_iters=50, frame_block=8,
                                    seed=args.seed, device=dev)
    state, video, model = r["state"], r["video"], r["model"]
    c_gt, gw = r["c_gt"], r["gram_window"]
    out = {}

    def record(name, stats, **extra):
        out[name] = {**stats, **extra}
        say(f"{name}: {json.dumps(out[name])}")

    def timed(fn):
        """``fn()`` and its seconds, after one warm-up call."""
        box = {}
        secs = host_seconds(lambda: box.update(res=fn()), 1, dev)
        return box["res"], secs[0]

    def grams(st):
        return model_lib.compute_grams(st, video, model, frame_block=8,
                                       use_kernels=True,
                                       gram_mode="analytic", gram_window=gw)

    record("baseline", corr_stats(state.c, c_gt))
    if not args.skip_polish:
        g, c1 = grams(state)
        st, s = timed(lambda: model_lib.footprint_update(
            state, g, c1, iters=args.mu_extra))
        record("extra_mu", corr_stats(st.c, c_gt), iters=args.mu_extra, s=s)
        st, s = timed(lambda: model_lib.footprint_update(
            state, g, c1, iters=args.fista, solver="fista"))
        record("fista", corr_stats(st.c, c_gt), iters=args.fista, s=s)
        # The true warps (the state starts at the true anchors) and an
        # exact trace solve: what is left is the unmixing limit of the
        # overlapping neurons at this noise.
        st_gt = state.replace(beta=r["betas_gt"])
        st = model_lib.footprint_update(st_gt, *grams(st_gt),
                                        iters=args.fista, solver="fista")
        record("oracle_gt_warp", corr_stats(st.c, c_gt))

    (st_r, pos_t, _m), s = timed(lambda: refine_lib.refined_rounds(
        state, video, model, rounds=args.refine_rounds,
        epochs=args.refine_epochs, mu_iters=50, frame_block=8,
        learning_rate=args.refine_lr, prior=args.refine_prior,
        use_kernels=True, gram_mode="analytic", gram_window=gw,
        trace_solver=args.refine_solver))
    record("refine", corr_stats(st_r.c, c_gt), rounds=args.refine_rounds,
           epochs=args.refine_epochs, lr=args.refine_lr,
           prior=args.refine_prior, solver=args.refine_solver, s=s)
    g_r, c1_r = refine_lib.tracked_grams(
        st_r, pos_t, video, model, frame_block=8, use_kernels=True,
        gram_mode="analytic", gram_window=gw)
    st, s = timed(lambda: model_lib.footprint_update(
        st_r, g_r, c1_r, iters=args.fista, solver="fista"))
    record("refine_fista", corr_stats(st.c, c_gt), iters=args.fista, s=s)
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_experiment: no CUDA device; it runs on the card only",
              file=sys.stderr, flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    info = bench.device_info()
    print(info["nvidia_smi"], flush=True)
    out = run(args, say=lambda msg: print(msg, flush=True))
    print(json.dumps({**out, "seed": args.seed, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
