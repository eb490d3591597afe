"""Save the JAX package's recovery-witness fixture for the port to fit,
or fit a fixture the port saved with the JAX package's fit half.

Makes the fixture of ``tools/wb_recovery.py``'s ``seeded_recovery`` for
one of the port's witnesses (``dnmf_tpu_torch.tools.wb_recovery.
WITNESSES``) with JAX on the CPU, from its own key splits: the
ground-truth positions, widths, traces and warps, the rendered video,
JAX's registration seed ``beta0`` and, per fitted arm, JAX's initial
state.  The port fits it on the card with::

    python tests/jax_recovery_fixture.py --witness aniso fixture.npz
    python -m dnmf_tpu_torch.tools.wb_recovery --witness aniso \\
        --fixture fixture.npz

(about 10 s and 84 MB for ``aniso``).  With ``--fit`` it goes the other
way: the JAX package's ``seeded_recovery`` fits, arm by arm, a fixture
saved by the port (``python -m dnmf_tpu_torch.tools.wb_recovery
--witness aniso --seeds 0 --save port_fixture.npz``) from the port's
registration seed and initial state, its own fixture half replaced by
the saved one, and prints a JSON line per arm::

    python tests/jax_recovery_fixture.py --witness aniso --fit \\
        port_fixture.npz

Not a test: it imports both packages, as the tests do.
"""

import argparse
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dnmf_tpu.config import ModelConfig, OptimizerConfig  # noqa: E402
from dnmf_tpu.models import dnmf as M  # noqa: E402
from dnmf_tpu.ops.basis import translation_beta  # noqa: E402
from dnmf_tpu.registration.motion_correct import (  # noqa: E402
    rigid_correct_frames,
)
from dnmf_tpu_torch.tools.wb_recovery import WITNESSES  # noqa: E402
from tools import wb_recovery as W  # noqa: E402


def jax_fixture(name: str) -> dict:
    w = WITNESSES[name]
    size, k, t = w["size"], w["k"], w["t"]
    key = jax.random.PRNGKey(0)
    k_pos, k_sim, k_init = jax.random.split(key, 3)
    pos_gt = W.interior_positions(k_pos, k, size)
    if w["sigma_aniso"]:
        k_sig = jax.random.fold_in(key, 17)
        sigma_gt = 3.0 * (1.0 + 0.25 * (
            2.0 * jax.random.uniform(k_sig, (k, 3)) - 1.0))
        sigma_gt = sigma_gt.at[:, 2].mul(0.6)
    else:
        sigma_gt = jnp.full((k,), 3.0)
    model = ModelConfig(size=size, num_neurons=k, num_frames=t,
                        shape_std=3.0)
    betas_gt, c_gt, video, _ = W.synthesize(model, pos_gt, sigma_gt, k_sim)
    template = jnp.mean(video[:8].reshape((8,) + size), axis=0)
    shifts = jnp.concatenate([
        rigid_correct_frames(video[s:s + 8].reshape((-1,) + size), template,
                             (16, 16, 3), upsample_factor=10,
                             border_nan=True)[1] for s in range(0, t, 8)])
    beta0 = translation_beta(shifts - shifts[0:1], size)
    out = {"size": np.asarray(size), "video": video, "c_gt": c_gt,
           "pos_gt": pos_gt, "betas_gt": betas_gt, "sigma_gt": sigma_gt,
           "shifts": shifts, "beta0": beta0}
    for axes in w["arms"]:
        axes = axes or (3 if w["sigma_aniso"] else 1)
        arm = ModelConfig(size=size, num_neurons=k, num_frames=t,
                          shape_std=3.0, sigma_axes=axes)
        opt = M.make_motion_optimizer(OptimizerConfig(learning_rate=1e-3))
        state = M.init_state(arm, opt, positions=pos_gt, key=k_init,
                             beta0=beta0)
        adam = state.opt_state[0]
        for field, value in (("beta", state.beta), ("c", state.c),
                             ("pos", state.pos), ("sigma", state.sigma),
                             ("count", adam.count), ("mu", adam.mu),
                             ("nu", adam.nu)):
            out[f"s{axes}_{field}"] = value
    return {name: np.asarray(value) for name, value in out.items()}


def jax_fit(name: str, path: str) -> list:
    """Every arm of witness ``name`` fitted by the JAX package's
    ``seeded_recovery`` on the fixture at ``path`` (saved by the port's
    ``wb_recovery --save``): its positions, truth and video stand in for
    JAX's draws, and its per-arm initial state (the port's registration
    seed ``beta0``, traces, positions, widths) for JAX's.  The width
    error is held against the saved truth."""
    w = WITNESSES[name]
    z = np.load(path)
    size = tuple(int(s) for s in z["size"])
    c_gt, pos_gt, betas_gt, sigma_gt = (
        jnp.asarray(z[f]) for f in ("c_gt", "pos_gt", "betas_gt",
                                    "sigma_gt"))
    k, t = c_gt.shape
    video = jnp.asarray(z["video"]).reshape(t, -1)
    aniso = sigma_gt.ndim == 2
    rows = []
    for axes in w["arms"]:
        fit_axes = axes or (3 if aniso else 1)
        start = {f: jnp.asarray(z[f"s{fit_axes}_{f}"])
                 for f in ("beta", "c", "pos", "sigma")}
        init_state = M.init_state

        def port_init(*args, **kwargs):
            return init_state(*args, **kwargs)._replace(**start)

        with mock.patch.object(W, "interior_positions",
                               lambda *a, **kw: pos_gt), \
                mock.patch.object(W, "synthesize", lambda *a, **kw: (
                    betas_gt, c_gt, video, None)), \
                mock.patch.object(M, "init_state", port_init):
            r = W.seeded_recovery(size, k, t, w["rounds"], w["epochs"],
                                  w["mu_iters"], sigma_aniso=aniso,
                                  fit_sigma_axes=axes, **w["fit"])
        sigma = r["state"].sigma
        if sigma.ndim == 1 and aniso:
            sigma = sigma[:, None]
        rows.append({
            "witness": name, "fit": "jax", "sigma_axes": fit_axes,
            "trace_corr_mean": float(np.mean(r["corr"])),
            "trace_corr_min": float(np.min(r["corr"])),
            "warp_err_px": float(r["warp_err_px"]),
            "sigma_err_px": float(jnp.mean(jnp.abs(sigma - sigma_gt))),
            "round_s_steady": r["round_s_steady"]})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--witness", choices=sorted(WITNESSES), required=True)
    ap.add_argument("--fit", action="store_true",
                    help="fit the port's fixture at npz instead of saving "
                    "JAX's there")
    ap.add_argument("npz", help="the .npz to write (or, with --fit, read)")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    if args.fit:
        for row in jax_fit(args.witness, args.npz):
            print(json.dumps({"fixture": args.npz, **row}), flush=True)
    else:
        np.savez(args.npz, **jax_fixture(args.witness))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
