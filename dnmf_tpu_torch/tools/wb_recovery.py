"""End-to-end recovery harness of the PyTorch port.

Counterpart of ``tools/wb_recovery.py`` (``synthesize``,
``interior_positions``, ``warp_error_px``, ``seeded_recovery``) with the
same protocol and constants.  A recording is synthesized on the
fixture's device from known factors: smooth quadratic warps (a random
walk on the normalized-basis coefficients), exponential-kernel traces and
analytic Gaussian neurons, rendered in voxel chunks, plus noise at
``noise_rel`` of each frame block's RMS.  It is then registered (rigid
FFT shifts on 8-frame blocks, a translation seed per frame), fitted from
the ground-truth positions, and scored: trace correlation with the truth,
warp error in pixels and, with width fitting, width error in pixels.

:func:`seeded_recovery` is :func:`recovery_fixture` followed by
:func:`recover`, so that a fixture made elsewhere (the JAX package's, in
the tests) can be fitted here.  On the card the motion, c1 and refine
passes run the CUDA kernels; ``use_kernels=False`` runs the plain
versions.

The round-5 recovery witnesses (:data:`WITNESSES`) run from the command
line, on fixtures of this harness or on one saved by the JAX package
(``tests/jax_recovery_fixture.py``), one JSON line per fitted arm::

    python -m dnmf_tpu_torch.tools.wb_recovery --witness aniso --seeds 0 1
    python -m dnmf_tpu_torch.tools.wb_recovery --witness aniso \
        --fixture fixture.npz
    python -m dnmf_tpu_torch.tools.wb_recovery --witness aniso --seeds 0 \
        --save port_fixture.npz

``--save`` keeps a port fixture, with the port's registration seed and
initial states, for the JAX package to fit (``tests/
jax_recovery_fixture.py fit``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from dnmf_tpu_torch.config import ModelConfig, OptimizerConfig
from dnmf_tpu_torch.data.simulator import _normal, _uniform, exponential_traces
from dnmf_tpu_torch.models import dnmf as model_lib
from dnmf_tpu_torch.ops import basis as basis_ops
from dnmf_tpu_torch.ops import gram_analytic as ga
from dnmf_tpu_torch.registration.motion_correct import rigid_correct_frames
from dnmf_tpu_torch.utils.metrics import trace_correlations

TRACE_DENSITY = 0.1
BETA_STEP = 0.002  # std of the per-frame steps of the warp coefficients
QUADRATIC_STEP = 0.25  # ... times this on the quadratic rows
NOISE_REL = 0.1  # noise std over each frame block's signal RMS
MARGIN = 20.0  # px, interior margin of the ground-truth positions
VOXEL_CHUNK = 1 << 16  # voxels per rendered [chunk, K] slab
REG_BLOCK = 8  # frames per registration call; the template's frames
REG_MAX_SHIFTS = (16, 16, 3)
REG_UPSAMPLE = 10
LEARNING_RATE = 1e-3
GAMMA = 0.1  # Jacobian regularizer weight of the motion epochs
SIGMA_LR = 0.05
SIGMA_SPREAD = 0.25  # per-axis truth: shape_std * U(1 -/+ spread), z x 0.6
# The round-5 witnesses (bench.py's pipeline and anisotropic runs):
# fixture shape, schedule, the fit's options and the arms' sigma_axes
# (None: as the truth).
WITNESSES = {
    "pipeline": dict(size=(512, 512, 20), k=200, t=32, rounds=6, epochs=12,
                     mu_iters=50, sigma_aniso=False, arms=(None,),
                     fit=dict(frame_block=8)),
    "aniso": dict(size=(256, 256, 10), k=100, t=32, rounds=6, epochs=8,
                  mu_iters=50, sigma_aniso=True, arms=(3, 1),
                  # The ceiling width-fit cadence: every round, 4 steps x
                  # 16 frames.
                  fit=dict(frame_block=8, fit_sigma=True, sigma_every=1,
                           sigma_steps=4, sigma_frames=16)),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _interior_from_uniform(u: torch.Tensor, size, margin: float = MARGIN
                           ) -> torch.Tensor:
    size_f = torch.tensor(size, dtype=torch.float32, device=u.device)
    m = torch.minimum(torch.full((3,), float(margin), device=u.device),
                      0.25 * (size_f - 1.0))
    return m + u * (size_f - 1.0 - 2.0 * m)


def interior_positions(generator: torch.Generator, k: int, size,
                       margin: float = MARGIN, device="cuda") -> torch.Tensor:
    """Ground-truth positions ``[K, 3]`` uniform over a per-axis interior
    window; the margin is capped at a quarter of each axis, so that thin
    axes stay inside the volume."""
    return _interior_from_uniform(_uniform(generator, (k, 3), device), size,
                                  margin)


def _ground_truth_motion(steps: torch.Tensor, pos_gt: torch.Tensor,
                         jsteps: Optional[torch.Tensor], jitter_px: float):
    """Warps ``[T, 10, 3]`` from unit normals ``steps [T, 10, 3]`` (a
    random walk from the identity) and per-frame centers ``[T, K, 3]``
    (with ``jsteps [T, K, 3]``, a random walk of ~``jitter_px`` RMS over
    T around the anchors, z scaled by 0.25)."""
    t = steps.shape[0]
    steps = steps * BETA_STEP
    steps[:, 4:, :] *= QUADRATIC_STEP
    steps[0] = 0.0
    betas = (basis_ops.identity_beta(t, device=steps.device)
             + torch.cumsum(steps, dim=0))
    if jsteps is None:
        return betas, pos_gt[None].expand((t,) + tuple(pos_gt.shape))
    jsteps = jsteps * (jitter_px / float(np.sqrt(t)))
    jsteps[:, :, 2] *= 0.25
    jsteps[0] = 0.0
    return betas, pos_gt[None] + torch.cumsum(jsteps, dim=0)


def render_recording(model: ModelConfig, betas: torch.Tensor,
                     c: torch.Tensor, pos_t: torch.Tensor,
                     sigma: torch.Tensor, draw_noise: Callable,
                     noise_rel: float = NOISE_REL,
                     frame_block: int = 8) -> torch.Tensor:
    """The model's own reconstruction ``[T, P]`` of ``betas [T, 10, 3]``,
    ``c [K, T]``, per-frame centers ``pos_t [T, K, 3]`` and widths, in
    voxel chunks of ``VOXEL_CHUNK``; per frame block, noise
    ``draw_noise(shape)`` (unit normals) times ``noise_rel`` of the
    block's RMS, then clamped at zero."""
    vb = model_lib.model_voxel_basis(model, device=betas.device)
    t, p = betas.shape[0], vb.shape[0]
    video = torch.empty((t, p), dtype=torch.float32, device=betas.device)
    for s in range(0, t, frame_block):
        e = min(s + frame_block, t)
        recon = video[s:e]
        for i in range(s, e):
            for q in range(0, p, VOXEL_CHUNK):
                r = min(q + VOXEL_CHUNK, p)
                a = model_lib.frame_footprints(betas[i], pos_t[i], sigma,
                                               model, vb[q:r])
                recon[i - s, q:r] = a @ c[:, i]
        sig = torch.sqrt(torch.mean(recon ** 2))
        noise = draw_noise(tuple(recon.shape)) * (noise_rel * sig)
        video[s:e] = torch.clamp_min(recon + noise, 0.0)
    return video


def synthesize(model: ModelConfig, pos_gt: torch.Tensor,
               sigma_gt: torch.Tensor, generator: torch.Generator,
               noise_rel: float = NOISE_REL, frame_block: int = 8,
               jitter_px: float = 0.0):
    """Ground-truth factors and the rendered video ``[T, P]`` on the
    device of ``pos_gt``.  Draws the traces, the warp steps, the jitter
    steps (with ``jitter_px > 0``) and the noise, in that order.

    Returns ``(betas_gt, c_gt, video, pos_t_gt)``."""
    dev = pos_gt.device
    t, k = model.num_frames, model.num_neurons
    c_gt = exponential_traces(generator, k, t, density=TRACE_DENSITY,
                              device=dev)
    steps = _normal(generator, (t, 10, 3), dev)
    jsteps = _normal(generator, (t, k, 3), dev) if jitter_px > 0.0 else None
    betas_gt, pos_t_gt = _ground_truth_motion(steps, pos_gt, jsteps,
                                              jitter_px)
    video = render_recording(model, betas_gt, c_gt, pos_t_gt, sigma_gt,
                             lambda shape: _normal(generator, shape, dev),
                             noise_rel, frame_block)
    return betas_gt, c_gt, video, pos_t_gt


def warp_error_px(beta_a: torch.Tensor, beta_b: torch.Tensor,
                  pos: torch.Tensor, model: ModelConfig) -> float:
    """Mean ``|warp_a(p) - warp_b(p)|`` over neurons x frames, in pixels."""
    normalized = model.deformation.basis_scaling == "normalized"
    pts = basis_ops.normalize_points(pos, model.size) if normalized else pos
    phi = basis_ops.quadratic_basis_points(pts)  # [K, 10]
    pa = torch.einsum("kb,tbd->tkd", phi, beta_a)
    pb = torch.einsum("kb,tbd->tkd", phi, beta_b)
    if normalized:
        scale = torch.tensor([max(float(s) - 1.0, 1.0) / 2.0
                              for s in model.size], device=pos.device)
        pa, pb = (pa + 1.0) * scale, (pb + 1.0) * scale
    return float(torch.mean(torch.linalg.norm(pa - pb, dim=-1)))


def recovery_fixture(size, k: int, t: int, sigma_aniso: bool = False,
                     seed: int = 0, device="cuda",
                     sigma_spread: float = 0.0) -> dict:
    """The ground-truth recording of :func:`seeded_recovery`, drawn from
    ``torch.Generator(device).manual_seed(seed)``: interior positions,
    widths (``shape_std`` 3; per axis with ``sigma_aniso``,
    ``shape_std * U(1 - SIGMA_SPREAD, 1 + SIGMA_SPREAD)`` and z times
    0.6; else, with ``sigma_spread > 0``, one width per neuron, ``shape_std
    * U(1 - sigma_spread, 1 + sigma_spread)``), then :func:`synthesize`."""
    size = tuple(int(s) for s in size)
    gen = torch.Generator(torch.device(device)).manual_seed(seed)
    shape_std = 3.0
    pos_gt = interior_positions(gen, k, size, device=device)
    if sigma_aniso:
        sigma_gt = shape_std * (1.0 + SIGMA_SPREAD * (
            2.0 * _uniform(gen, (k, 3), device) - 1.0))
        sigma_gt[:, 2] *= 0.6  # z-flattened cells
    elif sigma_spread > 0.0:
        sigma_gt = shape_std * (1.0 + sigma_spread * (
            2.0 * _uniform(gen, (k,), device) - 1.0))
    else:
        sigma_gt = torch.full((k,), shape_std, device=device)
    model = ModelConfig(size=size, num_neurons=k, num_frames=t,
                        shape_std=shape_std)
    t0 = time.perf_counter()
    betas_gt, c_gt, video, _ = synthesize(model, pos_gt, sigma_gt, gen)
    _sync(device)
    return {"size": size, "video": video, "c_gt": c_gt, "pos_gt": pos_gt,
            "betas_gt": betas_gt, "sigma_gt": sigma_gt,
            "sigma_aniso": sigma_aniso, "seed": seed,
            "synth_s": time.perf_counter() - t0}


def registration_seed(video: torch.Tensor, size,
                      scaling: str = "normalized"):
    """Rigid FFT shifts of 8-frame blocks against the mean of the first 8
    frames, and the per-frame translation warps of the shifts relative to
    frame 0.  Returns ``(shifts [T, 3], beta0 [T, 10, 3])``."""
    t = video.shape[0]
    template = torch.mean(video[:REG_BLOCK].reshape((-1,) + tuple(size)),
                          dim=0)
    shifts = torch.cat([
        rigid_correct_frames(
            video[s:min(s + REG_BLOCK, t)].reshape((-1,) + tuple(size)),
            template, REG_MAX_SHIFTS, upsample_factor=REG_UPSAMPLE,
            border_nan=True)[1]
        for s in range(0, t, REG_BLOCK)])
    beta0 = basis_ops.translation_beta(shifts - shifts[0:1], size,
                                       scaling=scaling)
    return shifts, beta0


def arm_model(fixture: dict, fit_sigma_axes: Optional[int] = None
              ) -> ModelConfig:
    """The fitted model of a fixture: per-axis widths on per-axis truth
    unless ``fit_sigma_axes`` says otherwise."""
    k, t = fixture["c_gt"].shape
    axes = fit_sigma_axes if fit_sigma_axes is not None else (
        3 if fixture["sigma_aniso"] else 1)
    return ModelConfig(size=tuple(fixture["size"]), num_neurons=k,
                       num_frames=t, shape_std=3.0, sigma_axes=axes)


def initial_state(fixture: dict, model: ModelConfig,
                  beta0: torch.Tensor) -> model_lib.DNMFState:
    """The fit's start: the ground-truth positions, warps ``beta0`` and
    random traces from a CPU generator seeded with the fixture's seed."""
    return model_lib.init_state(
        model, positions=fixture["pos_gt"],
        generator=torch.Generator().manual_seed(fixture["seed"]),
        device=fixture["video"].device, beta0=beta0)


def recover(fixture: dict, rounds: int, epochs: int, mu_iters: int,
            frame_block: int = 8, fit_sigma: bool = False,
            fit_sigma_axes: Optional[int] = None, sigma_every: int = 2,
            sigma_steps: int = 2, sigma_frames: int = 8,
            use_kernels: Optional[bool] = None,
            beta0: Optional[torch.Tensor] = None,
            state: Optional[model_lib.DNMFState] = None,
            gram_mode: str = "analytic") -> dict:
    """The fit half of :func:`seeded_recovery` on a fixture (the dict of
    :func:`recovery_fixture`: ``size``, ``video [T, P]``, ``c_gt``,
    ``pos_gt``, ``betas_gt``, ``sigma_gt``, ``sigma_aniso``, ``seed``).

    Registration seeds the warps (:func:`registration_seed`; ``beta0``
    replaces it), the state starts from :func:`initial_state` (``state``
    replaces it), then ``rounds`` x (``epochs`` motion epochs, with
    ``fit_sigma`` a width fit every ``sigma_every``-th round, the Grams
    of ``gram_mode`` and ``mu_iters`` MU iterations).  ``use_kernels``
    defaults to whether the video is on the card.

    Returns ``reg_s``, ``corr`` (per neuron), ``warp_err_px``,
    ``round_s_steady`` (median of the rounds after the first), ``round_s``
    (every round's seconds),
    ``sigma_err`` (mean ``|sigma - sigma_gt|``, px; an isotropic fit on
    per-axis truth is held against every axis), ``shifts`` (None when
    ``beta0`` is given), ``state``, ``model`` and ``gram_window``.
    """
    video, size = fixture["video"], tuple(fixture["size"])
    dev = video.device
    c_gt, pos_gt, sigma_gt = (fixture["c_gt"], fixture["pos_gt"],
                              fixture["sigma_gt"])
    t = c_gt.shape[1]
    model = arm_model(fixture, fit_sigma_axes)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"

    shifts, reg_s = None, 0.0
    if beta0 is None:
        t0 = time.perf_counter()
        shifts, beta0 = registration_seed(
            video, size, model.deformation.basis_scaling)
        _sync(dev)
        reg_s = time.perf_counter() - t0
    optimizer = model_lib.make_motion_optimizer(
        OptimizerConfig(learning_rate=LEARNING_RATE))
    if state is None:
        state = initial_state(fixture, model, beta0)
    # Per-axis truth flattens z to ~0.45 shape_std: keep the lower clip
    # bound under the smallest drawn width.
    sig_lo = (0.3 if fixture["sigma_aniso"] else 0.5) * model.shape_std
    sig_hi = 1.6 * model.shape_std
    gram_window = ga.default_window(sig_hi) if fit_sigma else None
    sig_idx = torch.as_tensor(np.linspace(0, t - 1, min(sigma_frames, t))
                              .round().astype(int), device=dev)
    round_times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        for _ in range(epochs):
            state, _m = model_lib.motion_epoch_parallel(
                state, video, model, optimizer, GAMMA,
                frame_block=frame_block, use_kernels=use_kernels)
        if fit_sigma and r % sigma_every == 0:
            sigma, _ = model_lib.sigma_fit(
                state, video[sig_idx], state.beta[sig_idx],
                state.c[:, sig_idx].T, model, steps=sigma_steps,
                lr=SIGMA_LR, lo=sig_lo, hi=sig_hi, frame_block=frame_block,
                use_kernels=use_kernels)
            state = state.replace(sigma=sigma)
        grams, c1 = model_lib.compute_grams(
            state, video, model, frame_block=frame_block,
            use_kernels=use_kernels, gram_mode=gram_mode,
            gram_window=gram_window)
        state = model_lib.footprint_update(state, grams, c1, iters=mu_iters)
        _sync(dev)
        round_times.append(time.perf_counter() - t0)
    later = sorted(round_times[1:])
    steady = later[len(later) // 2] if later else round_times[0]
    sigma = state.sigma
    if sigma.ndim == 1 and sigma_gt.ndim == 2:
        sigma = sigma[:, None]
    return {
        "reg_s": reg_s,
        "corr": trace_correlations(state.c, c_gt),
        "warp_err_px": warp_error_px(state.beta, fixture["betas_gt"],
                                     pos_gt, model),
        "round_s_steady": steady,
        "round_s": round_times,
        "sigma_err": float(torch.mean(torch.abs(sigma - sigma_gt))),
        "shifts": shifts,
        "state": state,
        "model": model,
        "gram_window": gram_window,
    }


def seeded_recovery(size, k: int, t: int, rounds: int, epochs: int,
                    mu_iters: int, frame_block: int = 8,
                    fit_sigma: bool = False, sigma_aniso: bool = False,
                    fit_sigma_axes: Optional[int] = None,
                    sigma_every: int = 2, sigma_steps: int = 2,
                    sigma_frames: int = 8, seed: int = 0, device="cuda",
                    use_kernels: Optional[bool] = None) -> dict:
    """Register -> seed -> demix recovery on a synthesized recording:
    :func:`recovery_fixture`, then :func:`recover`.  Returns the fields
    of both (``synth_s`` included)."""
    fixture = recovery_fixture(size, k, t, sigma_aniso=sigma_aniso,
                               seed=seed, device=device)
    out = recover(fixture, rounds, epochs, mu_iters, frame_block=frame_block,
                  fit_sigma=fit_sigma, fit_sigma_axes=fit_sigma_axes,
                  sigma_every=sigma_every, sigma_steps=sigma_steps,
                  sigma_frames=sigma_frames, use_kernels=use_kernels)
    return {**fixture, **out}


def closest_pair(pos: torch.Tensor) -> float:
    """The smallest distance between two planted neurons, px."""
    d = torch.linalg.norm(pos[:, None] - pos[None], dim=-1)
    return float(d[~torch.eye(pos.shape[0], dtype=torch.bool,
                               device=pos.device)].min())


def load_fixture(path: str, device="cuda") -> dict:
    """A fixture saved as ``.npz``: ``size``, ``video [T, P]``, ``c_gt``,
    ``pos_gt``, ``betas_gt``, ``sigma_gt``, and optionally the
    registration seed (``shifts``, ``beta0``) and initial states
    ``s{sigma_axes}_{field}`` (:data:`dnmf_tpu_torch.models.dnmf.
    STATE_FIELDS`) to fit from."""
    z = np.load(path)
    fixture = {name: torch.as_tensor(z[name], device=device)
               for name in ("video", "c_gt", "pos_gt", "betas_gt",
                            "sigma_gt")}
    fixture.update(size=tuple(int(s) for s in z["size"]),
                   sigma_aniso=fixture["sigma_gt"].ndim == 2, seed=0)
    fixture["video"] = fixture["video"].reshape(
        fixture["video"].shape[0], -1)
    for name in ("shifts", "beta0"):
        fixture[name] = (torch.as_tensor(z[name], device=device)
                         if name in z else None)
    fixture["states"] = {
        axes: model_lib.state_from_numpy(
            {f: z[f"s{axes}_{f}"] for f in model_lib.STATE_FIELDS},
            device=device)
        for axes in (1, 3) if f"s{axes}_beta" in z}
    return fixture


def save_fixture(path: str, name: str, fixture: dict) -> None:
    """Save ``fixture`` for :func:`load_fixture`, with the port's
    registration seed and the initial state of every arm of witness
    ``name`` (compressed: about half the voxels are clamped zeros)."""
    shifts, beta0 = registration_seed(fixture["video"],
                                      tuple(fixture["size"]))
    out = {name_: fixture[name_] for name_ in
           ("video", "c_gt", "pos_gt", "betas_gt", "sigma_gt")}
    out.update(size=torch.tensor(fixture["size"]), shifts=shifts,
               beta0=beta0)
    for axes in WITNESSES[name]["arms"]:
        model = arm_model(fixture, axes)
        state = model_lib.state_to_numpy(
            initial_state(fixture, model, beta0))
        out.update({f"s{model.sigma_axes}_{f}": v for f, v in state.items()})
    np.savez_compressed(path, **{
        k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        for k, v in out.items()})


def run_witness(name: str, fixture: dict, use_kernels=None) -> list:
    """Every arm of witness ``name`` on ``fixture``: a row of recovery
    figures per arm, from the fixture's registration seed and initial
    states where it has them."""
    w = WITNESSES[name]
    rows = []
    for axes in w["arms"]:
        fit_axes = arm_model(fixture, axes).sigma_axes
        r = recover(fixture, w["rounds"], w["epochs"], w["mu_iters"],
                    fit_sigma_axes=axes, use_kernels=use_kernels,
                    beta0=fixture.get("beta0"),
                    state=fixture.get("states", {}).get(fit_axes),
                    **w["fit"])
        rows.append({
            "witness": name, "sigma_axes": fit_axes,
            "trace_corr_mean": float(np.mean(r["corr"])),
            "trace_corr_min": float(np.min(r["corr"])),
            "warp_err_px": r["warp_err_px"], "sigma_err_px": r["sigma_err"],
            "closest_pair_px": closest_pair(fixture["pos_gt"]),
            "round_s_steady": r["round_s_steady"], "reg_s": r["reg_s"]})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--witness", choices=sorted(WITNESSES), required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0],
                    help="fixtures of this harness, one per seed")
    ap.add_argument("--fixture", help=".npz fixture (replaces --seeds); "
                    "with saved shifts, the port's are held against them")
    ap.add_argument("--save", help="with one seed: save its fixture, the "
                    "port's registration seed and initial states to this "
                    ".npz, then fit from them")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.save and (args.fixture or len(args.seeds) != 1):
        ap.error("--save takes one seed")
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for the "
                             "plain versions on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    w = WITNESSES[args.witness]
    if args.fixture:
        fixtures = [(args.fixture, load_fixture(args.fixture, args.device))]
    else:
        fixtures = [(f"seed {seed}", recovery_fixture(
            w["size"], w["k"], w["t"], sigma_aniso=w["sigma_aniso"],
            seed=seed, device=args.device)) for seed in args.seeds]
    if args.save:
        save_fixture(args.save, args.witness, fixtures[0][1])
        fixtures = [(args.save, load_fixture(args.save, args.device))]
    for label, fixture in fixtures:
        if fixture.get("shifts") is not None:
            shifts, _ = registration_seed(fixture["video"],
                                          tuple(fixture["size"]))
            diff = float(torch.max(torch.abs(shifts - fixture["shifts"])))
            print(json.dumps({"fixture": label, "shifts_max_diff_px": diff}),
                  flush=True)
        for row in run_witness(args.witness, fixture):
            print(json.dumps({"fixture": label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
