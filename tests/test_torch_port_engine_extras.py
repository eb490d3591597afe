"""The rest of the port's engine against ``dnmf_tpu`` on the same NumPy
inputs: checkpoint/resume, the profiler trace, ``fit_fused``,
``positions_at``, ``spatial_pushforward``, ``StaticFootprintNMF`` with
``mu_spatial_step`` and ``distance_penalty``, the footprint helpers in
both formulations, refinement of unfaded footprints,
``high_snr_registration`` and the package exports.

Tolerances are the JAX tests' own where they exist, stated at each test
(``tests/test_engine.py``, ``tests/test_mu.py``,
``tests/test_footprints.py``); elsewhere 1e-5 of the reference's max
magnitude for one step and 1e-4 for whole fits, as in
``tests/test_torch_port_model.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dnmf_tpu
import dnmf_tpu.engine
import dnmf_tpu.models
import dnmf_tpu.ops
import dnmf_tpu_torch
import dnmf_tpu_torch.engine
import dnmf_tpu_torch.models
import dnmf_tpu_torch.ops
from dnmf_tpu import config as jcfg
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.models import refine as jRf
from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import footprints as jF
from dnmf_tpu.ops import mu as jMu
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data.streaming import StreamingVideo
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import refine as tRf
from dnmf_tpu_torch.ops import footprints as tF
from dnmf_tpu_torch.ops import mu as tMu

SIZE = (16, 12, 4)
K, T, FB = 6, 7, 3  # the last frame block is short


def close(got, ref, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _fixture(rng):
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 4.0)
    c = rng.uniform(0.2, 1.0, (K, T))
    video = ((a @ c).T + rng.uniform(0, 0.2, (T, grid.shape[0])))
    return pos, video.astype(np.float32)


def _opt(**kw):
    base = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=2,
                mu_iters=20, gamma_motion=0.1)
    base.update(kw)
    return base


def _engines(rng, deform=None, opt=None, **runtime):
    """A JAX engine and a port engine (CPU) from the same NumPy state:
    JAX's initial traces, handed over, and perturbed warps."""
    deform = deform or {}
    kw = dict(size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0)
    jm = jcfg.ModelConfig(deformation=jcfg.DeformationConfig(**deform), **kw)
    tm = tcfg.ModelConfig(deformation=tcfg.DeformationConfig(**deform), **kw)
    pos, video = _fixture(rng)
    okw = _opt(**(opt or {}))
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=FB,
                                              use_pallas=False),
                           positions=jnp.asarray(pos))
    beta = np.asarray(jt.state.beta) + 0.01 * rng.normal(
        size=(T, 10, 3)).astype(np.float32)
    jt.state = jt.state._replace(beta=jnp.asarray(beta))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=FB, **runtime),
                           positions=pos, device="cpu")
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    tt._base_sigma = tt.state.sigma
    return jt, tt, video


def _port_engine(rng, deform=None, opt=None, **runtime):
    return _engines(rng, deform, opt, **runtime)[1:]


def _states_equal(a, b):
    for name in tM.STATE_FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ------------------------------------------------------ checkpoint/resume
@pytest.mark.parametrize("mode", ["parallel", "parity"])
def test_resumed_fit_equals_the_unbroken_one(rng, tmp_path, mode):
    """fit(3 rounds) with checkpoint_dir, against a fresh engine that
    restores round 0 and fits the remaining 2: bit for bit, the Adam
    moments and count included (parity mode: the batch generator's state
    travels in the checkpoint)."""
    opt = dict(motion_mode=mode, outer_rounds=3)
    ckpt = tmp_path / "ckpt"
    tt, video = _port_engine(rng, opt=opt, checkpoint_dir=str(ckpt))
    state0 = dataclasses.replace(tt.state)
    unbroken = tt.fit(video).state
    assert sorted(os.listdir(ckpt)) == ["round_0.pt", "round_1.pt",
                                        "round_2.pt"]
    fresh = ttr.DeformableNMF(tt.model, tt.opt_config,
                              tcfg.RuntimeConfig(frame_block=FB),
                              device="cpu")
    fresh.restore(str(ckpt / "round_0.pt"))
    resumed = fresh.fit(video, rounds=2).state
    _states_equal(resumed, unbroken)
    assert int(resumed.count) == (6 * 2 if mode == "parity" else 6)


def test_checkpoint_round_trip_and_pos_t(rng, tmp_path):
    tt, video = _port_engine(rng)
    tt.fit(video, rounds=1)
    path = str(tmp_path / "a.pt")
    tt.save(path)
    other, _ = _port_engine(np.random.default_rng(5))
    other.restore(path)
    _states_equal(other.state, tt.state)
    assert other.state.count.dtype == torch.int32
    assert torch.equal(other._base_sigma, tt._base_sigma)
    # With refined positions: they travel with the state.
    tt.refine(video, rounds=1, epochs=2, mu_iters=2)
    with_pos = str(tmp_path / "b.pt")
    tt.save(with_pos)
    other.restore(with_pos)
    assert torch.equal(other.pos_t, tt.pos_t)
    # A checkpoint without them clears positions refined before the restore,
    # as the JAX package does: they belong to the replaced factors.
    other.restore(path)
    assert other.pos_t is None
    # Only tensors are stored: weights_only loading takes the file.
    payload = torch.load(path, weights_only=True)
    assert set(tM.STATE_FIELDS) <= set(payload)


def test_restore_lands_on_the_requested_device(rng, tmp_path):
    """The checkpoint holds host tensors; loading maps every one to the
    device asked for (the engine passes its own; saved on the card and
    restored on the CPU and back: tests/test_torch_port_cuda.py)."""
    from dnmf_tpu_torch.utils import checkpoint

    tt, _ = _port_engine(rng)
    path = str(tmp_path / "c.pt")
    tt.save(path)
    state, extra = checkpoint.load_state(path, "meta")
    assert all(getattr(state, n).device.type == "meta"
               for n in tM.STATE_FIELDS)
    assert {v.device.type for v in extra.values()} == {"meta"}
    assert set(extra) == {"base_sigma", "batch_rng"}


# ------------------------------------------------------------- profiling
@pytest.mark.parametrize("use_kernels", [None, True])
def test_profile_dir_writes_a_trace_of_the_last_round(rng, tmp_path,
                                                      use_kernels):
    """The last round's trace, its steps named by the port's spans: the
    round on either route, each graph replay on the cache's
    (``use_kernels``; the default on the CPU runs the plain steps)."""
    prof = tmp_path / "prof"
    tt, video = _port_engine(rng, profile_dir=str(prof),
                             use_kernels=use_kernels)
    tt.fit(video, rounds=2)
    assert os.listdir(prof) == ["round_1.trace.json"]
    trace = json.loads((prof / "round_1.trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n or "bmm" in n for n in names), sorted(names)[:20]
    assert "span.engine.round" in names
    assert ("span.graphs.replay" in names) == bool(use_kernels)


# ------------------------------------------------------------- fit_fused
def test_fit_fused_matches_jax_and_fit(rng):
    """Against JAX's fit_fused (1e-4, whole fits) with an anneal
    segment, and against the port's own fit: bit for bit, since both run
    the same epochs, Grams and trace updates."""
    opt = dict(sigma_anneal=(1.3,), outer_rounds=3)
    jt, tt, video = _engines(rng, opt=opt)
    state0 = dataclasses.replace(tt.state)
    jres = jt.fit_fused(video)
    tres = tt.fit_fused(video)
    close(tres.traces, jres.traces, 1e-4)
    close(tres.beta, jres.beta, 1e-4)
    audits = [m for m in tres.metrics if m["phase"] == "gram_audit"]
    assert len(audits) == 2  # before (the mode) and after (a witness)
    rounds = [m for m in tres.metrics if m["phase"] == "round"]
    j_rounds = [m for m in jres.metrics if m["phase"] == "round"]
    for a, b in zip(rounds, j_rounds):
        close(np.float64(a["motion_recon_mse"]),
              np.float64(b["motion_recon_mse"]), 1e-4)
    assert torch.equal(tres.state.sigma, torch.full((K,), 2.0))
    _, plain, _ = _engines(np.random.default_rng(0), opt=opt)
    plain.state = state0
    plain._base_sigma = state0.sigma
    fres = plain.fit(video)
    _states_equal(tres.state, fres.state)


@pytest.mark.parametrize("what", ["parity", "fit_sigma", "streamed"])
def test_fit_fused_guards(rng, what):
    opt = {"parity": dict(motion_mode="parity"),
           "fit_sigma": dict(fit_sigma=True)}.get(what, {})
    tt, video = _port_engine(rng, opt=opt)
    source = (StreamingVideo(video, block=4, device="cpu")
              if what == "streamed" else video)
    match = {"parity": "motion_mode='parallel'", "fit_sigma": "fit_sigma",
             "streamed": "streamed"}[what]
    with pytest.raises(ValueError, match=match):
        tt.fit_fused(source)


# -------------------------------------------------- positions, pushforward
def test_positions_at_matches_jax(rng):
    """JAX's own test holds positions_at to positions_all at 1e-6; here
    the port's against JAX's at 1e-5, before and after refine (whose
    per-frame positions take the anchors' place)."""
    jt, tt, video = _engines(rng)
    for t in (0, 4):
        close(tt.positions_at(t), jt.positions_at(t))
    assert tt.positions_at(2).shape == (K, 3)
    jt.refine(video, rounds=1, epochs=2, mu_iters=2)
    tt.refine(video, rounds=1, epochs=2, mu_iters=2)
    close(tt.pos_t, jt.pos_t, 1e-4)
    close(tt.positions_all(), jt.positions_all(), 1e-4)


@pytest.mark.parametrize("deform", [{}, dict(footprint_mode="resample",
                                             basis_scaling="pixel")])
def test_spatial_pushforward_matches_jax(rng, deform):
    jt, tt, video = _engines(rng, deform=deform)
    a_r, y_r = jM.spatial_pushforward(jt.state, jnp.asarray(video),
                                      jt.model, frame_block=3)
    a, y = tM.spatial_pushforward(tt.state, torch.from_numpy(video),
                                  tt.model, frame_block=3)
    close(a, a_r)
    assert np.array_equal(y.numpy(), np.asarray(y_r))


# ------------------------------------------------------ unfaded refinement
def test_refine_honours_mask_out_of_bounds(rng):
    jt, tt, video = _engines(rng, deform=dict(mask_out_of_bounds=False))
    kw = dict(epochs=3, learning_rate=0.05, prior=1e-3, frame_block=FB)
    p_r, m_r = jRf.refine_positions(jt.state, None, jnp.asarray(video),
                                    jt.model, **kw)
    p, m = tRf.refine_positions(tt.state, None, torch.from_numpy(video),
                                tt.model, **kw)
    close(p, p_r)
    close(m["recon_mse"], m_r["recon_mse"])
    g_r, c1_r = jRf.tracked_grams(jt.state, p_r, jnp.asarray(video),
                                  jt.model, frame_block=FB)
    g, c1 = tRf.tracked_grams(tt.state, p, torch.from_numpy(video),
                              tt.model, frame_block=FB)
    close(g, g_r, 1e-4)
    close(c1, c1_r, 1e-4)
    with pytest.raises(ValueError, match="use_kernels=False"):
        tRf.refine_positions(tt.state, None, torch.from_numpy(video),
                             tt.model, use_kernels=True)


def test_refine_raises_for_resample(rng):
    jt, tt, video = _engines(rng, deform=dict(footprint_mode="resample"))
    with pytest.raises(ValueError, match="analytic footprints"):
        jRf.refine_positions(jt.state, None, jnp.asarray(video), jt.model)
    for call in (lambda: tRf.refine_positions(tt.state, None,
                                              torch.from_numpy(video),
                                              tt.model),
                 lambda: tRf.tracked_grams(tt.state, tt.state.pos.expand(
                     T, K, 3), torch.from_numpy(video), tt.model),
                 lambda: tt.refine(video)):
        with pytest.raises(ValueError, match="analytic footprints"):
            call()


# ---------------------------------------------------- StaticFootprintNMF
def test_static_footprint_nmf_matches_jax(rng):
    """The JAX engine's initial C carried across; A and C after a few
    alternations at 1e-4 (MU compounds float32 reorderings)."""
    model_j = jcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                               shape_std=2.0)
    model_t = tcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                               shape_std=2.0)
    pos, video = _fixture(rng)
    video[0, :5] = -1.0  # clamped by both
    je = jtr.StaticFootprintNMF(model_j, jnp.asarray(pos))
    te = ttr.StaticFootprintNMF(model_t, pos, device="cpu")
    close(te.a, je.a)
    close(te.d, je.d)
    te.c = torch.from_numpy(np.array(je.c))
    a_r, c_r = je.fit(video.reshape((T,) + SIZE), iters=5)
    a, c = te.fit(video.reshape((T,) + SIZE), iters=5)
    close(a, a_r, 1e-4)
    close(c, c_r, 1e-4)
    assert float(a.min()) >= 0 and float(c.min()) >= 0
    g = torch.Generator().manual_seed(3)
    seeded = ttr.StaticFootprintNMF(model_t, pos, generator=g, device="cpu")
    again = ttr.StaticFootprintNMF(
        model_t, pos, generator=torch.Generator().manual_seed(3),
        device="cpu")
    assert torch.equal(seeded.c, again.c)


def test_mu_spatial_step_and_distance_penalty(rng):
    """tests/test_mu.py's tolerances: rtol 1e-5 for the step, rtol 1e-4
    / atol 1e-5 for the penalty."""
    p, k, t = 30, 4, 6
    a = rng.uniform(size=(p, k)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, size=(k, t)).astype(np.float32)
    y = rng.uniform(size=(p, t)).astype(np.float32)
    d = rng.uniform(size=(p, k)).astype(np.float32)
    for kw_j, kw_t in ((dict(d=jnp.asarray(d), gamma=0.5),
                        dict(d=torch.from_numpy(d), gamma=0.5)), ({}, {})):
        ref = jMu.mu_spatial_step(jnp.asarray(a), jnp.asarray(c),
                                  jnp.asarray(y), **kw_j)
        got = tMu.mu_spatial_step(torch.from_numpy(a), torch.from_numpy(c),
                                  torch.from_numpy(y), **kw_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    grid = rng.uniform(0, 10, size=(20, 3)).astype(np.float32)
    pos = rng.uniform(0, 10, size=(3, 3)).astype(np.float32)
    ref = jMu.distance_penalty(jnp.asarray(grid), jnp.asarray(pos), rate=0.02)
    got = tMu.distance_penalty(torch.from_numpy(grid), torch.from_numpy(pos),
                               rate=0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------ footprint helpers
@pytest.mark.parametrize("aniso", [False, True])
def test_gaussian_weights_match(rng, aniso):
    pos = rng.uniform(0, 10, (5, 3)).astype(np.float32)
    sigma = rng.uniform(1, 3, (5, 3) if aniso else (5,)).astype(np.float32)
    w_r, b_r = jF.gaussian_weights(jnp.asarray(pos), jnp.asarray(sigma))
    w, b = tF.gaussian_weights(torch.from_numpy(pos), torch.from_numpy(sigma))
    close(w, w_r)
    close(b, b_r)


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("formulation", ["direct", "matmul"])
def test_footprint_helpers_match(rng, formulation, aniso):
    """``fused_reconstruction`` and ``reconstruct_frames`` against JAX's
    (1e-5), and the matmul form against the direct one at
    ``tests/test_footprints.py``'s rtol 2e-3 / atol 1e-5: it cancels
    O(coord^2) terms."""
    size, k, b = (8, 7, 3), 5, 3
    grid = np.asarray(jB.voxel_grid(size))
    pos = rng.uniform(0, np.array(size) - 1, (k, 3)).astype(np.float32)
    sigma = rng.uniform(1, 3, (k, 3) if aniso else (k,)).astype(np.float32)
    psi = (grid + 0.3).astype(np.float32)
    c_t = rng.uniform(size=(k,)).astype(np.float32)
    jp, js_ = jnp.asarray(pos), jnp.asarray(sigma)
    tp, ts_ = torch.from_numpy(pos), torch.from_numpy(sigma)
    hi = jax.lax.Precision.HIGHEST
    a_r = jF.evaluate_footprints(jnp.asarray(psi), jp, js_, size=size,
                                 formulation=formulation, precision=hi)
    a = tF.evaluate_footprints(torch.from_numpy(psi), tp, ts_, size=size,
                               formulation=formulation)
    close(a, a_r, 1e-5 if formulation == "direct" else 1e-4)
    direct = tF.evaluate_footprints(torch.from_numpy(psi), tp, ts_,
                                    size=size)
    np.testing.assert_allclose(a.numpy(), direct.numpy(), rtol=2e-3,
                               atol=1e-5)
    for mask in (True, False):
        ref = jF.fused_reconstruction(jnp.asarray(psi), jp, js_,
                                      jnp.asarray(c_t), size=size,
                                      mask_out_of_bounds=mask,
                                      formulation=formulation)
        got = tF.fused_reconstruction(torch.from_numpy(psi), tp, ts_,
                                      torch.from_numpy(c_t), size=size,
                                      mask_out_of_bounds=mask,
                                      formulation=formulation)
        close(got, ref, 1e-5 if formulation == "direct" else 1e-4)
    betas = np.asarray(jB.identity_beta(b)) + 0.01 * rng.normal(
        size=(b, 10, 3)).astype(np.float32)
    betas[:, 4:] *= 0.01
    c = rng.uniform(size=(b, k)).astype(np.float32)
    ref = jF.reconstruct_frames(jnp.asarray(betas), jnp.asarray(c), jp, js_,
                                size, formulation=formulation)
    got = tF.reconstruct_frames(torch.from_numpy(betas), torch.from_numpy(c),
                                tp, ts_, size, formulation=formulation)
    assert got.shape == (b, 8 * 7 * 3)
    close(got, ref, 1e-5 if formulation == "direct" else 1e-4)
    with pytest.raises(ValueError, match="formulation"):
        tF.evaluate_footprints(torch.from_numpy(psi), tp, ts_, size=size,
                               formulation="bogus")


# --------------------------------------------------- config and exports
def test_high_snr_registration_fields():
    for kw in ({}, dict(max_shifts=(4, 4), pw_rigid=True)):
        got = dataclasses.asdict(tcfg.high_snr_registration(**kw))
        ref = dataclasses.asdict(jcfg.high_snr_registration(**kw))
        assert got == ref
        assert got["dft_precision"] == "default"


@pytest.mark.parametrize("jmod,tmod", [
    (dnmf_tpu, dnmf_tpu_torch),
    (dnmf_tpu.models, dnmf_tpu_torch.models),
    (dnmf_tpu.ops, dnmf_tpu_torch.ops),
    (dnmf_tpu.engine, dnmf_tpu_torch.engine),
])
def test_exports_match_jax(jmod, tmod):
    """Every name the JAX package exports, the port exports too (the
    engine also exports StaticFootprintNMF)."""
    assert set(jmod.__all__) <= set(tmod.__all__)
    for name in tmod.__all__:
        assert hasattr(tmod, name), name
    if tmod is dnmf_tpu_torch:
        assert tmod.__version__ == jmod.__version__
