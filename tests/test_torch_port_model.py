"""The port's model layer and trainer against ``dnmf_tpu`` (plain XLA
path, ``use_pallas=False``) from the same state, handed over as NumPy.

Tolerance 1e-5 of the reference's max magnitude for one epoch / one
trace iteration; whole rounds compound float32 reorderings over Adam and
50 trace iterations and are held at 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import fused

SIZE = (16, 12, 4)
K, T, FB = 6, 7, 3  # the last frame block is short


def close(got, ref, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _video(rng, pos, sigma=2.0):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / sigma ** 2)
    c = rng.uniform(0.2, 1.0, (K, T))
    v = (a @ c).T + rng.uniform(0, 0.2, (T, grid.shape[0]))
    return v.astype(np.float32)


def _models(scaling="normalized", sigma_axes=1):
    deform = dict(basis_scaling=scaling)
    kw = dict(size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0,
              sigma_axes=sigma_axes)
    return (jcfg.ModelConfig(deformation=jcfg.DeformationConfig(**deform),
                             **kw),
            tcfg.ModelConfig(deformation=tcfg.DeformationConfig(**deform),
                             **kw))


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _pair(rng, scaling="normalized", lr=1e-3, sigma_axes=1):
    jm, tm = _models(scaling, sigma_axes)
    opt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=lr))
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    js = jM.init_state(jm, opt, positions=jnp.asarray(pos),
                       key=jax.random.PRNGKey(1))
    beta = np.asarray(js.beta) + 0.01 * rng.normal(
        size=(T, 10, 3)).astype(np.float32)
    if scaling == "pixel":
        beta[:, 4:] *= 0.01
    js = js._replace(beta=jnp.asarray(beta))
    ts = tM.state_from_numpy(_jax_to_numpy(js))
    video = _video(rng, pos)
    return jm, tm, opt, tM.Adam(lr), js, ts, video


def _check_state(ts, js, tol=1e-5):
    ref = _jax_to_numpy(js)
    for name, val in tM.state_to_numpy(ts).items():
        if name == "count":
            assert int(val) == int(ref[name])
        else:
            close(val, ref[name], tol)


def test_state_numpy_round_trip(rng):
    *_, js, ts, _ = _pair(rng)
    back = tM.state_from_numpy(tM.state_to_numpy(ts))
    for name in tM.STATE_FIELDS:
        assert torch.equal(getattr(back, name), getattr(ts, name))
    assert back.count.dtype == torch.int32


@pytest.mark.parametrize("scaling,lr", [("normalized", 1e-3),
                                        ("pixel", 1e-5)])
def test_motion_epochs_match(rng, scaling, lr):
    jm, tm, jopt, topt, js, ts, video = _pair(rng, scaling, lr)
    vj, vt = jnp.asarray(video), torch.from_numpy(video)
    for _ in range(2):
        js, jmet = jM.motion_epoch_parallel(js, vj, jm, jopt, 0.1,
                                            frame_block=FB)
        ts, tmet = tM.motion_epoch_parallel(ts, vt, tm, topt, 0.1,
                                            frame_block=FB)
        _check_state(ts, js)
        for key in ("recon_mse", "reg"):
            close(tmet[key], jmet[key])


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_frame_footprints_match(rng, scaling):
    jm, tm, _, _, js, ts, _ = _pair(rng, scaling)
    ref = jM.frame_footprints(js.beta[2], js.pos, js.sigma, jm,
                              jM.model_voxel_basis(jm))
    got = tM.frame_footprints(ts.beta[2], ts.pos, ts.sigma, tm,
                              tM.model_voxel_basis(tm))
    close(got, ref)


def test_frame_grads_match_per_frame(rng):
    jm, tm, _, _, js, ts, video = _pair(rng, sigma_axes=1)
    g_r, mse_r, reg_r = jM.frame_grads_local(js, jnp.asarray(video), jm,
                                             0.3, FB)
    g, mse, reg = tM.frame_grads_local(ts, torch.from_numpy(video), tm, 0.3,
                                       FB)
    close(g, g_r)
    close(mse, mse_r)
    close(reg, reg_r)


@pytest.mark.parametrize("mode", ["exact", "analytic"])
@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_grams_match(rng, mode, sigma_axes):
    jm, tm, _, _, js, ts, video = _pair(rng, sigma_axes=sigma_axes)
    g_r, c1_r = jM.compute_grams(js, jnp.asarray(video), jm, frame_block=FB,
                                 gram_mode=mode)
    g, c1 = tM.compute_grams(ts, torch.from_numpy(video), tm, FB,
                             gram_mode=mode)
    close(g, g_r)
    close(c1, c1_r)


@pytest.mark.parametrize("solver", ["mu", "fista"])
@pytest.mark.parametrize("gamma", [0.0, 0.2])
def test_trace_iteration_matches(rng, solver, gamma):
    jm, tm, _, _, js, ts, video = _pair(rng)
    g, c1 = jM.compute_grams(js, jnp.asarray(video), jm, frame_block=FB)
    js1 = jM.footprint_update(js, g, c1, iters=1, gamma=gamma, solver=solver)
    ts1 = tM.footprint_update(ts, torch.from_numpy(np.array(g)),
                              torch.from_numpy(np.array(c1)), 1, gamma,
                              solver)
    close(ts1.c, js1.c)


@pytest.mark.parametrize("mode", ["exact", "analytic"])
def test_fused_round_matches(rng, mode):
    jm, tm, jopt, topt, js, ts, video = _pair(rng)
    kw = dict(rounds=1, epochs=2, mu_iters=10, gamma=0.1, frame_block=FB,
              gram_mode=mode)
    js, jmet = jM.fused_rounds(js, jnp.asarray(video), jm, jopt, **kw)
    ts, tmet = tM.fused_rounds(ts, torch.from_numpy(video), tm, topt, **kw)
    _check_state(ts, js, 1e-4)
    close(tmet["recon_mse"], jmet["recon_mse"])


def _trainers(rng, **runtime):
    jm, tm, *_ = _pair(rng)
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    okw = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=2,
               mu_iters=20, gamma_motion=0.1, sigma_anneal=(1.3,))
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=FB,
                                              use_pallas=False),
                           positions=jnp.asarray(pos))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=FB, **runtime),
                           positions=pos, device="cpu")
    # jax.random and torch draw different initial traces: hand JAX's over.
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    tt._base_sigma = tt.state.sigma
    return jt, tt, _video(rng, pos)


def test_fit_auto_matches_jax(rng, tmp_path):
    path = tmp_path / "metrics.jsonl"
    jt, tt, video = _trainers(rng, metrics_path=str(path))
    jres = jt.fit(video.reshape((T,) + SIZE))
    tres = tt.fit(video.reshape((T,) + SIZE))
    close(tres.traces, jres.traces, 1e-4)
    close(tres.beta, jres.beta, 1e-4)
    assert [m["phase"] for m in tres.metrics] == [
        m["phase"] for m in jres.metrics]
    for tm_, jm_ in zip(tres.metrics, jres.metrics):
        for key in ("recon_mse", "motion_recon_mse", "traces_c_mean"):
            if key in jm_:
                close(np.float64(tm_[key]), np.float64(jm_[key]), 1e-4)
        if tm_["phase"] == "gram_audit":
            assert tm_["frame"] == jm_["frame"]
            assert abs(tm_["rel_err"] - jm_["rel_err"]) <= 1e-4
    close(tt.positions_all(), jt.positions_all(), 1e-5)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["round"] for x in lines] == [0, 1]
    # The anneal widened round 0 only; the fit ends on the base widths.
    assert torch.equal(tres.state.sigma, torch.full((K,), 2.0))


def test_fit_with_kernels_on_cpu_is_the_plain_fit(rng):
    """use_kernels=True on CPU tensors goes through the wrappers, which
    run the plain versions: bit-identical to use_kernels=False."""
    _, t_plain, video = _trainers(rng, use_kernels=False)
    state0 = dataclasses.replace(t_plain.state)
    r_plain = t_plain.fit(video)
    _, t_kern, _ = _trainers(np.random.default_rng(0), use_kernels=True)
    t_kern.state = state0
    t_kern._base_sigma = state0.sigma
    fused.reset_launch_counts()
    r_kern = t_kern.fit(video)
    assert np.array_equal(r_kern.traces, r_plain.traces)
    assert np.array_equal(r_kern.beta, r_plain.beta)
    assert sum(fused.launch_counts().values()) == 0


def test_exact_gram_mode_and_audit_fallback(rng):
    jt, tt, video = _trainers(rng, gram_mode="exact")
    tt.fit(video, rounds=1)
    assert not any(m["phase"] == "gram_audit" for m in tt.metrics)
    _, tt2, _ = _trainers(np.random.default_rng(1), gram_trust_tol=0.0)
    with pytest.warns(RuntimeWarning, match="trust audit breached"):
        tt2.fit(video, rounds=1)
    assert tt2._gram_mode == "exact"


def test_check_finite_raises(rng):
    _, tt, video = _trainers(rng, check_finite=True)
    tt.state = tt.state.replace(beta=tt.state.beta * float("nan"))
    with pytest.raises(FloatingPointError):
        tt.fit(video, rounds=1)


@pytest.mark.parametrize("opt,rt,model,item", [
    (dict(motion_mode="parity"), {}, {}, 11),
    ({}, dict(mesh_batch=2), {}, 10),
    ({}, dict(mesh_time=2), {}, 10),
    ({}, dict(mesh_pixel=2), {}, 10),
    ({}, dict(checkpoint_dir="ckpt"), {}, 11),
    ({}, dict(profile_dir="prof"), {}, 11),
    ({}, {}, dict(footprint_mode="resample"), 11),
    ({}, {}, dict(mask_out_of_bounds=False), 11),
])
def test_outside_the_slice_raises(opt, rt, model, item, tmp_path):
    """The mesh options (ROADMAP item 10) raise; item 11's options are
    ported, and the engine takes them."""
    m = tcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                         deformation=tcfg.DeformationConfig(**model))
    rt = {k: str(tmp_path / v) if k.endswith("_dir") else v
          for k, v in rt.items()}

    def make():
        return ttr.DeformableNMF(m, tcfg.OptimizerConfig(**opt),
                                 tcfg.RuntimeConfig(**rt), device="cpu")

    if item == 10:
        with pytest.raises(NotImplementedError, match="item 10"):
            make()
    else:
        assert not make()._use_kernels


def test_unported_methods_and_sources_raise(rng, tmp_path):
    _, tt, video = _trainers(rng)
    # save/restore are ported (tests/test_torch_port_engine_extras.py).
    tt.save(str(tmp_path / "ckpt.pt"))
    tt.restore(str(tmp_path / "ckpt.pt"))

    class Streamed:  # a source that streams to another device
        block = 4
        device = "meta"

        def blocks(self):
            return iter(())

    class Dataset:
        def frames_flat(self):
            return video

    for call in (lambda: tt.fit(Streamed()), lambda: tt.refine(Streamed())):
        with pytest.raises(ValueError, match="streams to meta"):
            call()
    # Datasets feed the trainer (tests/test_torch_port_datasets.py).
    tt.fit(Dataset(), rounds=1)
    tt.refine(Dataset(), rounds=1, epochs=1, mu_iters=1)


def test_init_state_is_seeded(rng):
    _, tm = _models()
    a = tM.init_state(tm, generator=torch.Generator().manual_seed(3))
    b = tM.init_state(tm, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.c, b.c) and torch.equal(a.pos, b.pos)
    assert a.beta.shape == (T, 10, 3) and a.c.shape == (K, T)
    assert float(a.c.min()) >= 0.0 and int(a.count) == 0
    _, tm3 = _models(sigma_axes=3)
    assert tM.init_state(tm3).sigma.shape == (K, 3)
