"""Sharded streaming, checkpoints and registration of the port against
the JAX package's, on the CPU: the counterparts of
``tests/test_sharded_streaming.py`` and
``tests/test_sharded_registration.py``.

The JAX side runs on the 8-virtual-device CPU mesh; the port on an
8-rank CPU ``gloo`` group (``tests/torch_dist_workers.py``, one start-up
for the file), each rank reading its own frames from the streamed source
(block 3, which does not divide the 8 frames of a rank).  Tolerances are
the JAX tests' (rtol 1e-5 on a time mesh; registration shifts and
templates 1e-4, movies 1e-3); whole fits are held against the port's
single-device engine at the JAX test's tolerances and against JAX at the
port's cross-package ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import torch_dist_workers as W
from dnmf_tpu.config import ModelConfig, OptimizerConfig, RegistrationConfig
from dnmf_tpu.engine.trainer import DeformableNMF
from dnmf_tpu.models import dnmf as M
from dnmf_tpu.parallel import (
    make_mesh,
    shard_state,
    shard_video,
    sharded_motion_epoch,
    sharded_register_pwrigid,
    sharded_register_rigid,
)
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.utils import checkpoint as tckpt

SIZE = (12, 12, 2)
K, T = 4, 64
MESH_TIME = 8
BLOCK = 3  # does NOT divide shard_len=8 -> exercises partial blocks
WORLD = 8
MODEL = dict(size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0)
ENGINE_OPT = dict(learning_rate=1e-3, motion_mode="parallel",
                  motion_epochs=2, mu_iters=5, outer_rounds=2,
                  gamma_motion=0.1, gamma_traces=0.01)
REG = {
    "rigid": dict(max_shifts=(5, 5), niter_rig=2, splits=8,
                  border_nan=False, frame_block=1),
    "pwrigid": dict(max_shifts=(5, 5), niter_rig=1, splits=8,
                    border_nan=False, pw_rigid=True, strides=(28, 28),
                    overlaps=(10, 10), frame_block=2),
}


def _fixture():
    rng = np.random.default_rng(0)
    model = ModelConfig(**MODEL)
    optimizer = M.make_motion_optimizer(OptimizerConfig(learning_rate=1e-3))
    pos = jnp.asarray(rng.uniform(2.0, 10.0, size=(K, 3)).astype(np.float32))
    state = M.init_state(model, optimizer, positions=pos,
                         key=jax.random.PRNGKey(0))
    video = rng.uniform(0.0, 1.0, size=(T,) + SIZE).astype(np.float32)
    return model, optimizer, state, video


def _np_state(state) -> dict:
    adam = state.opt_state[0]
    return {k: np.asarray(v) for k, v in dict(
        beta=state.beta, c=state.c, pos=state.pos, sigma=state.sigma,
        count=adam.count, mu=adam.mu, nu=adam.nu).items()}


def _engine_pos():
    return jnp.asarray(np.random.default_rng(1).uniform(
        2.0, 10.0, (K, 3)).astype(np.float32))


def _reg_video(shape=(48, 48), t=16):
    rng = np.random.default_rng(0)
    tmpl = gaussian_filter(rng.normal(size=shape), 2.0).astype(np.float32)
    shifts = [(i % 5 - 2, (i + 2) % 5 - 2) for i in range(t)]
    video = np.stack([np.roll(tmpl, s, axis=(0, 1)) for s in shifts])
    return tmpl, shifts, video.astype(np.float32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case of this file on one 8-rank process group; the
    checkpoint's path with the results."""
    tmp = tmp_path_factory.mktemp("pg")
    _, _, state, video = _fixture()
    st = _np_state(state)
    t8 = (1, MESH_TIME, 1)
    base = dict(model=MODEL, state=st, video=video, lr=1e-3, gamma=0.1,
                mesh=t8, block=BLOCK)
    eng = DeformableNMF(ModelConfig(**MODEL), OptimizerConfig(**ENGINE_OPT),
                        positions=_engine_pos())
    tmpl, _, rvideo = _reg_video()
    cases = [
        ("stream", "stream", dict(base, mu_iters=5, mu_gamma=0.01)),
        ("memmap", "stream", dict(base, block=4, grams=False,
                                  memmap=str(tmp / "video.raw"))),
        ("engine", "engine", dict(
            model=MODEL, opt=ENGINE_OPT, state=_np_state(eng.state),
            video=video, stream_block=BLOCK,
            runtime=dict(mesh_time=MESH_TIME, frame_block=4),
            calls=[("fit", {})])),
        ("checkpoint", "checkpoint", dict(
            base, video=video.reshape(T, -1), path=str(tmp / "ckpt.pt"))),
    ]
    for name, cfg in REG.items():
        cases.append((f"reg_{name}", "register", dict(
            mesh=t8, cfg=cfg, video=rvideo, template=tmpl,
            fn=f"sharded_register_{name}")))
    return W.spawn(cases, WORLD, tmp / "ranks"), tmp / "ckpt.pt"


def _get(run, name):
    res = run[0][name]
    if "error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res['error']}")
    return res


def test_sharded_streaming_matches_dense(run):
    """Streamed epoch, Grams and the halo'd trace update on an 8-way time
    mesh against JAX's dense single-device path."""
    model, optimizer, state, video = _fixture()
    video_flat = jnp.asarray(video.reshape(T, -1))
    dense_state, dense_m = M.motion_epoch_parallel(
        state, video_flat, model, optimizer, gamma=0.1, frame_block=4)
    dense_grams, dense_c1 = M.compute_grams(dense_state, video_flat, model,
                                            frame_block=4)
    dense_final = M.footprint_update(dense_state, dense_grams, dense_c1,
                                     iters=5, gamma=0.01)
    got = _get(run, "stream")
    np.testing.assert_allclose(got["beta"], np.asarray(dense_state.beta),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["recon_mse"], float(dense_m["recon_mse"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["grams"], np.asarray(dense_grams),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["c1"], np.asarray(dense_c1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["c_final"], np.asarray(dense_final.c),
                               rtol=1e-5, atol=1e-7)


def _close(got, ref, tol):
    """``max|got - ref| <= tol * max|ref|`` (the port's cross-package
    tolerance for whole rounds, ``tests/test_torch_port_model.py``)."""
    ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def test_engine_streaming_on_mesh_matches_dense(run):
    """``fit()`` with ``mesh_time=8`` on a ``StreamingVideo`` (2 rounds)
    against the port's dense single-device fit from the same state (the
    JAX test's tolerances) and against JAX's dense fit."""
    _, _, _, video = _fixture()
    jeng = DeformableNMF(ModelConfig(**MODEL), OptimizerConfig(**ENGINE_OPT),
                         positions=_engine_pos())
    one = ttr.DeformableNMF(tcfg.ModelConfig(**MODEL),
                            tcfg.OptimizerConfig(**ENGINE_OPT),
                            device="cpu")
    one.state = tM.state_from_numpy(_np_state(jeng.state))
    one._base_sigma = one.state.sigma
    jres = jeng.fit(video.reshape(T, -1))
    ores = one.fit(video.reshape(T, -1))
    res = _get(run, "engine")["after"][0]["result"]
    np.testing.assert_allclose(res["beta"], ores.beta, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["c"], ores.traces, rtol=1e-4, atol=1e-6)
    _close(res["beta"], jres.beta, 1e-4)
    _close(res["c"], jres.traces, 1e-4)


def test_streaming_memmap_source_on_mesh(run):
    """A disk-memmapped recording streams onto the mesh (block 4)."""
    model, optimizer, state, video = _fixture()
    dense_state, _ = M.motion_epoch_parallel(
        state, jnp.asarray(video.reshape(T, -1)), model, optimizer,
        gamma=0.1, frame_block=4)
    np.testing.assert_allclose(_get(run, "memmap")["beta"],
                               np.asarray(dense_state.beta), rtol=1e-5,
                               atol=1e-7)


def test_sharded_checkpoint_resume(run):
    """Save on an 8-way time mesh (rank 0 writes the whole state); restore
    onto the mesh (each rank its shard): equal; the resumed mesh run
    continues as a single-device run from the same checkpoint; the saved
    epoch is JAX's sharded epoch."""
    model, optimizer, state, video = _fixture()
    got = _get(run, "checkpoint")
    for name in tM.STATE_FIELDS:
        np.testing.assert_array_equal(got["restored"][name],
                                      got["saved"][name])
    single, _ = tckpt.load_state(str(run[1]), "cpu")
    np.testing.assert_array_equal(single.beta.numpy(), got["saved"]["beta"])
    cont, _ = tM.motion_epoch_parallel(
        single, torch.as_tensor(video.reshape(T, -1)),
        tcfg.ModelConfig(**MODEL), tM.Adam(1e-3), 0.1, frame_block=4)
    np.testing.assert_allclose(got["continued"], cont.beta.numpy(),
                               rtol=1e-5, atol=1e-7)
    mesh = make_mesh(num_time=MESH_TIME, num_batch=1)
    sh_state, _ = sharded_motion_epoch(
        shard_state(state, mesh),
        shard_video(jnp.asarray(video.reshape(T, -1)), mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4)
    np.testing.assert_allclose(got["saved"]["beta"],
                               np.asarray(sh_state.beta), rtol=1e-5,
                               atol=1e-7)


def test_sharded_rigid_matches_jax(run):
    tmpl, true, video = _reg_video()
    mesh = make_mesh(num_time=8, num_batch=1)
    templ_s, corrected_s, shifts_s = sharded_register_rigid(
        jnp.asarray(video), RegistrationConfig(**REG["rigid"]), mesh,
        template=jnp.asarray(tmpl))
    got = _get(run, "reg_rigid")
    np.testing.assert_allclose(got["shifts"], np.asarray(shifts_s),
                               atol=1e-4)
    np.testing.assert_allclose(got["template"], np.asarray(templ_s),
                               atol=1e-4)
    np.testing.assert_allclose(got["corrected"], np.asarray(corrected_s),
                               atol=1e-3)
    np.testing.assert_allclose(got["shifts"], -np.asarray(true, float),
                               atol=0.3)


def test_sharded_pwrigid_matches_jax(run):
    tmpl, _, video = _reg_video()
    mesh = make_mesh(num_time=8, num_batch=1)
    templ_s, corrected_s, shifts_s = sharded_register_pwrigid(
        jnp.asarray(video), RegistrationConfig(**REG["pwrigid"]), mesh,
        template=jnp.asarray(tmpl))
    got = _get(run, "reg_pwrigid")
    np.testing.assert_allclose(got["shifts"], np.asarray(shifts_s),
                               atol=1e-4)
    np.testing.assert_allclose(got["template"], np.asarray(templ_s),
                               atol=1e-4)
    np.testing.assert_allclose(got["corrected"], np.asarray(corrected_s),
                               atol=1e-3)


def test_sources_read_a_run_of_voxels(tmp_path):
    """``blocks`` over a run of frames and voxels, a rank's read, of an
    array, a memmap and a raw file: the clamped frames' columns ``[p0,
    p1)``, the last block zero-padded; the whole run as ``blocks()``."""
    from dnmf_tpu_torch.data.streaming import (StreamingVideo,
                                               open_memmap_video,
                                               open_raw_video)

    video = np.random.default_rng(3).normal(size=(6,) + SIZE).astype(
        np.float32)
    path = tmp_path / "video.raw"
    video.tofile(path)
    for src in (StreamingVideo(video, block=4, device="cpu"),
                open_memmap_video(str(path), video.shape, block=4,
                                  device="cpu"),
                open_raw_video(str(path), video.shape, block=4,
                               device="cpu")):
        got = [(f.numpy(), s, v) for f, s, v in
               src.blocks(1, 6, slice(100, 203))]
        assert [(f.shape, s, v) for f, s, v in got] == [
            ((4, 103), 1, 4), ((4, 103), 5, 1)]
        ref = np.maximum(video.reshape(6, -1), 0.0)
        np.testing.assert_array_equal(
            np.concatenate([got[0][0], got[1][0][:1]]), ref[1:6, 100:203])
        assert not got[1][0][1:].any()
        whole = [f.numpy() for f, _, _ in src.blocks(1, 6)]
        np.testing.assert_array_equal(
            np.concatenate([whole[0], whole[1][:1]]), ref[1:6])
