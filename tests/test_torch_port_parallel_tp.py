"""Pixel-sharded (tensor-parallel) Grams and gradients of the port
against the JAX package's, on the CPU: the counterparts of
``tests/test_tensor_parallel.py``, and kernels A and C over a voxel range
against the Pallas kernels' ``p_offset`` in interpret mode.

The JAX side runs its sharded functions on the 8-virtual-device CPU
mesh; the port runs on an 8-rank CPU ``gloo`` group of the same (time x
pixel) shapes (``tests/torch_dist_workers.py``, one start-up for the
file), from the same NumPy inputs.  Tolerances are the JAX tests': rtol
1e-4, atol 1e-5 for pixel meshes and voxel-offset kernels (rtol 1e-5
where the JAX test holds the plain path so); whole fits are also held
against the port's single-device engine at the JAX test's tolerances, and
against JAX at the port's cross-package ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from dnmf_tpu.config import ModelConfig, OptimizerConfig, RuntimeConfig
from dnmf_tpu.engine.trainer import DeformableNMF
from dnmf_tpu.models import dnmf as M
from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu.ops import pallas_kernels as pk
from dnmf_tpu.parallel import (
    make_mesh,
    shard_state,
    shard_video,
    sharded_compute_grams,
    sharded_motion_epoch,
)
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import fused

SIZE = (16, 12, 2)  # P = 384, divisible by 4 pixel shards
K, T = 96, 8
SUB = 48  # K <= 64 routes JAX to the dense fused kernels
WORLD = 8
MESHES = {"tp8": (1, 1, 8), "t2xp4": (1, 2, 4), "t4xp2": (1, 4, 2)}
TP_OPT = dict(learning_rate=1e-3, motion_mode="parallel", motion_epochs=1,
              mu_iters=5, outer_rounds=1, gamma_motion=0.1,
              gamma_traces=0.01)
SIGMA_OPT = dict(TP_OPT, fit_sigma=True, sigma_every=1, sigma_steps=2,
                 sigma_frames=5)


def _model_kw(k=K):
    return dict(size=SIZE, num_neurons=k, num_frames=T, shape_std=2.0)


def _fixture(k=K):
    """``test_tensor_parallel``'s fixture, from ``default_rng(0)``; ``k <
    K`` keeps the first ``k`` positions (its dense-kernel variant)."""
    rng = np.random.default_rng(0)
    model = ModelConfig(**_model_kw())
    optimizer = M.make_motion_optimizer(OptimizerConfig(learning_rate=1e-3))
    pos = jnp.asarray(rng.uniform(1.0, 11.0, size=(K, 3)).astype(np.float32))
    state = M.init_state(model, optimizer, positions=pos,
                         key=jax.random.PRNGKey(0))
    video = rng.uniform(0.0, 1.0, size=(T, SIZE[0] * SIZE[1] * SIZE[2]))
    if k < K:
        model = ModelConfig(**_model_kw(k))
        state = M.init_state(model, optimizer, positions=state.pos[:k],
                             key=jax.random.PRNGKey(0))
    return model, optimizer, state, jnp.asarray(video.astype(np.float32))


def _np_state(state) -> dict:
    adam = state.opt_state[0]
    return {k: np.asarray(v) for k, v in dict(
        beta=state.beta, c=state.c, pos=state.pos, sigma=state.sigma,
        count=adam.count, mu=adam.mu, nu=adam.nu).items()}


def _resample_kw():
    return dict(_model_kw(), deformation=dict(
        footprint_mode="resample", basis_scaling="pixel",
        detach_regularizer=True))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case of this file on one 8-rank process group."""
    _, _, state, video = _fixture()
    st, v = _np_state(state), np.asarray(video)
    base = dict(model=_model_kw(), state=st, video=v, lr=1e-3, gamma=0.1,
                frame_block=4)
    cases = [(f"grams_{name}", "grams", dict(base, mesh=mesh))
             for name, mesh in MESHES.items()]
    cases += [
        ("motion", "motion", dict(base, mesh=MESHES["t2xp4"])),
        ("mu_smooth", "tp_round", dict(base, mesh=MESHES["t4xp2"], iters=5,
                                       gamma=0.01)),
        ("stream_guard", "stream_guard", dict(
            model=_resample_kw(), state=st, mesh=MESHES["t2xp4"],
            video=np.zeros((T,) + SIZE, np.float32))),
    ]
    for culled in (False, True):
        k = K if culled else SUB
        _, _, st_k, _ = _fixture(k)
        kb = dict(base, model=_model_kw(k), state=_np_state(st_k),
                  mesh=MESHES["t2xp4"], use_kernels=True)
        cases += [(f"kgrams_{culled}", "grams", kb),
                  (f"kmotion_{culled}", "motion", kb)]
    for use_kernels in (False, True):
        cases.append((f"stream_{use_kernels}", "stream", dict(
            base, mesh=MESHES["t2xp4"], block=3, use_kernels=use_kernels,
            video=v.reshape((T,) + SIZE))))
    tp = DeformableNMF(ModelConfig(**_model_kw()), OptimizerConfig(**TP_OPT),
                       positions=state.pos,
                       runtime=RuntimeConfig(mesh_time=2, mesh_pixel=4,
                                             frame_block=4))
    cases.append(("engine", "engine", dict(
        model=_model_kw(), opt=TP_OPT, state=_np_state(tp.state), video=v,
        runtime=dict(mesh_time=2, mesh_pixel=4, frame_block=4),
        calls=[("fit", {})])))
    cases.append(("engine_sigma", "engine", dict(
        model=_model_kw(), opt=SIGMA_OPT, state=_np_state(tp.state),
        video=v, runtime=dict(mesh_time=2, mesh_pixel=4, frame_block=4),
        calls=[("fit", {})])))
    return W.spawn(cases, WORLD, tmp_path_factory.mktemp("pg"))


def _get(port, name):
    res = port[name]
    if "error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res['error']}")
    return res


@pytest.mark.parametrize("name", sorted(MESHES))
def test_pixel_sharded_grams_match_jax(port, name):
    _, num_time, num_pixel = MESHES[name]
    model, _, state, video = _fixture()
    mesh = make_mesh(num_time=num_time, num_batch=1, num_pixel=num_pixel)
    grams, c1 = sharded_compute_grams(shard_state(state, mesh),
                                      shard_video(video, mesh), model,
                                      mesh=mesh, frame_block=4)
    got = _get(port, f"grams_{name}")
    np.testing.assert_allclose(got["grams"], np.asarray(grams), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["c1"], np.asarray(c1), rtol=1e-5,
                               atol=1e-5)


def test_pixel_sharded_motion_epoch_matches_jax(port):
    model, optimizer, state, video = _fixture()
    mesh = make_mesh(num_time=2, num_batch=1, num_pixel=4)
    sh_state, sh_m = sharded_motion_epoch(
        shard_state(state, mesh), shard_video(video, mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4)
    got = _get(port, "motion")
    np.testing.assert_allclose(got["beta"], np.asarray(sh_state.beta),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["recon_mse"], float(sh_m["recon_mse"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["reg"], float(sh_m["reg"]), rtol=1e-5,
                               atol=1e-7)


def _close(got, ref, tol):
    """``max|got - ref| <= tol * max|ref|`` (the port's cross-package
    tolerance for whole rounds, ``tests/test_torch_port_model.py``)."""
    ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def test_engine_tp_round_matches_dense(port):
    """A fit round on a (time 2 x pixel 4) mesh: ``gram_mode="auto"``
    resolves to exact there (the pixel-mesh clause); held against the
    port's single-device engine with exact Grams from the same state
    (the JAX test's tolerances) and against JAX's (time x pixel) engine
    (the port's cross-package tolerance)."""
    model, _, state, video = _fixture()
    opt = OptimizerConfig(**TP_OPT)
    tp = DeformableNMF(model, opt, positions=state.pos,
                       runtime=RuntimeConfig(mesh_time=2, mesh_pixel=4,
                                             frame_block=4))
    init = _np_state(tp.state)
    tp_res = tp.fit(video)
    dense = ttr.DeformableNMF(tcfg.ModelConfig(**_model_kw()),
                              tcfg.OptimizerConfig(**TP_OPT),
                              tcfg.RuntimeConfig(gram_mode="exact"),
                              device="cpu")
    dense.state = tM.state_from_numpy(init)
    dense._base_sigma = dense.state.sigma
    dense_res = dense.fit(np.asarray(video))
    got = _get(port, "engine")
    assert got["gram_mode"] == tp._gram_mode == "exact"
    res = got["after"][0]["result"]
    np.testing.assert_allclose(res["beta"], dense_res.beta, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res["c"], dense_res.traces, rtol=1e-4,
                               atol=1e-6)
    _close(res["beta"], tp_res.state.beta, 1e-4)
    _close(res["c"], tp_res.state.c, 1e-4)


def test_engine_fit_sigma_on_a_pixel_mesh(port):
    """Width fitting on a (time 2 x pixel 4) mesh: every rank fits the
    widths on the same whole frames (each owner's rows summed over the
    time axis, the pixel runs joined), as the single-device engine does;
    held against it from the same state, and against JAX's (time x pixel)
    engine at the port's cross-package tolerance."""
    model, _, state, video = _fixture()
    tp = DeformableNMF(model, OptimizerConfig(**SIGMA_OPT),
                       positions=state.pos,
                       runtime=RuntimeConfig(mesh_time=2, mesh_pixel=4,
                                             frame_block=4))
    init = _np_state(tp.state)
    tp_res = tp.fit(video)
    one = ttr.DeformableNMF(tcfg.ModelConfig(**_model_kw()),
                            tcfg.OptimizerConfig(**SIGMA_OPT),
                            tcfg.RuntimeConfig(gram_mode="exact"),
                            device="cpu")
    one.state = tM.state_from_numpy(init)
    one._base_sigma = one.state.sigma
    one_res = one.fit(np.asarray(video))
    res = _get(port, "engine_sigma")["after"][0]["result"]
    assert any(m["phase"] == "sigma" for m in _get(
        port, "engine_sigma")["metrics"])
    np.testing.assert_allclose(res["sigma"], one_res.state.sigma.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res["beta"], one_res.beta, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res["c"], one_res.traces, rtol=1e-4,
                               atol=1e-6)
    _close(res["sigma"], tp_res.state.sigma, 1e-4)
    _close(res["c"], tp_res.state.c, 1e-4)


def test_pixel_sharded_mu_with_smoothing(port):
    """The halo'd trace update on pixel-sharded Grams (time 4 x pixel 2)
    against JAX's dense update."""
    model, _, state, video = _fixture()
    grams, c1 = M.compute_grams(state, video, model, frame_block=4)
    dense = M.footprint_update(state, grams, c1, iters=5, gamma=0.01)
    np.testing.assert_allclose(_get(port, "mu_smooth")["c"],
                               np.asarray(dense.c), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_pixel_sharded_kernel_grams_match_jax(port, culled):
    """Kernel C over each rank's voxel range (its plain version on the
    CPU) against JAX's voxel-offset Pallas Grams in interpret mode."""
    model, _, state, video = _fixture(K if culled else SUB)
    mesh = make_mesh(num_time=2, num_batch=1, num_pixel=4)
    grams, c1 = sharded_compute_grams(
        shard_state(state, mesh), shard_video(video, mesh), model,
        mesh=mesh, frame_block=4, use_pallas=True, pallas_interpret=True)
    got = _get(port, f"kgrams_{culled}")
    np.testing.assert_allclose(got["grams"], np.asarray(grams), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["c1"], np.asarray(c1), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("culled", [False, True], ids=["dense", "culled"])
def test_pixel_sharded_kernel_motion_matches_jax(port, culled):
    """Kernel A over each rank's voxel range against JAX's voxel-offset
    Pallas gradients in interpret mode."""
    model, optimizer, state, video = _fixture(K if culled else SUB)
    mesh = make_mesh(num_time=2, num_batch=1, num_pixel=4)
    sh_state, sh_m = sharded_motion_epoch(
        shard_state(state, mesh), shard_video(video, mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4, use_pallas=True,
        pallas_interpret=True)
    got = _get(port, f"kmotion_{culled}")
    np.testing.assert_allclose(got["beta"], np.asarray(sh_state.beta),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["recon_mse"], float(sh_m["recon_mse"]),
                               rtol=1e-4)


def test_guards(port):
    """Unsupported compositions fail loudly: a pixel shard needs analytic
    footprints (in the local Grams and gradients, in the engine before it
    looks for a process group, and in the sharded streamed epoch)."""
    _, _, state, video = _fixture()
    ts = tM.state_from_numpy(_np_state(state))
    kw = _resample_kw()
    resample = tcfg.ModelConfig(**{**kw, "deformation": tcfg.DeformationConfig(
        **kw["deformation"])})
    tvideo = torch.as_tensor(np.asarray(video))
    with pytest.raises(ValueError, match="analytic"):
        tM.grams_local(ts, tvideo, resample, 4, p_offset=0)
    with pytest.raises(ValueError, match="analytic"):
        tM.frame_grads_local(ts, tvideo, resample, 0.1, 4, p_offset=0)
    with pytest.raises(ValueError, match="analytic"):
        ttr.DeformableNMF(resample, tcfg.OptimizerConfig(),
                          tcfg.RuntimeConfig(mesh_pixel=4), device="cpu")
    assert "analytic" in (_get(port, "stream_guard")["raised"] or "")


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_streaming_on_pixel_mesh_matches_dense(port, use_kernels):
    """Host-streamed blocks (block 3) on a (time 2 x pixel 4) mesh, each
    rank reading its own frames and voxels, against JAX's dense
    single-device epoch and Grams."""
    model, optimizer, state, video = _fixture()
    dense_state, dense_m = M.motion_epoch_parallel(
        state, video, model, optimizer, gamma=0.1, frame_block=4)
    dense_grams, dense_c1 = M.compute_grams(dense_state, video, model,
                                            frame_block=4)
    got = _get(port, f"stream_{use_kernels}")
    np.testing.assert_allclose(got["beta"], np.asarray(dense_state.beta),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["recon_mse"], float(dense_m["recon_mse"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["grams"], np.asarray(dense_grams),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["c1"], np.asarray(dense_c1), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("kernel", ["motion", "gram"])
def test_voxel_range_kernels_match_jax_p_offset(kernel):
    """Kernels A and C over voxel ranges of 128 voxels, which cut the
    12 x 2 voxel rows of m mid-row (a pixel shard that is not a set of
    bricks), against the Pallas culled kernels' ``p_offset`` in interpret
    mode; per shard, and summed over the shards against the whole
    volume.  The kernels' candidate counts per brick cover only the
    bricks the range meets."""
    model, _, state, video = _fixture()
    betas = state.beta[:2] + 0.01 * jnp.asarray(
        np.random.default_rng(1).normal(size=(2, 10, 3)), jnp.float32)
    y = video[:2]
    c = jnp.asarray(np.random.default_rng(2).uniform(0.2, 1.0, (2, K)),
                    jnp.float32)
    tb, tpos, tsig = (torch.as_tensor(np.asarray(a)) for a in
                      (betas, state.pos, state.sigma))
    p_loc = 128
    assert p_loc % (SIZE[1] * SIZE[2])
    parts = []
    for p0 in range(0, y.shape[1], p_loc):
        ys = y[:, p0:p0 + p_loc]
        ty = torch.as_tensor(np.asarray(ys))
        if kernel == "motion":
            ref = pc.motion_block_culled(betas, state.pos, state.sigma, c,
                                         ys, SIZE, p_offset=p0,
                                         interpret=True)
            got = fused.motion_block(tb, tpos, tsig,
                                     torch.as_tensor(np.asarray(c)), ty,
                                     SIZE, p_offset=p0, brick_counts=True)
        else:
            ref = pc.gram_block_culled(betas, state.pos, state.sigma, ys,
                                       SIZE, p_offset=p0, interpret=True)
            got = fused.gram_block(tb, tpos, tsig, ty, SIZE, p_offset=p0,
                                   brick_counts=True)
        for g, r in zip(got[:2], ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5)
        first, n_bricks = fused.brick_range(SIZE, p0, p_loc)
        assert got[2].shape == (2, n_bricks)
        parts.append(got[:2])
    if kernel == "motion":
        whole = pk.motion_block(betas, state.pos, state.sigma, c, y, SIZE,
                                interpret=True)
        summed = [sum(p[i] for p in parts) / len(parts) for i in range(2)]
    else:
        whole = pk.gram_block(betas, state.pos, state.sigma, y, SIZE,
                              interpret=True)
        summed = [sum(p[i] for p in parts) for i in range(2)]
    for g, r in zip(summed, whole):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_voxel_ranges_only_where_the_kernels_take_them():
    """``p_offset`` takes shared anchors and the in-kernel warp: the Gram
    at per-frame positions (E) and from precomputed rows (C4) sum over the
    whole volume and refuse it, as the Pallas kernels refuse the streamed
    rows; analytic Grams refuse a pixel shard."""
    _, _, state, video = _fixture()
    ts = tM.state_from_numpy(_np_state(state))
    betas, y = ts.beta[:2], torch.as_tensor(np.asarray(video[:2, :128]))
    pos_t = ts.pos.expand(2, K, 3)
    with pytest.raises(ValueError, match="p_offset"):
        fused.gram_block(betas, pos_t, ts.sigma, y, SIZE, p_offset=0)
    with pytest.raises(ValueError, match="p_offset"):
        fused.gram_block(betas, ts.pos, ts.sigma, y, SIZE,
                         psi_source="stream", p_offset=0)
    with pytest.raises(ValueError, match="analytic"):
        tM.grams_local(ts, y, tcfg.ModelConfig(**_model_kw()), 4,
                       gram_mode="analytic", p_offset=0)
