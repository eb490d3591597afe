"""The port's parallel layer (``dnmf_tpu_torch.parallel``) against the JAX
package's, on the CPU: the counterparts of ``tests/test_sharding.py``.

The JAX side runs its sharded functions on the 8-virtual-device CPU mesh
of ``tests/conftest.py`` (in interpret mode where it reaches Pallas); the
port runs on an 8-rank CPU ``gloo`` process group of the same mesh shape
(``tests/torch_dist_workers.py``, one start-up for the whole file), from
the same NumPy inputs.  Tolerances are the JAX tests': rtol 1e-5 for
time meshes, trace updates rtol 1e-4 / atol 1e-6, kernel passes rtol 1e-4
/ atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from dnmf_tpu.config import ModelConfig, OptimizerConfig, RuntimeConfig
from dnmf_tpu.engine import DeformableNMF
from dnmf_tpu.models import dnmf as M
from dnmf_tpu.parallel import (
    make_mesh,
    shard_state,
    shard_video,
    sharded_compute_grams,
    sharded_footprint_update,
    sharded_motion_epoch,
)
from dnmf_tpu.parallel.batched import batched_round, stack_states
from dnmf_tpu.parallel.sharded import sharded_refined_rounds
from dnmf_tpu_torch import parallel as tP
from dnmf_tpu_torch.models import dnmf as tM

SIZE = (12, 12, 2)
K, T = 3, 16  # T divisible by 8 ranks
WORLD = 8
MODEL = dict(size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0)
ENGINE_OPT = dict(learning_rate=1e-3, motion_epochs=3, mu_iters=10,
                  gamma_motion=0.1, gamma_traces=0.05)
TRACE_RUNS = {"halo": (15, 0.05, "mu"), "plain": (15, 0.0, "mu"),
              "fista0": (25, 0.0, "fista"), "fista5": (25, 0.05, "fista")}


def _setup():
    model = ModelConfig(**MODEL)
    optimizer = M.make_motion_optimizer(OptimizerConfig(learning_rate=1e-3))
    pos = jnp.asarray([[3.0, 3.0, 1.0], [8.0, 3.0, 1.0], [5.0, 8.0, 1.0]])
    state = M.init_state(model, optimizer, positions=pos,
                         key=jax.random.PRNGKey(3))
    video = jax.random.uniform(jax.random.PRNGKey(9),
                               (T, SIZE[0] * SIZE[1] * SIZE[2]))
    return model, optimizer, state, video


def _np_state(state) -> dict:
    adam = state.opt_state[0]
    return {k: np.asarray(v) for k, v in dict(
        beta=state.beta, c=state.c, pos=state.pos, sigma=state.sigma,
        count=adam.count, mu=adam.mu, nu=adam.nu).items()}


def _second_recording(state0, video0, optimizer, seed):
    model = ModelConfig(**MODEL)
    key = jax.random.PRNGKey(seed)
    state1 = M.init_state(model, optimizer, positions=state0.pos + 0.5,
                          key=key)
    return state1, jax.random.uniform(key, video0.shape)


def _engine_pos():
    return jnp.asarray([[3.0, 3.0, 1.0], [8.0, 3.0, 1.0], [5.0, 8.0, 1.0]])


def _engine_video():
    return jax.random.uniform(jax.random.PRNGKey(5),
                              (T, SIZE[0] * SIZE[1] * SIZE[2]))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case of this file on one 8-rank process group."""
    model, optimizer, state, video = _setup()
    st, v = _np_state(state), np.asarray(video)
    grams, c1 = M.compute_grams(state, video, model, frame_block=4)
    state1, video1 = _second_recording(state, video, optimizer, 11)
    eng = DeformableNMF(model, OptimizerConfig(**ENGINE_OPT),
                        RuntimeConfig(frame_block=4), positions=_engine_pos())
    base = dict(model=MODEL, state=st, video=v, lr=1e-3, gamma=0.1,
                frame_block=4)
    t8, bt = (1, 8, 1), (2, 4, 1)
    cases = [
        ("motion", "motion", dict(base, mesh=t8)),
        ("grams", "grams", dict(base, mesh=t8)),
        ("traces", "footprint", dict(base, mesh=t8, grams=np.asarray(grams),
                                     c1=np.asarray(c1), runs=TRACE_RUNS)),
        ("shapes", "mesh_shapes", dict(shapes=[(2, 4, 1), (1, 2, 4)])),
        ("fields", "shard_fields", dict(base, mesh=t8)),
        ("batched", "batched", dict(
            base, mesh=bt, states=[st, _np_state(state1)],
            videos=np.stack([v, np.asarray(video1)]), mu_iters=5)),
        ("refine", "refine", dict(base, mesh=t8, kw=dict(
            rounds=2, epochs=4, mu_iters=5, frame_block=4))),
        ("engine", "engine", dict(
            model=MODEL, opt=ENGINE_OPT, state=_np_state(eng.state),
            runtime=dict(frame_block=4, mesh_time=8),
            video=np.asarray(_engine_video()),
            calls=[("update_motion", dict(epochs=3)),
                   ("update_footprints", dict(iters=10)),
                   ("refine", dict(rounds=1, epochs=3, mu_iters=3))])),
        ("kernels_motion", "motion", dict(base, mesh=bt, use_kernels=True)),
        ("kernels_grams", "grams", dict(base, mesh=bt, use_kernels=True)),
        ("pod_check", "pod_check", {}),
    ]
    return W.spawn(cases, WORLD, tmp_path_factory.mktemp("pg"))


def _get(port, name):
    res = port[name]
    if "error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res['error']}")
    return res


def test_sharded_motion_epoch_matches_jax(port):
    model, optimizer, state, video = _setup()
    mesh = make_mesh(num_time=8)
    sh_state, sh_m = sharded_motion_epoch(
        shard_state(state, mesh), shard_video(video, mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4)
    got = _get(port, "motion")
    np.testing.assert_allclose(got["beta"], np.asarray(sh_state.beta),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["recon_mse"], float(sh_m["recon_mse"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["reg"], float(sh_m["reg"]), rtol=1e-5)


def test_sharded_grams_match_jax(port):
    model, optimizer, state, video = _setup()
    mesh = make_mesh(num_time=8)
    sh_g, sh_c1 = sharded_compute_grams(
        shard_state(state, mesh), shard_video(video, mesh), model,
        mesh=mesh, frame_block=4)
    got = _get(port, "grams")
    np.testing.assert_allclose(got["grams"], np.asarray(sh_g), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["c1"], np.asarray(sh_c1), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("run", sorted(TRACE_RUNS))
def test_sharded_trace_updates_match_jax(port, run):
    """The MU halo (gamma > 0), MU without smoothing and FISTA with and
    without the halo (the maximum of the ranks' Lipschitz bounds), each
    against JAX's sharded update of the same single-device Grams."""
    model, optimizer, state, video = _setup()
    mesh = make_mesh(num_time=8)
    grams, c1 = M.compute_grams(state, video, model, frame_block=4)
    iters, gamma, solver = TRACE_RUNS[run]
    sh = sharded_footprint_update(
        shard_state(state, mesh), shard_video(grams, mesh),
        shard_video(c1, mesh), mesh=mesh, iters=iters, gamma=gamma,
        solver=solver)
    np.testing.assert_allclose(_get(port, "traces")[run], np.asarray(sh.c),
                               rtol=1e-4, atol=1e-6)


def test_mesh_construction_and_helpers(port):
    """``make_mesh``'s axes, as ``test_mesh_construction``; the helpers
    inside the group; and outside a group the single-process answers
    (``test_distributed_helpers_single_host``)."""
    got = _get(port, "shapes")
    assert got[(2, 4, 1)] == {"batch": 2, "time": 4, "pixel": 1}
    assert got[(1, 2, 4)] == {"batch": 1, "time": 2, "pixel": 4}
    assert got["is_distributed"]
    assert got["summary"]["process_count"] == WORLD
    assert got["summary"]["process_index"] == 0
    assert got["summary"]["global_device_count"] == WORLD
    assert not tP.is_distributed()
    summary = tP.process_summary()
    assert summary["process_count"] == 1 and summary["process_index"] == 0
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tP.make_mesh(num_time=8)


def test_shard_state_splits_by_field_name(port):
    """``shard_state`` splits beta, the Adam moments and C by frames and
    replicates the rest, by field (the counterpart of
    ``test_state_specs_match_by_field_path_not_shape``); ``gather_state``
    gives the whole state back."""
    got = _get(port, "fields")
    t_loc = T // WORLD
    assert got["local_shapes"] == {
        "beta": (t_loc, 10, 3), "mu": (t_loc, 10, 3), "nu": (t_loc, 10, 3),
        "c": (K, t_loc), "pos": (K, 3), "sigma": (K,), "count": ()}
    assert all(got["roundtrip"].values()), got["roundtrip"]


def _batched_reference():
    model, optimizer, state0, video0 = _setup()
    state1, video1 = _second_recording(state0, video0, optimizer, 11)
    new, metrics = batched_round(
        stack_states([state0, state1]), jnp.stack([video0, video1]), model,
        optimizer, gamma=0.1, mu_iters=5, frame_block=4)
    return (model, [state0, state1], [video0, video1], new, metrics)


def test_batched_round_matches_jax():
    """``batched_round`` in one process (a loop over the recordings)
    against JAX's ``vmap``; with the kernels (their plain versions on the
    CPU) it is the same, as ``test_batched_round_pallas_matches_xla``
    holds JAX's Pallas path to its XLA one."""
    model, states, videos, new, metrics = _batched_reference()
    from dnmf_tpu_torch import config as tcfg

    tmodel = tcfg.ModelConfig(**MODEL)
    tstates = tP.stack_states([tM.state_from_numpy(_np_state(s))
                               for s in states])
    tvideos = torch.as_tensor(np.stack([np.asarray(v) for v in videos]))
    for use_kernels in (False, True):
        got, m = tP.batched_round(tstates, tvideos, tmodel, tM.Adam(1e-3),
                                  0.1, 5, frame_block=4,
                                  use_kernels=use_kernels)
        assert m["recon_mse"].shape == (2,)
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(new.beta),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.c.numpy(),
                                   np.asarray(new.c), rtol=1e-4, atol=1e-6)


def test_batched_round_over_a_batch_axis_matches_jax(port):
    """The recordings split over a (batch 2 x time 4) mesh, results
    gathered on every rank."""
    _, _, _, new, metrics = _batched_reference()
    got = _get(port, "batched")
    np.testing.assert_allclose(got["beta"], np.asarray(new.beta), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["c"], np.asarray(new.c), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["recon_mse"],
                               np.asarray(metrics["recon_mse"]), rtol=1e-5)


def test_sharded_refined_rounds_matches_jax(port):
    model, optimizer, state, video = _setup()
    mesh = make_mesh(num_time=8, num_batch=1)
    sh_state, sh_pos, sh_m = sharded_refined_rounds(
        shard_state(state, mesh), shard_video(video, mesh), model, mesh,
        rounds=2, epochs=4, mu_iters=5, frame_block=4)
    got = _get(port, "refine")
    np.testing.assert_allclose(got["pos_t"], np.asarray(sh_pos), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["c"], np.asarray(sh_state.c), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["recon_mse"],
                               np.asarray(sh_m["recon_mse"]), rtol=1e-4,
                               atol=1e-7)


def _close(got, ref, tol):
    """``max|got - ref| <= tol * max|ref|``: the port's cross-package
    tolerance for whole Adam epochs (``tests/test_torch_port_model.py``),
    where the first Adam steps (about ``lr * sign(g)``) turn float32
    reorderings of near-zero gradient entries into ~3e-5 of beta."""
    ref = np.asarray(ref)
    err = float(np.max(np.abs(np.asarray(got) - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def test_engine_with_mesh_matches_jax(port):
    """``DeformableNMF`` with ``mesh_time=8`` (the audit and closed-form
    Grams of ``gram_mode="auto"``, the halo), after the trace update and
    after the refinement: against the port's single-device engine from
    the same state at the JAX test's sharded == single tolerances, and
    against JAX's mesh engine at the port's cross-package ones."""
    from dnmf_tpu_torch import config as tcfg
    from dnmf_tpu_torch.engine import trainer as ttr

    mc = ModelConfig(**MODEL)
    eng = DeformableNMF(mc, OptimizerConfig(**ENGINE_OPT),
                        RuntimeConfig(frame_block=4, mesh_time=8),
                        positions=_engine_pos())
    one = ttr.DeformableNMF(tcfg.ModelConfig(**MODEL),
                            tcfg.OptimizerConfig(**ENGINE_OPT),
                            tcfg.RuntimeConfig(frame_block=4), device="cpu")
    one.state = tM.state_from_numpy(_np_state(eng.state))
    one._base_sigma = one.state.sigma
    video = _engine_video()
    got = _get(port, "engine")
    assert got["gram_mode"] == eng._gram_mode == one._gram_mode == "analytic"
    for e in (eng, one):
        e.update_motion(np.asarray(video), epochs=3)
        e.update_footprints(np.asarray(video), iters=10)
    mid, end = got["after"][1], got["after"][2]
    np.testing.assert_allclose(mid["beta"], one.state.beta.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(mid["c"], one.traces, rtol=1e-4, atol=1e-6)
    _close(mid["beta"], eng.state.beta, 1e-4)
    _close(mid["c"], eng.traces, 1e-4)
    audits = [m for m in got["metrics"] if m["phase"] == "gram_audit"]
    for ref in (eng, one):
        raudits = [m for m in ref.metrics if m["phase"] == "gram_audit"]
        assert [a["frame"] for a in audits] == [a["frame"] for a in raudits]
        np.testing.assert_allclose(audits[0]["rel_err"],
                                   raudits[0]["rel_err"], rtol=1e-2)
    for e in (eng, one):
        e.refine(np.asarray(video), rounds=1, epochs=3, mu_iters=3)
    np.testing.assert_allclose(end["pos_t"], one.pos_t.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(end["c"], one.traces, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(end["result"]["c"], end["c"])
    _close(end["pos_t"], eng.pos_t, 1e-4)
    _close(end["c"], eng.traces, 1e-4)
    np.testing.assert_allclose(got["positions"], one.positions_all(),
                               rtol=1e-5, atol=1e-5)


def test_sharded_kernels_match_jax_interpret(port):
    """The kernel passes inside the ranks (their plain versions on the
    CPU) on a time-4 axis, against JAX's Pallas kernels in interpret mode
    inside ``shard_map``."""
    model, optimizer, state, video = _setup()
    mesh = make_mesh(num_time=4)
    sh_state, _ = sharded_motion_epoch(
        shard_state(state, mesh), shard_video(video, mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4, use_pallas=True,
        pallas_interpret=True)
    np.testing.assert_allclose(_get(port, "kernels_motion")["beta"],
                               np.asarray(sh_state.beta), rtol=1e-4,
                               atol=1e-5)
    sh_g, sh_c1 = sharded_compute_grams(
        shard_state(state, mesh), shard_video(video, mesh), model,
        mesh=mesh, frame_block=4, use_pallas=True, pallas_interpret=True)
    got = _get(port, "kernels_grams")
    np.testing.assert_allclose(got["grams"], np.asarray(sh_g), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["c1"], np.asarray(sh_c1), rtol=1e-4,
                               atol=1e-5)


def test_pod_check_passes_on_the_group(port):
    """The 14 equalities of ``dnmf_tpu_torch.tools.pod_check`` on the
    8-rank group."""
    assert _get(port, "pod_check")["failed"] == []
