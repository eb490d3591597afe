"""A mesh's steps through the compiled-program layer: each rank replays
its local work between two collectives as captured entries
(``models.graphs.mesh_steps`` and the entries of one device), the
collectives running eagerly between the replays.

One 4-rank CPU ``gloo`` group (``tests/torch_dist_workers.py``, one
start-up for the file), where an entry keeps its step function and calls
it eagerly on its static buffers, runs each case twice on every rank:
through the cache, every replay under the host probe of
``tests/torch_host_probe.py``, and inside ``graphs.disabled()``.

* Captured == eager bit for bit on every rank: the sharded epoch, Grams
  (exact and closed form) and trace updates (MU and FISTA, with and
  without the halo) on time 4, time 2 x pixel 2 and batch 2 x time 2
  meshes; the streamed epoch, Grams and halo'd update on a
  ``StreamingVideo`` (time 2 x pixel 2) and a ``RawFileVideo`` whose
  last block is padded (time 4); refinement; the recordings round over a
  batch axis; rigid and pw-rigid registration; three engines (``fit``
  with the width fit, ``refine``, a streamed ``fit``).
* The entries each case makes and their replays (a smoothed update one
  replay per iteration, a streamed step one per block).
* The host probe finds no tensor made from host data, no host read and
  no collective inside any replayed step, and does see the collectives
  run between them.
* The captured steps against the JAX package's sharded functions on its
  CPU mesh, at ``tests/test_torch_port_parallel.py``'s tolerances:
  kernel passes (their plain versions here) rtol 1e-4 / atol 1e-5,
  trace updates rtol 1e-4 / atol 1e-6, the recordings round rtol 1e-5 /
  atol 1e-7 (C rtol 1e-4 / atol 1e-6); registration shifts and templates
  atol 1e-4, movies 1e-3 (``tests/test_torch_port_parallel_stream.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_port_parallel as PAR
import test_torch_port_parallel_stream as PST
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
    sharded_register_pwrigid,
    sharded_register_rigid,
)
from dnmf_tpu.parallel.sharded import sharded_refined_rounds

WORLD = 4
T4, TP, BT = (1, 4, 1), (1, 2, 2), (2, 2, 1)  # (batch, time, pixel)
MODEL, T, SIZE = PAR.MODEL, PAR.T, PAR.SIZE
BLOCK = 3  # divides neither 4 nor 8 frames per rank: a padded last block
TRACE_RUNS = PAR.TRACE_RUNS
REG = {"rigid": PST.REG["rigid"],
       "pwrigid": dict(PST.REG["pwrigid"], frame_block=3)}  # 3 + 1 frames
ENGINE_OPT = dict(learning_rate=1e-3, motion_epochs=2, mu_iters=5,
                  outer_rounds=2, gamma_motion=0.1, gamma_traces=0.01,
                  fit_sigma=True, sigma_every=1, sigma_steps=2,
                  sigma_frames=5)
ENGINES = {
    "engine_tp": (dict(mesh_time=2, mesh_pixel=2, gram_mode="exact"),
                  {}, [("fit", {})]),
    "engine_t4": (dict(mesh_time=4, gram_mode="auto"),
                  dict(trace_solver="fista"),
                  [("fit", {}), ("refine", dict(rounds=2, epochs=2,
                                                mu_iters=3))]),
    "engine_bt": (dict(mesh_time=2, mesh_batch=2, gram_mode="exact"),
                  dict(trace_solver="fista", gamma_traces=0.0,
                       fit_sigma=False), [("fit", {})]),
    "engine_stream": (dict(mesh_time=4, gram_mode="exact"), {},
                      [("fit", {})]),
}
# Per case, every rank's entries and their replays: (name, replays).
MESH_STEPS = {"compute_grams": 1, "sharded_motion_epoch": 1}
STEPS_T4 = dict(MESH_STEPS, sharded_mu_halo=15, sharded_mu=1,
                sharded_fista=1, sharded_fista_halo=25)
STEPS_TP = {"compute_grams": 1, "sharded_frame_grads": 1, "sharded_adam": 1,
            "sharded_mu_halo": 15}
STEPS_BT = dict(MESH_STEPS, sharded_fista_halo=25)
ENTRIES = {
    "steps_t4": STEPS_T4, "steps_tp": STEPS_TP, "steps_bt": STEPS_BT,
    # T_loc 8 in blocks of 3 (3 blocks); 4 in blocks of 3 (2 blocks).
    "stream_tp": {"sharded_motion_epoch_streaming": 3,
                  "sharded_compute_grams_streaming": 3,
                  "sharded_mu_halo": 5},
    "stream_raw": {"sharded_motion_epoch_streaming": 2,
                   "sharded_compute_grams_streaming": 2,
                   "sharded_mu_halo": 5},
    "refine": {"refine_positions": 2, "tracked_grams": 2,
               "footprint_update": 2},
    "batched": {"batched_round": 1},
    # Rigid: 4 one-frame blocks in each of 2 iterations; pw-rigid: a
    # 3-frame and a 1-frame block, one iteration.
    "reg_rigid": [("rigid_block", 8)],
    "reg_pwrigid": [("pwrigid_block", 1), ("pwrigid_block", 1)],
    # 2 rounds x 2 epochs; one Gram pass, one trace update (5 iterations
    # of the halo'd MU) and one width fit per round.
    "engine_tp": {"sharded_frame_grads": 4, "sharded_adam": 4,
                  "compute_grams": 2, "sharded_mu_halo": 10, "sigma_fit": 2},
    "engine_t4": {"sharded_motion_epoch": 4, "compute_grams": 2,
                  "sharded_fista_halo": 10, "sigma_fit": 2,
                  "refine_positions": 2, "tracked_grams": 2,
                  "footprint_update": 2},
    "engine_bt": {"sharded_motion_epoch": 4, "compute_grams": 2,
                  "sharded_fista": 2},
    "engine_stream": {"sharded_motion_epoch_streaming": 8,
                      "sharded_compute_grams_streaming": 4,
                      "sharded_mu_halo": 10, "sigma_fit": 2},
}
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)
TRACE_TOL = dict(rtol=1e-4, atol=1e-6)


def _engine_inputs(name):
    runtime, opt, calls = ENGINES[name]
    opt = dict(ENGINE_OPT, **opt)
    eng = DeformableNMF(ModelConfig(**MODEL), OptimizerConfig(**opt),
                        RuntimeConfig(frame_block=4),
                        positions=PAR._engine_pos())
    video = np.asarray(PAR._engine_video())
    return dict(model=MODEL, opt=opt, state=PAR._np_state(eng.state),
                runtime=dict(frame_block=4, **runtime), calls=calls,
                video=video.reshape((T,) + SIZE))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case of this file on one 4-rank process group."""
    tmp = tmp_path_factory.mktemp("pg")
    model, optimizer, state, video = PAR._setup()
    st, v = PAR._np_state(state), np.asarray(video)
    grams, c1 = M.compute_grams(state, video, model, frame_block=4)
    state1, video1 = PAR._second_recording(state, video, optimizer, 11)
    base = dict(model=MODEL, state=st, video=v, lr=1e-3, gamma=0.1,
                frame_block=4, grams=np.asarray(grams), c1=np.asarray(c1))
    stream = dict(base, video=v.reshape((T,) + SIZE), block=BLOCK,
                  mu_iters=5, mu_gamma=0.01)
    tmpl, _, rvideo = PST._reg_video()
    cases = [
        ("steps_t4", "captured_steps", dict(
            base, mesh=T4, gram_mode="analytic", runs=TRACE_RUNS)),
        ("steps_tp", "captured_steps", dict(
            base, mesh=TP, gram_mode="exact",
            runs={"halo": TRACE_RUNS["halo"]})),
        ("steps_bt", "captured_steps", dict(
            base, mesh=BT, gram_mode="exact",
            runs={"fista5": TRACE_RUNS["fista5"]})),
        ("stream_tp", "captured_stream", dict(stream, mesh=TP)),
        ("stream_raw", "captured_stream", dict(
            stream, mesh=T4, raw=str(tmp / "video.raw"))),
        ("refine", "captured_refine", dict(base, mesh=T4, kw=dict(
            rounds=2, epochs=3, mu_iters=5, frame_block=4))),
        ("batched", "captured_batched", dict(
            base, mesh=BT, states=[st, PAR._np_state(state1)],
            videos=np.stack([v, np.asarray(video1)]), mu_iters=5)),
        ("probe", "probe_collectives", dict(mesh=T4)),
    ]
    for name, cfg in REG.items():
        cases.append((f"reg_{name}", "captured_register", dict(
            mesh=T4, cfg=cfg, video=rvideo, template=tmpl,
            fn=f"sharded_register_{name}")))
    for name in ENGINES:
        inp = _engine_inputs(name)
        if name == "engine_stream":
            inp.update(block=BLOCK, raw=str(tmp / "engine.raw"))
        cases.append((name, "captured_engine", inp))
    return W.spawn(cases, WORLD, tmp / "ranks")


def _get(port, name):
    res = port[name]
    if "error" in res:
        pytest.fail(f"case {name} raised on the ranks:\n{res['error']}")
    return res


@pytest.mark.parametrize("case", sorted(ENTRIES))
def test_captured_equals_eager_on_every_rank(port, case):
    assert _get(port, case)["equal"] == [True] * WORLD


@pytest.mark.parametrize("case", sorted(ENTRIES))
def test_entries_and_replays(port, case):
    """Every rank makes the same entries, each replayed once per call,
    iteration or block."""
    want = ENTRIES[case]
    if isinstance(want, dict):
        want = sorted(want.items())
    assert _get(port, case)["entries"] == [want] * WORLD


@pytest.mark.parametrize("case", sorted(ENTRIES))
def test_no_host_tensor_read_or_collective_inside_a_step(port, case):
    assert _get(port, case)["hits"] == []


def test_the_probe_sees_the_collectives_between_the_steps(port):
    assert _get(port, "probe")["ops"] == ["c10d.allgather_.default",
                                          "c10d.allreduce_.default"]


@pytest.mark.parametrize("case,mesh_shape", [
    ("steps_t4", T4), ("steps_tp", TP), ("steps_bt", BT)])
def test_captured_steps_match_jax(port, case, mesh_shape):
    """The captured epoch, Grams and trace updates against JAX's sharded
    functions on the same mesh shape."""
    model, optimizer, state, video = PAR._setup()
    b, t, p = mesh_shape
    mesh = make_mesh(num_time=t, num_batch=b, num_pixel=p)
    got = _get(port, case)["got"]
    st, m = sharded_motion_epoch(
        shard_state(state, mesh), shard_video(video, mesh), model,
        optimizer, gamma=0.1, mesh=mesh, frame_block=4)
    np.testing.assert_allclose(got["beta"], np.asarray(st.beta), **KERNEL_TOL)
    np.testing.assert_allclose(got["recon_mse"], float(m["recon_mse"]),
                               rtol=1e-4)
    mode = "analytic" if case == "steps_t4" else "exact"
    g, c1 = sharded_compute_grams(
        shard_state(state, mesh), shard_video(video, mesh), model, mesh=mesh,
        frame_block=4, gram_mode=mode)
    np.testing.assert_allclose(got["grams"], np.asarray(g), **KERNEL_TOL)
    np.testing.assert_allclose(got["c1"], np.asarray(c1), **KERNEL_TOL)
    # The trace update on the time axis alone (the other axes' ranks
    # repeat it), from the single-device Grams of the workers' inputs.
    grams, c1 = M.compute_grams(state, video, model, frame_block=4)
    mesh = make_mesh(num_time=t)
    for label, (iters, gamma, solver) in TRACE_RUNS.items():
        if label not in got:
            continue
        sh = sharded_footprint_update(
            shard_state(state, mesh), shard_video(grams, mesh),
            shard_video(c1, mesh), mesh=mesh, iters=iters, gamma=gamma,
            solver=solver)
        np.testing.assert_allclose(got[label], np.asarray(sh.c),
                                   **TRACE_TOL)


@pytest.mark.parametrize("case", ["stream_tp", "stream_raw"])
def test_captured_streamed_steps_match_jax(port, case):
    """The streamed epoch, Grams and halo'd update (its padded last block
    included) against JAX's dense single-device path, as
    ``test_sharded_streaming_matches_dense``."""
    model, optimizer, state, video = PAR._setup()
    dense, m = M.motion_epoch_parallel(state, video, model, optimizer,
                                       gamma=0.1, frame_block=4)
    grams, c1 = M.compute_grams(dense, video, model, frame_block=4)
    final = M.footprint_update(dense, grams, c1, iters=5, gamma=0.01)
    got = _get(port, case)["got"]
    np.testing.assert_allclose(got["beta"], np.asarray(dense.beta),
                               **KERNEL_TOL)
    np.testing.assert_allclose(got["recon_mse"], float(m["recon_mse"]),
                               rtol=1e-4)
    np.testing.assert_allclose(got["grams"], np.asarray(grams), **KERNEL_TOL)
    np.testing.assert_allclose(got["c1"], np.asarray(c1), **KERNEL_TOL)
    np.testing.assert_allclose(got["c_final"], np.asarray(final.c),
                               **TRACE_TOL)


def test_captured_refinement_matches_jax(port):
    model, optimizer, state, video = PAR._setup()
    mesh = make_mesh(num_time=4)
    st, pos_t, m = sharded_refined_rounds(
        shard_state(state, mesh), shard_video(video, mesh), model, mesh,
        rounds=2, epochs=3, mu_iters=5, frame_block=4)
    got = _get(port, "refine")["got"]
    np.testing.assert_allclose(got["pos_t"], np.asarray(pos_t), **KERNEL_TOL)
    np.testing.assert_allclose(got["c"], np.asarray(st.c), **TRACE_TOL)
    np.testing.assert_allclose(got["recon_mse"], np.asarray(m["recon_mse"]),
                               rtol=1e-4, atol=1e-7)


def test_captured_recordings_round_matches_jax(port):
    _, _, _, new, metrics = PAR._batched_reference()
    got = _get(port, "batched")["got"]
    np.testing.assert_allclose(got["beta"], np.asarray(new.beta), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got["c"], np.asarray(new.c), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got["recon_mse"],
                               np.asarray(metrics["recon_mse"]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(REG))
def test_captured_registration_matches_jax(port, name):
    tmpl, _, video = PST._reg_video()
    fn = {"rigid": sharded_register_rigid,
          "pwrigid": sharded_register_pwrigid}[name]
    from dnmf_tpu.config import RegistrationConfig

    templ, corrected, shifts = fn(
        jnp.asarray(video), RegistrationConfig(**REG[name]),
        make_mesh(num_time=4, num_batch=1), template=jnp.asarray(tmpl))
    got = _get(port, f"reg_{name}")["got"]
    np.testing.assert_allclose(got["shifts"], np.asarray(shifts), atol=1e-4)
    np.testing.assert_allclose(got["template"], np.asarray(templ), atol=1e-4)
    np.testing.assert_allclose(got["corrected"], np.asarray(corrected),
                               atol=1e-3)
