"""The compiled-program layer's refinement, width-fit and recordings
programs (``graphs.refine_positions``, ``tracked_grams``,
``refined_rounds``, ``sigma_fit``, ``batched_round``) on the CPU, where
an entry keeps its step function and calls it eagerly on its static
buffers.

* The launch accounting on a made-up node table: wrappers that end in
  one kernel (``c1_block`` and ``c1_block_tracked`` in ``c1_finish``)
  are summed against its nodes.
* The host probe of ``tests/test_torch_port_graphs.py`` over the four
  programs' steps: no tensor made from host data, no host read.
* One entry per program for every round of ``refined_rounds``; the
  trainer's ``refine`` and ``fit(fit_sigma=True)`` through the cache,
  ``graphs.disabled()`` around it, and on a one-rank mesh; returned
  tensors that share no storage with the cache.
* Through the cache against the JAX package's plain XLA path, at the
  tolerances of ``tests/test_torch_port_refine.py`` (positions 1e-4 px;
  C and recon_mse 1e-4 of the reference's max; sigma 3e-4, its mse
  1e-4) and ``tests/test_torch_port_batched.py`` (beta rtol 1e-5 / atol
  1e-7, C rtol 1e-4 / atol 1e-6), and bit for bit against the port's
  eager loop.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.models import refine as jR
from dnmf_tpu.parallel.batched import batched_round as jax_batched_round
from dnmf_tpu.parallel.batched import stack_states as jax_stack_states
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import parallel as tP
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.models import refine as tR
from dnmf_tpu_torch.ops import mu as mu_ops

import test_torch_port_batched as B
import test_torch_port_graphs as G
import test_torch_port_refine as RF

FB = RF.FB  # 3 of T = 7 frames: the last frame block is short
IDX = np.array([0, 2, 3, 6])  # the width fit's frames
PROGRAMS = ("refine_positions", "tracked_grams", "footprint_update")


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_flat(a), _flat(b)))


def _flat(out):
    if isinstance(out, tM.DNMFState):
        return [getattr(out, f) for f in tM.STATE_FIELDS]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _flat(part)]
    return [out]


def _names():
    return sorted(e.name for e in graphs.entries())


# ------------------------------------------------------- launch accounting
# Kernel nodes by (made-up) mangled name: two wrappers end in c1_finish,
# and the table and elementwise kernels belong to no wrapper.
NODES = {"_Z13motion_bricksILi5EEvPKfS1_": 4, "_Z13motion_finishPKfPfS1_": 4,
         "_Z9c1_bricksILi3EEvPKf": 5, "_Z9c1_finishPKfPf": 5,
         "_Z13gram_assemblePKfS0_PKiPfS3_": 2, "_Z11build_tablePKf": 11,
         "_Z13refine_finishILi3EEvPKf": 3,
         "void at::native::vectorized_elementwise_kernel": 40}
COUNTED = {"motion_block": 4, "c1_block": 2, "c1_block_tracked": 3,
           "gram_block": 0, "gram_block_tracked": 2, "refine_block": 3,
           "phase_corr_block": 0}


@pytest.mark.parametrize("shift", [None, ("c1_block", "c1_block_tracked"),
                                   ("gram_block_tracked", "gram_block")])
def test_replay_launches_sum_wrappers_that_share_a_kernel(shift):
    counted = dict(COUNTED)
    if shift is not None:  # one launch moved between twins: same nodes
        counted[shift[0]] -= 1
        counted[shift[1]] += 1
    got = graphs.replay_launches(NODES, counted)
    assert got == {k: n for k, n in counted.items() if n}


@pytest.mark.parametrize("wrong", [
    {"c1_block_tracked": 2},  # the c1_finish nodes outnumber the launches
    {"gram_block": 1},  # a launch the graph does not hold
    {"refine_block": 0},  # refine_finish nodes no wrapper launched
    {"phase_corr_block": 1},  # a wrapper without a last kernel
])
def test_replay_launches_raise_where_the_graph_differs(wrong):
    with pytest.raises(RuntimeError, match="differ"):
        graphs.replay_launches(NODES, {**COUNTED, **wrong})


# ------------------------------------------------------------- host probe
def _state(rng, scaling, sigma_axes):
    state, video = G._inputs(rng, scaling)
    if sigma_axes == 3:
        state = state.replace(sigma=torch.from_numpy(
            rng.uniform(1.5, 2.5, (G.K, 3)).astype(np.float32)))
    model = tcfg.ModelConfig(
        size=G.SIZE, num_neurons=G.K, num_frames=G.T, shape_std=2.0,
        sigma_axes=sigma_axes,
        deformation=tcfg.DeformationConfig(basis_scaling=scaling))
    return state, video, model


def _program_step(name, rng, scaling):
    """The eager step that a program captures, with the kernel wrappers
    (their plain versions on CPU tensors), as a call."""
    state, video, model = _state(rng, scaling, 3 if name.endswith("3") else 1)
    pos_t = (state.pos + 0.3 * torch.from_numpy(rng.normal(
        size=(G.T, G.K, 3)).astype(np.float32))).contiguous()
    if name == "refine_positions":
        return lambda: tR.refine_positions(state, pos_t, video, model,
                                           epochs=2, frame_block=FB,
                                           use_kernels=True)
    if name.startswith("tracked"):
        return lambda: tR.tracked_grams(state, pos_t, video, model, FB, True,
                                        name.split("_")[1])
    if name.startswith("sigma"):
        idx = torch.from_numpy(IDX)
        return lambda: tM.sigma_fit(state, video[idx], state.beta[idx],
                                    state.c[:, idx].T, model, steps=2,
                                    frame_block=3, use_kernels=True)
    states = tP.stack_states([state, _state(rng, scaling, 1)[0]])
    videos = torch.stack([video, video.flip(0)])
    return lambda: tM.fused_round(states, videos, model, tM.Adam(1e-3),
                                  epochs=1, mu_iters=3, gamma=0.1,
                                  frame_block=FB, use_kernels=True,
                                  gram_mode=name.split("_")[1])


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("program", [
    "refine_positions", "tracked_exact", "tracked_analytic", "sigma_1",
    "sigma_3", "batched_exact", "batched_analytic"])
def test_programs_make_no_host_tensor_and_read_nothing(rng, program,
                                                       scaling):
    run = _program_step(program, rng, scaling)
    with G._HostProbe() as probe:
        run()
    assert probe.hits == [], probe.hits


# -------------------------------------------------------- keys and routing
@pytest.mark.parametrize("mode", ["exact", "analytic"])
def test_refined_rounds_make_one_entry_per_program(rng, mode):
    jm, tm, js, ts, video = RF._pair(rng)
    kw = dict(rounds=3, epochs=2, mu_iters=5, frame_block=FB,
              use_kernels=True, gram_mode=mode)
    got = graphs.refined_rounds(ts, torch.from_numpy(video), tm, **kw)
    assert _names() == sorted(PROGRAMS)
    assert [e.replays for e in graphs.entries()] == [3, 3, 3]
    # Round 1 starts from the anchors (a stride-0 view), rounds 2 and 3
    # from the positions: one key.  A second call replays the same three.
    graphs.refined_rounds(ts, torch.from_numpy(video), tm,
                          pos_t=got[1], **kw)
    assert [e.replays for e in graphs.entries()] == [6, 6, 6]
    ref = tR.refined_rounds(ts, torch.from_numpy(video), tm, **kw)
    assert _same(got, ref)


@pytest.mark.parametrize("solver", ["mu", "fista"])
def test_refine_trace_update_is_footprint_update_without_gamma(rng, solver):
    """``refined_rounds``' trace update (MU or FISTA called directly) is
    ``footprint_update`` with ``gamma=0``, whose entry the cached rounds
    use."""
    state, video = G._inputs(rng)
    g, c1 = tR.tracked_grams(state, state.pos.expand(G.T, G.K, 3), video,
                             G._model(), FB, True)
    solve = mu_ops.nnls_temporal if solver == "fista" else \
        mu_ops.run_mu_temporal
    direct = solve(state.c, g, c1, iters=7)
    assert torch.equal(tM.footprint_update(state, g, c1, 7, 0.0, solver).c,
                       direct)
    assert torch.equal(graphs.footprint_update(state, g, c1, 7, 0.0, solver,
                                               True).c, direct)


def _engine(rng, runtime=None, **opt):
    jt, tt, video = RF._trainers(rng, runtime=dict(use_kernels=True,
                                                   **(runtime or {})), **opt)
    return tt, video


def _strip(metrics):
    return [{k: v for k, v in m.items() if k != "seconds"} for m in metrics]


def test_trainer_refine_and_width_fit_go_through_the_cache(rng):
    runs = []
    for cached in (True, False):
        graphs.clear()
        eng, video = _engine(np.random.default_rng(5))
        with contextlib.nullcontext() if cached else graphs.disabled():
            eng.fit(video)
            res = eng.refine(video, rounds=3, epochs=3, mu_iters=5)
        runs.append((eng, res, {e.name: e.replays for e in graphs.entries()}))
    (eng, got, entries), (eng_e, ref, none) = runs
    assert none == {}
    # fit: 3 rounds (the first annealed), the widths fitted in rounds 2
    # and 3; refine: 3 rounds through one entry per program.
    assert entries["sigma_fit"] == 2
    assert all(entries[name] == 3 for name in PROGRAMS[:2])
    assert _same(got.state, ref.state) and torch.equal(eng.pos_t, eng_e.pos_t)
    assert _strip(got.metrics) == _strip(ref.metrics)


def test_trainer_keeps_a_run_under_max_entries(rng):
    """``fit(fit_sigma)`` and ``refine`` of one engine, then ``fit_fused``
    of another on the same video, stay under ``MAX_ENTRIES``: nothing is
    dropped (the cache drops only past it) and no entry is captured
    twice."""
    eng, video = _engine(rng, runtime=dict(gram_mode="auto"))
    eng.fit(video)
    eng.refine(video, rounds=2, epochs=2, mu_iters=5)
    other, _ = _engine(rng, fit_sigma=False)
    other.fit_fused(video)
    replays = {e.name: e.replays for e in graphs.entries()}
    assert len(graphs.entries()) < graphs.MAX_ENTRIES
    assert replays["motion_epoch"] == 3 * 2 and replays["sigma_fit"] == 2
    assert replays["refine_positions"] == 2 and replays["fused_round"] == 3


def test_mesh_runs_eagerly(tmp_path, rng):
    """On a mesh (here a one-rank ``gloo`` group) the width fit, refine and
    the recordings round go through the entries of one device, and the
    sharded epoch, Grams and trace update through the mesh's: bit for bit
    the ``graphs.disabled()`` run, which makes none."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    runs = []
    try:
        for cached in (True, False):
            graphs.clear()
            eng, video = _engine(np.random.default_rng(5),
                                 runtime=dict(mesh_time=1))
            inp = B._inputs(6, aniso=False)
            with contextlib.nullcontext() if cached else graphs.disabled():
                eng.fit(video)
                res = eng.refine(video, rounds=2, epochs=2, mu_iters=5)
                rec = tP.batched_round(
                    B._port_states(inp), B._t(inp["videos"]),
                    B._model(6, False, tcfg.ModelConfig), tM.Adam(1e-3), 0.1,
                    3, frame_block=FB, use_kernels=True,
                    mesh=tP.make_mesh(num_time=1))
            runs.append((res, eng.pos_t, rec, {
                e.name: e.replays for e in graphs.entries()}))
    finally:
        dist.destroy_process_group()
    (got, pos_t, rec, entries), (ref, pos_e, rec_e, none) = runs
    assert none == {}
    # fit: 3 rounds (the first annealed) of 2 epochs, the widths fitted in
    # rounds 2 and 3; refine: 2 rounds through one entry per program.
    assert entries["sharded_motion_epoch"] == 6
    assert entries["sigma_fit"] == 2 and entries["batched_round"] == 1
    assert all(entries[name] == 2 for name in PROGRAMS)
    assert _same(got.state, ref.state) and torch.equal(pos_t, pos_e)
    assert _same(rec, rec_e)
    assert _strip(got.metrics) == _strip(ref.metrics)


def test_returned_tensors_share_no_storage_with_the_cache(rng):
    jm, tm, js, ts, video = RF._pair(rng)
    video = torch.from_numpy(video)
    idx = torch.from_numpy(IDX)
    pos, m = graphs.refine_positions(ts, None, video, tm, epochs=2,
                                     frame_block=FB, use_kernels=True)
    g, c1 = graphs.tracked_grams(ts, pos, video, tm, FB, True, "analytic")
    sig, mses = graphs.sigma_fit(ts, video[idx], ts.beta[idx],
                                 ts.c[:, idx].T, tm, steps=2, frame_block=3,
                                 use_kernels=True)
    states = tP.stack_states([ts, ts.replace(c=ts.c.flip(1))])
    videos = torch.stack([video, video.flip(0)])
    st, bm = tP.batched_round(states, videos, tm, tM.Adam(1e-3), 0.1, 3,
                              frame_block=FB, use_kernels=True)
    handed = [pos, *m.values(), g, c1, sig, mses, *bm.values(),
              *[getattr(st, f) for f in ("beta", "c", "count", "mu", "nu")]]
    kept = [t for e in graphs.entries() for t in e.inputs + e.outputs]
    assert not G._storages(handed) & G._storages(kept)
    before = [t.clone() for t in handed]
    graphs.refine_positions(ts, pos, video, tm, epochs=2, frame_block=FB,
                            use_kernels=True)
    graphs.sigma_fit(ts, video[idx], ts.beta[idx], ts.c[:, idx].T, tm,
                     steps=2, frame_block=3, use_kernels=True)
    tP.batched_round(st, videos, tm, tM.Adam(1e-3), 0.1, 3, frame_block=FB,
                     use_kernels=True)
    assert all(torch.equal(a, b) for a, b in zip(handed, before))
    # Fields that the round does not change are the caller's own tensors.
    assert st.pos is states.pos and st.sigma is states.sigma


# ---------------------------------------------------- against the JAX package
@pytest.mark.parametrize("solver", ["mu", "fista"])
@pytest.mark.parametrize("mode", ["exact", "analytic"])
def test_refined_rounds_through_the_cache_match_jax(rng, mode, solver):
    jm, tm, js, ts, video = RF._pair(rng)
    kw = dict(rounds=2, epochs=4, mu_iters=10, learning_rate=0.05,
              prior=3e-4, frame_block=FB, gram_mode=mode,
              trace_solver=solver)
    js2, pos_r, m_r = jR.refined_rounds(js, jnp.asarray(video), jm, **kw)
    ts2, pos, m = graphs.refined_rounds(ts, torch.from_numpy(video), tm,
                                        use_kernels=True, **kw)
    assert _names() == sorted(PROGRAMS)
    RF.close_abs(pos, pos_r, 1e-4)
    RF.close(ts2.c, js2.c, 1e-4)
    RF.close(m["recon_mse"], m_r["recon_mse"], 1e-4)
    ref = tR.refined_rounds(ts, torch.from_numpy(video), tm,
                            use_kernels=True, **kw)
    assert _same((ts2, pos, m), ref)


@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_sigma_fit_through_the_cache_matches_jax(rng, sigma_axes):
    jm, tm, js, ts, video = RF._pair(rng, sigma_axes)
    kw = dict(steps=5, lr=0.05, lo=1.0, hi=3.2, frame_block=3)
    sig_r, mse_r = jM.sigma_fit(js, jnp.asarray(video[IDX]), js.beta[IDX],
                                js.c[:, IDX].T, jm, **kw)
    args = (ts, torch.from_numpy(video[IDX]), ts.beta[IDX], ts.c[:, IDX].T,
            tm)
    for call in range(2):  # the entry's first call, then a replay
        sig, mse = graphs.sigma_fit(*args, use_kernels=True, **kw)
        RF.close(sig, sig_r, 3e-4)
        RF.close(mse, mse_r, 1e-4)
    (entry,) = graphs.entries()
    assert entry.name == "sigma_fit" and entry.replays == 2
    assert _same((sig, mse), tM.sigma_fit(*args, use_kernels=True, **kw))


@pytest.mark.parametrize("gram_mode", ["exact", "analytic"])
def test_batched_round_through_the_cache_matches_jax(gram_mode):
    k = B.KS[0]
    inp = B._inputs(k, aniso=False)
    optimizer = optax.adam(B.LR, b1=0.9, b2=0.999, eps=1e-8)
    jstates = jax_stack_states([
        jM.DNMFState(beta=jnp.asarray(d["beta"]), c=jnp.asarray(d["c"]),
                     pos=jnp.asarray(d["pos"]), sigma=jnp.asarray(d["sigma"]),
                     opt_state=optimizer.init(jnp.asarray(d["beta"])))
        for d in B._np_states(inp)])
    kw = dict(frame_block=FB, gram_mode=gram_mode)  # T = 8: short last block
    new, metrics = jax_batched_round(
        jstates, jnp.asarray(inp["videos"]), B._model(k, False,
                                                      B.ModelConfig),
        optimizer, B.GAMMA, B.MU_ITERS, **kw)
    model = B._model(k, False, tcfg.ModelConfig)
    videos = B._t(inp["videos"])
    got, m = graphs.batched_round(B._port_states(inp), videos, model,
                                  tM.Adam(B.LR), B.GAMMA, B.MU_ITERS,
                                  use_kernels=True, **kw)
    (entry,) = graphs.entries()
    assert entry.name == "batched_round"
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(new.beta),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got.c.numpy(), np.asarray(new.c),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(m["recon_mse"].numpy(),
                               np.asarray(metrics["recon_mse"]), rtol=1e-5)
    # parallel.batched_round without a mesh is this entry; eager, the same
    # bits.
    again = tP.batched_round(B._port_states(inp), videos, model,
                             tM.Adam(B.LR), B.GAMMA, B.MU_ITERS,
                             use_kernels=True, **kw)
    assert entry.replays == 2 and _same(again, (got, m))
    with graphs.disabled():
        eager = tP.batched_round(B._port_states(inp), videos, model,
                                 tM.Adam(B.LR), B.GAMMA, B.MU_ITERS,
                                 use_kernels=True, **kw)
    assert _same(eager, (got, m))
