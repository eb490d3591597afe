"""The compiled-program layer (:mod:`dnmf_tpu_torch.models.graphs`) on the
CPU, where its entries keep the step functions and call them eagerly on
their static buffers.

* A ``TorchDispatchMode`` probe (``tests/torch_host_probe.py``) over the
  round's steps, through the kernel wrappers' CPU route: no tensor made
  from host data (``aten.lift_fresh``: a copy from pageable host memory,
  which a CUDA graph cannot hold), no host read
  (``aten._local_scalar_dense``) and no collective (``c10d.*``; a mesh's
  steps, ``tests/test_torch_port_graphs_mesh.py``).
* The cache's key and static-buffer protocol against the plain step
  functions, bit for bit.
* ``fused_rounds`` through that protocol against the JAX package's
  (plain XLA path), at ``test_torch_port_model.py``'s tolerances: 1e-4
  of the reference's max magnitude for the state after whole rounds,
  1e-5 for the per-round metrics.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_host_probe import HostProbe as _HostProbe

from dnmf_tpu import config as jcfg
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import graphs

SIZE = (16, 12, 4)
K, T, FB = 6, 7, 3  # the last frame block is short


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _model(scaling="normalized"):
    return tcfg.ModelConfig(
        size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0,
        deformation=tcfg.DeformationConfig(basis_scaling=scaling))


def _inputs(rng, scaling="normalized", t=T):
    """A state off the identity warps and a video, from numpy."""
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    beta = np.zeros((t, 10, 3), np.float32)
    beta[:, 1, 0] = beta[:, 2, 1] = beta[:, 3, 2] = 1.0
    beta += 0.01 * rng.normal(size=beta.shape).astype(np.float32)
    if scaling == "pixel":
        beta[:, 4:] *= 0.01
    state = tM.state_from_numpy({
        "beta": beta, "c": rng.uniform(0.2, 1.0, (K, t)), "pos": pos,
        "sigma": np.full(K, 2.0), "count": np.int32(3),
        "mu": 1e-3 * rng.normal(size=beta.shape),
        "nu": 1e-6 * rng.uniform(size=beta.shape)})
    video = rng.uniform(0, 1, (t, int(np.prod(SIZE)))).astype(np.float32)
    return state, torch.from_numpy(video)


def _same(a: tM.DNMFState, b: tM.DNMFState) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in tM.STATE_FIELDS)


def _step(name, state, video, model):
    """One of the captured steps, eager, with the kernel wrappers (their
    plain versions on CPU tensors)."""
    adam = tM.Adam(1e-3)
    if name == "motion":
        return tM.motion_epoch_parallel(state, video, model, adam, 0.1, FB,
                                        use_kernels=True)
    if name.startswith("grams"):
        return tM.grams_local(state, video, model, FB, True,
                              name.split("_")[1])
    g, c1 = tM.grams_local(state, video, model, FB, True, "exact")
    if name == "round":
        return tM.fused_round(state, video, model, adam, epochs=1,
                              mu_iters=3, gamma=0.1, mu_gamma=0.2,
                              frame_block=FB, use_kernels=True,
                              gram_mode="analytic")
    solver, gamma = name.split("_")
    with _HostProbe() as probe:
        tM.footprint_update(state, g, c1, 3, float(gamma), solver)
    return probe


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("step", ["motion", "grams_exact", "grams_analytic",
                                  "mu_0.0", "mu_0.2", "fista_0.0",
                                  "fista_0.2", "round"])
def test_steps_make_no_host_tensor_and_read_nothing(rng, step, scaling):
    state, video = _inputs(rng, scaling)
    model = _model(scaling)
    if step.startswith(("mu", "fista")):
        probe = _step(step, state, video, model)
    else:
        with _HostProbe() as probe:
            _step(step, state, video, model)
    assert probe.hits == [], probe.hits


def test_same_key_reuses_the_entry(rng):
    state, video = _inputs(rng)
    model, adam = _model(), tM.Adam(1e-3)
    got, ref = state, state
    for i in range(3):
        got, m = graphs.motion_epoch(got, video, model, adam, 0.1, FB, True)
        ref, m_ref = tM.motion_epoch_parallel(ref, video, model, adam, 0.1,
                                              FB, True)
        assert _same(got, ref)
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)
        (entry,) = graphs.entries()
        assert entry.name == "motion_epoch" and entry.replays == i + 1


@pytest.mark.parametrize("change", ["frame_block", "gram_mode", "video",
                                    "frames"])
def test_another_key_makes_an_entry(rng, change):
    state, video = _inputs(rng)
    model = _model()
    kw = dict(frame_block=FB, use_kernels=True, gram_mode="exact")
    graphs.compute_grams(state, video, model, **kw)
    if change == "frame_block":
        kw["frame_block"] = FB + 1
    elif change == "gram_mode":
        kw["gram_mode"] = "analytic"
    elif change == "video":
        video = video.clone()  # same values at another address
    else:
        state, video = _inputs(rng, t=T + 1)
        model = tcfg.ModelConfig(size=SIZE, num_neurons=K,
                                 num_frames=T + 1, shape_std=2.0)
    got = graphs.compute_grams(state, video, model, **kw)
    ref = tM.grams_local(state, video, model, kw["frame_block"], True,
                         kw["gram_mode"])
    assert [e.replays for e in graphs.entries()] == [1, 1]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_disabled_and_plain_route_run_eagerly(rng):
    state, video = _inputs(rng)
    model, adam = _model(), tM.Adam(1e-3)
    with graphs.disabled():
        graphs.motion_epoch(state, video, model, adam, 0.1, FB, True)
        graphs.fused_rounds(state, video, model, adam, rounds=1, epochs=1,
                            mu_iters=2, gamma=0.1, frame_block=FB,
                            use_kernels=True)
    graphs.motion_epoch(state, video, model, adam, 0.1, FB, False)
    g, c1 = tM.grams_local(state, video, model, FB, True)
    graphs.footprint_update(state, g, c1, 2, 0.1, "mu", False)
    assert graphs.entries() == []


def test_cache_keeps_the_most_recent_entries(rng):
    state, video = _inputs(rng)
    model = _model()
    for fb in range(1, graphs.MAX_ENTRIES + 2):
        graphs.compute_grams(state, video, model, fb, True)
    kept = graphs.entries()
    assert len(kept) == graphs.MAX_ENTRIES
    # Frame block 1 was dropped: calling it again captures anew.
    graphs.compute_grams(state, video, model, 1, True)
    assert graphs.entries()[-1].replays == 1
    assert graphs.entries()[0] is kept[1]


def test_fused_rounds_of_any_length_share_the_entry(rng):
    state, video = _inputs(rng)
    model, adam = _model(), tM.Adam(1e-3)
    kw = dict(epochs=1, mu_iters=3, gamma=0.1, frame_block=FB,
              use_kernels=True)
    got, ref = state, state
    for rounds in (1, 3, 2):
        got, m = graphs.fused_rounds(got, video, model, adam, rounds, **kw)
        ref, m_ref = tM.fused_rounds(ref, video, model, adam, rounds, **kw)
        assert _same(got, ref)
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)
        assert m["recon_mse"].shape == (rounds,)
    (entry,) = graphs.entries()
    assert entry.name == "fused_round" and entry.replays == 6


@pytest.mark.parametrize("fused_fit", [False, True])
def test_trainer_steps_go_through_the_cache(rng, fused_fit):
    """``fit`` and ``fit_fused`` with the kernels and no mesh take the
    cache's protocol, bit for bit the steps called directly."""
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    state, video = _inputs(rng)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                               motion_epochs=2, mu_iters=3)
    rt = tcfg.RuntimeConfig(frame_block=FB, use_kernels=True,
                            gram_mode="exact")
    runs = []
    for cached in (True, False):
        graphs.clear()
        eng = DeformableNMF(_model(), opt, rt, positions=state.pos,
                            device="cpu")
        with (contextlib.nullcontext() if cached else graphs.disabled()):
            res = (eng.fit_fused if fused_fit else eng.fit)(video)
        runs.append((res, sorted(e.name for e in graphs.entries())))
    (got, names), (ref, none) = runs
    assert names == (["fused_round"] if fused_fit else
                     ["compute_grams", "footprint_update", "motion_epoch"])
    assert none == []
    assert _same(got.state, ref.state)
    strip = [[{k: v for k, v in m.items() if k != "seconds"}
              for m in r.metrics] for r in (got, ref)]
    assert strip[0] == strip[1]


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def test_returned_tensors_share_no_storage_with_the_cache(rng):
    state, video = _inputs(rng)
    model, adam = _model(), tM.Adam(1e-3)
    st, m = graphs.motion_epoch(state, video, model, adam, 0.1, FB, True)
    g, c1 = graphs.compute_grams(st, video, model, FB, True, "analytic")
    st2 = graphs.footprint_update(st, g, c1, 3, 0.1, "fista", True)
    st3, m3 = graphs.fused_rounds(st2, video, model, adam, rounds=2,
                                  epochs=1, mu_iters=3, gamma=0.1,
                                  frame_block=FB, use_kernels=True)
    handed = [getattr(s, f) for s in (st, st2, st3) for f in tM.STATE_FIELDS]
    handed += [g, c1, *m.values(), *m3.values()]
    kept = [t for e in graphs.entries()
            for t in e.inputs + e.outputs]
    assert not _storages(handed) & _storages(kept)
    before = [t.clone() for t in handed]
    graphs.motion_epoch(st3, video, model, adam, 0.1, FB, True)
    graphs.fused_rounds(st3, video, model, adam, rounds=2, epochs=1,
                        mu_iters=3, gamma=0.1, frame_block=FB,
                        use_kernels=True)
    assert all(torch.equal(a, b) for a, b in zip(handed, before))
    # Fields that a step does not change are the caller's own tensors.
    assert st.pos is state.pos and st2.beta is st.beta


def _jax_state(state: tM.DNMFState, jm, opt):
    js = jM.init_state(jm, opt, positions=jnp.asarray(state.pos.numpy()))
    d = tM.state_to_numpy(state)
    adam = js.opt_state[0]._replace(count=jnp.asarray(d["count"]),
                                    mu=jnp.asarray(d["mu"]),
                                    nu=jnp.asarray(d["nu"]))
    return js._replace(beta=jnp.asarray(d["beta"]), c=jnp.asarray(d["c"]),
                       sigma=jnp.asarray(d["sigma"]),
                       opt_state=(adam,) + tuple(js.opt_state[1:]))


@pytest.mark.parametrize("solver", ["mu", "fista"])
@pytest.mark.parametrize("mode", ["exact", "analytic"])
def test_fused_rounds_through_the_cache_match_jax(rng, mode, solver):
    state, video = _inputs(rng)
    jm = jcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                          shape_std=2.0)
    jopt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=1e-3))
    kw = dict(rounds=2, epochs=2, mu_iters=10, gamma=0.1, mu_gamma=0.05,
              frame_block=FB, gram_mode=mode, trace_solver=solver)
    js, jmet = jM.fused_rounds(_jax_state(state, jm, jopt),
                               jnp.asarray(video.numpy()), jm, jopt, **kw)
    ts, tmet = graphs.fused_rounds(state, video, _model(), tM.Adam(1e-3),
                                   use_kernels=True, **kw)
    (entry,) = graphs.entries()
    assert entry.name == "fused_round" and entry.replays == 2
    adam = js.opt_state[0]
    ref = {"beta": js.beta, "c": js.c, "count": adam.count, "mu": adam.mu,
           "nu": adam.nu}
    for name, val in ref.items():
        if name == "count":
            assert int(ts.count) == int(val)
        else:
            close(getattr(ts, name), val, 1e-4)
    for key in ("recon_mse", "reg"):
        close(tmet[key], jmet[key], 1e-5)
    # The eager loop of the port gives the same bits.
    loop, loop_m = tM.fused_rounds(state, video, _model(), tM.Adam(1e-3),
                                   use_kernels=True, **kw)
    assert _same(ts, loop)
    assert all(torch.equal(tmet[k], loop_m[k]) for k in loop_m)
