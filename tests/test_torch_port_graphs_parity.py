"""The parity epoch and ``StaticFootprintNMF.fit`` as programs of
:mod:`dnmf_tpu_torch.models.graphs`, and ``positions_all``'s cache, on the
CPU (where an entry calls its step eagerly on its static buffers).

* ``graphs.motion_epoch_parity`` (one serial Adam step replayed once per
  batch) against ``motion_epoch_parity`` bit for bit, and against the
  JAX package's (plain XLA path) at ``test_torch_port_parity.py``'s
  1e-5 of the reference's max magnitude per epoch.
* ``graphs.static_nmf_fit`` against the eager loop bit for bit, and
  ``StaticFootprintNMF.fit`` against JAX's at
  ``test_static_footprint_nmf_matches_jax``'s 1e-4.
* A ``TorchDispatchMode`` probe: no tensor made from host data and no
  host read in a parity step or a static alternation.
* ``positions_all`` cached on the identity of ``beta``, the positions and
  ``iters``, read-only, as ``tests/test_engine.py`` holds JAX's; values
  against JAX's at 1e-4.
"""

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
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.ops import mu as mu_ops

from test_torch_port_graphs import _HostProbe

SIZE = (16, 12, 4)
K, BATCH = 6, 4


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_libraries():
    """One eager parity epoch and one static alternation before any
    comparison: in a fresh process the first eager epoch can differ from
    the next by an ulp of ``beta`` (the CPU libraries' first call; seen in
    2 of 12 processes, never after any earlier epoch), which is no
    property of the cache."""
    rng = np.random.default_rng(1)
    _, tm, _, adam, _, state, video = _states(rng, "pixel", 7)
    times, weights = (torch.from_numpy(x) for x in _batches(rng, 7, True))
    tM.motion_epoch_parity(state, torch.from_numpy(video), times, weights,
                           tm, adam, 0.5)
    a = torch.rand(20, 3)
    mu_ops.static_alternation(a, torch.rand(3, 5), torch.rand(20, 5),
                              torch.rand(20, 3), 1.0)


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _models(scaling, t):
    kw = dict(size=SIZE, num_neurons=K, num_frames=t, shape_std=2.0)
    return (jcfg.ModelConfig(deformation=jcfg.DeformationConfig(
                basis_scaling=scaling), **kw),
            tcfg.ModelConfig(deformation=tcfg.DeformationConfig(
                basis_scaling=scaling), **kw))


def _fixture(rng, t):
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 4.0)
    c = rng.uniform(0.2, 1.0, (K, t))
    video = (a @ c).T + rng.uniform(0, 0.2, (t, grid.shape[0]))
    return pos, video.astype(np.float32)


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _states(rng, scaling, t, lr=1e-3):
    """The JAX package's state and the port's, from the same NumPy
    arrays (warps off the identity), with the video and the models."""
    jm, tm = _models(scaling, t)
    jopt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=lr))
    pos, video = _fixture(rng, t)
    js = jM.init_state(jm, jopt, positions=jnp.asarray(pos),
                       key=jax.random.PRNGKey(1))
    beta = np.asarray(js.beta) + 0.01 * rng.normal(
        size=(t, 10, 3)).astype(np.float32)
    if scaling == "pixel":
        beta[:, 4:] *= 0.01
    js = js._replace(beta=jnp.asarray(beta))
    ts = tM.state_from_numpy(_jax_to_numpy(js))
    return jm, tm, jopt, tM.Adam(lr), js, ts, video


def _batches(rng, t, shuffle):
    """An epoch's ``(times, weights)`` as the trainers lay them out:
    ``[num_batches, B]``, padded with frame 0 at weight 0."""
    pad = (-t) % BATCH
    order = rng.permutation(t) if shuffle else np.arange(t)
    times = np.concatenate([order, np.zeros(pad, np.int64)])
    weights = np.concatenate([np.ones(t), np.zeros(pad)]).astype(np.float32)
    return times.reshape(-1, BATCH), weights.reshape(-1, BATCH)


def _same(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in tM.STATE_FIELDS)


# ---------------------------------------------------------- parity epoch
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("t", [8, 7])  # 7: the last batch is padded
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_parity_epoch_through_the_cache_equals_eager(rng, scaling, t,
                                                     shuffle):
    _, tm, _, adam, _, state, video = _states(rng, scaling, t)
    video = torch.from_numpy(video)
    got = ref = state
    for epoch in range(2):
        times, weights = (torch.from_numpy(x)
                          for x in _batches(rng, t, shuffle))
        got, m = graphs.motion_epoch_parity(got, video, times, weights, tm,
                                            adam, 0.5, use_kernels=True)
        ref, m_ref = tM.motion_epoch_parity(ref, video, times, weights, tm,
                                            adam, 0.5)
        assert _same(got, ref)
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)
        (entry,) = graphs.entries()
        assert entry.name == "motion_epoch_parity"
        assert entry.replays == (epoch + 1) * times.shape[0]
    assert int(got.count) == int(state.count) + 2 * times.shape[0]
    # The caller's traces, positions and widths pass through.
    assert got.c is state.c and got.pos is state.pos


@pytest.mark.parametrize("t", [8, 7])
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_parity_epoch_through_the_cache_matches_jax(rng, scaling, t):
    jm, tm, jopt, adam, js, ts, video = _states(rng, scaling, t)
    vj, vt = jnp.asarray(video), torch.from_numpy(video)
    for _ in range(2):
        times, weights = _batches(rng, t, True)
        js, jmet = jM.motion_epoch_parity(
            js, vj, jnp.asarray(times, jnp.int32), jnp.asarray(weights), jm,
            jopt, 0.5)
        ts, tmet = graphs.motion_epoch_parity(
            ts, vt, torch.from_numpy(times), torch.from_numpy(weights), tm,
            adam, 0.5, use_kernels=True)
        ref = _jax_to_numpy(js)
        for name, val in tM.state_to_numpy(ts).items():
            if name == "count":
                assert int(val) == int(ref[name])
            else:
                close(val, ref[name], 1e-5)
        for key in ("recon_mse", "reg"):
            close(tmet[key], jmet[key], 1e-5)


def test_parity_fit_through_the_cache_equals_the_eager_fit(rng):
    """The trainer in parity mode: its epochs through the cache (the
    kernels' plain versions on the CPU) equal the same fit inside
    ``graphs.disabled()``, bit for bit, metrics included."""
    _, tm = _models("normalized", 7)
    pos, video = _fixture(rng, 7)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                               motion_epochs=2, mu_iters=3,
                               motion_mode="parity", batch_size=BATCH)

    def fit():
        eng = ttr.DeformableNMF(tm, opt, tcfg.RuntimeConfig(
            frame_block=3, use_kernels=True), positions=pos, device="cpu")
        return eng.fit(video.reshape((7,) + SIZE))

    with graphs.disabled():
        eager = fit()
    assert graphs.entries() == []
    captured = fit()
    assert _same(captured.state, eager.state)
    strip = [[{k: v for k, v in m.items() if k != "seconds"}
              for m in r.metrics] for r in (captured, eager)]
    assert strip[0] == strip[1]
    parity = [e for e in graphs.entries()
              if e.name == "motion_epoch_parity"]
    assert len(parity) == 1 and parity[0].replays == 2 * 2 * 2


def test_parity_epoch_without_kernels_runs_eagerly(rng):
    """The plain route (resampled footprints and every model without
    ``use_kernels``) makes no entry."""
    _, tm, _, adam, _, state, video = _states(rng, "normalized", 8)
    times, weights = (torch.from_numpy(x) for x in _batches(rng, 8, True))
    got, _ = graphs.motion_epoch_parity(state, torch.from_numpy(video), times,
                                        weights, tm, adam, 0.5)
    ref, _ = tM.motion_epoch_parity(state, torch.from_numpy(video), times,
                                    weights, tm, adam, 0.5)
    assert graphs.entries() == [] and _same(got, ref)


# ------------------------------------------------------ static footprints
def _static_pair(rng, t=7):
    jm, tm = _models("normalized", t)
    pos, video = _fixture(rng, t)
    video[0, :5] = -1.0  # clamped by both
    je = jtr.StaticFootprintNMF(jm, jnp.asarray(pos))
    te = ttr.StaticFootprintNMF(tm, pos, device="cpu")
    te.c = torch.from_numpy(np.array(je.c))
    return je, te, video.reshape((t,) + SIZE)


@pytest.mark.parametrize("gamma_a", [1.0, 0.0])
def test_static_fit_through_the_cache_equals_eager(rng, gamma_a):
    _, te, video = _static_pair(rng)
    te.gamma_a = gamma_a
    a0, c0 = te.a, te.c
    with graphs.disabled():
        a_e, c_e = te.fit(video, iters=4)
    assert graphs.entries() == []
    te.a, te.c = a0, c0
    for calls in (1, 2):
        a_c, c_c = te.fit(video, iters=4 if calls == 1 else 3)
        (entry,) = graphs.entries()
        assert entry.name == "static_nmf_fit" and entry.replays == (
            4 if calls == 1 else 7)
        if calls == 1:
            assert torch.equal(a_c, a_e) and torch.equal(c_c, c_e)
            # The results are clones: another fit leaves them as they are.
            kept = a_c.clone()
    assert torch.equal(a_e, kept)
    with graphs.disabled():
        a_r, c_r = graphs.static_nmf_fit(a_e, c_e, te.a.new_tensor(
            np.maximum(video.reshape(7, -1), 0).T), te.d, gamma_a, 3)
    assert torch.equal(te.a, a_r) and torch.equal(te.c, c_r)


def test_static_fit_through_the_cache_matches_jax(rng):
    je, te, video = _static_pair(rng)
    a_r, c_r = je.fit(video, iters=5)
    a, c = te.fit(video, iters=5)
    assert [e.name for e in graphs.entries()] == ["static_nmf_fit"]
    close(a, a_r, 1e-4)
    close(c, c_r, 1e-4)


# ----------------------------------------------------------------- probe
@pytest.mark.parametrize("what", ["parity normalized", "parity pixel",
                                  "static"])
def test_captured_steps_make_no_host_tensor_and_read_nothing(rng, what):
    if what == "static":
        _, te, video = _static_pair(rng)
        y = torch.clamp_min(torch.from_numpy(video).reshape(7, -1), 0.0).T
        te.fit(video, iters=1)  # the entry exists: the probe sees a replay
        with _HostProbe() as probe:
            graphs.static_nmf_fit(te.a, te.c, y, te.d, te.gamma_a, 1)
    else:
        _, tm, _, adam, _, state, video = _states(rng, what.split()[1], 8)
        video = torch.from_numpy(video)
        times, weights = (torch.from_numpy(x) for x in _batches(rng, 8, True))
        graphs.motion_epoch_parity(state, video, times, weights, tm, adam,
                                   0.5, use_kernels=True)
        with _HostProbe() as probe:
            graphs.motion_epoch_parity(state, video, times, weights, tm,
                                       adam, 0.5, use_kernels=True)
    assert probe.hits == [], probe.hits


# --------------------------------------------------------- positions_all
def _position_engines(rng):
    jm, tm = _models("normalized", 7)
    pos, _ = _fixture(rng, 7)
    okw = dict(learning_rate=1e-3, outer_rounds=1)
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(use_pallas=False),
                           positions=jnp.asarray(pos))
    beta = np.asarray(jt.state.beta) + 0.01 * rng.normal(
        size=(7, 10, 3)).astype(np.float32)
    jt.state = jt.state._replace(beta=jnp.asarray(beta))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           positions=pos, device="cpu")
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    return jt, tt


def test_positions_all_is_cached_and_read_only(rng):
    """``tests/test_engine.py``'s cache test against the port: a hit is
    the same array, read-only; a new ``pos_t``, ``beta`` or ``iters``
    misses; every value within 1e-4 of JAX's."""
    jt, tt = _position_engines(rng)
    base = tt.positions_all()
    close(base, jt.positions_all(), 1e-4)
    assert tt.positions_all() is base
    assert np.shares_memory(tt.positions_at(3), base)
    with pytest.raises(ValueError):
        base[0, 0, 0] = 0.0
    assert tt.positions_all(iters=2) is not base
    t = tt.model.num_frames
    tt.pos_t = tt.state.pos.expand((t,) + tt.state.pos.shape) + 1.5
    jt.pos_t = (jnp.broadcast_to(jt.state.pos[None],
                                 (t,) + jt.state.pos.shape) + 1.5)
    refined = tt.positions_all()
    assert refined is not base
    close(refined, jt.positions_all(), 1e-4)
    assert tt.positions_all() is refined
    with pytest.raises(ValueError):
        refined[0, 0, 0] = 0.0
    beta = tt.state.beta.clone()
    beta[:, 0] += 0.25
    tt.state = tt.state.replace(beta=beta)
    jt.state = jt.state._replace(beta=jnp.asarray(beta.numpy()))
    moved = tt.positions_all()
    assert moved is not refined
    close(moved, jt.positions_all(), 1e-4)
    close(tt.positions_at(5), jt.positions_at(5), 1e-4)
