"""The port's simulator against ``dnmf_tpu.data.simulator``.

Each random transform is fed the JAX function's own draws (the JAX
package's key splits, made here) and must give the JAX function's
output: anchors 1e-6 px, GP offsets 1e-5 of their largest, quadratic
trajectories 1e-4 relative (float32 compounded over the frames), traces,
``render_video`` and ``roi_signals`` 1e-6 relative, the normalized and
noised video 1e-5 of its max.  The host-side NumPy fixtures are equal bit
for bit for the same seed.  Draws of the port's own generator are held
to the fixtures' statistics: GP variance, exact spike counts, shapes,
max 1, repeatability, the ``"sq"``/``"qs"`` alias and the errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.config import SimulatorConfig as JSimulatorConfig
from dnmf_tpu.data import simulator as jS
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data import simulator as tS

SMALL = dict(num_neurons=4, num_frames=12, size=(16, 14, 2), shape_std=2.0,
             density=0.2, bg_snr_db=-60.0)


def t32(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rel_max(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# --------------------------------------------------------------- configs
def test_simulator_config_matches_jax():
    assert (dataclasses.asdict(tcfg.SimulatorConfig())
            == dataclasses.asdict(JSimulatorConfig()))


@pytest.mark.parametrize("preset", ["reference_demo_simulator",
                                    "reference_demo_optimizer",
                                    "reference_demo_model",
                                    "reference_demo_model_parity"])
def test_reference_demo_presets_match_jax(preset):
    from dnmf_tpu import config as jcfg

    name, kw = preset, {}
    if preset.endswith("_parity"):
        name, kw = "reference_demo_model", {"parity": True}
    got = dataclasses.asdict(getattr(tcfg, name)(**kw))
    ref = dataclasses.asdict(getattr(jcfg, name)(**kw))
    assert {k: v for k, v in got.items() if k in ref} == {
        k: v for k, v in ref.items() if k in got}


def test_parity_model_raises_item_11():
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    with pytest.raises(NotImplementedError, match="item 11"):
        DeformableNMF(tcfg.reference_demo_model(parity=True),
                      tcfg.reference_demo_optimizer(), device="cpu")


# ------------------------------------------------- transforms on JAX draws
@pytest.mark.parametrize("min_sep,margin", [(0.0, 0.0), (0.0, 3.0),
                                            (4.0, 2.0), (2.0, 11.0)])
def test_anchors_match_jax(min_sep, margin):
    key = jax.random.PRNGKey(3)
    k, size = 7, (30, 26, 4)
    n = k if min_sep <= 0.0 else 50 * k
    u = jax.random.uniform(key, (n, 3))
    ref = jS._sample_anchors(key, k, size, min_separation=min_sep,
                             margin=margin)
    got = tS._anchors_from_uniform(t32(u), k, size, min_sep, margin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_anchors_raise_when_they_cannot_be_placed():
    u = t32(jax.random.uniform(jax.random.PRNGKey(0), (250, 3)))
    with pytest.raises(ValueError, match="could not place"):
        tS._anchors_from_uniform(u, 5, (6, 6, 1), min_separation=20.0)
    with pytest.raises(ValueError, match="could not place"):
        jS._sample_anchors(jax.random.PRNGKey(0), 5, (6, 6, 1),
                           min_separation=20.0)


def test_rbf_kernel_matches_jax():
    """Within one float32 ulp: XLA's exp and torch's differ there."""
    x = np.arange(20, dtype=np.float32) * 1.3
    for amplitude, ls in ((2.0, 6.0), (0.05, 20.0)):
        ref = np.asarray(jS._rbf_kernel(jnp.asarray(x), amplitude, ls))
        got = tS._rbf_kernel(t32(x), amplitude, ls).numpy()
        np.testing.assert_allclose(got, ref, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("timed", [False, True])
def test_gp_motion_matches_jax(monkeypatch, timed):
    """The GP transforms on JAX's anchors, normals and kernel matrices.
    The matrices are JAX's own: the factors' clamped near-null
    eigenvalues turn a one-ulp difference of ``exp`` into ~1e-4 of the
    offsets, on a rank-deficient time kernel."""
    monkeypatch.setattr(tS, "_rbf_kernel", lambda x, a, ls: t32(
        jS._rbf_kernel(jnp.asarray(x.numpy()), a, ls)))
    key = jax.random.PRNGKey(1)
    k, t, size = 6, 20, (30, 30, 3)
    sigma = (2.0, 1.5, 0.05)
    k_anchor, k_eps = jax.random.split(key)
    anchors = jS._sample_anchors(k_anchor, k, size, min_separation=4.0,
                                 margin=2.0)
    eps = jax.random.normal(k_eps, (3, k, t))
    if timed:
        ref = jS.gp_time_motion(key, k, t, sigma=sigma, length_scale=6.0,
                                size=size, min_separation=4.0, margin=2.0)
        got = tS._gp_time_positions(t32(anchors), t32(eps), sigma, 6.0)
    else:
        ls = (8.0, 6.0, 5.0)
        ref = jS.gp_motion(key, k, t, sigma=sigma, length_scale=ls,
                           size=size, min_separation=4.0, margin=2.0)
        got = tS._gp_positions(t32(anchors), t32(eps), sigma, ls)
    a = np.asarray(anchors)[:, :, None]
    assert rel_max(got - t32(a), np.asarray(ref) - a) <= 1e-5


@pytest.mark.parametrize("means", [(0.0, 0.0, 0.0), (0.5, -0.3, 0.0)])
def test_quadratic_sequential_matches_jax(means):
    key = jax.random.PRNGKey(2)
    k, t, size, snr = 5, 10, (20, 18, 3), (-80.0, -80.0, -90.0)
    k_beta, k_init = jax.random.split(key)
    noise = jax.random.normal(k_beta, (t, 10, 3))
    u = jax.random.uniform(k_init, (k, 3))
    ref = jS.quadratic_sequential_trajectory(key, k, t, means=means,
                                             snr_db=snr, size=size)
    got = tS._quadratic_sequential(t32(noise), t32(u), means, snr, size)
    assert rel_max(got, ref) <= 1e-4


def test_quadratic_trajectory_matches_jax():
    key = jax.random.PRNGKey(4)
    k, t, size, snr = 5, 9, (20, 18, 3), (-60.0, -60.0, -60.0)
    k_beta, k_init = jax.random.split(key)
    noise = jax.random.normal(k_beta, (t, 10, 3))
    u = jax.random.uniform(k_init, (k, 3))
    ref = jS.quadratic_trajectory(key, k, t, snr_db=snr, size=size)
    got = tS._quadratic(t32(noise), t32(u), snr, size)
    assert rel_max(got, ref) <= 1e-4


@pytest.mark.parametrize("density", [0.1, 0.35])
def test_exponential_traces_match_jax(density):
    key = jax.random.PRNGKey(5)
    k, t = 6, 30
    n = t + 9
    nnz = int(round(density * n))
    idx = np.stack([np.asarray(jax.random.permutation(kk, n))[:nnz]
                    for kk in jax.random.split(key, k)])
    ref = jS.exponential_traces(key, k, t, density=density)
    got = tS._traces_from_spikes(torch.from_numpy(idx).long(), t)
    assert rel_max(got, ref) <= 1e-6


@pytest.mark.parametrize("chunk", [tS.RENDER_CHUNK, 40])
def test_render_video_matches_jax(rng, monkeypatch, chunk):
    monkeypatch.setattr(tS, "RENDER_CHUNK", chunk)
    k, t, size = 5, 4, (14, 12, 3)
    pos = rng.uniform([[-1], [0], [0]], [[15], [12], [3]],
                      (k, 3, t)).astype(np.float32)
    c = rng.uniform(0.5, 2.0, (k, t)).astype(np.float32)
    ref = jS.render_video(jnp.asarray(pos), jnp.asarray(c), size, 2.5)
    got = tS.render_video(t32(pos), t32(c), size, 2.5)
    assert rel_max(got, ref) <= 1e-6


def test_generate_video_matches_jax_on_its_draws():
    """JAX's positions, traces and noise through the port's renderer and
    normalization give JAX's video."""
    cfg = JSimulatorConfig(**SMALL, motion="gpt", gp_sigma=(0.5, 0.5, 0.01))
    key = jax.random.PRNGKey(cfg.seed)
    video, pos, traces = jS.generate_video(cfg, key)
    noise = jax.random.normal(jax.random.split(key, 3)[2], video.shape)
    clean = tS.render_video(t32(pos), t32(traces), cfg.size, cfg.shape_std)
    got = tS._finish_video(clean, t32(noise), cfg.bg_snr_db)
    assert rel_max(got, video) <= 1e-5


@pytest.mark.parametrize("window", [(3, 3, 0), (2, 1, 1), (0, 0, 0)])
def test_roi_signals_match_jax(rng, window):
    t, size = 5, (12, 10, 3)
    video = rng.uniform(0, 1, (t,) + size).astype(np.float32)
    # Some centers sit on or past the border: zero-padded in the mean.
    pos = rng.uniform([[-2], [-2], [-1]], [[13], [11], [3.5]],
                      (6, 3, t)).astype(np.float32)
    ref = jS.roi_signals(jnp.asarray(video), jnp.asarray(pos), window)
    got = tS.roi_signals(t32(video), t32(pos), window)
    assert rel_max(got, ref) <= 1e-6


# --------------------------------------------------- host NumPy fixtures
HOST_CASES = {
    "simulate_cell": lambda S: S.simulate_cell(
        (9, 8, 3, 2), [4.2, 3.5, 1.0], [[3, 0.5, 0], [0.5, 2, 0], [0, 0, 1]],
        [1.0, 0.5], [0.1, 0.0], [0.2, 0.1], trunc_percentile=30.0, seed=3),
    "generate_random_video": lambda S: S.generate_random_video(
        cellnum=2, size=(24, 24, 1, 2, 4), cell_size=(9, 9, 1, 2), seed=1),
    "generate_random_video_static": lambda S: S.generate_random_video(
        cellnum=2, rnd_pos=False, rnd_rot=False, size=(20, 22, 1, 1, 3),
        cell_size=(7, 7, 1, 1), seed=2),
    "simulate_trajectory": lambda S: S.simulate_trajectory(
        6, 3, np.arange(9.0).reshape(3, 3),
        [[1.0, 0.2, 0], [0.2, 0.5, 0], [0, 0, 0.1]], seed=4),
    "unit_vector": lambda S: S.unit_vector([[3.0, 4.0], [1.0, 1.0]], axis=1),
    "rotation_matrix": lambda S: S.rotation_matrix(0.7, [1.0, 2.0, 2.0]),
    "compute_snr_motion": lambda S: S.compute_snr_motion((1e-3, 2e-3, 1e-5)),
    "compute_snr_positions": lambda S: S.compute_snr_positions(
        np.random.default_rng(0).uniform(0, 10, (4, 3, 6))),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_fixtures_equal_jax_bit_for_bit(case):
    got, ref = HOST_CASES[case](tS), HOST_CASES[case](jS)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_snr_helpers_take_tensors():
    pos = tS.gp_motion(torch.Generator().manual_seed(0), 5, 10,
                       sigma=(1, 1, 0.01), length_scale=(5, 5, 5),
                       size=(20, 20, 2), device="cpu")
    assert np.isfinite(tS.compute_snr_positions(pos))
    assert np.isfinite(tS.compute_snr_intensity(0.2, num_frames=20))


# ------------------------------------------------ the port's own draws
def test_gp_offset_variance_is_gp_sigma():
    gen = torch.Generator().manual_seed(0)
    pos = tS.gp_motion(gen, 30, 200, sigma=(4.0, 4.0, 0.01),
                       length_scale=(10.0, 10.0, 10.0), size=(50, 50, 2),
                       device="cpu")
    assert pos.shape == (30, 3, 200)
    offsets = pos - pos.mean(dim=2, keepdim=True)
    # Prior variance 4.0 on x and y: 6000 draws, correlated over ~5
    # neighbours at a length scale of 10 px in a 50 px volume.
    for d in (0, 1):
        assert 3.0 < float(offsets[:, d].var()) < 5.0
    assert float(offsets[:, 2].var()) < 0.02


def test_spike_counts_are_exact():
    gen = torch.Generator().manual_seed(1)
    k, t, density = 8, 50, 0.2
    n, nnz = t + 9, int(round(0.2 * (50 + 9)))
    idx = tS._spike_indices(gen, k, n, nnz, "cpu")
    assert idx.shape == (k, nnz)
    for row in idx.tolist():
        assert len(set(row)) == nnz and 0 <= min(row) and max(row) < n
    traces = tS.exponential_traces(torch.Generator().manual_seed(1), k, t,
                                   density=density, device="cpu")
    assert torch.equal(traces, tS._traces_from_spikes(idx, t))
    assert float(traces.min()) >= 1.0 and float(traces.max()) > 1.5


@pytest.mark.parametrize("motion", ["gp", "gpt", "sq", "q"])
def test_generate_video_contract(motion):
    cfg = tcfg.SimulatorConfig(**SMALL, motion=motion,
                               motion_snr_db=(-100.0,) * 3)
    video, pos, traces = tS.generate_video(cfg, device="cpu")
    assert video.shape == (12, 16, 14, 2)
    assert pos.shape == (4, 3, 12) and traces.shape == (4, 12)
    assert abs(float(video.max()) - 1.0) < 1e-6
    assert bool(torch.isfinite(video).all())
    again = tS.generate_video(cfg, torch.Generator().manual_seed(cfg.seed),
                              device="cpu")
    for a, b in zip((video, pos, traces), again):
        assert torch.equal(a, b)


def test_sq_and_qs_are_one_model():
    kw = dict(num_neurons=3, num_frames=5, size=(10, 10, 1),
              motion_snr_db=(-60, -60, -60))
    v1, _, _ = tS.generate_video(tcfg.SimulatorConfig(motion="sq", **kw),
                                 device="cpu")
    v2, _, _ = tS.generate_video(tcfg.SimulatorConfig(motion="qs", **kw),
                                 device="cpu")
    assert torch.equal(v1, v2)


@pytest.mark.parametrize("field,value,match", [
    ("motion", "brownian", "motion model"), ("traces", "poisson",
                                             "trace model")])
def test_unknown_models_raise(field, value, match):
    cfg = tcfg.SimulatorConfig(**{**SMALL, field: value})
    with pytest.raises(ValueError, match=match):
        tS.generate_video(cfg, device="cpu")


def test_roi_signals_follow_the_traces():
    t = 12
    positions = torch.tensor([[4.0, 4.0, 1.0], [12.0, 4.0, 1.0],
                              [4.0, 12.0, 1.0], [12.0, 12.0, 1.0]])[
                                  :, :, None].expand(4, 3, t)
    traces = tS.exponential_traces(torch.Generator().manual_seed(5), 4, t,
                                   density=0.3, device="cpu")
    video = tS.render_video(positions, traces, (17, 17, 3), shape_std=2.0)
    sig = tS.roi_signals(video, positions, window=(2, 2, 0))
    for k in range(4):
        assert np.corrcoef(sig[k].numpy(), traces[k].numpy())[0, 1] > 0.95
