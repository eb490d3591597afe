"""The port's host-streamed sources and streamed model paths against
``dnmf_tpu`` on the same NumPy inputs.

Sources (``StreamingVideo``, ``RawFileVideo``, ``SpatialView``) are held
to the JAX package's behaviour exactly: clamped vs raw reads, NumPy index
rules, the zero-padded tail block.  The streamed epochs, Grams and
refinement carry one state across both packages at 1e-5 of the
reference's max (refinement: rtol 1e-5, atol 1e-6); a streamed ``fit``
with ``fit_sigma`` is held at 1e-4, as whole fits are.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.data import streaming as jS
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.models import refine as jR
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import native
from dnmf_tpu_torch.data import streaming as tS
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import refine as tR

SIZE = (16, 12, 4)
K, T, BLOCK = 5, 11, 4  # the last block holds 3 valid frames


def close(got, ref, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _ramp(t=6, offset=0.0):
    return np.arange(t * 4 * 3 * 2, dtype=np.float32).reshape(
        t, 4, 3, 2) - offset


# ----------------------------------------------------------------- sources
def test_spatial_view_indexing_matches_array():
    video = _ramp()
    sv = tS.SpatialView(tS.StreamingVideo(video, block=2, device="cpu"))
    assert sv.shape == video.shape and sv.ndim == 4 and len(sv) == 6
    np.testing.assert_array_equal(sv[1:5], video[1:5])
    np.testing.assert_array_equal(sv[::2], video[::2])
    idx = np.array([0, 3, 4, 5, 2])  # mixed contiguous runs
    np.testing.assert_array_equal(sv[idx], video[idx])
    np.testing.assert_array_equal(sv[np.int64(3)], video[3])
    np.testing.assert_array_equal(sv[-1], video[-1])
    np.testing.assert_array_equal(sv[np.array([-1, -6, 2])],
                                  video[np.array([-1, -6, 2])])
    np.testing.assert_array_equal(sv[-3:-1], video[-3:-1])
    for bad in (6, -7, np.array([0, 6]), np.array([-7])):
        with pytest.raises(IndexError):
            sv[bad]


def test_reads_clamp_and_raw_reads_do_not():
    video = _ramp(offset=50.0)
    src = tS.StreamingVideo(video, block=2, device="cpu")
    ref = jS.StreamingVideo(video, block=2)
    np.testing.assert_array_equal(src.read(0, 6), ref.read(0, 6))
    assert src.read(0, 6).min() == 0.0
    np.testing.assert_array_equal(src.read_raw(0, 6), video.reshape(6, -1))
    sv = tS.SpatialView(src)
    np.testing.assert_array_equal(sv[0:6], video)  # negatives intact
    np.testing.assert_array_equal(sv[0:6], jS.SpatialView(ref)[0:6])


def _blocks(src):
    return [(np.asarray(f), s, v) for f, s, v in src.blocks()]


@pytest.mark.parametrize("block", [2, 4, 6, 8])
def test_blocks_match_jax(block):
    """Clamped frames, a zero-padded tail block and its valid count."""
    video = _ramp(offset=40.0)
    got = _blocks(tS.StreamingVideo(video, block=block, device="cpu"))
    ref = _blocks(jS.StreamingVideo(video, block=block))
    assert len(got) == len(ref) == -(-6 // block)
    for (f, s, v), (fr, sr, vr) in zip(got, ref):
        assert (s, v) == (sr, vr) and f.shape == (block, 24)
        np.testing.assert_array_equal(f, fr)
        assert not f[v:].any()


def test_spatial_view_rejects_flat_sources():
    flat = tS.StreamingVideo(np.zeros((6, 48), np.float32), block=2,
                             device="cpu")
    assert flat.size is None
    with pytest.raises(ValueError, match="spatial shape"):
        tS.SpatialView(flat)


@pytest.mark.parametrize("prefetch", [True, False])
def test_raw_file_video_matches_jax(tmp_path, prefetch):
    if native.load_blockreader() is None:
        pytest.skip("no C++ compiler for the native block reader")
    video = _ramp(t=7, offset=30.0)
    path = tmp_path / "neg.raw"
    video.tofile(path)
    src = tS.RawFileVideo(str(path), video.shape, block=3,
                          prefetch=prefetch, device="cpu")
    ref = jS.StreamingVideo(video, block=3)
    np.testing.assert_array_equal(src.read(0, 7), ref.read(0, 7))
    np.testing.assert_array_equal(src.read_raw(0, 7), video.reshape(7, -1))
    np.testing.assert_array_equal(tS.SpatialView(src)[1:3], video[1:3])
    for (f, s, v), (fr, sr, vr) in zip(_blocks(src), _blocks(ref)):
        assert (s, v) == (sr, vr)
        np.testing.assert_array_equal(f, fr)
    # A loop left after one block leaves a prefetch in flight: reads and
    # a new loop still see the right frames.
    next(iter(src.blocks()))
    np.testing.assert_array_equal(src.read(2, 5), ref.read(2, 5))
    assert len(_blocks(src)) == 3


def test_wait_range_mismatch_fails_loudly(tmp_path):
    """The reader rejects a wait for another range than the one in
    flight, and the prefetch stays serviceable, as the JAX package's."""
    if native.load_blockreader() is None:
        pytest.skip("no C++ compiler for the native block reader")
    video = _ramp(t=8, offset=10.0)
    path = tmp_path / "rec.raw"
    video.tofile(path)
    src = tS.RawFileVideo(str(path), video.shape, block=4, device="cpu")
    src._reader.prefetch(0, 4)
    with pytest.raises(ValueError, match="does not match"):
        src._reader.wait(4, 8)
    np.testing.assert_array_equal(src._reader.wait(0, 4), np.maximum(
        video[:4].reshape(4, -1), 0.0))


def test_open_raw_video_falls_back_to_memmap(tmp_path, monkeypatch):
    """Without a compiler the raw file opens as a memmapped source."""
    video = _ramp(t=5, offset=10.0)
    path = tmp_path / "rec.raw"
    video.tofile(path)
    monkeypatch.setattr(native, "load_blockreader", lambda: None)
    src = tS.open_raw_video(str(path), video.shape, block=2, device="cpu")
    assert isinstance(src, tS.StreamingVideo)
    assert isinstance(src.array, np.memmap)
    for (f, s, v), (fr, sr, vr) in zip(_blocks(src), _blocks(
            jS.StreamingVideo(video, block=2))):
        assert (s, v) == (sr, vr)
        np.testing.assert_array_equal(f, fr)


def test_open_raw_video_and_memmap(tmp_path):
    video = _ramp(t=5, offset=10.0)
    path = tmp_path / "rec.raw"
    video.tofile(path)
    for src in (tS.open_raw_video(str(path), video.shape, block=2,
                                  device="cpu"),
                tS.open_memmap_video(str(path), video.shape, block=2,
                                     device="cpu")):
        assert src.size == video.shape[1:] and src.num_blocks() == 3
        np.testing.assert_array_equal(src.read(0, 5),
                                      np.maximum(video.reshape(5, -1), 0))
        np.testing.assert_array_equal(src.read_raw(1, 4),
                                      video[1:4].reshape(3, -1))


# ---------------------------------------------------------- streamed model
def _video(rng, pos, t=T):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 4.0)
    c = rng.uniform(0.2, 1.0, (K, t))
    v = (a @ c).T + rng.uniform(0, 0.2, (t, grid.shape[0]))
    return v.reshape((t,) + SIZE).astype(np.float32)


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _pair(rng, sigma_axes=1):
    kw = dict(size=SIZE, num_neurons=K, num_frames=T, shape_std=2.0,
              sigma_axes=sigma_axes)
    jm, tm = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    opt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=1e-3))
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    js = jM.init_state(jm, opt, positions=jnp.asarray(pos))
    beta = np.asarray(js.beta) + 0.01 * rng.normal(size=(T, 10, 3))
    js = js._replace(beta=jnp.asarray(beta, jnp.float32))
    ts = tM.state_from_numpy(_jax_to_numpy(js))
    video = _video(rng, pos)
    return (jm, tm, opt, tM.Adam(1e-3), js, ts,
            jS.StreamingVideo(video, block=BLOCK),
            tS.StreamingVideo(video, block=BLOCK, device="cpu"))


def test_motion_epochs_streaming_match_jax(rng):
    jm, tm, jopt, topt, js, ts, jsrc, tsrc = _pair(rng)
    for _ in range(2):  # one state carried across epochs
        js, jmet = jM.motion_epoch_streaming(js, jsrc, jm, jopt, 0.1)
        ts, tmet = tM.motion_epoch_streaming(ts, tsrc, tm, topt, 0.1)
        ref = _jax_to_numpy(js)
        for name, val in tM.state_to_numpy(ts).items():
            if name == "count":
                assert int(val) == int(ref[name])
            else:
                close(val, ref[name])
        for key in ("recon_mse", "reg"):
            close(tmet[key], jmet[key])


def test_motion_epoch_streaming_equals_resident(rng):
    """Streamed == resident in the port itself: the padded, masked tail
    block changes nothing."""
    _, tm, _, topt, _, ts, _, tsrc = _pair(rng)
    video = torch.clamp_min(torch.from_numpy(tsrc.array).reshape(T, -1), 0)
    a, ma = tM.motion_epoch_streaming(ts, tsrc, tm, topt, 0.1)
    b, mb = tM.motion_epoch_parallel(ts, video, tm, topt, 0.1,
                                     frame_block=BLOCK)
    close(a.beta, b.beta.numpy(), 1e-6)
    close(ma["recon_mse"], mb["recon_mse"].numpy(), 1e-6)


@pytest.mark.parametrize("mode", ["exact", "analytic"])
@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_grams_streaming_match_jax(rng, mode, sigma_axes):
    jm, tm, _, _, js, ts, jsrc, tsrc = _pair(rng, sigma_axes)
    g_r, c1_r = jM.compute_grams_streaming(js, jsrc, jm, gram_mode=mode)
    g, c1 = tM.compute_grams_streaming(ts, tsrc, tm, gram_mode=mode)
    close(g, g_r)
    close(c1, c1_r)


def test_refined_rounds_streaming_match_jax(rng):
    jm, tm, _, _, js, ts, jsrc, tsrc = _pair(rng)
    kw = dict(rounds=2, epochs=4, mu_iters=10, learning_rate=0.05,
              prior=1e-3)
    st_j, pos_j, m_j = jR.refined_rounds_streaming(js, jsrc, jm, **kw)
    st_t, pos_t, m_t = tR.refined_rounds_streaming(ts, tsrc, tm, **kw)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st_t.c.numpy(), np.asarray(st_j.c),
                               rtol=1e-5, atol=1e-6)
    close(m_t["recon_mse"], m_j["recon_mse"])


def test_refined_rounds_streaming_fista_matches_jax(rng):
    """The FISTA trace solve per block: held at 1e-4 of the max, as whole
    fits are (its momentum carries the float32 reorderings of one round
    into the next round's positions)."""
    jm, tm, _, _, js, ts, jsrc, tsrc = _pair(rng)
    kw = dict(rounds=2, epochs=4, mu_iters=10, learning_rate=0.05,
              prior=1e-3, trace_solver="fista")
    st_j, pos_j, _ = jR.refined_rounds_streaming(js, jsrc, jm, **kw)
    st_t, pos_t, _ = tR.refined_rounds_streaming(ts, tsrc, tm, **kw)
    close(pos_t, pos_j, 1e-4)
    close(st_t.c, st_j.c, 1e-4)


def _trainers(rng, **opt):
    jm, tm, *_ = _pair(rng)
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    okw = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=2,
               mu_iters=20, gamma_motion=0.1, **opt)
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=BLOCK,
                                              use_pallas=False),
                           positions=jnp.asarray(pos))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=BLOCK),
                           positions=pos, device="cpu")
    # jax.random and torch draw different initial traces: hand JAX's over.
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    tt._base_sigma = tt.state.sigma
    video = _video(rng, pos)
    return (jt, tt, jS.StreamingVideo(video, block=BLOCK),
            tS.StreamingVideo(video, block=BLOCK, device="cpu"))


def test_fit_streaming_with_fit_sigma_matches_jax(rng):
    jt, tt, jsrc, tsrc = _trainers(rng, fit_sigma=True, sigma_steps=3,
                                   sigma_frames=6, sigma_every=1,
                                   sigma_anneal=(1.3,))
    jres = jt.fit(jsrc)
    tres = tt.fit(tsrc)
    close(tres.traces, jres.traces, 1e-4)
    close(tres.beta, jres.beta, 1e-4)
    close(tres.state.sigma, jres.state.sigma, 1e-4)
    assert [m["phase"] for m in tres.metrics] == [
        m["phase"] for m in jres.metrics]
    assert any(m["phase"] == "sigma" for m in tres.metrics)


def test_engine_refine_streaming_matches_jax(rng):
    jt, tt, jsrc, tsrc = _trainers(rng)
    jt.refine(jsrc, rounds=1, epochs=5)
    tt.refine(tsrc, rounds=1, epochs=5)
    np.testing.assert_allclose(tt.pos_t.numpy(), np.asarray(jt.pos_t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.traces, np.asarray(jt.traces), rtol=1e-5,
                               atol=1e-6)
    ref = [m for m in tt.metrics if m["phase"] == "refine"]
    assert len(ref) == 1 and np.isfinite(ref[0]["recon_mse"])


def test_update_sigma_streaming_equals_resident(rng):
    """The streamed width fit gathers its fixed-size subsample through
    ``read``: the same widths as the resident engine's."""
    _, tt, _, tsrc = _trainers(rng, fit_sigma=True, sigma_steps=4,
                               sigma_frames=6)
    state0 = tt.state
    tt.update_sigma(tsrc)
    streamed = tt.state.sigma
    tt.state = state0
    tt.update_sigma(tsrc.array)
    assert torch.equal(streamed, tt.state.sigma)
