"""The port's recovery harness (``dnmf_tpu_torch/tools/wb_recovery.py``)
against ``tools/wb_recovery.py`` on the same inputs.

``interior_positions`` and the synthesis transforms on JAX's draws match
to 1e-6 px / 1e-6 of the warps / 1e-5 of the video's max;
``warp_error_px`` to 1e-6 relative.  Each witness's fit half, on the
JAX package's fixture from JAX's registration seed and initial states
(saved by ``tests/jax_recovery_fixture.py``, fitted by the port's
command line), gives JAX's trace correlations, warp error and width
error within 1e-4.  The port's registration shifts of the fixture are
compared with JAX's on their own (upsampled peaks may part by one
subpixel bin between float32 paths; here none does).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.ops.basis import identity_beta
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.tools import wb_recovery as tW

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools import wb_recovery as jW  # noqa: E402

SIZE, K, T = (32, 32, 6), 6, 16
ROUNDS, EPOCHS, MU = 2, 3, 20


def t32(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def rel_max(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("size,margin", [((32, 32, 6), 20.0),
                                         ((96, 80, 20), 20.0),
                                         ((40, 30, 8), 5.0)])
def test_interior_positions_match_jax(size, margin):
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (9, 3))
    ref = jW.interior_positions(key, 9, size, margin)
    got = tW._interior_from_uniform(t32(u), size, margin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    pos = tW.interior_positions(gen, 200, size, margin, device="cpu")
    lo = np.minimum(margin, 0.25 * (np.array(size) - 1.0))
    assert (pos.numpy() >= lo - 1e-5).all()
    assert (pos.numpy() <= np.array(size) - 1.0 - lo + 1e-5).all()


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_warp_error_px_matches_jax(rng, scaling):
    model_j = jcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                               deformation=jcfg.DeformationConfig(
                                   basis_scaling=scaling))
    model_t = tcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                               deformation=tcfg.DeformationConfig(
                                   basis_scaling=scaling))
    a = np.asarray(identity_beta(T)) + 0.01 * rng.normal(size=(T, 10, 3))
    b = np.asarray(identity_beta(T)) + 0.01 * rng.normal(size=(T, 10, 3))
    if scaling == "pixel":
        a[:, 4:] *= 0.01
        b[:, 4:] *= 0.01
    pos = rng.uniform(2, 20, (K, 3))
    ref = jW.warp_error_px(
        *(jnp.asarray(x, jnp.float32) for x in (a, b, pos)), model_j)
    got = tW.warp_error_px(t32(a), t32(b), t32(pos), model_t)
    assert abs(got - ref) <= 1e-6 * abs(ref)
    assert tW.warp_error_px(t32(a), t32(a), t32(pos), model_t) == 0.0


@pytest.mark.parametrize("jitter,aniso", [(0.0, False), (1.0, True)])
def test_synthesis_matches_jax_on_its_draws(rng, jitter, aniso):
    size, k, t, fb = (16, 12, 4), 4, 7, 3
    model_j = jcfg.ModelConfig(size=size, num_neurons=k, num_frames=t,
                               shape_std=2.0)
    model_t = tcfg.ModelConfig(size=size, num_neurons=k, num_frames=t,
                               shape_std=2.0)
    pos = rng.uniform(3, 9, (k, 3)).astype(np.float32)
    sigma = (rng.uniform(1.5, 2.5, (k, 3)) if aniso
             else np.full((k,), 2.0)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    betas_j, c_j, video_j, pos_t_j = jW.synthesize(
        model_j, jnp.asarray(pos), jnp.asarray(sigma), key,
        frame_block=fb, jitter_px=jitter)
    _, k_beta, k_noise, k_jit = jax.random.split(key, 4)
    steps = jax.random.normal(k_beta, (t, 10, 3))
    jsteps = jax.random.normal(k_jit, (t, k, 3)) if jitter else None
    p = size[0] * size[1] * size[2]
    nkeys = jax.random.split(k_noise, -(-t // fb))
    blocks = iter([t32(jax.random.normal(nk, (min(s + fb, t) - s, p)))
                   for nk, s in zip(nkeys, range(0, t, fb))])
    betas, pos_t = tW._ground_truth_motion(
        t32(steps), t32(pos), None if jsteps is None else t32(jsteps),
        jitter)
    assert rel_max(betas, betas_j) <= 1e-6
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_t_j), rtol=0,
                               atol=1e-5)
    video = tW.render_recording(model_t, betas, t32(c_j), pos_t, t32(sigma),
                                lambda shape: next(blocks), frame_block=fb)
    assert rel_max(video, video_j) <= 1e-5


@pytest.mark.parametrize("witness", ["pipeline", "aniso"])
def test_witness_on_the_jax_fixture_matches_jax(monkeypatch, tmp_path,
                                                capsys, witness):
    """``tests/jax_recovery_fixture.py`` saves JAX's fixture, registration
    seed and initial states of a witness cut to 32x32x6, K=6, T=16, 2
    rounds of 3 epochs.  ``wb_recovery.main`` finds the port's rigid
    shifts of it equal to JAX's and fits every arm from JAX's seed and
    state: JAX's ``seeded_recovery`` figures within 1e-4."""
    import json

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax_recovery_fixture as export

    w = tW.WITNESSES[witness]
    for key, value in dict(size=SIZE, k=K, t=T, rounds=ROUNDS,
                           epochs=EPOCHS, mu_iters=MU).items():
        monkeypatch.setitem(w, key, value)
    path = tmp_path / "fixture.npz"
    np.savez(path, **export.jax_fixture(witness))
    assert tW.main(["--witness", witness, "--fixture", str(path),
                    "--device", "cpu"]) == 0
    check, *rows = [json.loads(x)
                    for x in capsys.readouterr().out.splitlines()]
    assert check["shifts_max_diff_px"] <= 1e-4
    for row, axes in zip(rows, w["arms"], strict=True):
        ref = jW.seeded_recovery(SIZE, K, T, ROUNDS, EPOCHS, MU,
                                 sigma_aniso=w["sigma_aniso"],
                                 fit_sigma_axes=axes, **w["fit"])
        assert abs(row["trace_corr_mean"] - np.mean(ref["corr"])) <= 1e-4
        assert abs(row["trace_corr_min"] - np.min(ref["corr"])) <= 1e-4
        assert abs(row["warp_err_px"] - ref["warp_err_px"]) <= 1e-4
        assert abs(row["sigma_err_px"] - ref["sigma_err"]) <= 1e-4


def test_seeded_recovery_runs_on_the_cpu():
    """The port's own fixture and fit end to end: the fields, shapes and a
    recovery a 2-round schedule reaches on a 32x32x6 recording."""
    r = tW.seeded_recovery(SIZE, K, T, ROUNDS, EPOCHS, MU, device="cpu",
                           fit_sigma=True, fit_sigma_axes=1,
                           sigma_aniso=True)
    assert r["video"].shape == (T, 32 * 32 * 6)
    assert r["sigma_gt"].shape == (K, 3) and r["state"].sigma.shape == (K,)
    assert r["shifts"].shape == (T, 3) and r["corr"].shape == (K,)
    assert np.isfinite(r["corr"]).all() and r["warp_err_px"] < 1.0
    assert float(r["video"].min()) >= 0.0
    assert all(bool(torch.isfinite(getattr(r["state"], f)).all())
               for f in ("beta", "c", "sigma"))


@pytest.mark.parametrize("witness", ["pipeline", "aniso"])
def test_port_fixture_fitted_by_jax_matches_the_port(monkeypatch, tmp_path,
                                                     capsys, witness):
    """The other way round: ``wb_recovery.main --save`` keeps a port
    fixture with the port's registration seed and initial states, and
    ``tests/jax_recovery_fixture.py``'s ``jax_fit`` (the JAX package's
    ``seeded_recovery`` on it) gives the port's figures within 1e-4."""
    import json

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax_recovery_fixture as export

    w = tW.WITNESSES[witness]
    for key, value in dict(size=SIZE, k=K, t=T, rounds=ROUNDS,
                           epochs=EPOCHS, mu_iters=MU).items():
        monkeypatch.setitem(w, key, value)
    path = tmp_path / "port_fixture.npz"
    assert tW.main(["--witness", witness, "--seeds", "2", "--save",
                    str(path), "--device", "cpu"]) == 0
    check, *rows = [json.loads(x)
                    for x in capsys.readouterr().out.splitlines()]
    assert check["shifts_max_diff_px"] == 0.0
    saved = np.load(path)
    assert saved["video"].shape == (T, 32 * 32 * 6)
    refs = export.jax_fit(witness, str(path))
    for row, ref, axes in zip(rows, refs, w["arms"], strict=True):
        assert row["sigma_axes"] == ref["sigma_axes"]
        for name in ("trace_corr_mean", "trace_corr_min", "warp_err_px",
                     "sigma_err_px"):
            assert abs(row[name] - ref[name]) <= 1e-4, (axes, name)
