"""The port's datasets, the trainer's dataset sources and the port's
copies of the NumPy-only modules against ``dnmf_tpu``.

The NeuroPAL loader reads the same ``scipy.io.savemat`` fixture into the
same arrays (bit for bit).  ``DeformableNMF.fit(dataset)`` is
``fit(dataset.video)`` bit for bit on the CPU, and matches the JAX
trainer's ``fit`` on a dataset holding the same video from the same
state: beta within 1e-5 of its max, traces within the trainer tests'
1e-4.  A base ``VideoDataset`` is not clamped, in either package.  The
copies of ``utils/volume.py``, ``utils/metrics.py`` and
``traces/postprocess.py`` give the JAX package's outputs exactly, on
NumPy arrays and on tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.data import datasets as jD
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.traces import postprocess as jpost
from dnmf_tpu.utils import metrics as jmet
from dnmf_tpu.utils import volume as jvol
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data import datasets as tD
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.traces import postprocess as tpost
from dnmf_tpu_torch.utils import metrics as tmet
from dnmf_tpu_torch.utils import volume as tvol

SIM = dict(num_neurons=4, num_frames=7, size=(16, 12, 4), shape_std=2.0,
           density=0.3, bg_snr_db=-75.0, motion="gpt",
           gp_sigma=(0.3, 0.3, 0.01), min_separation=4.0, margin=3.0)
OPT = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=2, mu_iters=20,
           gamma_motion=0.1)


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


# ------------------------------------------------------------- NeuroPAL
@pytest.fixture
def neuropal_dir(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(0)
    m, n, z, t = 20, 18, 20, 12
    data = rng.uniform(-0.1, 1.0, size=(m, n, z, t)).astype(np.float32)
    savemat(str(tmp_path / "data.mat"), {"data": data})
    k = 3
    positions = rng.uniform(1, 15, size=(k, 3, t)).astype(np.float64)
    names = np.empty((1, k), dtype=object)
    for i in range(k):
        names[0, i] = np.array([f"N{i}"])
    savemat(str(tmp_path / "traces_n.mat"),
            {"positions": positions, "neuron_names": names})
    return str(tmp_path)


@pytest.mark.parametrize("downsample,max_frames", [((2, 2, 10), 10),
                                                   ((1, 3, 4), 100)])
def test_neuropal_loader_matches_jax(neuropal_dir, downsample, max_frames):
    ref = jD.NeuroPALVideoDataset(neuropal_dir, downsample=downsample,
                                  max_frames=max_frames)
    got = tD.NeuroPALVideoDataset(neuropal_dir, downsample=downsample,
                                  max_frames=max_frames, device="cpu")
    np.testing.assert_array_equal(got.video.numpy(), np.asarray(ref.video))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(ref.positions))
    assert got.names == ref.names == ["N0", "N1", "N2"]
    assert float(got.video.min()) >= 0.0
    assert got.size == ref.size and len(got) == len(ref)


# ------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def sim():
    return tD.SimulatedVideoDataset(tcfg.SimulatorConfig(**SIM),
                                    device="cpu")


def test_simulated_dataset_is_the_clamped_fixture(sim):
    from dnmf_tpu_torch.data import simulator as tS

    video, pos, traces = tS.generate_video(tcfg.SimulatorConfig(**SIM),
                                           device="cpu")
    assert bool((video < 0).any())  # the noise goes below zero...
    assert torch.equal(sim.video, torch.clamp_min(video, 0.0))  # ...clamped
    assert torch.equal(sim.positions, pos) and torch.equal(sim.traces, traces)
    assert len(sim) == 7 and sim.size == (16, 12, 4)
    assert sim.frames_flat().shape == (7, 16 * 12 * 4)
    frame, idx = sim[3]
    assert idx == 3 and torch.equal(frame, sim.video[3])


@pytest.mark.parametrize("batch,shuffle,drop", [(3, False, False),
                                                (3, True, False),
                                                (2, True, True),
                                                (7, False, False)])
def test_batches_cover_every_frame_once(sim, batch, shuffle, drop):
    gen = torch.Generator().manual_seed(2) if shuffle else None
    blocks = list(sim.batches(batch, shuffle=shuffle, generator=gen,
                              drop_remainder=drop))
    times = torch.cat([t for _, t in blocks]).tolist()
    expect = 7 - 7 % batch if drop else 7
    assert len(times) == expect and len(set(times)) == expect
    if not shuffle:
        assert times == list(range(7))
    for frames, t in blocks:
        assert torch.equal(frames, sim.video[t])


def test_shuffle_without_a_generator_raises(sim):
    with pytest.raises(ValueError, match="torch.Generator"):
        next(sim.batches(2, shuffle=True))


# ------------------------------------------------- datasets in the trainer
def _models(sigma_axes=1):
    kw = dict(size=SIM["size"], num_neurons=SIM["num_neurons"],
              num_frames=SIM["num_frames"], shape_std=2.0,
              sigma_axes=sigma_axes)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _jax_state(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _trainers(ds, sigma_axes=1, **opt):
    """A JAX and a port trainer from one state (JAX's initial traces)."""
    jm, tm = _models(sigma_axes)
    okw = {**OPT, **opt}
    pos0 = ds.positions[:, :, 0]
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=3,
                                              use_pallas=False),
                           positions=jnp.asarray(pos0.numpy()))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=3),
                           positions=pos0, device="cpu")
    tt.state = tM.state_from_numpy(_jax_state(jt.state))
    tt._base_sigma = tt.state.sigma
    return jt, tt


def _jax_dataset(video):
    jds = jD.VideoDataset()
    jds.video = jnp.asarray(video.numpy())
    return jds


def test_fit_on_a_dataset_is_fit_on_its_video(sim):
    _, t_ds = _trainers(sim)
    _, t_arr = _trainers(sim)
    r_ds, r_arr = t_ds.fit(sim), t_arr.fit(sim.video)
    assert torch.equal(r_ds.state.beta, r_arr.state.beta)
    assert torch.equal(r_ds.state.c, r_arr.state.c)


@pytest.mark.parametrize("fit_sigma", [False, True])
def test_fit_on_a_dataset_matches_jax(sim, fit_sigma):
    jt, tt = _trainers(sim, fit_sigma=fit_sigma, sigma_every=1)
    jres = jt.fit(_jax_dataset(sim.video))
    tres = tt.fit(sim)
    close(tres.beta, jres.beta, 1e-5)
    close(tres.traces, jres.traces, 1e-4)
    close(tres.state.sigma, jres.state.sigma, 1e-5)


def test_a_base_dataset_is_not_clamped(sim):
    """Only raw arrays are clamped on the way in: a base dataset with
    negative voxels is fitted as it is, in both packages."""
    shifted = tD.VideoDataset()
    shifted.video = sim.video - 0.3 * float(sim.video.max())
    assert bool((shifted.video < 0).any())
    jt, tt = _trainers(sim)
    jres = jt.fit(_jax_dataset(shifted.video))
    tres = tt.fit(shifted)
    close(tres.beta, jres.beta, 1e-5)
    close(tres.traces, jres.traces, 1e-4)
    _, t_raw = _trainers(sim)
    clamped = t_raw.fit(shifted.video)  # a raw tensor: clamped
    assert not torch.equal(clamped.state.c, tres.state.c)


@pytest.mark.parametrize("method", ["update_motion", "update_footprints",
                                    "update_sigma", "refine"])
def test_update_methods_take_a_dataset(sim, method):
    kw = {"refine": dict(rounds=1, epochs=2, mu_iters=5)}.get(method, {})
    _, t_ds = _trainers(sim, fit_sigma=True)
    _, t_arr = _trainers(sim, fit_sigma=True)
    getattr(t_ds, method)(sim, **kw)
    getattr(t_arr, method)(sim.video, **kw)
    for name in ("beta", "c", "sigma"):
        assert torch.equal(getattr(t_ds.state, name),
                           getattr(t_arr.state, name))


# -------------------------------------------------- NumPy-only copies
def _volume():
    return np.random.default_rng(7).random((12, 11, 6))


def _bleached(seed=0, k=4, t=200, bleach=0.01):
    rng = np.random.default_rng(seed)
    base = 1.0 + 0.5 * rng.random((k, 1))
    signal = rng.random((k, t)) * (rng.random((k, t)) > 0.8)
    return (base + signal) * np.exp(-bleach * np.arange(t))[None, :]


def _with_spike():
    tr = _bleached(bleach=0.0)
    tr[1, 100] += 100.0
    return tr


def _gamma(seed, n):
    return np.random.default_rng(seed).gamma(2.0, 1.0, size=n)


def _nan_affine():
    a = 2.0 * _gamma(1, 300) - 1.0
    a[10:20] = np.nan
    return a


COPY_CASES = {
    "subcube_integer": ("subcube", lambda: (_volume(), [6.0, 5.0, 3.0],
                                            [2, 2, 1]), {}),
    "subcube_border": ("subcube", lambda: (_volume(), [0.0, 0.0, 0.0],
                                           [2, 2, 1]), {}),
    "subcube_fractional": ("subcube", lambda: (_volume(), [6.3, 5.7, 2.4],
                                               [2, 2, 1]), {}),
    "subcube_channels": ("subcube", lambda: (
        np.stack([_volume(), 2.0 * _volume()], -1), [6.2, 5.0, 3.0],
        [1, 1, 1]), {}),
    "placement": ("placement", lambda: ((7, 7, 7), [3, 3, 3],
                                        np.arange(27.0).reshape(3, 3, 3)),
                  {}),
    "placement_clipped": ("placement", lambda: ((5, 5, 5), [0, 0, 0],
                                                np.ones((3, 3, 3))), {}),
    "superpose": ("superpose", lambda: (np.full((6, 6, 6), 5.0), [3, 3, 3],
                                        np.ones((3, 3, 3))), {}),
    "max_project": ("max_project", lambda: (
        np.random.default_rng(1).random((4, 5, 3, 2)),), {}),
    "max_project_depth": ("max_project", lambda: (
        np.random.default_rng(2).random((4, 5, 6, 2, 3)),),
        dict(color_by_depth=True, cut_points=(1, 3))),
    "pairwise_distances": ("pairwise_distances", lambda: (
        np.random.default_rng(3).random((5, 3)),
        np.random.default_rng(4).random((4, 3))), {}),
    "r_squared": ("r_squared", lambda: (
        np.random.default_rng(5).random((3, 40)),
        np.random.default_rng(6).random((3, 40))), {}),
    "r_squared_raw": ("r_squared", lambda: (
        np.random.default_rng(5).random(40),
        np.random.default_rng(6).random(40)), dict(affine=False)),
    "trace_correlations": ("trace_correlations", lambda: (
        np.random.default_rng(7).random((4, 30)),
        np.concatenate([np.random.default_rng(8).random((3, 30)),
                        np.ones((1, 30))])), {}),
    "histogram_match_regular": ("histogram_match", lambda: (
        0.5 * _gamma(0, 500) + 2.0, _gamma(0, 500), 50),
        dict(kind="regular")),
    "histogram_match_nnls": ("histogram_match", lambda: (
        _nan_affine(), _gamma(1, 300), 30), {}),
    "clean_traces_bleach": ("clean_traces", lambda: (
        _bleached(bleach=0.02), 4.0),
        dict(detrend_mode=2, interp_method="linear")),
    "clean_traces_global": ("clean_traces", lambda: (
        _bleached(bleach=0.02), 4.0), dict(detrend_mode=1)),
    "clean_traces_outlier": ("clean_traces", lambda: (_with_spike(), 4.0),
                             dict(sigma_threshold=5.0, detrend_mode=0,
                                  interp_method="linear")),
    "clean_traces_dff": ("clean_traces", lambda: (
        _bleached(bleach=0.01) * 10, 4.0), dict(detrend_mode=3)),
    "clean_traces_movmean": ("clean_traces", lambda: (
        _bleached(bleach=0.0), 4.0),
        dict(detrend_mode=0, interp_method="linear",
             smooth_method="movmean", smooth_window=5)),
    "clean_traces_butter": ("clean_traces", lambda: (
        _bleached(bleach=0.0), 4.0),
        dict(detrend_mode=0, smooth_method="low", smooth_window=(4, 0.2))),
}
COPY_MODULES = [(jvol, tvol), (jmet, tmet), (jpost, tpost)]


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("case", sorted(COPY_CASES))
def test_copies_match_jax(case, as_tensor):
    name, args, kw = COPY_CASES[case]
    ref_mod, got_mod = next((j, t) for j, t in COPY_MODULES
                            if hasattr(j, name))
    ref = getattr(ref_mod, name)(*args(), **kw)
    targs = [torch.as_tensor(np.asarray(a)) if as_tensor and isinstance(
        a, np.ndarray) else a for a in args()]
    got = getattr(got_mod, name)(*targs, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_copies_are_the_jax_api():
    for jmod, tmod in COPY_MODULES:
        public = {n for n in dir(jmod) if not n.startswith("_")
                  and callable(getattr(jmod, n))
                  and getattr(getattr(jmod, n), "__module__", "")
                  == jmod.__name__}
        assert public <= set(dir(tmod)), public - set(dir(tmod))


def test_dataset_classes_mirror_jax():
    for name in ("VideoDataset", "SimulatedVideoDataset",
                 "NeuroPALVideoDataset"):
        assert hasattr(tD, name)
    assert {f.name for f in dataclasses.fields(tcfg.SimulatorConfig)} == {
        f.name for f in dataclasses.fields(jcfg.SimulatorConfig)}


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """The port keeps its own copies of the NumPy-only modules: no module
    of ``dnmf_tpu_torch`` and not ``chip_smoke.py`` imports ``jax`` or
    ``dnmf_tpu``."""
    import ast
    import pathlib

    root = pathlib.Path(tD.__file__).resolve().parents[2]
    files = sorted((root / "dnmf_tpu_torch").rglob("*.py"))
    for path in files + [root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "dnmf_tpu"), (path, name)
