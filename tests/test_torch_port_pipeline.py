"""The port's one-call pipeline against ``dnmf_tpu`` on the same NumPy
inputs: the registration-seeded warps (``ops/basis.py``), summary-image
seeding (``ops/seeding.py``), ``register_and_demix`` in every branch,
Grams and fits of seeds on border planes, and kernel C4's plain path (the Gram from precomputed coordinate rows)
against the Pallas kernel in interpret mode.

Tolerances: seeded affine warps 1e-5 absolute (quadratic fits 1e-4
relative to the largest coefficient: ten-term ridge solves in float32);
summary images 1e-5 of their max; peaks equal; the pipeline's positions
1e-4 px, traces and beta 1e-4 of their max (registration, seeding and a
whole fit of float32 reorderings); C4 1e-5 of the reference's max.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.data import streaming as jS
from dnmf_tpu.engine import pipeline as jP
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import gram_analytic as jGA
from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu.ops import seeding as jseed
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data import streaming as tS
from dnmf_tpu_torch.engine import pipeline as tP
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import basis as tB
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import gram_analytic as tGA
from dnmf_tpu_torch.ops import seeding as tseed


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def close_abs(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol, f"max abs error {err:.3e} > {tol:g}"


# ------------------------------------------------------------ seeded warps
def _patch_field(rng, n, t=5, flat_z=False):
    pts = rng.uniform([4, 4, 1], [36, 28, 5], (n, 3)).astype(np.float32)
    if flat_z:
        pts[:, 2] = 2.0  # a single z plane of patch centres
    disp = rng.normal(0, 1.0, (t, n, 3)).astype(np.float32)
    return pts, disp


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("n,flat_z", [(0, False), (2, False), (3, False),
                                      (6, False), (9, False), (9, True)])
def test_affine_seed_matches_jax(rng, scaling, n, flat_z):
    pts, disp = _patch_field(rng, n, flat_z=flat_z)
    size = (40, 32, 6)
    ref = jB.affine_beta_from_displacements(
        jnp.asarray(pts), jnp.asarray(disp), size, scaling=scaling)
    got = tB.affine_beta_from_displacements(
        torch.from_numpy(pts), torch.from_numpy(disp), size, scaling=scaling)
    close_abs(got, ref, 1e-5)


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("n,flat_z", [(5, False), (12, False), (16, False),
                                      (16, True)])
def test_quadratic_seed_matches_jax(rng, scaling, n, flat_z):
    pts, disp = _patch_field(rng, n, flat_z=flat_z)
    size = (40, 32, 6)
    ref = jB.quadratic_beta_from_displacements(
        jnp.asarray(pts), jnp.asarray(disp), size, scaling=scaling)
    got = tB.quadratic_beta_from_displacements(
        torch.from_numpy(pts), torch.from_numpy(disp), size, scaling=scaling)
    close(got, ref, 1e-4)


def test_centered_quadratic_expansion_matches_jax(rng):
    mu = rng.normal(size=3).astype(np.float32)
    close_abs(tB._centered_quadratic_expansion(torch.from_numpy(mu)),
              jB._centered_quadratic_expansion(jnp.asarray(mu)), 1e-6)


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_translation_beta_matches_jax(rng, scaling):
    shifts = rng.normal(0, 2, (6, 3)).astype(np.float32)
    size = (40, 32, 1)  # a singleton axis normalizes by 1
    close_abs(tB.translation_beta(torch.from_numpy(shifts), size, scaling),
              jB.translation_beta(jnp.asarray(shifts), size, scaling), 1e-6)


def test_init_state_takes_beta0(rng):
    """A registration-seeded beta crosses over whole: the JAX state made
    with ``beta0`` carries into the port, and the port's own ``beta0``
    starts Adam at zero moments around it."""
    kw = dict(size=(16, 12, 4), num_neurons=3, num_frames=5, shape_std=2.0)
    beta0 = jB.translation_beta(jnp.asarray(
        rng.normal(size=(5, 3)).astype(np.float32)), kw["size"])
    opt = jM.make_motion_optimizer(jcfg.OptimizerConfig())
    js = jM.init_state(jcfg.ModelConfig(**kw), opt, beta0=beta0)
    adam = js.opt_state[0]
    ts = tM.state_from_numpy({"beta": js.beta, "c": js.c, "pos": js.pos,
                              "sigma": js.sigma, "count": adam.count,
                              "mu": adam.mu, "nu": adam.nu})
    own = tM.init_state(tcfg.ModelConfig(**kw),
                        beta0=torch.from_numpy(np.asarray(beta0)))
    for st in (ts, own):
        assert torch.equal(st.beta, torch.from_numpy(np.asarray(beta0)))
        assert int(st.count) == 0
        assert not st.mu.any() and not st.nu.any()
    with pytest.raises(ValueError, match="beta0"):
        tM.init_state(tcfg.ModelConfig(**kw), beta0=torch.zeros(4, 10, 3))


# ----------------------------------------------------------------- seeding
SEED_SIZE = (20, 16, 4)
SEED_T = 23


def _seed_video(seed=0):
    rng = np.random.default_rng(seed)
    pos = np.array([[5, 4, 1], [14, 5, 2], [6, 12, 2], [15, 12, 1]], float)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SEED_SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 4.0)
    c = rng.exponential(1.0, (4, SEED_T)) * (rng.uniform(
        size=(4, SEED_T)) < 0.4)
    video = (a @ c).T + 0.05 * rng.uniform(size=(SEED_T, grid.shape[0]))
    return video.reshape((SEED_T,) + SEED_SIZE).astype(np.float32), pos


@pytest.mark.parametrize("mode", ["array", "streamed", "shifted",
                                  "streamed_shifted"])
def test_summary_images_match_jax(rng, mode):
    video, _ = _seed_video()
    shifts = None
    if "shifted" in mode:
        shifts = rng.uniform(-2, 2, (SEED_T, 3))
        shifts[:, 2] = rng.uniform(-0.5, 0.5, SEED_T)
    if mode.startswith("streamed"):
        ref = jseed.summary_images(jS.StreamingVideo(video, block=7),
                                   SEED_SIZE, shifts=shifts)
        got = tseed.summary_images(
            tS.StreamingVideo(video, block=7, device="cpu"), SEED_SIZE,
            shifts=shifts)
    else:
        ref = jseed.summary_images(video, SEED_SIZE, frame_block=8,
                                   shifts=shifts)
        got = tseed.summary_images(video, SEED_SIZE, frame_block=8,
                                   shifts=shifts, device="cpu")
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        close(g, r, 1e-5)


def test_summary_images_of_a_tensor_match_numpy():
    video, _ = _seed_video()
    a = tseed.summary_images(video, SEED_SIZE, device="cpu")
    b = tseed.summary_images(torch.from_numpy(video), SEED_SIZE)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num", [3, 4, 9, 40])
def test_detect_peaks_match_jax(num):
    """All three tiers: 3-4 seeds from the thresholded maxima, 9 from the
    sub-threshold ones, 40 from the bounded voxel scan."""
    video, _ = _seed_video()
    corr, pnr = jseed.summary_images(video, SEED_SIZE)
    corr, pnr = np.asarray(corr), np.asarray(pnr)
    np.testing.assert_array_equal(
        tseed.detect_peaks_summary(corr, pnr, num, min_distance=3.0),
        jseed.detect_peaks_summary(corr, pnr, num, min_distance=3.0))
    template = video.mean(0)
    np.testing.assert_array_equal(tP.detect_peaks(template, num),
                                  jP.detect_peaks(template, num))


def test_detect_peaks_on_a_blank_volume():
    z = np.zeros(SEED_SIZE, np.float32)
    got = tseed.detect_peaks_summary(z, z, 2)
    np.testing.assert_array_equal(got, jseed.detect_peaks_summary(z, z, 2))


# ---------------------------------------------------------------- pipeline
RIGID = dict(size=(24, 24, 2), k=4, t=8,
             reg=dict(max_shifts=(4, 4, 1), pw_rigid=False, is3d=True,
                      splits=2, border_nan=False))
PW = dict(size=(40, 40, 4), k=6, t=8,
          reg=dict(max_shifts=(3, 3, 1), pw_rigid=True, is3d=True,
                   strides=(10, 10, 4), overlaps=(4, 4, 0), splits=2,
                   border_nan=False))
OPT = dict(learning_rate=1e-3, outer_rounds=2, motion_epochs=3, mu_iters=15,
           gamma_motion=0.1)


def _pipe_video(case, seed=2):
    """Gaussian neurons on a noise floor, moving by a smooth drift."""
    rng = np.random.default_rng(seed)
    size, k, t = case["size"], case["k"], case["t"]
    lo = np.array([5.0, 5.0, 0.5])
    hi = np.array(size, float) - np.array([6.0, 6.0, 1.5])
    while True:  # neurons at least 6 px apart
        pos = rng.uniform(lo, hi, (k, 3))
        d = np.linalg.norm(pos[:, None, :2] - pos[None, :, :2], axis=-1)
        if (d + 100 * np.eye(k)).min() >= 6.0:
            break
    tt = np.arange(t)
    drift = np.stack([1.5 * np.sin(2 * np.pi * tt / t),
                      np.cos(2 * np.pi * tt / t) - 1.0, 0 * tt], -1)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in size],
                                indexing="ij"), -1).reshape(-1, 3)
    c = 0.2 + rng.exponential(1.0, (k, t)) * (rng.uniform(size=(k, t)) < 0.5)
    frames = []
    for i in range(t):
        a = np.exp(-((grid[:, None] - (pos + drift[i])[None]) ** 2).sum(-1)
                   / 4.0)
        frames.append(a @ c[:, i])
    video = np.stack(frames)
    video = video / video.max() + 0.05 * rng.uniform(size=video.shape)
    return video.reshape((t,) + size).astype(np.float32), pos


def _source(kind, video, tmp_path, jax_side):
    if kind == "resident":
        return video
    if kind == "streamed":
        return (jS.StreamingVideo(video, block=3) if jax_side
                else tS.StreamingVideo(video, block=3, device="cpu"))
    path = tmp_path / "rec.raw"
    if not path.exists():
        video.tofile(path)
    return np.memmap(path, dtype=np.float32, mode="r", shape=video.shape)


def _run_both(monkeypatch, tmp_path, case, kind="resident", **kw):
    """The JAX and the port's ``register_and_demix`` on one recording;
    the port starts from the JAX run's initial traces."""
    video, pos = _pipe_video(case)
    mk = dict(size=case["size"], num_neurons=case["k"], num_frames=case["t"],
              shape_std=2.0)
    cfgs = {}
    for name, mod in (("jax", jcfg), ("torch", tcfg)):
        cfgs[name] = dict(registration=mod.RegistrationConfig(**case["reg"]),
                          model=mod.ModelConfig(**mk),
                          optimizer=mod.OptimizerConfig(**OPT))
    if "points" not in kw and "num_neurons" not in kw:
        kw["num_neurons"] = case["k"]
    first = {}
    j_init = jM.init_state

    def capture(*a, **k):
        st = j_init(*a, **k)
        first["c"] = np.array(st.c)
        return st

    monkeypatch.setattr(jM, "init_state", capture)
    res_j = jP.register_and_demix(_source(kind, video, tmp_path, True),
                                  **cfgs["jax"], **kw)
    t_init = tM.init_state

    def handed_over(*a, **k):
        return t_init(*a, **k).replace(c=torch.from_numpy(first["c"]))

    monkeypatch.setattr(tM, "init_state", handed_over)
    res_t = tP.register_and_demix(_source(kind, video, tmp_path, False),
                                  **cfgs["torch"], **kw, device="cpu")
    return res_j, res_t, pos


def _check_pipeline(res_j, res_t):
    close_abs(res_t.positions, res_j.positions, 1e-4)
    close(res_t.traces, res_j.traces, 1e-4)
    # Relative to the largest coefficient: a quadratic seed on a flat patch
    # grid starts some coefficients at O(10).
    close(res_t.fit.beta, np.asarray(res_j.fit.state.beta), 1e-4)
    assert [m["phase"] for m in res_t.fit.metrics] == [
        m["phase"] for m in res_j.fit.metrics]


@pytest.mark.parametrize("kind", ["resident", "streamed", "memmap"])
def test_register_and_demix_rigid_matches_jax(monkeypatch, tmp_path, kind):
    res_j, res_t, _ = _run_both(monkeypatch, tmp_path, RIGID, kind,
                                refine_positions=kind == "memmap",
                                refine_rounds=1, refine_epochs=4)
    _check_pipeline(res_j, res_t)
    np.testing.assert_array_equal(np.asarray(res_t.motion.shifts_rig),
                                  np.asarray(res_j.motion.shifts_rig))


@pytest.mark.parametrize("seed_mode", ["auto", "affine", "quadratic"])
def test_register_and_demix_pw_rigid_matches_jax(monkeypatch, tmp_path,
                                                 seed_mode):
    """Piecewise-rigid registration on 16 patches: "auto" takes the
    quadratic seed there."""
    res_j, res_t, _ = _run_both(monkeypatch, tmp_path, PW,
                                seed_mode=seed_mode)
    _check_pipeline(res_j, res_t)


@pytest.mark.parametrize("seeder", ["summary", "template"])
def test_register_and_demix_seeders_match_jax(monkeypatch, tmp_path, seeder):
    res_j, res_t, _ = _run_both(monkeypatch, tmp_path, RIGID, seeder=seeder,
                                seed_deformation=seeder == "summary")
    _check_pipeline(res_j, res_t)


def test_register_and_demix_points_and_shortfall(monkeypatch, tmp_path):
    """Pinned points go through as frame-0 positions; fewer points than
    ``num_neurons`` warn, as in the JAX package."""
    case = dict(RIGID, k=3)
    _, pos = _pipe_video(case)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res_j, res_t, _ = _run_both(monkeypatch, tmp_path, case,
                                    points=pos, num_neurons=4)
    assert sum("3 of the requested 4" in str(w.message)
               for w in caught) == 2  # one per package
    _check_pipeline(res_j, res_t)


def test_tracked_points_flip_z_as_in_jax():
    """Registration corrects z with the sign of x/y, but both packages
    track points (and seed warps) with the opposite z sign, the
    reference's convention (ROADMAP Queue 3): content moved by +2 px in m
    and in z is tracked to +2 in m and -2 in z."""
    from dnmf_tpu.registration import MotionCorrect as JMC
    from dnmf_tpu_torch.registration import MotionCorrect as TMC

    size = (48, 48, 16)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in size],
                                indexing="ij"), -1)
    p = np.array([24.0, 20.0, 7.0])

    def blob(c):
        return np.exp(-((grid - c) ** 2).sum(-1) / 8.0)

    video = np.stack([blob(p + d) + 0.3 * blob(p + d + [8.0, 10.0, 3.0])
                      for d in ([0.0] * 3, [2.0, 0.0, 2.0]) * 2])
    video = video.astype(np.float32)
    reg = dict(max_shifts=(4, 4, 3), pw_rigid=True, strides=(24, 24, 16),
               overlaps=(8, 8, 0), is3d=True, border_nan=False)
    mj = JMC(jnp.asarray(video), jcfg.RegistrationConfig(**reg))
    mt = TMC(video, tcfg.RegistrationConfig(**reg), device="cpu")
    mj.motion_correct()
    mt.motion_correct()
    rig = np.asarray(mt.shifts_rig)
    np.testing.assert_allclose(rig[1] - rig[0], [-2.0, 0.0, -2.0], atol=0.2)
    tracked = mt.apply_shifts_points(p[None])
    np.testing.assert_allclose(tracked, mj.apply_shifts_points(p[None]),
                               atol=1e-4)
    np.testing.assert_allclose(tracked[0, :, 1], [26.0, 20.0, 5.0], atol=0.2)


def test_register_and_demix_rejects_bad_options():
    video = np.zeros((2, 8, 8, 2), np.float32)
    with pytest.raises(ValueError, match="seed_mode"):
        tP.register_and_demix(video, num_neurons=2, seed_mode="quad",
                              device="cpu")
    with pytest.raises(ValueError, match="seeder"):
        tP.register_and_demix(video, num_neurons=2, seeder="peaks",
                              device="cpu")
    flat = tS.StreamingVideo(np.zeros((4, 48), np.float32), device="cpu")
    with pytest.raises(ValueError, match="spatial shape"):
        tP.register_and_demix(flat, num_neurons=2, device="cpu")


def test_entry_points_default_to_cuda():
    """The public entry points run on the card unless told otherwise (read
    from the signatures: nothing is allocated)."""
    for fn in (ttr.DeformableNMF.__init__, tP.register_and_demix,
               tS.StreamingVideo.__init__, tS.RawFileVideo.__init__,
               tS.open_raw_video, tS.open_memmap_video,
               tseed.summary_images):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


# ------------------------------------------------------ border-plane seeds
BORDER_SIZE = (24, 24, 8)  # z deeper than plane_axis_max: linearized z sums
BORDER_T = 6
# Seeds on the z = 0 and z = 7 border planes and one inside.
BORDER_POS = np.array([[8.0, 9.0, 0.0], [15.0, 14.0, 7.0], [12.0, 5.0, 4.0]],
                      np.float32)
# Seeded z translations, px: frame 2 carries the z = 7 seed's footprint
# 6 px past the volume, frame 3 every footprint 9 px past it.
BORDER_DZ = np.array([0.0, -2.0, -6.0, -9.0, -4.0, 0.0], np.float32)


def _border_case():
    """Warps, recording and true traces of seeds on border z planes whose
    footprints leave the volume in some frames, over a constant
    background of 0.1."""
    rng = np.random.default_rng(0)
    k = len(BORDER_POS)
    beta = np.array(jB.identity_beta(BORDER_T))
    beta[:, 0, 2] = BORDER_DZ / ((BORDER_SIZE[2] - 1) / 2.0)  # normalized
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in BORDER_SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    c_true = rng.uniform(0.5, 1.5, (k, BORDER_T))
    frames = []
    for t in range(BORDER_T):
        psi = grid + np.array([0.0, 0.0, BORDER_DZ[t]])
        a = np.exp(-((psi[:, None] - BORDER_POS[None]) ** 2).sum(-1) / 4.0)
        frames.append(a @ c_true[:, t] + 0.1
                      + 0.02 * rng.uniform(size=grid.shape[0]))
    return beta.astype(np.float32), np.stack(frames).astype(np.float32), c_true


def test_border_plane_grams_match_jax():
    """Both packages' closed-form Grams agree with each other and with the
    exact Gram for seeds on border planes, also where a footprint leaves
    the volume: there the diagonal falls with the footprint, in closed
    form and exact alike, while ``c1`` keeps the background under the
    footprint's tail (ROADMAP Queue 3)."""
    beta, video, _ = _border_case()
    sigma = np.full(len(BORDER_POS), 2.0, np.float32)
    window = jGA.default_window(2.0)
    ref = np.asarray(jGA.analytic_grams(
        jnp.asarray(beta), jnp.asarray(BORDER_POS), jnp.asarray(sigma),
        BORDER_SIZE, window=window))
    got = tGA.analytic_grams(torch.from_numpy(beta),
                             torch.from_numpy(BORDER_POS),
                             torch.from_numpy(sigma), BORDER_SIZE,
                             window=tGA.default_window(2.0))
    close(got, ref, 1e-5)
    exact, c1 = fused.gram_block_plain(
        torch.from_numpy(beta), torch.from_numpy(BORDER_POS),
        torch.from_numpy(sigma), torch.from_numpy(video), BORDER_SIZE)
    close(got, exact.numpy(), 1e-5)
    diag = torch.diagonal(exact, dim1=1, dim2=2)
    # The z = 7 seed in frame 2: its diagonal falls eight orders of
    # magnitude, c1 five, so MU drives its trace toward c1 / G_kk.
    assert float(diag[2, 1]) < 1e-2 * float(diag[0, 1])
    assert float(c1[2, 1] / diag[2, 1]) > 30 * float(c1[0, 1] / diag[0, 1])


@pytest.mark.parametrize("gram_mode", ["analytic", "exact"])
def test_border_plane_fit_matches_jax(gram_mode):
    """``fit`` from the same state and seeded warps gives the same traces
    in both packages, finite or not; the trace of a seed whose footprint
    left the volume runs away from the truth in both, in either Gram mode
    (the fault recorded in ROADMAP Queue 3)."""
    beta, video, c_true = _border_case()
    k = len(BORDER_POS)
    okw = dict(learning_rate=1e-4, outer_rounds=2, motion_epochs=2,
               mu_iters=50, gamma_motion=0.1)
    mk = dict(size=BORDER_SIZE, num_neurons=k, num_frames=BORDER_T,
              shape_std=2.0)
    jt = jtr.DeformableNMF(
        jcfg.ModelConfig(**mk), jcfg.OptimizerConfig(**okw),
        jcfg.RuntimeConfig(frame_block=3, use_pallas=False,
                           gram_mode=gram_mode),
        positions=jnp.asarray(BORDER_POS), beta0=jnp.asarray(beta))
    tt = ttr.DeformableNMF(
        tcfg.ModelConfig(**mk), tcfg.OptimizerConfig(**okw),
        tcfg.RuntimeConfig(frame_block=3, gram_mode=gram_mode),
        positions=BORDER_POS, beta0=torch.from_numpy(beta), device="cpu")
    adam = jt.state.opt_state[0]
    tt.state = tM.state_from_numpy(
        {"beta": jt.state.beta, "c": jt.state.c, "pos": jt.state.pos,
         "sigma": jt.state.sigma, "count": adam.count, "mu": adam.mu,
         "nu": adam.nu})
    tt._base_sigma = tt.state.sigma
    clip = video.reshape((BORDER_T,) + BORDER_SIZE)
    ref = np.asarray(jt.fit(clip).traces)
    got = tt.fit(clip).traces
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    close(got[fin], ref[fin], 1e-4)
    assert ref[1, 2] > 100 * c_true[1, 2] and got[1, 2] > 100 * c_true[1, 2]


# -------------------------------------------------------------------- C4
C4_SIZE = (16, 12, 4)


def _c4_inputs(rng, t=3, k=10):
    pos = rng.uniform([1, 1, 0], [15, 11, 3], (k, 3)).astype(np.float32)
    sigma = rng.uniform(1.2, 2.2, k).astype(np.float32)
    betas = np.asarray(jB.identity_beta(t)) + 0.01 * rng.normal(
        size=(t, 10, 3))
    betas = betas.astype(np.float32)
    y = rng.uniform(0, 1, (t, int(np.prod(C4_SIZE)))).astype(np.float32)
    return pos, sigma, betas, y


@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_psi_rows_match_jax(rng, scaling):
    _, _, betas, _ = _c4_inputs(rng)
    if scaling == "pixel":
        betas[:, 4:] *= 0.01
    psi_j, w_j = pc._xla_psi_rows(jnp.asarray(betas), C4_SIZE, scaling)
    psi_t, w_t = fused.psi_rows(torch.from_numpy(betas), C4_SIZE, scaling)
    close_abs(psi_t, psi_j, 1e-5)
    close_abs(w_t, w_j, 1e-5)


@pytest.mark.parametrize("f", [1, 2])
def test_gram_block_rows_matches_pallas_stream(rng, f):
    """C4's plain version against ``gram_block_culled(psi_source="stream")``
    in interpret mode, and the port's two psi sources against each other
    (rows computed here, or handed in by the caller)."""
    pos, sigma, betas, y = _c4_inputs(rng)
    g_j, c1_j = pc.gram_block_culled(
        jnp.asarray(betas), jnp.asarray(pos), jnp.asarray(sigma),
        jnp.asarray(y), C4_SIZE, scaling="normalized", tile_p=128, kblock=8,
        frames_per_step=f, psi_source="stream", interpret=True)
    b, p_, s, yt = (torch.from_numpy(x) for x in (betas, pos, sigma, y))
    psi, w = fused.psi_rows(b, C4_SIZE)
    g_t, c1_t = fused.gram_block_rows_plain(psi, w, p_, s, yt)
    close(g_t, g_j, 1e-5)
    close(c1_t, np.asarray(c1_j), 1e-5)
    fused.reset_launch_counts()
    g_s, c1_s = fused.gram_block(b, p_, s, yt, C4_SIZE, psi_source="stream")
    g_r, c1_r = fused.gram_block(b, p_, s, yt, C4_SIZE, psi_source="stream",
                                 rows=(psi, w))
    g_k, c1_k = fused.gram_block(b, p_, s, yt, C4_SIZE)
    assert torch.equal(g_s, g_t) and torch.equal(c1_s, c1_t)
    assert torch.equal(g_r, g_t) and torch.equal(c1_r, c1_t)
    close(g_s, g_k.numpy(), 1e-5)
    close(c1_s, c1_k.numpy(), 1e-5)
    assert sum(fused.launch_counts().values()) == 0  # CPU: plain versions
    with pytest.raises(ValueError, match="psi_source"):
        fused.gram_block(b, p_, s, yt, C4_SIZE, psi_source="xla")
