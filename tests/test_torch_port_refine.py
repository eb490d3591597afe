"""Position refinement and width fitting of the port against ``dnmf_tpu``.

Kernel plain versions are held against the Pallas kernels in interpret
mode (``dot_mode="highest"`` where the kernel has one); the model layer
and the trainer against the JAX package's XLA paths (``use_pallas``
off), from the same state handed over as NumPy.

Tolerances, relative to the reference's max magnitude unless stated:
1e-5 for mse, c1, G and closed-form Grams (float32 sums in another
order); 1e-4 for dpos and for dsigma against JAX autodiff (gradients
summed in another order); 5e-3 for dsigma against the Pallas kernel,
whose binomial moment form cancels; after several Adam steps, pos_t
within 1e-4 px, recon_mse and C within 1e-4, sigma within 3e-4.
``kblock=8`` with K=20 makes the culled kernels cross neuron blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.models import refine as jR
from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import gram_analytic as jGA
from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import parallel as tparallel
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import refine as tR
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import gram_analytic as tGA

K = 20
CASES = {
    "box": (16, 12, 4),
    "thin_z": (12, 10, 2),
}


def close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def close_abs(got, ref, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.max(np.abs(got - np.asarray(ref))))
    assert err <= atol, f"max abs error {err:.3e} > {atol:g}"


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _inputs(rng, size, aniso=False, b=3, jitter=0.7):
    """``(betas, pos_t, sigma, c, y)``: per-frame positions about 0.7 px
    around random anchors; frame 0 at the identity warp (fade ties)."""
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform([1, 1, 0], hi - [1, 1, 0], (K, 3))
    pos_t = pos[None] + jitter * rng.normal(size=(b, K, 3))
    sigma = rng.uniform(1.0, 2.0, (K, 3) if aniso else (K,))
    betas = np.asarray(jB.identity_beta(b)) + 0.01 * rng.normal(
        size=(b, 10, 3))
    betas[0] = np.asarray(jB.identity_beta(1))[0]
    y = rng.uniform(0, 1, (b, size[0] * size[1] * size[2]))
    c = rng.uniform(0.2, 1, (b, K))
    return [x.astype(np.float32) for x in (betas, pos_t, sigma, c, y)]


def _crossing(pos_t):
    """Neurons 0 and 1 swap places in m across the frames (their means
    differ, so both packages sort them alike)."""
    b = pos_t.shape[0]
    pos_t = pos_t.copy()
    pos_t[:, 0, 0] = np.linspace(2.0, 12.0, b)
    pos_t[:, 1, 0] = np.linspace(11.0, 4.0, b)
    return pos_t


# --------------------------------------------------------------- kernels
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("want_dsigma", [False, True])
def test_refine_plain_matches_pallas(rng, case, aniso, want_dsigma):
    size = CASES[case]
    args = _inputs(rng, size, aniso)
    ref = pc.refine_block_culled(*_j(*args), size, tile_p=128, kblock=8,
                                 want_dsigma=want_dsigma, interpret=True)
    got = fused.refine_block_plain(*_t(*args), size,
                                   want_dsigma=want_dsigma)
    assert len(got) == len(ref) == (3 if want_dsigma else 2)
    close(got[0], ref[0], 1e-5)
    close(got[1], ref[1], 1e-4)
    if want_dsigma:
        close(got[2], ref[2], 5e-3)


def _jax_data_term(betas, pos_t, sigma, c, y, size, scaling):
    """Per-frame mse and its autodiff gradients wrt (pos_t, sigma) on the
    JAX package's XLA footprints."""
    model = jcfg.ModelConfig(
        size=size, num_neurons=K, num_frames=betas.shape[0],
        deformation=jcfg.DeformationConfig(basis_scaling=scaling))
    vb = jM.model_voxel_basis(model)

    def frame_mse(pos_f, sig, beta_f, c_f, y_f):
        a = jR._tracked_frame_footprints(beta_f, pos_f, sig, model, vb)
        recon = jnp.dot(a, c_f, precision=jax.lax.Precision.HIGHEST)
        return jnp.mean((recon - y_f) ** 2)

    fn = jax.vmap(jax.value_and_grad(frame_mse, argnums=(0, 1)),
                  in_axes=(0, None, 0, 0, 0))
    mse, (dpos, dsig) = fn(*_j(pos_t, sigma, betas, c, y))
    return mse, dpos, dsig


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_refine_plain_matches_jax_autodiff(rng, case, aniso, scaling):
    size = CASES[case]
    betas, pos_t, sigma, c, y = _inputs(rng, size, aniso)
    if scaling == "pixel":
        betas[:, 4:] *= 0.01
    ref = _jax_data_term(betas, pos_t, sigma, c, y, size, scaling)
    got = fused.refine_block_plain(*_t(betas, pos_t, sigma, c, y), size,
                                   scaling, want_dsigma=True)
    close(got[0], ref[0], 1e-5)
    close(got[1], ref[1], 1e-4)
    close(got[2], ref[2], 1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("crossing", [False, True])
def test_tracked_c1_and_gram_plain_match_pallas(rng, case, aniso, crossing):
    size = CASES[case]
    betas, pos_t, sigma, _, y = _inputs(rng, size, aniso)
    if crossing:
        pos_t = _crossing(pos_t)
    jargs = _j(betas, pos_t, sigma, y)
    c1_r = pc.c1_block_culled(*jargs, size, tile_p=128, kblock=8,
                              dot_mode="highest", interpret=True)
    g_r, c1g_r = pc.gram_block_tracked(*jargs, size, tile_p=128, kblock=8,
                                       dot_mode="highest", interpret=True)
    targs = _t(betas, pos_t, sigma, y)
    close(fused.c1_block_plain(*targs, size), c1_r, 1e-5)
    g, c1 = fused.gram_block_tracked_plain(*targs, size)
    close(g, g_r, 1e-5)
    close(c1, c1g_r, 1e-5)


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("crossing", [False, True])
def test_sorted_params_tracked_match_jax(rng, aniso, crossing):
    """Per-frame neuron tables: the mean-m order, each frame's centers,
    per-axis scales and all-frame block intervals."""
    betas, pos_t, sigma, _, _ = _inputs(rng, CASES["box"], aniso, b=4)
    if crossing:
        pos_t = _crossing(pos_t)
    perm_r, params_r, blocks_r = pc._sorted_params_tracked(
        *_j(pos_t, sigma), 8, 3)
    perm, params, blocks = fused.sorted_params_tracked(*_t(pos_t, sigma),
                                                       kb=8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    params_r = np.asarray(params_r)
    np.testing.assert_array_equal(params[..., :3].numpy(), params_r[..., :3])
    np.testing.assert_allclose(params[..., 3:6].numpy(),
                               params_r[..., [3, 5, 6]], rtol=1e-6)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(blocks_r),
                               rtol=1e-6)
    # The shared-anchor table is the one-frame case.
    _, p1, b1 = fused.sorted_params_tracked(*_t(pos_t[:1], sigma), kb=8)
    _, p_shared, b_shared = fused.sorted_params(*_t(pos_t[0], sigma), kb=8)
    assert torch.equal(p1[0], p_shared) and torch.equal(b1, b_shared)


@pytest.mark.parametrize("size", [(16, 12, 4), (14, 12, 6)])
@pytest.mark.parametrize("aniso", [False, True])
def test_analytic_grams_tracked_match(rng, size, aniso):
    b = 3
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform(0.5, hi - 0.5, (9, 3))
    pos_t = (pos[None] + 0.6 * rng.normal(size=(b, 9, 3))).astype(np.float32)
    sigma = rng.uniform(1.2, 2.2, (9, 3) if aniso else (9,)).astype(
        np.float32)
    betas = (np.asarray(jB.identity_beta(b)) + 0.01 * rng.normal(
        size=(b, 10, 3))).astype(np.float32)
    window = tGA.default_window(2.2)
    ref = jGA.analytic_grams_tracked(*_j(betas, pos_t, sigma), size,
                                     window=window)
    got = tGA.analytic_grams_tracked(*_t(betas, pos_t, sigma), size,
                                     window=window)
    close(got, ref, 1e-5)


def test_adam_update_matches_optax(rng):
    opt = optax.adam(0.05)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    jx, jstate = jnp.asarray(x), opt.init(jnp.asarray(x))
    adam = tM.Adam(0.05)
    tx = torch.from_numpy(x)
    count, mu, nu = adam.init(tx)
    for _ in range(4):
        g = rng.normal(size=x.shape).astype(np.float32)
        upd, jstate = opt.update(jnp.asarray(g), jstate, jx)
        jx = optax.apply_updates(jx, upd)
        tx, count, mu, nu = adam.update(tx, torch.from_numpy(g), count, mu,
                                        nu)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert int(count) == 4


# ----------------------------------------------------------- model layer
SIZE = (16, 12, 4)
KM, T, FB = 6, 7, 3  # the last frame block is short


def _models(sigma_axes=1):
    kw = dict(size=SIZE, num_neurons=KM, num_frames=T, shape_std=2.0,
              sigma_axes=sigma_axes)
    return jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _jittered_video(rng, pos, sigma=2.0, jitter=0.6):
    """Frames of neurons moved independently per frame (no global warp
    expresses it), plus noise."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    c = rng.uniform(0.2, 1.0, (KM, T))
    frames = []
    for t in range(T):
        p = pos + jitter * rng.normal(size=pos.shape)
        a = np.exp(-((grid[:, None] - p[None]) ** 2).sum(-1) / sigma ** 2)
        frames.append(a @ c[:, t])
    v = np.stack(frames) + rng.uniform(0, 0.1, (T, grid.shape[0]))
    return v.astype(np.float32)


def _pair(rng, sigma_axes=1):
    jm, tm = _models(sigma_axes)
    opt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=1e-3))
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (KM, 3)).astype(np.float32)
    js = jM.init_state(jm, opt, positions=jnp.asarray(pos),
                       key=jax.random.PRNGKey(1))
    beta = np.asarray(js.beta) + 0.01 * rng.normal(size=(T, 10, 3))
    sig = np.asarray(js.sigma) * rng.uniform(0.8, 1.2, js.sigma.shape)
    js = js._replace(beta=jnp.asarray(beta, jnp.float32),
                     sigma=jnp.asarray(sig, jnp.float32))
    ts = tM.state_from_numpy(_jax_to_numpy(js))
    return jm, tm, js, ts, _jittered_video(rng, pos)


def test_refine_positions_match(rng):
    jm, tm, js, ts, video = _pair(rng)
    kw = dict(epochs=8, learning_rate=0.05, prior=1e-3, frame_block=FB)
    pos_r, m_r = jR.refine_positions(js, None, jnp.asarray(video), jm, **kw)
    pos, m = tR.refine_positions(ts, None, torch.from_numpy(video), tm, **kw)
    close_abs(pos, pos_r, 1e-4)
    close(m["recon_mse"], m_r["recon_mse"], 1e-4)
    # Starting from given positions continues the fit.
    pos2_r, _ = jR.refine_positions(js, pos_r, jnp.asarray(video), jm, **kw)
    pos2, _ = tR.refine_positions(ts, torch.from_numpy(np.array(pos_r)),
                                  torch.from_numpy(video), tm, **kw)
    close_abs(pos2, pos2_r, 1e-4)


@pytest.mark.parametrize("mode", ["exact", "analytic"])
@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_tracked_grams_match(rng, mode, sigma_axes):
    jm, tm, js, ts, video = _pair(rng, sigma_axes)
    pos_t = (np.asarray(js.pos)[None] + 0.5 * rng.normal(
        size=(T, KM, 3))).astype(np.float32)
    g_r, c1_r = jR.tracked_grams(js, jnp.asarray(pos_t), jnp.asarray(video),
                                 jm, frame_block=FB, gram_mode=mode)
    g, c1 = tR.tracked_grams(ts, torch.from_numpy(pos_t),
                             torch.from_numpy(video), tm, frame_block=FB,
                             gram_mode=mode)
    close(g, g_r, 1e-5)
    close(c1, c1_r, 1e-5)


@pytest.mark.parametrize("solver", ["mu", "fista"])
@pytest.mark.parametrize("mode", ["exact", "analytic"])
def test_refined_rounds_match(rng, solver, mode):
    jm, tm, js, ts, video = _pair(rng)
    kw = dict(rounds=2, epochs=4, mu_iters=10, learning_rate=0.05,
              prior=3e-4, frame_block=FB, gram_mode=mode,
              trace_solver=solver)
    js2, pos_r, m_r = jR.refined_rounds(js, jnp.asarray(video), jm, **kw)
    ts2, pos, m = tR.refined_rounds(ts, torch.from_numpy(video), tm, **kw)
    close_abs(pos, pos_r, 1e-4)
    close(ts2.c, js2.c, 1e-4)
    close(m["recon_mse"], m_r["recon_mse"], 1e-4)
    assert torch.equal(ts2.beta, ts.beta) and torch.equal(ts2.pos, ts.pos)


@pytest.mark.parametrize("sigma_axes", [1, 3])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_sigma_fit_matches(rng, sigma_axes, use_kernels):
    jm, tm, js, ts, video = _pair(rng, sigma_axes)
    idx = np.array([0, 2, 3, 6])
    kw = dict(steps=5, lr=0.05, lo=1.0, hi=3.2, frame_block=3)
    sig_r, mse_r = jM.sigma_fit(js, jnp.asarray(video[idx]), js.beta[idx],
                                js.c[:, idx].T, jm, **kw)
    fused.reset_launch_counts()
    sig, mse = tM.sigma_fit(ts, torch.from_numpy(video[idx]), ts.beta[idx],
                            ts.c[:, idx].T, tm, use_kernels=use_kernels,
                            **kw)
    assert sum(fused.launch_counts().values()) == 0  # CPU: plain versions
    close(sig, sig_r, 3e-4)
    close(mse, mse_r, 1e-4)
    assert float(sig.min()) >= 1.0 - 1e-6 and float(sig.max()) <= 3.2 + 1e-6


# ---------------------------------------------------------------- trainer
def _trainers(rng, sigma_axes=1, runtime=None, **opt):
    jm, tm, *_ = _pair(rng, sigma_axes)
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (KM, 3)).astype(np.float32)
    okw = dict(learning_rate=1e-3, outer_rounds=3, motion_epochs=2,
               mu_iters=20, gamma_motion=0.1, sigma_anneal=(1.3,),
               fit_sigma=True, sigma_every=1, sigma_steps=3, sigma_frames=4)
    okw.update(opt)
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=FB,
                                              use_pallas=False),
                           positions=jnp.asarray(pos))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=FB,
                                              **(runtime or {})),
                           positions=pos, device="cpu")
    # jax.random and torch draw different initial traces: hand JAX's over.
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    tt._base_sigma = tt.state.sigma
    return jt, tt, _jittered_video(rng, pos)


@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_fit_sigma_then_refine_match_jax(rng, sigma_axes):
    jt, tt, video = _trainers(rng, sigma_axes)
    jres = jt.fit(video)
    tres = tt.fit(video)
    phases = [m["phase"] for m in tres.metrics]
    assert phases == [m["phase"] for m in jres.metrics]
    # Round 0 is annealed; rounds 1 and 2 fit the widths (sigma_every=1).
    assert phases.count("sigma") == 2
    close(tres.state.sigma, jres.state.sigma, 3e-4)
    close(tres.traces, jres.traces, 1e-4)
    jres = jt.refine(video, rounds=2, epochs=5, mu_iters=10)
    tres = tt.refine(video, rounds=2, epochs=5, mu_iters=10)
    close_abs(tt.pos_t, jt.pos_t, 1e-4)
    close(tres.traces, jres.traces, 1e-4)
    ref = [m for m in jres.metrics if m["phase"] == "refine"]
    got = [m for m in tres.metrics if m["phase"] == "refine"]
    assert len(got) == len(ref) == 1
    close(np.float64(got[0]["recon_mse"]), np.float64(ref[0]["recon_mse"]),
          1e-4)


def test_update_sigma_matches_jax(rng):
    jt, tt, video = _trainers(rng, sigma_frames=5)
    jm_ = jt.update_sigma(video)
    tm_ = tt.update_sigma(video)
    close(tt.state.sigma, jt.state.sigma, 3e-4)
    assert torch.equal(tt._base_sigma, tt.state.sigma)
    for key in ("mse", "sigma_mean", "sigma_min", "sigma_max"):
        close(np.float64(tm_[key]), np.float64(jm_[key]), 3e-4)


@pytest.mark.parametrize("fit_sigma", [False, True])
@pytest.mark.parametrize("anneal", [(), (1.3,), (2.0,)])
def test_gram_window_matches_jax(fit_sigma, anneal):
    """The closed-form window covers the widest width the fit can reach:
    the anneal's, and under fit_sigma the upper clip bound's."""
    jm, tm = _models()
    okw = dict(fit_sigma=fit_sigma, sigma_anneal=anneal)
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(use_pallas=False))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw), device="cpu")
    assert tt._gram_window() == jt._gram_window()


def test_refine_on_cpu_with_kernels_is_the_plain_refine(rng):
    """use_kernels=True on CPU tensors goes through the wrappers, which
    run the plain versions: the same positions and traces, no launches."""
    runs = []
    for use_kernels in (False, True):
        _, tt, video = _trainers(np.random.default_rng(3),
                                 runtime=dict(use_kernels=use_kernels))
        fused.reset_launch_counts()
        tt.fit(video, rounds=2)
        tt.refine(video, rounds=1, epochs=3, mu_iters=5)
        assert sum(fused.launch_counts().values()) == 0
        runs.append(tt)
    close_abs(runs[1].pos_t, runs[0].pos_t, 1e-6)
    close(runs[1].traces, runs[0].traces, 1e-6)


def test_streamed_and_sharded_refine_raise(rng):
    _, tt, video = _trainers(rng)

    class Streamed:  # a source that streams to another device
        block = 4
        device = "meta"

        def blocks(self):
            return iter(())

    class Dataset:
        def frames_flat(self):
            return video

    with pytest.raises(ValueError, match="streams to meta"):
        tt.refine(Streamed())
    # Datasets feed refine (tests/test_torch_port_datasets.py).
    tt.refine(Dataset(), rounds=1, epochs=1, mu_iters=1)
    # Mesh refinement needs a process group (the sharded runs are held
    # against JAX in tests/test_torch_port_parallel.py); parity mode
    # refuses a mesh before it looks for one.
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tparallel.make_mesh(num_time=2)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        ttr.DeformableNMF(tt.model, tcfg.OptimizerConfig(),
                          tcfg.RuntimeConfig(mesh_time=2), device="cpu")
    with pytest.raises(ValueError, match="parity motion mode"):
        ttr.DeformableNMF(tt.model, tcfg.OptimizerConfig(motion_mode="parity"),
                          tcfg.RuntimeConfig(mesh_time=2), device="cpu")
