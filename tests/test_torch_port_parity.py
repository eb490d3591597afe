"""The port's reference-parity path against ``dnmf_tpu`` (plain XLA path)
from the same state and the same batch arrays, handed over as NumPy: the
serial mini-batch epoch, the batch loss, resampled and unfaded
footprints, their gradients, exact Grams and width fits, and the trainer
in parity mode.

Two configurations: analytic footprints on the normalized basis, and the
reference's numerics (resampled footprints, pixel basis, detached
regularizer).  Tolerance 1e-5 of the reference's max magnitude per epoch
and per step (``jax.random.permutation`` cannot be reproduced in torch,
so the batch arrays are passed in or ``shuffle=False``); whole fits
compound float32 reorderings over Adam and 50 trace iterations and are
held at 1e-4, as in ``tests/test_torch_port_model.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.data.streaming import StreamingVideo as JStreamingVideo
from dnmf_tpu.engine import trainer as jtr
from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import interp as jI
from dnmf_tpu.ops import resample as jR
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data.streaming import StreamingVideo
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import basis as tB
from dnmf_tpu_torch.ops import interp as tI
from dnmf_tpu_torch.ops import resample as tR

SIZE = (20, 20, 2)
K, BATCH = 4, 4
CONFIGS = {
    "analytic": (dict(), 1e-3),
    "reference": (dict(footprint_mode="resample", basis_scaling="pixel",
                       detach_regularizer=True), 1e-4),
    "unmasked": (dict(mask_out_of_bounds=False), 1e-3),
}


def close(got, ref, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def _models(name, t):
    deform, lr = CONFIGS[name]
    kw = dict(size=SIZE, num_neurons=K, num_frames=t, shape_std=3.0)
    return (jcfg.ModelConfig(deformation=jcfg.DeformationConfig(**deform),
                             **kw),
            tcfg.ModelConfig(deformation=tcfg.DeformationConfig(**deform),
                             **kw), lr)


def _video(rng, pos, t):
    """Gaussians at the positions (sigma 3, the reference's form) over
    uniform noise, as ``tests/test_torch_parity.py`` draws them."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SIZE],
                                indexing="ij"), -1).reshape(-1, 3)
    a = np.exp(-((grid[:, None] - pos[None]) ** 2).sum(-1) / 9.0)
    c = rng.uniform(0.2, 1.0, (K, t))
    v = (a @ c).T + rng.uniform(0, 0.3, (t, grid.shape[0]))
    return v.astype(np.float32)


def _jax_to_numpy(state):
    adam = state.opt_state[0]
    return {"beta": state.beta, "c": state.c, "pos": state.pos,
            "sigma": state.sigma, "count": adam.count, "mu": adam.mu,
            "nu": adam.nu}


def _pair(rng, name, t=8):
    jm, tm, lr = _models(name, t)
    opt = jM.make_motion_optimizer(jcfg.OptimizerConfig(learning_rate=lr))
    # Neurons near the border too, so the fade (or its absence) matters.
    pos = np.array([[4.0, 4.0, 1.0], [15.0, 4.5, 0.5], [1.0, 14.0, 1.2],
                    [14.5, 18.5, 0.8]], np.float32)
    js = jM.init_state(jm, opt, positions=jnp.asarray(pos),
                       key=jax.random.PRNGKey(1))
    beta = np.asarray(js.beta) + 0.01 * rng.normal(
        size=(t, 10, 3)).astype(np.float32)
    if jm.deformation.basis_scaling == "pixel":
        beta[:, 4:] *= 0.01
    if jm.deformation.footprint_mode == "resample":
        # A half-pixel shift keeps the deformed coordinates off the cell
        # faces, where the trilinear gradient jumps: a coordinate within
        # float32 resolution of a face can round to either side in the
        # two packages' matmuls (``test_resample_gradient_on_the_faces``
        # holds the faces themselves, at the identity warp).
        beta[:, 0] += 0.5
    js = js._replace(beta=jnp.asarray(beta))
    ts = tM.state_from_numpy(_jax_to_numpy(js))
    return jm, tm, opt, tM.Adam(lr), js, ts, _video(rng, pos, t)


def _check_state(ts, js, tol=1e-5):
    ref = _jax_to_numpy(js)
    for name, val in tM.state_to_numpy(ts).items():
        if name == "count":
            assert int(val) == int(ref[name])
        else:
            close(val, ref[name], tol)


def _batches(rng, t):
    """A shuffled epoch's ``(times, weights)`` as the JAX trainer lays
    them out: ``[num_batches, B]``, padded with frame 0 at weight 0."""
    pad = (-t) % BATCH
    times = np.concatenate([rng.permutation(t), np.zeros(pad, np.int64)])
    weights = np.concatenate([np.ones(t), np.zeros(pad)]).astype(np.float32)
    return times.reshape(-1, BATCH), weights.reshape(-1, BATCH)


@pytest.mark.parametrize("t", [8, 7])
@pytest.mark.parametrize("name", ["analytic", "reference"])
def test_parity_epochs_match(rng, name, t):
    jm, tm, jopt, topt, js, ts, video = _pair(rng, name, t)
    vj, vt = jnp.asarray(video), torch.from_numpy(video)
    for _ in range(2):
        times, weights = _batches(rng, t)
        js, jmet = jM.motion_epoch_parity(
            js, vj, jnp.asarray(times, jnp.int32), jnp.asarray(weights), jm,
            jopt, 0.5)
        ts, tmet = tM.motion_epoch_parity(
            ts, vt, torch.from_numpy(times), torch.from_numpy(weights), tm,
            topt, 0.5)
        _check_state(ts, js)
        for key in ("recon_mse", "reg"):
            close(tmet[key], jmet[key])
    # count steps once per batch: two epochs of ceil(t / B) batches.
    assert int(ts.count) == 2 * times.shape[0]


@pytest.mark.parametrize("name", ["analytic", "reference", "unmasked"])
def test_batch_loss_value_and_gradient(rng, name):
    jm, tm, _, _, js, ts, video = _pair(rng, name, 7)
    times, weights = _batches(rng, 7)
    times, weights = times[-1], weights[-1]  # the padded batch
    jvb = jM.model_voxel_basis(jm)
    tvb = tM.model_voxel_basis(tm)
    j_sa = jM._maybe_stored_a(js, jm, jvb)
    t_sa = tM._maybe_stored_a(ts, tm)
    args_j = (jnp.asarray(times, jnp.int32), jnp.asarray(weights),
              jnp.asarray(video[times]), js.c, js.pos, js.sigma, jm, jvb,
              0.5, j_sa)
    (loss_r, (mse_r, reg_r)), g_r = jax.value_and_grad(
        jM.batch_loss, has_aux=True)(js.beta, *args_j)
    beta = ts.beta.clone().requires_grad_(True)
    tt, tw = torch.from_numpy(times), torch.from_numpy(weights)
    yb = torch.from_numpy(video[times])
    loss, (mse, reg) = tM.batch_loss(beta, tt, tw, yb, ts.c, ts.pos,
                                     ts.sigma, tm, tvb, 0.5, t_sa)
    (g,) = torch.autograd.grad(loss, beta)
    close(loss, loss_r)
    close(mse, mse_r)
    close(reg, reg_r)
    close(g, g_r)
    # The epoch's chunked gradient is the same function.
    g2, mse2, reg2 = tM._batch_loss_grad(ts.beta, tt, tw, yb, ts.c, ts.pos,
                                         ts.sigma, tm, tvb, 0.5, t_sa)
    close(g2, g_r)
    close(mse2, mse_r)
    close(reg2, reg_r)


@pytest.mark.parametrize("name", ["reference", "unmasked"])
def test_frame_footprints_and_grads_match(rng, name):
    jm, tm, _, _, js, ts, video = _pair(rng, name, 7)
    jvb, tvb = jM.model_voxel_basis(jm), tM.model_voxel_basis(tm)
    ref = jM.frame_footprints(js.beta[3], js.pos, js.sigma, jm, jvb,
                              jM._maybe_stored_a(js, jm, jvb))
    got = tM.frame_footprints(ts.beta[3], ts.pos, ts.sigma, tm, tvb,
                              tM._maybe_stored_a(ts, tm))
    close(got, ref)
    g_r, mse_r, reg_r = jM.frame_grads_local(js, jnp.asarray(video), jm,
                                             0.3, 3)
    g, mse, reg = tM.frame_grads_local(ts, torch.from_numpy(video), tm, 0.3,
                                       3)
    close(g, g_r)
    close(mse, mse_r)
    close(reg, reg_r)


def test_unmasked_footprints_differ_from_faded_ones(rng):
    """The unmasked configuration is a different function at the border
    (the neuron at x=1 and the one at y=18.5 reach past it)."""
    _, tm, _, _, _, ts, _ = _pair(rng, "unmasked", 7)
    _, faded, _, _, _, _, _ = _pair(rng, "analytic", 7)
    vb = tM.model_voxel_basis(tm)
    a = tM.frame_footprints(ts.beta[0], ts.pos, ts.sigma, tm, vb)
    b = tM.frame_footprints(ts.beta[0], ts.pos, ts.sigma, faded, vb)
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("mode", ["exact", "analytic"])
@pytest.mark.parametrize("name", ["reference", "unmasked"])
def test_grams_match(rng, name, mode):
    jm, tm, _, _, js, ts, video = _pair(rng, name, 7)
    if mode == "analytic" and name == "reference":
        for call in (lambda: jM.compute_grams(js, jnp.asarray(video), jm,
                                              frame_block=3,
                                              gram_mode=mode),
                     lambda: tM.compute_grams(ts, torch.from_numpy(video),
                                              tm, 3, gram_mode=mode)):
            with pytest.raises(ValueError, match="analytic footprints"):
                call()
        return
    g_r, c1_r = jM.compute_grams(js, jnp.asarray(video), jm, frame_block=3,
                                 gram_mode=mode)
    g, c1 = tM.compute_grams(ts, torch.from_numpy(video), tm, 3,
                             gram_mode=mode)
    close(g, g_r)
    close(c1, c1_r)


@pytest.mark.parametrize("name", ["reference", "unmasked"])
def test_sigma_fit_matches(rng, name):
    jm, tm, _, _, js, ts, video = _pair(rng, name, 7)
    idx = np.array([0, 3, 6])
    kw = dict(steps=3, lr=0.05, lo=1.5, hi=4.8, frame_block=2)
    s_r, m_r = jM.sigma_fit(js, jnp.asarray(video[idx]), js.beta[idx],
                            js.c[:, idx].T, jm, **kw)
    s, m = tM.sigma_fit(ts, torch.from_numpy(video[idx]), ts.beta[idx],
                        ts.c[:, idx].T, tm, **kw)
    close(s, s_r)
    close(m, m_r)
    # The widths moved: the gradient is not zero in resample mode.
    assert float((s - ts.sigma).abs().max()) > 1e-3


def _trainers(rng, name, t=8, **opt):
    jm, tm, lr = _models(name, t)
    _, _, _, _, js, _, video = _pair(rng, name, t)
    pos = np.array(js.pos)
    okw = dict(learning_rate=lr, outer_rounds=2, motion_epochs=2,
               mu_iters=20, gamma_motion=0.5, motion_mode="parity",
               batch_size=BATCH, **opt)
    jt = jtr.DeformableNMF(jm, jcfg.OptimizerConfig(**okw),
                           jcfg.RuntimeConfig(frame_block=3,
                                              use_pallas=False),
                           positions=jnp.asarray(pos))
    tt = ttr.DeformableNMF(tm, tcfg.OptimizerConfig(**okw),
                           tcfg.RuntimeConfig(frame_block=3),
                           positions=pos, device="cpu")
    # jax.random and torch draw different initial traces: hand JAX's over.
    # The warps start perturbed, as in _pair: from the identity, Adam's
    # first step moves every coefficient by exactly +-lr, and the moves
    # cancel exactly on some face voxels, which then sit on the border
    # fade's kink, where float32 rounding picks either side.
    jt.state = jt.state._replace(beta=js.beta)
    tt.state = tM.state_from_numpy(_jax_to_numpy(jt.state))
    tt._base_sigma = tt.state.sigma
    return jt, tt, video


@pytest.mark.parametrize("name", ["analytic", "reference"])
def test_parity_fit_matches_jax(rng, name):
    jt, tt, video = _trainers(rng, name, shuffle=False)
    jres = jt.fit(video.reshape((-1,) + SIZE))
    tres = tt.fit(video.reshape((-1,) + SIZE))
    close(tres.traces, jres.traces, 1e-4)
    close(tres.beta, jres.beta, 1e-4)
    assert int(tres.state.count) == int(jres.state.opt_state[0].count) == 8
    assert [m["phase"] for m in tres.metrics] == [
        m["phase"] for m in jres.metrics]
    for tm_, jm_ in zip(tres.metrics, jres.metrics):
        if tm_["phase"] == "motion":
            close(np.float64(tm_["recon_mse"]),
                  np.float64(jm_["recon_mse"]), 1e-4)


@pytest.mark.parametrize("t", [8, 7])
def test_shuffled_batches_are_a_padded_permutation(rng, t):
    jt, tt, _ = _trainers(rng, "analytic", t=t)
    times, weights = tt._epoch_batches()
    jtimes, jweights = jt._epoch_batches(jax.random.PRNGKey(0))
    assert times.shape == jtimes.shape == (-(-t // BATCH), BATCH)
    assert times.dtype == torch.int64
    flat, w = times.reshape(-1).numpy(), weights.reshape(-1).numpy()
    assert sorted(flat[:t]) == list(range(t))
    assert np.array_equal(w, np.asarray(jweights).reshape(-1))
    assert np.array_equal(flat[t:], np.asarray(jtimes).reshape(-1)[t:])
    # Each epoch draws a new order from the engine's generator, which is
    # seeded from OptimizerConfig.seed.
    again = ttr.DeformableNMF(tt.model, tt.opt_config, device="cpu")
    assert torch.equal(again._epoch_batches()[0], times)
    assert not torch.equal(tt._epoch_batches()[0], times)
    j_ordered, t_ordered, _ = _trainers(rng, "analytic", t=t,
                                        shuffle=False)
    ordered, _ = t_ordered._epoch_batches()
    assert np.array_equal(ordered.numpy(), np.asarray(
        j_ordered._epoch_batches(jax.random.PRNGKey(0))[0]))


def test_gram_mode_auto_is_exact_for_resample(rng):
    jt, tt, _ = _trainers(rng, "reference")
    assert tt._gram_mode == jt._gram_mode == "exact"
    _, tu, _ = _trainers(rng, "unmasked")
    assert tu._gram_mode == "analytic" and not tu._use_kernels


@pytest.mark.parametrize("name,option", [
    ("reference", "footprint_mode='resample'"),
    ("unmasked", "mask_out_of_bounds=False"),
])
def test_use_kernels_raises_for_other_functions(name, option):
    _, tm, _ = _models(name, 8)
    with pytest.raises(ValueError, match=option.replace("(", r"\(")):
        ttr.DeformableNMF(tm, tcfg.OptimizerConfig(),
                          tcfg.RuntimeConfig(use_kernels=True), device="cpu")
    state = tM.init_state(tm)
    video = torch.zeros((8, tm.num_voxels))
    for call in (lambda: tM.frame_grads_local(state, video, tm, 0.1, 4, True),
                 lambda: tM.compute_grams(state, video, tm, 4, True)):
        with pytest.raises(ValueError, match="use_kernels=False"):
            call()


def test_streamed_parity_runs_the_parallel_epoch_as_jax_does(rng):
    """A streamed source in parity mode takes the streamed *parallel*
    epoch in the JAX package (a reference quirk, ROADMAP Queue 3); the
    port does the same."""
    jt, tt, video = _trainers(rng, "analytic", t=7)
    jt.update_motion(JStreamingVideo(video, block=3), epochs=2)
    tt.update_motion(StreamingVideo(video, block=3, device="cpu"), epochs=2)
    close(tt.state.beta, jt.state.beta)
    # One Adam step per epoch, not one per batch.
    assert int(tt.state.count) == int(jt.state.opt_state[0].count) == 2


@pytest.mark.parametrize("shift", [0.0, 0.37])
def test_resample_gradient_on_the_faces(rng, shift):
    """``resample_footprints``' autograd with respect to the coordinates
    and to the stored volume, against JAX's.  At the identity warp
    (``shift`` 0) every coordinate sits on a cell face, where ``floor``
    picks the cell on both sides; off it the gradient is smooth."""
    p = SIZE[0] * SIZE[1] * SIZE[2]
    grid = np.asarray(jB.voxel_grid(SIZE)) + np.float32(shift)
    vol = rng.uniform(size=(p, K)).astype(np.float32)
    g_out = rng.normal(size=(p, K)).astype(np.float32)

    def f(psi, v):
        return jnp.sum(jR.resample_footprints(v, psi, SIZE) * g_out)

    out_r = jR.resample_footprints(jnp.asarray(vol), jnp.asarray(grid), SIZE)
    gp_r, gv_r = jax.grad(f, argnums=(0, 1))(jnp.asarray(grid),
                                             jnp.asarray(vol))
    psi = torch.tensor(grid, requires_grad=True)
    v = torch.tensor(vol, requires_grad=True)
    out = tR.resample_footprints(v, psi, SIZE)
    gp, gv = torch.autograd.grad((out * torch.from_numpy(g_out)).sum(),
                                 (psi, v))
    close(out, out_r)
    close(gp, gp_r)
    close(gv, gv_r)
    if shift == 0.0:  # the identity warp samples the volume itself
        close(out, vol, 0.0)


def test_inverse_warp_nearest_matches(rng):
    p = SIZE[0] * SIZE[1] * SIZE[2]
    grid = np.array(jB.voxel_grid(SIZE))
    # A smooth displacement under the search radius.
    psi = (grid + 0.6 * np.sin(grid[:, ::-1] / 3.0)).astype(np.float32)
    values = rng.uniform(size=p).astype(np.float32)
    ref = jI.inverse_warp_nearest(jnp.asarray(values), jnp.asarray(psi),
                                  SIZE)
    got = tI.inverse_warp_nearest(torch.from_numpy(values),
                                  torch.from_numpy(psi), SIZE)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert torch.equal(tB.voxel_grid(SIZE), torch.from_numpy(grid))


def test_jax_pallas_path_ignores_mask_out_of_bounds(rng):
    """A reference fault, held as it is (ROADMAP Queue 3): the JAX
    package's Pallas path applies the border fade whatever
    ``mask_out_of_bounds`` says, so with ``mask_out_of_bounds=False`` it
    gives the faded model's gradients, not the unfaded ones.  The port
    refuses the kernels for that model (``ValueError``) and runs the
    unfaded function plain."""
    jm, tm, _, _, js, ts, video = _pair(rng, "unmasked", 7)
    faded, _, _ = _models("analytic", 7)
    vj = jnp.asarray(video)
    pallas = jM.frame_grads_local(js, vj, jm, 0.3, 4, use_pallas=True,
                                  pallas_interpret=True)
    masked = jM.frame_grads_local(js, vj, faded, 0.3, 4)
    unmasked = jM.frame_grads_local(js, vj, jm, 0.3, 4)
    for got, ref in zip(pallas, masked):
        close(got, ref, 1e-4)
    assert np.abs(np.asarray(pallas[0]) - np.asarray(unmasked[0])).max() \
        > 1e-2 * np.abs(np.asarray(unmasked[0])).max()
    port = tM.frame_grads_local(ts, torch.from_numpy(video), tm, 0.3, 4)
    for got, ref in zip(port, unmasked):
        close(got, ref)
