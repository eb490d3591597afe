"""The port's recordings axis (several recordings of one size, K and T
demixed together) against per-recording calls and against the JAX
package's ``vmap``-ed ``batched_round``, on the CPU.

On CPU tensors the kernel wrappers run their plain versions, which take
the recordings axis by applying the single-recording plain version to
each recording; the kernels' own recordings axis (one launch per frame
block for all recordings, bit-equal per recording to launches of one
recording) is held on the card by ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``.  Inputs come from NumPy seeds.  Tolerances: the plain
wrappers against per-recording calls are exact (the same calls); the
batched round's model steps against per-recording steps within rtol
1e-6 (batched products and reductions may order sums differently); the
round against JAX at the tolerances of ``tests/test_sharding.py``'s
batched test (beta rtol 1e-5 / atol 1e-7, C rtol 1e-4 / atol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnmf_tpu.config import ModelConfig
from dnmf_tpu.models import dnmf as M
from dnmf_tpu.parallel.batched import batched_round, stack_states
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import parallel as tP
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import fused

SIZE = (24, 20, 4)
P = SIZE[0] * SIZE[1] * SIZE[2]
R, T, FB = 3, 8, 4
KS = (6, 70)  # both sides of the JAX package's K <= 64 kernel switch
LR, GAMMA, MU_ITERS = 1e-3, 0.1, 5


def _inputs(k, aniso, seed=0):
    """Per-recording numpy arrays: positions, widths (+-10% per recording
    and neuron), warps near identity, traces and videos."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([3.0, 3.0, 0.5]), np.array(SIZE) - [4.0, 4.0, 1.5]
    pos = lo + rng.random((R, k, 3)) * (hi - lo)
    shape = (R, k, 3) if aniso else (R, k)
    sigma = 2.0 * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, shape))
    beta = np.zeros((R, T, 10, 3))
    beta[:, :, 1, 0] = beta[:, :, 2, 1] = beta[:, :, 3, 2] = 1.0
    beta += 0.01 * rng.standard_normal(beta.shape)
    c = rng.random((R, k, T))
    videos = rng.random((R, T, P))
    return {n: a.astype(np.float32) for n, a in dict(
        pos=pos, sigma=sigma, beta=beta, c=c, videos=videos).items()}


def _t(a):
    return torch.as_tensor(a)


def _np_states(inp):
    """Per-recording state dicts (fresh Adam moments)."""
    zeros = np.zeros_like(inp["beta"][0])
    return [dict(beta=inp["beta"][r], c=inp["c"][r], pos=inp["pos"][r],
                 sigma=inp["sigma"][r], count=np.int32(0), mu=zeros,
                 nu=zeros) for r in range(R)]


def _port_states(inp):
    return tP.stack_states([tM.state_from_numpy(d)
                            for d in _np_states(inp)])


def _model(k, aniso, cls):
    return cls(size=SIZE, num_neurons=k, num_frames=T, shape_std=2.0,
               sigma_axes=3 if aniso else 1)


CASES = [(k, aniso) for k in KS for aniso in (False, True)]


@pytest.mark.parametrize("k,aniso", CASES)
def test_plain_kernels_take_a_recordings_axis(k, aniso):
    """The wrappers on CPU tensors with a recordings axis (A, B, C, each
    with its candidate counts) equal today's plain functions called per
    recording."""
    inp = _inputs(k, aniso)
    betas, y = _t(inp["beta"][:, :FB]), _t(inp["videos"][:, :FB])
    pos, sigma = _t(inp["pos"]), _t(inp["sigma"])
    c_block = _t(inp["c"][:, :, :FB]).transpose(1, 2)
    got = {
        "motion": fused.motion_block(betas, pos, sigma, c_block, y, SIZE,
                                     brick_counts=True),
        "c1": fused.c1_block(betas, pos, sigma, y, SIZE, brick_counts=True),
        "gram": fused.gram_block(betas, pos, sigma, y, SIZE,
                                 brick_counts=True)}
    assert got["motion"][0].shape == (R, FB)
    assert got["gram"][0].shape == (R, FB, k, k)
    for r in range(R):
        one = (betas[r], pos[r], sigma[r])
        want = {
            "motion": fused.motion_block_plain(*one, c_block[r], y[r], SIZE),
            "c1": (fused.c1_block_plain(*one, y[r], SIZE),),
            "gram": fused.gram_block_plain(*one, y[r], SIZE)}
        counts = fused.brick_candidates_plain(*one, SIZE).sum(-1)
        for name, outs in want.items():
            for g, w in zip(got[name], outs + (counts.to(torch.int32),)):
                np.testing.assert_array_equal(g[r].numpy(), w.numpy(),
                                              err_msg=f"{name} recording {r}")


@pytest.mark.parametrize("k,aniso", CASES)
def test_neuron_tables_per_recording(k, aniso):
    """One table per recording, each from its own positions and widths,
    equals the shared-width table of that recording; rmax is the largest
    m reach over all of them."""
    inp = _inputs(k, aniso)
    pos, sigma = _t(inp["pos"]), _t(inp["sigma"])
    table, order, rmax = fused.neuron_table(pos, sigma, per_table=True)
    reaches = []
    for r in range(R):
        t1, o1, m1 = fused.neuron_table_plain(pos[r][None], sigma[r])
        np.testing.assert_array_equal(table[r].numpy(), t1[0].numpy())
        np.testing.assert_array_equal(order[r].numpy(), o1[0].numpy())
        reaches.append(float(m1))
    assert float(rmax) == max(reaches)


@pytest.mark.parametrize("k", KS)
def test_model_steps_take_a_recordings_axis(k):
    """``frame_grads_local``, ``grams_local`` (exact and closed-form),
    ``footprint_update`` and the Adam step on a stacked state against the
    same steps per recording."""
    inp = _inputs(k, aniso=False)
    model = _model(k, False, tcfg.ModelConfig)
    states, videos = _port_states(inp), _t(inp["videos"])
    singles = [tM.state_from_numpy(d) for d in _np_states(inp)]
    adam = tM.Adam(LR)

    def close(got, want, what):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=what)

    grads = tM.frame_grads_local(states, videos, model, GAMMA, FB, True)
    stepped = adam.step(states, grads[0])
    assert stepped.count.tolist() == [1] * R
    stats = {mode: tM.grams_local(stepped, videos, model, FB, True, mode)
             for mode in ("exact", "analytic")}
    traces = tM.footprint_update(stepped, *stats["exact"], MU_ITERS, 0.05)
    for r in range(R):
        want = tM.frame_grads_local(singles[r], videos[r], model, GAMMA, FB,
                                    True)
        for g, w, what in zip(grads, want, ("grads", "mses", "regs")):
            close(g[r], w, f"{what} recording {r}")
        one = adam.step(singles[r], want[0])
        close(stepped.beta[r], one.beta, f"Adam beta recording {r}")
        for mode, got in stats.items():
            want = tM.grams_local(one, videos[r], model, FB, True, mode)
            for g, w, what in zip(got, want, ("grams", "c1")):
                close(g[r], w, f"{mode} {what} recording {r}")
        g1, c1 = stats["exact"][0][r], stats["exact"][1][r]
        close(traces.c[r],
              tM.footprint_update(one, g1, c1, MU_ITERS, 0.05).c,
              f"traces recording {r}")


@pytest.mark.parametrize("gram_mode", ["exact", "analytic"])
@pytest.mark.parametrize("k", KS)
def test_batched_round_matches_jax(k, gram_mode):
    """``batched_round`` with and without the kernels (their plain
    versions here) against JAX's ``vmap``-ed round (XLA path, which
    ``tests/test_sharding.py`` holds to its Pallas path), per-recording
    widths and positions, K on both sides of 64."""
    inp = _inputs(k, aniso=False)
    jmodel = _model(k, False, ModelConfig)
    optimizer = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jstates = stack_states([
        M.DNMFState(beta=jnp.asarray(d["beta"]), c=jnp.asarray(d["c"]),
                    pos=jnp.asarray(d["pos"]), sigma=jnp.asarray(d["sigma"]),
                    opt_state=optimizer.init(jnp.asarray(d["beta"])))
        for d in _np_states(inp)])
    new, metrics = batched_round(jstates, jnp.asarray(inp["videos"]), jmodel,
                                 optimizer, GAMMA, MU_ITERS, frame_block=FB,
                                 gram_mode=gram_mode)
    tmodel = _model(k, False, tcfg.ModelConfig)
    for use_kernels in (False, True):
        got, m = tP.batched_round(_port_states(inp), _t(inp["videos"]),
                                  tmodel, tM.Adam(LR), GAMMA, MU_ITERS,
                                  frame_block=FB, use_kernels=use_kernels,
                                  gram_mode=gram_mode)
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(new.beta),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got.c.numpy(), np.asarray(new.c),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(m["recon_mse"].numpy(),
                                   np.asarray(metrics["recon_mse"]),
                                   rtol=1e-5)
        assert got.count.tolist() == [1] * R


def test_refused_combinations():
    """A recordings axis takes no voxel range and not the rows variant,
    and needs equal shapes in every recording."""
    inp = _inputs(6, aniso=False)
    betas, y = _t(inp["beta"][:, :FB]), _t(inp["videos"][:, :FB])
    pos, sigma = _t(inp["pos"]), _t(inp["sigma"])
    c_block = _t(inp["c"][:, :, :FB]).transpose(1, 2)
    with pytest.raises(ValueError, match="recordings axis takes no p_offset"):
        fused.motion_block(betas, pos, sigma, c_block, y, SIZE, p_offset=0)
    with pytest.raises(ValueError, match="recordings axis takes no p_offset"):
        fused.gram_block(betas, pos, sigma, y, SIZE, p_offset=0)
    with pytest.raises(ValueError, match="recordings axis takes psi_source"):
        fused.gram_block(betas, pos, sigma, y, SIZE, psi_source="stream")
    psi, w = fused.psi_rows(betas[0], SIZE)
    with pytest.raises(ValueError, match="takes no recordings axis"):
        fused.gram_block_rows(psi, w, pos[0], sigma[0], y, SIZE)
    with pytest.raises(ValueError, match="equal shapes in every recording"):
        fused.c1_block(betas, pos[:2], sigma[:2], y, SIZE)
    with pytest.raises(ValueError, match="equal shapes in every recording"):
        fused.motion_block(betas, pos, sigma, c_block[..., :5], y, SIZE)
    states = [tM.state_from_numpy(d) for d in _np_states(inp)]
    states[1] = states[1].replace(pos=states[1].pos[:5],
                                  sigma=states[1].sigma[:5],
                                  c=states[1].c[:5])
    with pytest.raises(ValueError, match="equal shapes in every recording"):
        tP.stack_states(states)
    model = _model(6, False, tcfg.ModelConfig)
    with pytest.raises(ValueError, match="recordings axis takes neither"):
        tM.grams_local(_port_states(inp), _t(inp["videos"]), model, FB,
                       p_offset=0)


@pytest.mark.parametrize("footprint_mode", ["analytic", "resample"])
def test_models_without_kernels_run_recording_by_recording(footprint_mode):
    """Footprints that no kernel computes (unfaded, resampled) take the
    footprint ops recording by recording: the batched round equals each
    recording's own round, and ``use_kernels=True`` is refused."""
    inp = _inputs(6, aniso=False)
    model = tcfg.ModelConfig(
        size=SIZE, num_neurons=6, num_frames=T, shape_std=2.0,
        deformation=tcfg.DeformationConfig(footprint_mode=footprint_mode,
                                           mask_out_of_bounds=False))
    adam = tM.Adam(LR)
    got, m = tP.batched_round(_port_states(inp), _t(inp["videos"]), model,
                              adam, GAMMA, MU_ITERS, frame_block=FB)
    for r, d in enumerate(_np_states(inp)):
        st, mr = tM.motion_epoch_parallel(tM.state_from_numpy(d),
                                          _t(inp["videos"][r]), model, adam,
                                          GAMMA, FB)
        g, c1 = tM.grams_local(st, _t(inp["videos"][r]), model, FB)
        ref = tM.footprint_update(st, g, c1, MU_ITERS)
        np.testing.assert_array_equal(got.beta[r].numpy(), ref.beta.numpy())
        np.testing.assert_array_equal(got.c[r].numpy(), ref.c.numpy())
        assert float(m["recon_mse"][r]) == float(mr["recon_mse"])
    with pytest.raises(ValueError, match="use_kernels"):
        tP.batched_round(_port_states(inp), _t(inp["videos"]), model, adam,
                         GAMMA, MU_ITERS, frame_block=FB, use_kernels=True)
