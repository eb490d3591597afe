"""The closed-form Grams' wrapper (``fused.analytic_grams``, kernel
``csrc/gram_closed.cu`` on the card) and its route through
``grams_local``, on the CPU.

CPU tensors take the plain ``gram_analytic.analytic_grams``, so the
wrapper equals it exactly, for shared anchors, per-frame positions and a
recordings axis, isotropic and per-axis widths, both scalings and a thin
volume (the plane form); it also matches the JAX package's closed form.
``pair_counts``, the kernel's own count of its evaluated pairs, is
refused on CPU tensors.  ``grams_local`` with the kernels evaluates the
closed form once over the call's frames on the card, and per frame block
on the CPU (the block bounds the plain form's memory): the CPU route is
the plain one exactly, and the wrapper over the whole call, as the card
route calls it, matches the per-block result within rtol 1e-6 (the plain
form's batched products and sums may order differently by batch size).
The kernel itself is held to the plain form on the card
(``tests/test_torch_port_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import gram_analytic as jGA
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import parallel as tP
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.ops import gram_analytic as tGA

SIZES = {"box": (24, 20, 6), "thin": (30, 22, 3)}
K, B, R = 9, 4, 2


def _inputs(size, seed=0, aniso=False, tracked=False, recordings=False):
    rng = np.random.default_rng(seed)
    hi = np.asarray(size, np.float64) - 1
    lead = (R, B) if recordings else (B,)
    tables = (R,) if recordings else ((B,) if tracked else ())
    pos = rng.uniform([1, 1, 0], hi - [1, 1, 0], tables + (K, 3))
    sigma = rng.uniform(1.2, 2.2, tables[:1 if recordings else 0]
                        + ((K, 3) if aniso else (K,)))
    betas = np.zeros(lead + (10, 3))
    betas[..., 1, 0] = betas[..., 2, 1] = betas[..., 3, 2] = 1.0
    betas += 0.01 * rng.normal(size=betas.shape)
    return [torch.tensor(x, dtype=torch.float32) for x in (betas, pos, sigma)]


LAYOUTS = ["shared", "tracked", "recordings"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("shape", sorted(SIZES))
def test_wrapper_on_cpu_is_the_plain_closed_form(layout, aniso, scaling,
                                                 shape):
    size = SIZES[shape]
    betas, pos, sigma = _inputs(size, aniso=aniso,
                                tracked=layout == "tracked",
                                recordings=layout == "recordings")
    fused.reset_launch_counts()
    got = fused.analytic_grams(betas, pos, sigma, size, scaling=scaling,
                               window=7)
    ref = tGA.analytic_grams(betas, pos, sigma, size, scaling=scaling,
                             window=7)
    assert torch.equal(got, ref)
    assert fused.launch_counts()["analytic_grams"] == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_pair_counts_are_refused_on_cpu(layout):
    """The count is the kernel's; the plain form has none to give."""
    size = SIZES["box"]
    betas, pos, sigma = _inputs(size, tracked=layout == "tracked",
                                recordings=layout == "recordings")
    with pytest.raises(ValueError, match="pair_counts"):
        fused.analytic_grams(betas, pos, sigma, size, window=7,
                             pair_counts=True)


def test_wrapper_matches_jax():
    size = SIZES["box"]
    betas, pos, sigma = _inputs(size, seed=1)
    ref = np.asarray(jGA.analytic_grams(
        jnp.asarray(betas.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(sigma.numpy()), size, window=8))
    got = fused.analytic_grams(betas, pos, sigma, size, window=8).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bad", ["pos", "sigma", "betas"])
def test_wrapper_refuses_mismatched_shapes(bad):
    size = SIZES["box"]
    betas, pos, sigma = _inputs(size)
    args = {"betas": betas, "pos": pos, "sigma": sigma}
    args[bad] = {"pos": pos[:, :2], "sigma": sigma[:-1],
                 "betas": betas[:, :9]}[bad]
    with pytest.raises(ValueError, match="analytic_grams"):
        fused.analytic_grams(args["betas"], args["pos"], args["sigma"], size)


def _state(layout, seed=2):
    size = SIZES["box"]
    t = 7
    rng = np.random.default_rng(seed)
    betas, pos, sigma = _inputs(size, seed=seed,
                                recordings=layout == "recordings")
    if layout == "recordings":
        betas = betas[:, :1].expand(R, t, 10, 3) + 0.01 * torch.tensor(
            rng.normal(size=(R, t, 10, 3)), dtype=torch.float32)
        states = [tM.state_from_numpy(dict(
            beta=betas[r].numpy(), c=np.ones((K, t), np.float32),
            pos=pos[r].numpy(), sigma=sigma[r].numpy(), count=np.int32(0),
            mu=np.zeros((t, 10, 3), np.float32),
            nu=np.zeros((t, 10, 3), np.float32))) for r in range(R)]
        state = tP.stack_states(states)
        video = torch.tensor(rng.uniform(0, 1, (R, t, int(np.prod(size)))),
                             dtype=torch.float32)
    else:
        beta = betas[:1].expand(t, 10, 3) + 0.01 * torch.tensor(
            rng.normal(size=(t, 10, 3)), dtype=torch.float32)
        state = tM.state_from_numpy(dict(
            beta=beta.numpy(), c=np.ones((K, t), np.float32),
            pos=pos.numpy(), sigma=sigma.numpy(), count=np.int32(0),
            mu=np.zeros((t, 10, 3), np.float32),
            nu=np.zeros((t, 10, 3), np.float32)))
        video = torch.tensor(rng.uniform(0, 1, (t, int(np.prod(size)))),
                             dtype=torch.float32)
    pos_t = None
    if layout == "tracked":
        pos_t = state.pos + 0.3 * torch.tensor(
            rng.normal(size=(t, K, 3)), dtype=torch.float32)
    model = tcfg.ModelConfig(size=size, num_neurons=K, num_frames=t,
                             shape_std=1.5)
    return model, state, video, pos_t


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("frame_block", [2, 3])
def test_grams_local_closed_form_once_matches_per_block(layout, frame_block):
    model, state, video, pos_t = _state(layout)
    kw = dict(gram_mode="analytic", pos_t=pos_t)
    g_cpu, c1_cpu = tM.grams_local(state, video, model, frame_block,
                                   use_kernels=True, **kw)
    g_blk, c1_blk = tM.grams_local(state, video, model, frame_block,
                                   use_kernels=False, **kw)
    assert torch.equal(g_cpu, g_blk) and torch.equal(c1_cpu, c1_blk)
    # The card route's one call over the whole recording.
    g_once = fused.analytic_grams(
        state.beta, state.pos if pos_t is None else pos_t, state.sigma,
        model.size, scaling=model.deformation.basis_scaling,
        window=tGA.default_window(model.shape_std))
    assert g_once.shape == g_blk.shape
    torch.testing.assert_close(g_once, g_blk, rtol=1e-6, atol=0.0)
