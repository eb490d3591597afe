"""The port's plain ops against ``dnmf_tpu`` on the same NumPy inputs.

Tolerance: 1e-5 of the reference's max magnitude (both sides compute in
float32; the sums differ only in order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu import config as jcfg
from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import footprints as jFP
from dnmf_tpu.ops import gram_analytic as jGA
from dnmf_tpu.ops import jacobian as jJ
from dnmf_tpu.ops import mu as jMU
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.ops import basis as tB
from dnmf_tpu_torch.ops import footprints as tFP
from dnmf_tpu_torch.ops import gram_analytic as tGA
from dnmf_tpu_torch.ops import jacobian as tJ
from dnmf_tpu_torch.ops import mu as tMU

TOL = 1e-5
SIZE = (16, 12, 4)


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(got - ref))) / scale
    assert err <= tol, f"relative-to-max error {err:.3e} > {tol:g}"


def t(x):
    return torch.from_numpy(np.asarray(x))


def _betas(rng, n, scale=0.02):
    b = np.asarray(jB.identity_beta(n)) + scale * rng.normal(
        size=(n, 10, 3)).astype(np.float32)
    return b.astype(np.float32)


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("name", ["DeformationConfig", "ModelConfig",
                                  "OptimizerConfig", "RuntimeConfig"])
def test_config_fields_and_defaults(name):
    ref = [("use_kernels" if f.name == "use_pallas" else f.name)
           for f in dataclasses.fields(getattr(jcfg, name))]
    got = [f.name for f in dataclasses.fields(getattr(tcfg, name))]
    assert got == ref
    ref_inst, got_inst = getattr(jcfg, name)(), getattr(tcfg, name)()
    for field in ref:
        src = "use_pallas" if field == "use_kernels" else field
        want = getattr(ref_inst, src)
        have = getattr(got_inst, field)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, field


@pytest.mark.parametrize("name", ["demo", "roi", "whole_brain", "long",
                                  "multi"])
def test_baseline_workload_matches(name):
    jm, jr = jcfg.baseline_workload(name)
    tm, tr = tcfg.baseline_workload(name)
    assert (tm.size, tm.num_neurons, tm.num_frames) == (
        jm.size, jm.num_neurons, jm.num_frames)
    assert (tr.frame_block, tr.mesh_time, tr.mesh_batch) == (
        jr.frame_block, jr.mesh_time, jr.mesh_batch)
    with pytest.raises(KeyError):
        tcfg.baseline_workload("nope")


# ----------------------------------------------------------------- basis
@pytest.mark.parametrize("size", [SIZE, (7, 1, 3)])
def test_grids_and_bases(size):
    close(tB.voxel_grid(size), jB.voxel_grid(size), 0)
    close(tB.voxel_basis(size), jB.voxel_basis(size))
    close(tB.voxel_basis_normalized(size), jB.voxel_basis_normalized(size))
    close(tB.identity_beta(3), jB.identity_beta(3), 0)


def test_normalize_round_trip_and_singleton_axis(rng):
    size = (9, 1, 5)
    pts = rng.uniform(0, 8, (20, 3)).astype(np.float32)
    pts[:, 1] = 0.0
    close(tB.normalize_points(t(pts), size),
          jB.normalize_points(jnp.asarray(pts), size))
    back = tB.denormalize_points(tB.normalize_points(t(pts), size), size)
    close(back, jB.denormalize_points(
        jB.normalize_points(jnp.asarray(pts), size), size))
    assert float(back[:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("scaling", ["pixel", "normalized"])
def test_warp_and_inverse(rng, scaling):
    beta = _betas(rng, 1, 0.01)[0]
    vb_j = (jB.voxel_basis_normalized(SIZE) if scaling == "normalized"
            else jB.voxel_basis(SIZE))
    vb_t = (tB.voxel_basis_normalized(SIZE) if scaling == "normalized"
            else tB.voxel_basis(SIZE))
    close(tB.warp_voxel_coords(vb_t, t(beta), SIZE, scaling),
          jB.warp_voxel_coords(vb_j, jnp.asarray(beta), SIZE, scaling))
    pts = rng.uniform(-0.8, 0.8, (11, 3)).astype(np.float32)
    close(tB.warp_points(t(pts), t(beta)),
          jB.warp_points(jnp.asarray(pts), jnp.asarray(beta)))
    close(tB.invert_warp_points(t(pts), t(beta)),
          jB.invert_warp_points(jnp.asarray(pts), jnp.asarray(beta)))


# ------------------------------------------------------------ footprints
@pytest.mark.parametrize("aniso", [False, True])
def test_footprints_match(rng, aniso):
    k = 7
    pos = rng.uniform([0, 0, 0], [15, 11, 3], (k, 3)).astype(np.float32)
    sigma = rng.uniform(1.0, 2.5, (k, 3) if aniso else (k,)).astype(
        np.float32)
    psi = rng.uniform(-1.5, 16.5, (40, 3)).astype(np.float32)
    close(tFP.gaussian_footprints(t(psi), t(pos), t(sigma)),
          jFP.gaussian_footprints(jnp.asarray(psi), jnp.asarray(pos),
                                  jnp.asarray(sigma)))
    close(tFP.evaluate_footprints(t(psi), t(pos), t(sigma), size=SIZE),
          jFP.evaluate_footprints(jnp.asarray(psi), jnp.asarray(pos),
                                  jnp.asarray(sigma), size=SIZE))


def test_fade_tie_subgradients_match_jax():
    """Face voxels of a thin volume at the identity warp sit exactly on
    the fade's ties: JAX's subgradient there is 0.5."""
    size = (5, 4, 2)
    psi = np.asarray(jB.voxel_grid(size))
    psi = np.concatenate([psi, psi + np.float32(-1.0),
                          psi + np.float32(0.5)], axis=0)
    pos = np.array([[2.0, 1.5, 0.5]], np.float32)
    sigma = np.array([1.5], np.float32)

    def jloss(p):
        return jnp.sum(jFP.evaluate_footprints(p, jnp.asarray(pos),
                                               jnp.asarray(sigma), size))

    g_ref = jax.grad(jloss)(jnp.asarray(psi))
    p_t = t(psi).requires_grad_(True)
    tFP.evaluate_footprints(p_t, t(pos), t(sigma), size).sum().backward()
    close(p_t.grad, g_ref)
    vals = {float(v) for v in np.asarray(jax.grad(lambda x: jnp.sum(
        jFP._bounds_mask(x, size)))(jnp.asarray(psi))).ravel()}
    assert 0.5 in vals or -0.5 in vals  # the ties were exercised


# -------------------------------------------------------------- jacobian
@pytest.mark.parametrize("scaling", ["pixel", "normalized"])
@pytest.mark.parametrize("detach", [False, True])
def test_corner_regularizer_and_grad(rng, scaling, detach):
    betas = _betas(rng, 5, 0.05)
    if scaling == "pixel":
        betas[:, 4:] *= 0.01
    reg_fn = lambda b: jJ.corner_regularizer(b, SIZE, detach=detach,
                                             scaling=scaling)
    ref = jax.vmap(jax.value_and_grad(reg_fn))(jnp.asarray(betas))
    reg, grad = tJ.corner_regularizer_and_grad(t(betas), SIZE, detach,
                                               scaling)
    close(reg, ref[0])
    if detach:
        assert float(grad.abs().max()) == 0.0
    else:
        close(grad, ref[1])
    close(tJ.quadratic_jacobian(t(betas[0]), t(np.float32([1.0, 2.0, 3.0]))),
          jJ.quadratic_jacobian(jnp.asarray(betas[0]),
                                jnp.asarray(np.float32([1.0, 2.0, 3.0]))))


# --------------------------------------------------------------------- mu
def _grams(rng, tt=6, k=5):
    a = rng.uniform(0, 1, (tt, 30, k)).astype(np.float32)
    y = rng.uniform(0, 1, (tt, 30)).astype(np.float32)
    g = np.einsum("tpk,tpl->tkl", a, a).astype(np.float32)
    c1 = np.einsum("tpk,tp->tk", a, y).astype(np.float32)
    c = rng.uniform(0.1, 1, (k, tt)).astype(np.float32)
    return a, y, g, c1, c


def test_mu_grams(rng):
    a, y, *_ = _grams(rng)
    for got, ref in zip(tMU.mu_grams(t(a[0]), t(y[0])),
                        jMU.mu_grams(jnp.asarray(a[0]), jnp.asarray(y[0]))):
        close(got, ref)


@pytest.mark.parametrize("gamma", [None, 0.5])
def test_mu_steps(rng, gamma):
    _, _, g, c1, c = _grams(rng)
    close(tMU.mu_temporal_step(t(c), t(g), t(c1), gamma),
          jMU.mu_temporal_step(jnp.asarray(c), jnp.asarray(g),
                               jnp.asarray(c1), gamma))
    close(tMU.run_mu_temporal(t(c), t(g), t(c1), 7, gamma),
          jMU.run_mu_temporal(jnp.asarray(c), jnp.asarray(g),
                              jnp.asarray(c1), 7, gamma))


@pytest.mark.parametrize("gamma", [None, 0.3])
def test_fista_and_lipschitz(rng, gamma):
    _, _, g, c1, c = _grams(rng)
    close(tMU.gram_lipschitz(t(g), gamma),
          jMU.gram_lipschitz(jnp.asarray(g), gamma))
    close(tMU.nnls_temporal(t(c), t(g), t(c1), 9, gamma),
          jMU.nnls_temporal(jnp.asarray(c), jnp.asarray(g),
                            jnp.asarray(c1), 9, gamma))


# --------------------------------------------------------- gram_analytic
@pytest.mark.parametrize("size", [(16, 12, 4), (14, 12, 6)])
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("aniso", [False, True])
def test_analytic_grams_match(rng, size, scaling, aniso):
    k = 9
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform(0.5, hi - 0.5, (k, 3)).astype(np.float32)
    sigma = rng.uniform(1.2, 2.2, (k, 3) if aniso else (k,)).astype(
        np.float32)
    betas = _betas(rng, 3, 0.01)
    if scaling == "pixel":
        betas[:, 4:] *= 0.05
    window = tGA.default_window(2.2)
    assert window == jGA.default_window(2.2)
    ref = jGA.analytic_grams(jnp.asarray(betas), jnp.asarray(pos),
                             jnp.asarray(sigma), size, scaling=scaling,
                             window=window)
    got = tGA.analytic_grams(t(betas), t(pos), t(sigma), size,
                             scaling=scaling, window=window)
    close(got, ref)
    close(tGA.analytic_gram_frame(t(betas[1]), t(pos), t(sigma), size,
                                  scaling=scaling, window=window), ref[1])
