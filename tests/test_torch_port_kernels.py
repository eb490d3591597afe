"""Plain versions of the port's motion / c1 / Gram passes against the JAX
Pallas kernels in interpret mode (``dot_mode="highest"``: JAX's default
bf16 split dot is a TPU emulation).

Tolerances, relative to the reference's max magnitude: 1e-5 for mse, G
and c1 (float32 sums in another order); 1e-4 for dbeta (the Pallas
kernel's analytic gradient against autograd sums).  ``kblock=8`` with
K=20 makes the culled kernels cross blocks; the thin-z volume at the
identity warp puts every face voxel on a fade tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import basis as jB
from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu.ops import pallas_kernels as pk
from dnmf_tpu_torch.ops import fused

K = 20
CASES = {
    "box": (16, 12, 4),
    "thin_z": (12, 10, 2),
}


def rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))) / max(
        float(np.max(np.abs(ref))), 1e-30)


def _inputs(rng, size, aniso=False, b=3):
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform([1, 1, 0], hi - [1, 1, 0], (K, 3)).astype(np.float32)
    sigma = rng.uniform(1.0, 2.0, (K, 3) if aniso else (K,)).astype(
        np.float32)
    betas = np.asarray(jB.identity_beta(b)) + 0.01 * rng.normal(
        size=(b, 10, 3)).astype(np.float32)
    betas[0] = np.asarray(jB.identity_beta(1))[0]  # exact ties
    betas = betas.astype(np.float32)
    p = size[0] * size[1] * size[2]
    y = rng.uniform(0, 1, (b, p)).astype(np.float32)
    c = rng.uniform(0.2, 1, (b, K)).astype(np.float32)
    return pos, sigma, betas, y, c


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("culled", [False, True])
def test_motion_plain_matches_pallas(rng, case, scaling, culled):
    size = CASES[case]
    pos, sigma, betas, y, c = _inputs(rng, size)
    jargs = _j(betas, pos, sigma, c, y)
    if culled:
        mse_r, db_r = pc.motion_block_culled(*jargs, size, scaling=scaling,
                                             tile_p=128, kblock=8,
                                             interpret=True)
    else:
        mse_r, db_r = pk.motion_block(*jargs, size, scaling=scaling,
                                      tile_p=128, interpret=True)
    mse, db = fused.motion_block_plain(*_t(betas, pos, sigma, c, y), size,
                                       scaling)
    assert rel_err(mse, mse_r) <= 1e-5
    assert rel_err(db, db_r) <= 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
def test_c1_plain_matches_pallas(rng, case, aniso):
    size = CASES[case]
    pos, sigma, betas, y, _ = _inputs(rng, size, aniso)
    ref = pc.c1_block_culled(*_j(betas, pos, sigma, y), size, tile_p=128,
                             kblock=8, dot_mode="highest", interpret=True)
    got = fused.c1_block_plain(*_t(betas, pos, sigma, y), size)
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("culled", [False, True])
def test_gram_plain_matches_pallas(rng, case, culled):
    size = CASES[case]
    pos, sigma, betas, y, _ = _inputs(rng, size)
    jargs = _j(betas, pos, sigma, y)
    if culled:
        g_r, c1_r = pc.gram_block_culled(*jargs, size, tile_p=128, kblock=8,
                                         dot_mode="highest", interpret=True)
    else:
        g_r, c1_r = pk.gram_block(*jargs, size, tile_p=128, interpret=True)
    g, c1 = fused.gram_block_plain(*_t(betas, pos, sigma, y), size)
    assert rel_err(g, g_r) <= 1e-5
    assert rel_err(c1, c1_r) <= 1e-5


def test_aniso_motion_matches_pallas(rng):
    size = CASES["box"]
    pos, sigma, betas, y, c = _inputs(rng, size, aniso=True)
    mse_r, db_r = pc.motion_block_culled(*_j(betas, pos, sigma, c, y), size,
                                         tile_p=128, kblock=8,
                                         interpret=True)
    mse, db = fused.motion_block_plain(*_t(betas, pos, sigma, c, y), size)
    assert rel_err(mse, mse_r) <= 1e-5
    assert rel_err(db, db_r) <= 1e-4


@pytest.mark.parametrize("aniso", [False, True])
def test_sorted_params_match_jax(rng, aniso):
    """The kernels' neuron tables: same order, centers, per-axis scales
    and block intervals as the Pallas wrappers build."""
    pos, sigma, *_ = _inputs(rng, CASES["box"], aniso)
    perm_r, params_r, blocks_r = pc._sorted_params(
        jnp.asarray(pos), jnp.asarray(sigma), 8, 3)
    perm, params, blocks = fused.sorted_params(
        torch.from_numpy(pos), torch.from_numpy(sigma), kb=8)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_r))
    params_r = np.asarray(params_r)
    np.testing.assert_array_equal(params[:, :3].numpy(), params_r[:, :3])
    np.testing.assert_allclose(params[:, 3:6].numpy(),
                               params_r[:, list(pk.SCALE_COLS)], rtol=1e-6)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(blocks_r),
                               rtol=1e-6)


def test_motion_weights_match_jax(rng):
    pos, sigma, betas, y, c = _inputs(rng, CASES["box"], aniso=True)
    perm_r, params_r, _, w2_r = pc._sorted_params(
        jnp.asarray(pos), jnp.asarray(sigma), 8, 3, c_block=jnp.asarray(c))
    perm, *_ = fused.sorted_params(torch.from_numpy(pos),
                                   torch.from_numpy(sigma), kb=8)
    w = fused.motion_weights(*_t(pos, sigma, c), perm, 24).numpy()
    np.testing.assert_allclose(w[..., 0], np.asarray(params_r)[..., 4],
                               rtol=1e-6)
    np.testing.assert_allclose(w[..., 1:7], np.asarray(w2_r)[..., 0:6],
                               rtol=1e-6)


def test_wrappers_take_plain_path_on_cpu(rng):
    """CPU tensors go to the plain versions and launch nothing."""
    size = CASES["box"]
    pos, sigma, betas, y, c = _t(*_inputs(rng, size))
    pos_t = pos + 0.5 * torch.randn((betas.shape[0],) + pos.shape)
    fused.reset_launch_counts()
    for got, ref in [
        (fused.motion_block(betas, pos, sigma, c, y, size),
         fused.motion_block_plain(betas, pos, sigma, c, y, size)),
        (fused.gram_block(betas, pos, sigma, y, size),
         fused.gram_block_plain(betas, pos, sigma, y, size)),
        ((fused.c1_block(betas, pos, sigma, y, size),),
         (fused.c1_block_plain(betas, pos, sigma, y, size),)),
        ((fused.c1_block(betas, pos_t, sigma, y, size),),
         (fused.c1_block_plain(betas, pos_t, sigma, y, size),)),
        (fused.gram_block_tracked(betas, pos_t, sigma, y, size),
         fused.gram_block_plain(betas, pos_t, sigma, y, size)),
        (fused.refine_block(betas, pos_t, sigma, c, y, size,
                            want_dsigma=True),
         fused.refine_block_plain(betas, pos_t, sigma, c, y, size,
                                  want_dsigma=True)),
    ]:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert fused.launch_counts() == {
        "motion_block": 0, "c1_block": 0, "gram_block": 0,
        "refine_block": 0, "c1_block_tracked": 0, "gram_block_tracked": 0}


def test_plain_chunking_is_invisible(rng, monkeypatch):
    """Pixel chunks of the plain versions only reorder the sums."""
    size = CASES["box"]
    args = _t(*_inputs(rng, size))
    pos, sigma, betas, y, c = args
    whole = fused.motion_block_plain(betas, pos, sigma, c, y, size)
    g_whole = fused.gram_block_plain(betas, pos, sigma, y, size)
    monkeypatch.setattr(fused, "_CHUNK_ELEMS", 3 * K * 3 * 100)
    part = fused.motion_block_plain(betas, pos, sigma, c, y, size)
    g_part = fused.gram_block_plain(betas, pos, sigma, y, size)
    for a, b in zip(part + g_part, whole + g_whole):
        assert rel_err(a, b.numpy()) <= 1e-6


def test_chunk_count_bounds():
    for p in (1, 255, 256, 257, 655360, 5242880):
        n_tiles = -(-p // 256)
        for per_chunk in (1, 8, 56, 10 ** 6):
            n = fused._n_chunks(p, 256, per_chunk)
            assert 1 <= n <= n_tiles
            assert n * per_chunk >= min(fused.TARGET_BLOCKS, n_tiles * per_chunk)
