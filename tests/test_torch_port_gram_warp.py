"""Kernels C/E/C4 (the exact Gram: shared anchors, per-frame positions,
precomputed rows) and G (the fused warp) in their H100 designs, checked on
the CPU against ``dnmf_tpu``.

``csrc/gram.cu`` walks the bricks of ``csrc/cull.cuh``: at the voxels of a
brick it sums the pairs of the brick's candidates only (those that
``brick_candidates_plain`` lists), a window of table rows per group of
bricks, groups set by ``gram_groups`` from the volume and K.
``gram_block_bricks_plain`` is that pair rule in plain torch; here it is
held to the unrestricted plain Gram and to the JAX kernels in interpret
mode, on a small volume with strongly quadratic warps, neurons on brick
edges, on the volume's faces and outside it, and tracks that cross in m.

``csrc/warp.cu`` evaluates the cubic shift field by partial contraction
(``H`` per frame over z, ``Q`` per m row over m, then n per voxel) and
reads every tap of its n pass from a halo of ``warp_halo`` columns;
``warp_field_plain`` is that order in plain torch.

Tolerances: restricted vs unrestricted 1e-6 relative (the dropped terms
are below exp(-36) of a footprint's peak); Grams against the JAX kernels
1e-5 (as ``test_torch_port_kernels.py``); the warp against JAX 1e-4
relative / 1e-5 absolute (as ``test_torch_port_registration.py``); the
contraction field against ``upsample_field`` 1e-6 of the field's scale
(float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu.ops import pallas_kernels as pk
from dnmf_tpu.ops.pallas_warp import fused_separable_warp as j_fused_warp
from dnmf_tpu.registration import motion_correct as jmc
from dnmf_tpu_torch.ops import fused, resize, warp

SIZE, K = (24, 20, 6), 23


def rel(got, ref):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _inputs(rng, aniso, b=3):
    """Neurons on brick edges, at a corner, on the far m face and outside
    the volume; per-frame positions ~0.7 px around the anchors, where
    neurons 7 and 8 trade places in m between frames 0 and 2 (crossing
    tracks); frame 0 at the identity warp, the others strongly
    quadratic."""
    hi = np.asarray(SIZE, np.float64) - 1
    pos = rng.uniform(0, 1, (K, 3)) * hi
    pos[:4, :2] = np.round(pos[:4, :2] / 8) * 8
    pos[4, :] = 0.0
    pos[5, 0] = hi[0]
    pos[6] = hi + [2.0, 1.5, 0.5]
    pos[7] = [9.0, 5.0, 2.0]
    pos[8] = [12.0, 14.0, 3.0]
    pos_t = pos[None] + 0.7 * rng.normal(size=(b, K, 3))
    pos_t[0, 7, 0], pos_t[0, 8, 0] = 8.0, 13.0
    pos_t[2, 7, 0], pos_t[2, 8, 0] = 13.5, 7.5
    sigma = rng.uniform(0.6, 1.2, (K, 3) if aniso else (K,))
    betas = np.zeros((b, 10, 3))
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    betas[1:, 4:] = 0.15 * rng.uniform(-1, 1, (b - 1, 6, 3))
    betas[1:, 0] = 0.05 * rng.normal(size=(b - 1, 3))
    y = rng.uniform(0, 1, (b, SIZE[0] * SIZE[1] * SIZE[2]))
    return [torch.tensor(x, dtype=torch.float32)
            for x in (betas, pos, pos_t, sigma, y)]


def _j(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("source", ["shared", "tracked", "rows"])
def test_restricted_gram_matches_pallas(rng, source, aniso):
    """The Gram kernel's pair rule (each voxel sums the pairs of its
    brick's candidates) equals the plain Gram and the JAX kernels:
    ``gram_block_culled`` (shared anchors), ``gram_block_tracked``
    (per-frame positions with crossing tracks) and ``gram_block_culled(
    psi_source="stream")`` (rows made outside the kernel)."""
    betas, pos, pos_t, sigma, y = _inputs(rng, aniso)
    opts = dict(tile_p=128, kblock=8, dot_mode="highest", interpret=True)
    if source == "tracked":
        got = fused.gram_block_bricks_plain(betas, pos_t, sigma, y, SIZE)
        full = fused.gram_block_plain(betas, pos_t, sigma, y, SIZE)
        ref = pc.gram_block_tracked(*_j(betas, pos_t, sigma, y), SIZE,
                                    **opts)
    elif source == "rows":
        psi, w = fused.psi_rows(betas, SIZE)
        got = fused.gram_block_bricks_plain(betas, pos, sigma, y, SIZE,
                                            rows=(psi, w))
        full = fused.gram_block_rows_plain(psi, w, pos, sigma, y)
        ref = pc.gram_block_culled(*_j(betas, pos, sigma, y), SIZE,
                                   psi_source="stream", **opts)
    else:
        got = fused.gram_block_bricks_plain(betas, pos, sigma, y, SIZE)
        full = fused.gram_block_plain(betas, pos, sigma, y, SIZE)
        ref = pc.gram_block_culled(*_j(betas, pos, sigma, y), SIZE, **opts)
    for g, f, r in zip(got, full, ref):
        assert rel(g, f.numpy()) <= 1e-6
        assert rel(g, r) <= 1e-5
    if source == "shared" and not aniso:  # the dense JAX kernel too
        g_d, c1_d = pk.gram_block(*_j(betas, pos, sigma, y), SIZE,
                                  tile_p=128, interpret=True)
        assert rel(got[0], g_d) <= 1e-5 and rel(got[1], c1_d) <= 1e-5


@pytest.mark.parametrize("source", ["shared", "tracked", "rows"])
def test_gram_wrappers_count_candidates_by_the_plain_rule_on_cpu(rng,
                                                                 source):
    """``brick_counts=True`` appends the candidate count per brick (a
    brick sums the pairs of those candidates); on CPU tensors it is
    ``brick_candidates_plain``'s, and the Grams are the plain versions'."""
    betas, pos, pos_t, sigma, y = _inputs(rng, False)
    if source == "rows":
        psi, w = fused.psi_rows(betas, SIZE)
        out = fused.gram_block(betas, pos, sigma, y, SIZE,
                               psi_source="stream", rows=(psi, w),
                               brick_counts=True)
        mask = fused.brick_candidates_plain(None, pos, sigma, SIZE, psi=psi)
        ref = fused.gram_block_rows_plain(psi, w, pos, sigma, y)
    else:
        where = pos_t if source == "tracked" else pos
        out = fused.gram_block(betas, where, sigma, y, SIZE,
                               brick_counts=True)
        mask = fused.brick_candidates_plain(betas, where, sigma, SIZE)
        ref = fused.gram_block_plain(betas, where, sigma, y, SIZE)
    assert len(out) == 3 and out[2].dtype == torch.int32
    assert torch.equal(out[2], mask.sum(-1).to(torch.int32))
    for g, r in zip(out[:2], ref):
        assert torch.equal(g, r)


def test_gram_pair_rule_lists_crossing_tracks_in_every_frame(rng):
    """Neurons 7 and 8 trade places in m between frames 0 and 2: each
    frame's bricks list them from that frame's own positions, so their
    pair is summed in every frame where both reach a brick."""
    betas, _, pos_t, sigma, y = _inputs(rng, False)
    mask = fused.brick_candidates_plain(betas, pos_t, sigma, SIZE)
    both = (mask[..., 7] & mask[..., 8]).any(dim=1)
    assert bool(both.all())
    g = fused.gram_block_bricks_plain(betas, pos_t, sigma, y, SIZE)[0]
    g_full = fused.gram_block_plain(betas, pos_t, sigma, y, SIZE)[0]
    assert rel(g[:, 7, 8], g_full[:, 7, 8].numpy()) <= 1e-6


@pytest.mark.parametrize("size,k", [((512, 512, 20), 200),
                                    ((256, 256, 10), 50),
                                    ((24, 16, 6), 6000),
                                    ((512, 512, 20), 6000),
                                    ((21, 13, 1), 15), ((1, 1, 1), 1)])
def test_gram_group_count_depends_on_the_volume_and_k_only(size, k):
    """``gram_groups`` and ``gram_splits`` take no frame count, so a
    frame's (G, c1) are the same alone or in a call of any length.  The
    groups cover every brick, at most ``BRICK_GROUPS`` of them, each with
    a ``k (k + 1) / 2`` partial, within ``GRAM_PART_FLOATS`` per frame
    where one group per frame allows it (K = 6000: one group); splits of a
    group share its partial and make up for few groups."""
    _, nb = fused.brick_ids(size)
    per_group, n_groups = fused.gram_groups(size, k)
    tri = k * (k + 1) // 2
    assert 1 <= n_groups <= fused.BRICK_GROUPS
    assert (n_groups - 1) * per_group < nb <= n_groups * per_group
    assert n_groups * tri <= fused.GRAM_PART_FLOATS or n_groups == 1
    assert fused.gram_groups((512, 512, 20), 200) == (20, 205)
    assert fused.gram_groups((256, 256, 10), 50) == (2, 512)
    # Splits make up for few groups, at most one per GRAM_ROWS table rows.
    splits = fused.gram_splits(size, k)
    assert 1 <= splits <= min(fused.GRAM_SPLITS,
                              -(-k // fused.GRAM_ROWS))
    assert splits == 1 or (splits - 1) * n_groups < fused.GRAM_SPLIT_BLOCKS
    assert fused.gram_splits((512, 512, 20), 200) == 1
    assert fused.gram_splits((24, 16, 6), 6000) == fused.GRAM_SPLITS


# --------------------------------------------------------- kernel G
WCASES = {  # name: (size, grid, max_shifts, max_dev)
    "odd": ((19, 37, 5), (3, 4, 2), (3, 3, 2), 2),
    "wide_halo": ((23, 70, 3), (2, 3, 1), (6, 6, 1), 3),
    "one_patch": ((17, 9, 4), (1, 1, 1), (2, 2, 1), 1),
    "equal_axis": ((13, 11, 3), (2, 2, 3), (3, 3, 1), 2),
}


def _warp_inputs(rng, size, grid, max_shifts, max_dev, b=3):
    """Rigid shifts at the base bound ``ceil(max_shifts) + 1`` (frame 0,
    both signs across the axes) and inside it, patch shifts spread past
    ``max_dev + 2`` around them, so every clip is active."""
    bound = np.array([np.ceil(float(m)) + 1 for m in max_shifts])
    base = rng.uniform(-1, 1, (b, 3)) * bound
    base[0] = bound * [1, -1, 1]
    spread = max_dev + 4.0
    shifts = base[:, None] + rng.uniform(-spread, spread,
                                         (b, int(np.prod(grid)), 3))
    vol = rng.random((b,) + size)
    return [x.astype(np.float32) for x in (vol, base, shifts)]


@pytest.mark.parametrize("case", sorted(WCASES))
def test_warp_field_by_partial_contraction(rng, case):
    """The kernel's field order (``warp_field_plain``: H over z, Q over m,
    then n) equals ``upsample_field``, and the separable warp on it equals
    the JAX fused warp in interpret mode and the XLA remap, on odd sizes
    and at the clip bounds."""
    size, grid, max_shifts, max_dev = WCASES[case]
    vol, base, shifts = _warp_inputs(rng, size, grid, max_shifts, max_dev)
    ps = torch.from_numpy(shifts)
    field = warp.warp_field_plain(ps, grid, size)
    ref = torch.stack([resize.upsample_field(ps[..., d], grid, size)
                       for d in range(3)], dim=-1)
    assert field.shape == ref.shape
    assert rel(field, ref.numpy()) <= 1e-6
    rb, base_bound = warp._bounds(max_shifts, max_dev)
    got = warp.separable_warp(torch.from_numpy(vol), field, (rb,) * 3,
                              base=torch.from_numpy(base),
                              base_bound=base_bound)
    ref_k = j_fused_warp(jnp.asarray(vol), jnp.asarray(shifts),
                         jnp.asarray(base), grid, size, max_shifts, max_dev,
                         tm=8, tn=16, interpret=True)
    ref_x = jax.vmap(lambda f, rs, p: jmc._apply_remap_field(
        f, rs, p, grid, "separable", max_shifts, max_dev))(
        jnp.asarray(vol), jnp.asarray(base), jnp.asarray(shifts))
    for r in (ref_k, ref_x):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("case", sorted(WCASES))
def test_warp_halo_holds_every_tap_of_the_n_pass(case):
    """Every tap of the n pass lies within ``warp_halo`` columns of its
    voxel: the base's integer part (at most ``ceil(max_shifts) + 1``), the
    residual clipped to ``rb + 1`` and the lerp's second tap; the tile's
    shared memory counts the halo."""
    size, grid, max_shifts, max_dev = WCASES[case]
    rb, base_bound = warp._bounds(max_shifts, max_dev)
    halo = warp.warp_halo(max_shifts, max_dev)
    # The extreme taps: floor of the clipped base and residual, plus 1.
    lo = -base_bound[1] + int(np.floor(-rb - 1.0))
    hi = base_bound[1] + int(np.floor(rb + 1.0)) + 1
    assert -halo <= lo and hi <= halo
    assert halo == base_bound[1] + rb + 2
    m, n, z = size
    gm, gn, _ = grid
    w1 = min(n, warp.WARP_TN + 2 * halo)
    assert warp.warp_tile_bytes(size, grid, halo) == 4 * (
        warp.WARP_TM * (w1 + min(n, warp.WARP_TN)) * z
        + (gm + warp.WARP_TM) * gn * z * 3)
