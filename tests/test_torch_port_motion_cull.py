"""Kernels A (motion) and B (c1) cull by 3-D bricks
(``dnmf_tpu_torch/ops/fused.py``, ``csrc/cull.cuh``), checked on the CPU.

``csrc/motion.cu`` and ``csrc/c1.cu`` evaluate, at the voxels of a brick
(``refine_bricks``: 8 x 8 voxels in (m, n) by runs of at most 32 in z),
only the neurons that ``brick_candidates_plain`` lists: those whose
per-axis box ``p +- 6 sigma`` meets the brick's exact range of deformed
coordinates on all three axes (shared anchors ``pos [K, 3]``, or each
frame's own positions ``pos [B, K, 3]`` for the tracked c1).  Here, on
small volumes with strongly quadratic warps, neurons on brick edges, on
the volume's faces and outside it: every (frame, voxel, neuron) whose
footprint clears ``exp(-36)`` is listed, and the motion and c1 passes
restricted to the listed neurons equal the unrestricted plain versions
and the JAX kernels.

Tolerances: restricted vs unrestricted 1e-6 relative (the dropped terms
are below exp(-36) of a footprint's peak); against the JAX kernels as in
``test_torch_port_kernels.py`` (mse and c1 1e-5, dbeta 1e-4: the Pallas
kernels' analytic gradient against autograd sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu.ops import pallas_kernels as pk
from dnmf_tpu_torch.ops import fused

CASES = {  # name: (size, K, scaling)
    "box": ((24, 20, 6), 23, "normalized"),
    "deep_z": ((17, 11, 40), 37, "normalized"),  # z cut into bricks
    "pixel": ((19, 26, 3), 20, "pixel"),
    "flat": ((21, 13, 1), 15, "normalized"),  # z = 1: fade ties
}


def _inputs(rng, size, k, scaling, aniso=False, b=3):
    """Neurons anywhere in the volume (on brick edges, on its faces and
    just outside it), narrow widths, per-frame positions ~0.7 px around
    the anchors; frame 0 at the identity warp (every face voxel on a fade
    tie), the others strongly quadratic."""
    hi = np.asarray(size, np.float64) - 1
    pos = rng.uniform(0, 1, (k, 3)) * hi
    pos[:4, :2] = np.round(pos[:4, :2] / 8) * 8  # on brick edges in m and n
    pos[4, :] = 0.0  # a volume corner
    pos[5, 0] = hi[0]  # the far m face
    pos[6] = hi + [2.0, 1.5, 0.5]  # outside, within reach of the faces
    pos_t = pos[None] + 0.7 * rng.normal(size=(b, k, 3))
    sigma = rng.uniform(0.6, 1.2, (k, 3) if aniso else (k,))
    betas = np.zeros((b, 10, 3))
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    quad = 0.15 if scaling == "normalized" else 0.02
    betas[1:, 4:] = quad * rng.uniform(-1, 1, (b - 1, 6, 3))
    betas[1:, 0] = 0.05 * rng.normal(size=(b - 1, 3))
    y = rng.uniform(0, 1, (b, size[0] * size[1] * size[2]))
    c = rng.uniform(0.2, 1, (b, k))
    return [torch.tensor(x, dtype=torch.float32)
            for x in (betas, pos, pos_t, sigma, c, y)]


def _kept_footprints(betas, pos, sigma, size, scaling, mask):
    """Warped, faded footprints ``[B, P, K]``, each zeroed at the voxels
    of every brick that does not list it."""
    ids, _ = fused.brick_ids(size)
    a = fused._footprints(betas, pos, sigma, size, scaling, 0, ids.numel())
    return a * mask[:, ids].to(a.dtype)


def _restricted_motion(betas, pos, sigma, c, y, size, scaling, mask):
    """``motion_block_plain`` over the listed neurons only."""
    p = y.shape[1]
    with torch.enable_grad():
        b = betas.detach().requires_grad_(True)
        a = _kept_footprints(b, pos, sigma, size, scaling, mask)
        r = torch.bmm(a, c[:, :, None])[..., 0] - y
        sse = torch.sum(r * r, dim=1)
        (g,) = torch.autograd.grad(sse.sum(), b)
    return sse.detach() / p, g / p


def _restricted_c1(betas, pos, sigma, y, size, scaling, mask):
    """``c1_block_plain`` over the listed neurons only."""
    a = _kept_footprints(betas, pos, sigma, size, scaling, mask)
    return torch.bmm(y[:, None], a)[:, 0]


def rel(got, ref):
    ref = torch.as_tensor(np.asarray(ref)) if not isinstance(
        ref, torch.Tensor) else ref
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def _j(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("tracked", [False, True])
def test_candidates_cover_every_active_footprint(rng, case, aniso, tracked):
    size, k, scaling = CASES[case]
    betas, pos, pos_t, sigma, _, y = _inputs(rng, size, k, scaling, aniso)
    where = pos_t if tracked else pos
    mask = fused.brick_candidates_plain(betas, where, sigma, size, scaling)
    ids, nb = fused.brick_ids(size)
    assert tuple(mask.shape) == (betas.shape[0], nb, k)
    psi = fused._warped(betas.double(), size, scaling, 0, y.shape[1])
    sig3 = sigma.double() if aniso else sigma.double()[:, None].expand(-1, 3)
    centres = where.double()[None] if not tracked else where.double()[:, None]
    d2 = (((psi[:, :, None] - centres) / sig3) ** 2).sum(-1)
    active = d2 < 36.0  # [B, P, K]
    assert bool(active.any())
    assert bool(mask[:, ids][active].all())
    # The rule culls: most (brick, neuron) pairs are not listed.
    assert float(mask.double().mean()) < 0.6


def test_shared_anchors_are_every_frame_at_the_anchors(rng):
    """The rule for ``pos [K, 3]`` is the rule for per-frame positions
    that equal the anchors in every frame."""
    size, k, scaling = CASES["box"]
    betas, pos, _, sigma, _, _ = _inputs(rng, size, k, scaling, aniso=True)
    shared = fused.brick_candidates_plain(betas, pos, sigma, size, scaling)
    each = fused.brick_candidates_plain(
        betas, pos[None].expand(betas.shape[0], -1, -1), sigma, size,
        scaling)
    assert torch.equal(shared, each)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
def test_motion_restricted_to_candidates_is_the_plain_motion(rng, case,
                                                             aniso):
    size, k, scaling = CASES[case]
    betas, pos, _, sigma, c, y = _inputs(rng, size, k, scaling, aniso)
    mask = fused.brick_candidates_plain(betas, pos, sigma, size, scaling)
    got = _restricted_motion(betas, pos, sigma, c, y, size, scaling, mask)
    ref = fused.motion_block_plain(betas, pos, sigma, c, y, size, scaling)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel(g, r) <= 1e-6


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("tracked", [False, True])
def test_c1_restricted_to_candidates_is_the_plain_c1(rng, case, aniso,
                                                     tracked):
    size, k, scaling = CASES[case]
    betas, pos, pos_t, sigma, _, y = _inputs(rng, size, k, scaling, aniso)
    where = pos_t if tracked else pos
    mask = fused.brick_candidates_plain(betas, where, sigma, size, scaling)
    got = _restricted_c1(betas, where, sigma, y, size, scaling, mask)
    ref = fused.c1_block_plain(betas, where, sigma, y, size, scaling)
    assert got.shape == ref.shape
    assert rel(got, ref) <= 1e-6


@pytest.mark.parametrize("case", ["box", "flat"])
@pytest.mark.parametrize("culled", [False, True])
def test_restricted_motion_matches_pallas(rng, case, culled):
    """Against ``_motion_kernel`` (dense) and ``_motion_kernel_culled``;
    frame 0 at the identity warp puts the thin volume's face voxels on
    the fade's ties."""
    size, k, scaling = CASES[case]
    betas, pos, _, sigma, c, y = _inputs(rng, size, k, scaling)
    mask = fused.brick_candidates_plain(betas, pos, sigma, size, scaling)
    mse, db = _restricted_motion(betas, pos, sigma, c, y, size, scaling,
                                 mask)
    jargs = _j(betas, pos, sigma, c, y)
    if culled:
        mse_r, db_r = pc.motion_block_culled(*jargs, size, scaling=scaling,
                                             tile_p=128, kblock=8,
                                             interpret=True)
    else:
        mse_r, db_r = pk.motion_block(*jargs, size, scaling=scaling,
                                      tile_p=128, interpret=True)
    assert rel(mse, np.array(mse_r)) <= 1e-5
    assert rel(db, np.array(db_r)) <= 1e-4


@pytest.mark.parametrize("tracked", [False, True])
@pytest.mark.parametrize("impl", ["grid", "pipelined"])
def test_restricted_c1_matches_pallas(rng, tracked, impl):
    size, k, scaling = CASES["box"]
    betas, pos, pos_t, sigma, _, y = _inputs(rng, size, k, scaling,
                                             aniso=True)
    where = pos_t if tracked else pos
    mask = fused.brick_candidates_plain(betas, where, sigma, size, scaling)
    got = _restricted_c1(betas, where, sigma, y, size, scaling, mask)
    ref = pc.c1_block_culled(*_j(betas, where, sigma, y), size, tile_p=128,
                             kblock=8, dot_mode="highest", impl=impl,
                             interpret=True)
    assert rel(got, np.array(ref)) <= 1e-5


@pytest.mark.parametrize("size,k", [((512, 512, 20), 200), ((256, 256, 10), 50),
                                    ((21, 13, 1), 15), ((17, 11, 40), 37),
                                    ((1, 1, 1), 1), ((64, 64, 64), 5000)])
def test_group_count_depends_on_the_volume_and_k_only(size, k):
    """``brick_groups`` takes no frame count: the motion and c1 wrappers
    pass it the volume and the floats a group writes (32, or K), so a
    frame's partial sums, and so its result, are the same alone or in a
    call of any length.  The groups cover every brick, at most
    ``BRICK_GROUPS`` of them, with partials within 1/``PART_SHARE`` of a
    frame's video where a group per brick allows it."""
    _, nb = fused.brick_ids(size)
    p = size[0] * size[1] * size[2]
    for floats in (32, k):
        per_group, n_groups = fused.brick_groups(size, floats)
        assert 1 <= n_groups <= fused.BRICK_GROUPS
        assert (n_groups - 1) * per_group < nb <= n_groups * per_group
        assert (n_groups * floats * fused.PART_SHARE <= p
                or n_groups == 1)
    assert fused.brick_groups((512, 512, 20), 32) == (8, 512)
    assert fused.brick_groups((256, 256, 10), 50) == (2, 512)


@pytest.mark.parametrize("aniso", [False, True])
def test_table_builder_sorts_each_frame(rng, aniso):
    """The brick kernels' tables (``neuron_table``: ``build_table`` of
    csrc/table.cu on the card, its plain version here): rows sorted by each
    frame's own m, ties in neuron order, no trace column; shared anchors
    are one frame."""
    size, k, scaling = CASES["deep_z"]
    _, pos, pos_t, sigma, _, _ = _inputs(rng, size, k, scaling, aniso)
    pos_t[:, 7, 0] = pos_t[:, 8, 0]  # a tie in m in every frame
    for where in (pos[None], pos_t):
        table, order, rmax = fused.neuron_table(where, sigma)
        assert tuple(table.shape) == (where.shape[0], k, fused.REFINE_ROW)
        assert order.dtype == torch.int64
        assert bool((table[:, 1:, 0] >= table[:, :-1, 0]).all())
        sig3 = sigma if aniso else sigma[:, None].expand(-1, 3)
        for b in range(where.shape[0]):
            ob = order[b]
            ties = table[b, 1:, 0] == table[b, :-1, 0]
            assert bool((ob[1:][ties] > ob[:-1][ties]).all())
            np.testing.assert_array_equal(table[b, :, :3].numpy(),
                                          where[b, ob].numpy())
            np.testing.assert_array_equal(table[b, :, 8:11].numpy(),
                                          (6.0 * sig3[ob]).numpy())
            np.testing.assert_allclose(table[b, :, 12:15].numpy(),
                                       (1.0 / sig3[ob] ** 2).numpy(),
                                       rtol=1e-6)
        assert not bool(table[..., 6].any())
        assert float(rmax) == float(6.0 * sig3[:, 0].max())


def test_wrappers_on_cpu_take_the_plain_versions(rng):
    """CPU tensors go to the plain versions and launch nothing."""
    size, k, scaling = CASES["flat"]
    betas, pos, pos_t, sigma, c, y = _inputs(rng, size, k, scaling)
    fused.reset_launch_counts()
    for got, ref in [
            (fused.motion_block(betas, pos, sigma, c, y, size, scaling),
             fused.motion_block_plain(betas, pos, sigma, c, y, size,
                                      scaling)),
            ((fused.c1_block(betas, pos, sigma, y, size, scaling),),
             (fused.c1_block_plain(betas, pos, sigma, y, size, scaling),)),
            ((fused.c1_block_tracked(betas, pos_t, sigma, y, size,
                                     scaling),),
             (fused.c1_block_plain(betas, pos_t, sigma, y, size,
                                   scaling),))]:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    counts = fused.launch_counts()
    assert counts["motion_block"] == counts["c1_block"] == 0
    assert counts["c1_block_tracked"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrappers_count_candidates_by_the_plain_rule_on_cpu(rng, case):
    """``brick_counts=True`` appends the candidate count per brick; on CPU
    tensors it is ``brick_candidates_plain``'s (the card tests hold the
    kernels' own counts to it)."""
    size, k, scaling = CASES[case]
    betas, pos, pos_t, sigma, c, y = _inputs(rng, size, k, scaling)
    _, nb = fused.brick_ids(size)
    for where, out in (
            (pos, fused.motion_block(betas, pos, sigma, c, y, size, scaling,
                                     brick_counts=True)),
            (pos, fused.c1_block(betas, pos, sigma, y, size, scaling,
                                 brick_counts=True)),
            (pos_t, fused.c1_block(betas, pos_t, sigma, y, size, scaling,
                                   brick_counts=True))):
        counts = out[-1]
        assert counts.dtype == torch.int32
        assert tuple(counts.shape) == (betas.shape[0], nb)
        mask = fused.brick_candidates_plain(betas, where, sigma, size,
                                            scaling)
        assert torch.equal(counts, mask.sum(-1).to(torch.int32))
    assert len(out) == 2
