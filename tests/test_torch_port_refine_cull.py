"""Kernel D's brick culling (``dnmf_tpu_torch/ops/fused.py``) on the CPU.

``csrc/refine.cu`` evaluates, at the voxels of a brick (``refine_bricks``:
8 x 8 voxels in (m, n) by runs of at most 32 in z), only the neurons that
``brick_candidates_plain`` lists: those whose per-axis box ``p +- 6
sigma`` meets the brick's exact range of deformed coordinates on all
three axes.  Here, on small volumes with strongly quadratic warps: every
(frame, voxel, neuron) whose footprint clears ``exp(-36)`` is listed, and
the refinement's data term restricted to the listed neurons equals the
unrestricted plain version and the JAX kernel.

Tolerances: restricted vs unrestricted 1e-6 relative (the dropped terms
are below exp(-36) of a footprint's peak); against the JAX kernel as in
``test_torch_port_refine.py`` (mse 1e-5, dpos 1e-4, dsigma 5e-3: the
Pallas wrapper's raw moments cancel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnmf_tpu.ops import pallas_culled as pc
from dnmf_tpu_torch.ops import footprints as fp_ops
from dnmf_tpu_torch.ops import fused

CASES = {  # name: (size, K, scaling)
    "box": ((24, 20, 6), 23, "normalized"),
    "deep_z": ((17, 11, 40), 37, "normalized"),  # z cut into bricks
    "pixel": ((19, 26, 3), 20, "pixel"),
}


def _inputs(rng, size, k, scaling, aniso=False, b=3):
    """Neurons anywhere in the volume (on its border and on brick edges
    too), narrow widths, and strongly quadratic warps."""
    hi = np.asarray(size, np.float64) - 1
    pos = rng.uniform(0, 1, (k, 3)) * hi
    pos[:4] = np.round(pos[:4] / 8) * 8  # on brick edges in m and n
    pos[4, :] = 0.0  # a volume corner
    pos[5, 0] = hi[0]  # the far m face
    pos_t = pos[None] + 0.7 * rng.normal(size=(b, k, 3))
    sigma = rng.uniform(0.6, 1.2, (k, 3) if aniso else (k,))
    betas = np.zeros((b, 10, 3))
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    quad = 0.15 if scaling == "normalized" else 0.02
    betas[:, 4:] = quad * rng.uniform(-1, 1, (b, 6, 3))
    betas[:, 0] = 0.05 * rng.normal(size=(b, 3))
    y = rng.uniform(0, 1, (b, size[0] * size[1] * size[2]))
    c = rng.uniform(0.2, 1, (b, k))
    return [torch.tensor(x, dtype=torch.float32)
            for x in (betas, pos_t, sigma, c, y)]


def _restricted(betas, pos_t, sigma, c, y, size, scaling, want_dsigma,
                mask):
    """``refine_block_plain`` with each neuron's footprint zeroed at the
    voxels of every brick that does not list it."""
    bsz, p = y.shape
    k = pos_t.shape[1]
    ids, _ = fused.brick_ids(size)
    keep = mask[:, ids].to(y.dtype)  # [B, P, K]
    with torch.enable_grad():
        pt = pos_t.detach().requires_grad_(True)
        sg = sigma.detach().expand((bsz,) + sigma.shape).clone()
        sg.requires_grad_(want_dsigma)
        psi = fused._warped(betas, size, scaling, 0, p)
        s3 = sg if sigma.ndim == 2 else sg[..., None].expand(bsz, k, 3)
        d = psi[:, :, None, :] - pt[:, None]
        a = torch.exp(-torch.sum(d * d / (s3 * s3)[:, None], dim=-1))
        a = a * fp_ops._bounds_mask(psi, size) * keep
        r = torch.bmm(a, c[:, :, None])[..., 0] - y
        sse = torch.sum(r * r, dim=1)
        grads = torch.autograd.grad(sse.sum(), (pt, sg) if want_dsigma
                                    else (pt,))
    out = (sse.detach() / p, grads[0] / p)
    return out + (grads[1] / p,) if want_dsigma else out


def rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("size", [(16, 16, 4), (17, 9, 33), (8, 24, 64),
                                  (5, 3, 1)])
def test_bricks_tile_the_volume(size):
    bm, bn, bz = fused.refine_bricks(size)
    assert (bm, bn) == (8, 8) and 1 <= bz <= 32
    assert bz * -(-size[2] // bz) - size[2] < -(-size[2] // bz)  # equal runs
    ids, nb = fused.brick_ids(size)
    counts = torch.bincount(ids, minlength=nb)
    assert counts.numel() == nb and int(counts.min()) >= 1
    assert int(counts.max()) <= bm * bn * bz <= 2048
    assert int(counts.sum()) == size[0] * size[1] * size[2]
    # Brick numbers run z fastest, then n, then m.
    m, n, z = size
    grid = torch.arange(m * n * z).reshape(m, n, z)
    assert int(ids[grid[0, 0, 0]]) == 0
    assert int(ids[grid[0, 0, z - 1]]) == -(-z // bz) - 1
    assert int(ids[grid[m - 1, n - 1, z - 1]]) == nb - 1


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
def test_candidates_cover_every_active_footprint(rng, case, aniso):
    size, k, scaling = CASES[case]
    betas, pos_t, sigma, _, y = _inputs(rng, size, k, scaling, aniso)
    mask = fused.brick_candidates_plain(betas, pos_t, sigma, size, scaling)
    ids, nb = fused.brick_ids(size)
    assert tuple(mask.shape) == (betas.shape[0], nb, k)
    psi = fused._warped(betas.double(), size, scaling, 0, y.shape[1])
    sig3 = sigma.double() if aniso else sigma.double()[:, None].expand(-1, 3)
    d2 = (((psi[:, :, None] - pos_t.double()[:, None]) / sig3) ** 2).sum(-1)
    active = d2 < 36.0  # [B, P, K]
    assert bool(mask[:, ids][active].all())
    # The rule culls: most (brick, neuron) pairs are not listed.
    assert float(mask.double().mean()) < 0.6


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("want_dsigma", [False, True])
def test_refine_restricted_to_candidates_is_the_plain_refine(
        rng, case, aniso, want_dsigma):
    size, k, scaling = CASES[case]
    args = _inputs(rng, size, k, scaling, aniso)
    betas, pos_t, sigma = args[:3]
    mask = fused.brick_candidates_plain(betas, pos_t, sigma, size, scaling)
    got = _restricted(*args, size, scaling, want_dsigma, mask)
    ref = fused.refine_block_plain(*args, size, scaling, want_dsigma)
    assert len(got) == len(ref) == 2 + want_dsigma
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel(g, r) <= 1e-6


def test_refine_block_counts_on_cpu(rng):
    """The wrapper on CPU tensors: the plain results, and the plain
    rule's candidate count per brick."""
    size, k, scaling = CASES["box"]
    args = _inputs(rng, size, k, scaling, aniso=True)
    fused.reset_launch_counts()
    out = fused.refine_block(*args, size, scaling, want_dsigma=True,
                             brick_counts=True)
    ref = fused.refine_block_plain(*args, size, scaling, want_dsigma=True)
    assert len(out) == 4
    for g, r in zip(out, ref):
        assert torch.equal(g, r)
    mask = fused.brick_candidates_plain(*args[:3], size, scaling)
    assert out[3].dtype == torch.int32
    assert torch.equal(out[3], mask.sum(-1).to(torch.int32))
    assert fused.launch_counts()["refine_block"] == 0


def test_refine_table_sorts_each_frame(rng):
    """The refine kernel's per-frame tables (``neuron_table``; its plain
    version on CPU tensors): rows sorted by each frame's own m, the trace
    kept out of the table (the kernel reads it through ``order``)."""
    size, k, scaling = CASES["deep_z"]
    betas, pos_t, sigma, c, _ = _inputs(rng, size, k, scaling, aniso=True)
    table, order, rmax = fused.neuron_table(pos_t, sigma)
    assert tuple(table.shape) == (pos_t.shape[0], k, fused.REFINE_ROW)
    assert order.dtype == torch.int64
    assert bool((table[:, 1:, 0] >= table[:, :-1, 0]).all())
    for b in range(pos_t.shape[0]):
        ob = order[b]
        np.testing.assert_array_equal(table[b, :, :3].numpy(),
                                      pos_t[b, ob].numpy())
        np.testing.assert_array_equal(table[b, :, 8:11].numpy(),
                                      (6.0 * sigma[ob]).numpy())
    assert not bool(table[..., 6].any())
    assert float(rmax) == float(6.0 * sigma[:, 0].max())


@pytest.mark.parametrize("want_dsigma", [False, True])
def test_restricted_refine_matches_pallas(rng, want_dsigma):
    size, k, scaling = CASES["box"]
    args = _inputs(rng, size, k, scaling)
    betas, pos_t, sigma = args[:3]
    mask = fused.brick_candidates_plain(betas, pos_t, sigma, size, scaling)
    got = _restricted(*args, size, scaling, want_dsigma, mask)
    ref = pc.refine_block_culled(*[jnp.asarray(a.numpy()) for a in args],
                                 size, tile_p=128, kblock=8,
                                 want_dsigma=want_dsigma, interpret=True)
    tols = (1e-5, 1e-4, 5e-3)
    for g, r, tol in zip(got, ref, tols):
        r = torch.from_numpy(np.array(r))
        assert rel(g, r) <= tol
