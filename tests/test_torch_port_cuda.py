"""The port's CUDA kernels (motion, c1, Gram, refine; c1 and Gram also at
per-frame positions; the Gram from precomputed coordinate rows, C4;
phase correlation F and the fused warp G) against their plain PyTorch
versions on the card, and the streamed pipeline on the card.  The motion
and Gram kernels also over voxel ranges (pixel shards).  The brick
kernels (motion, c1, Gram, refine) also at odd shapes, at K = 6000 and
20000 crowding a small volume, repeated bit for bit, frame for frame
alone or inside a 16-frame call, and with their candidate counts held to
the plain rule; G also at odd sizes and the largest shifts its halo
takes.  The motion, c1 and Gram kernels over a recordings axis (one
launch for every recording's frame block, bit-equal per recording to the
kernel launched on that recording) and ``batched_round`` with them.  The
closed-form Grams' kernel against the plain closed form (its layouts,
widths, scalings and the plane form), exactly symmetric, its evaluated
pairs against the plain pair factors, through the trust audit, and as
one kernel node per captured Grams call.  The compiled-program layer
(``models/graphs.py``): each captured step equal to its eager run bit
for bit, one graph launch per step and no kernel launch from the host in
a replay, the launch counters kept by the replays, a step that breaks
capture raising, no synchronizing call in a replayed round, autograd's
backward inside a capture, and a captured ``fit`` under the profiler
with its spans on the device's timeline, bit-equal to the eager one; the
same for the programs of refinement (``refine_positions``,
``tracked_grams``, ``refined_rounds``), the width fit and the recordings
round, whose replays count the tracked kernels' launches as their own,
and for the streamed block steps (one entry per step serving every block
of a ``StreamingVideo`` or ``RawFileVideo``, the padded tail included).
The data layer on the card: the simulator against its CPU run on one CPU
generator's draws, a ``SimulatedVideoDataset`` on the card feeding
``fit``, and the recovery harness with and without the kernels.  Marked
``cuda``; every test skips where no CUDA device exists.

Run on a machine with an H100:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda``.

Tolerance: 1e-4 of the float64 oracle's max magnitude (the kernels sum
in float32, per thread and then per chunk in a fixed order).
"""

import math

import numpy as np
import pytest
import torch

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.config import RegistrationConfig
from dnmf_tpu_torch.data.streaming import RawFileVideo, StreamingVideo
from dnmf_tpu_torch.engine.pipeline import register_and_demix
from dnmf_tpu_torch.ops import fft_reg, fused, phasecorr, warp
from dnmf_tpu_torch.registration import MotionCorrect

pytestmark = pytest.mark.cuda

SHAPES = {
    "box": ((16, 12, 4), 20),
    "thin_z": ((40, 24, 2), 45),
    "blocks": ((96, 64, 6), 100),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(size, k, dev, b=5, seed=0, aniso=False):
    rng = np.random.default_rng(seed)
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform([1, 1, 0], hi - [1, 1, 0], (k, 3))
    sigma = rng.uniform(1.0, 2.5, (k, 3) if aniso else (k,))
    betas = np.zeros((b, 10, 3))
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    betas[1:] += 0.01 * rng.normal(size=(b - 1, 10, 3))
    y = rng.uniform(0, 1, (b, size[0] * size[1] * size[2]))
    c = rng.uniform(0.2, 1, (b, k))
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (betas, pos, sigma, c, y)]


def rel_err(got, ref):
    return float((got.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_kernels_match_float64(dev, shape, scaling):
    size, k = SHAPES[shape]
    betas, pos, sigma, c, y = _inputs(size, k, dev)
    d = [t.double() for t in (betas, pos, sigma, c, y)]
    fused.reset_launch_counts()

    mse, db = fused.motion_block(betas, pos, sigma, c, y, size, scaling)
    mse_o, db_o = fused.motion_block_plain(*d, size, scaling)
    assert rel_err(mse, mse_o) <= 1e-4
    assert rel_err(db, db_o) <= 1e-4

    c1 = fused.c1_block(betas, pos, sigma, y, size, scaling)
    g, c1g = fused.gram_block(betas, pos, sigma, y, size, scaling)
    g_o, c1_o = fused.gram_block_plain(d[0], d[1], d[2], d[4], size, scaling)
    torch.cuda.synchronize()
    assert rel_err(c1, c1_o) <= 1e-4
    assert rel_err(c1g, c1_o) <= 1e-4
    assert rel_err(g, g_o) <= 1e-4
    assert fused.launch_counts() == {
        "motion_block": 1, "c1_block": 1, "gram_block": 1,
        "refine_block": 0, "c1_block_tracked": 0, "gram_block_tracked": 0,
        "gram_block_rows": 0, "analytic_grams": 0,
        "phase_corr_block": 0, "fused_separable_warp": 0}



@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("npix", [3, 5])
def test_voxel_range_kernels_match_float64(dev, shape, npix):
    """Kernels A and C over voxel ranges (pixel shards, unequal when
    ``npix`` does not divide P, cutting rows of m mid-row) against the
    plain versions over the same range in float64; the Grams summed over
    the shards, and A's means weighted by the shards' voxels, against the
    whole volume's; the candidate counts are the plain rule's over the
    bricks of the range."""
    size, k = SHAPES[shape]
    betas, pos, sigma, c, y = _inputs(size, k, dev)
    d = [t.double() for t in (betas, pos, sigma, c, y)]
    p = y.shape[1]
    g_sum = c1_sum = mse_sum = db_sum = 0.0
    for i in range(npix):
        lo, hi = i * p // npix, (i + 1) * p // npix
        ys = y[:, lo:hi].contiguous()
        mse, db, cnt = fused.motion_block(betas, pos, sigma, c, ys, size,
                                          brick_counts=True, p_offset=lo)
        mse_o, db_o = fused.motion_block_plain(*d[:4], d[4][:, lo:hi], size,
                                               p_offset=lo)
        g, c1g, gcnt = fused.gram_block(betas, pos, sigma, ys, size,
                                        brick_counts=True, p_offset=lo)
        g_o, c1_o = fused.gram_block_plain(d[0], d[1], d[2], d[4][:, lo:hi],
                                           size, p_offset=lo)
        mask = fused.brick_candidates_plain(betas, pos, sigma, size,
                                            p_offset=lo, p_count=hi - lo)
        torch.cuda.synchronize()
        for got, ref in ((mse, mse_o), (db, db_o), (g, g_o), (c1g, c1_o)):
            assert rel_err(got, ref) <= 1e-4
        assert torch.equal(cnt, mask.sum(-1).to(torch.int32))
        assert torch.equal(gcnt, cnt)
        g_sum, c1_sum = g_sum + g.double(), c1_sum + c1g.double()
        mse_sum = mse_sum + mse.double() * (hi - lo) / p
        db_sum = db_sum + db.double() * (hi - lo) / p
    g_o, c1_o = fused.gram_block_plain(d[0], d[1], d[2], d[4], size)
    mse_o, db_o = fused.motion_block_plain(*d, size)
    for got, ref in ((g_sum, g_o), (c1_sum, c1_o), (mse_sum, mse_o),
                     (db_sum, db_o)):
        assert rel_err(got, ref) <= 1e-4


def test_anisotropic_widths(dev):
    size, k = SHAPES["blocks"]
    betas, pos, sigma, c, y = _inputs(size, k, dev, aniso=True)
    d = [t.double() for t in (betas, pos, sigma, c, y)]
    mse, db = fused.motion_block(betas, pos, sigma, c, y, size)
    mse_o, db_o = fused.motion_block_plain(*d, size)
    g, c1 = fused.gram_block(betas, pos, sigma, y, size)
    g_o, c1_o = fused.gram_block_plain(d[0], d[1], d[2], d[4], size)
    assert rel_err(mse, mse_o) <= 1e-4
    assert rel_err(db, db_o) <= 1e-4
    assert rel_err(g, g_o) <= 1e-4
    assert rel_err(c1, c1_o) <= 1e-4


def _tracked(pos, b, seed=1, crossing=False):
    """Per-frame positions about 1 px around the anchors; with
    ``crossing`` neurons 0 and 1 swap places in m across the frames."""
    gen = torch.Generator(device=pos.device).manual_seed(seed)
    pos_t = pos[None] + torch.randn((b,) + pos.shape, generator=gen,
                                    device=pos.device)
    if crossing:
        lo, hi = float(pos[:, 0].min()), float(pos[:, 0].max())
        steps = torch.linspace(0.0, 1.0, b, device=pos.device)
        pos_t[:, 0, 0] = lo + (hi - lo) * steps
        pos_t[:, 1, 0] = hi - 0.9 * (hi - lo) * steps
    return pos_t


def _refine_inputs(size, k, dev, scaling, aniso, warp):
    """``_inputs`` with per-frame positions, some neurons on brick edges
    (multiples of 8 in m and n) and on the volume's border; ``warp =
    "quadratic"`` adds strongly quadratic warps."""
    betas, pos, sigma, c, y = _inputs(size, k, dev, aniso=aniso)
    hi = torch.tensor(size, dtype=torch.float32, device=dev) - 1
    pos[:4, :2] = torch.round(pos[:4, :2] / 8) * 8
    pos[4] = 0.0
    pos[5] = hi
    pos[6, 1] = hi[1]
    if warp == "quadratic":
        gen = torch.Generator(device="cpu").manual_seed(7)
        quad = 0.15 if scaling == "normalized" else 0.02
        betas[:, 4:] += quad * (2 * torch.rand((betas.shape[0], 6, 3),
                                               generator=gen) - 1).to(dev)
    return betas, _tracked(pos, betas.shape[0]), sigma, c, y


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("aniso", [False, True])
@pytest.mark.parametrize("warp", ["mild", "quadratic"])
def test_refine_kernel_matches_float64(dev, shape, scaling, aniso, warp):
    """Neurons on brick edges and the border, K not a multiple of 32 (20,
    45, 100), mild and strongly quadratic warps; two launches give
    bit-equal outputs."""
    size, k = SHAPES[shape]
    betas, pos_t, sigma, c, y = _refine_inputs(size, k, dev, scaling, aniso,
                                               warp)
    d = [t.double() for t in (betas, pos_t, sigma, c, y)]
    fused.reset_launch_counts()
    for want in (False, True):
        got = fused.refine_block(betas, pos_t, sigma, c, y, size, scaling,
                                 want_dsigma=want)
        again = fused.refine_block(betas, pos_t, sigma, c, y, size, scaling,
                                   want_dsigma=want)
        ref = fused.refine_block_plain(*d, size, scaling, want_dsigma=want)
        torch.cuda.synchronize()
        assert len(got) == len(ref) == 2 + want
        for g, a, r in zip(got, again, ref):
            assert g.shape == r.shape
            assert rel_err(g, r) <= 1e-4
            assert torch.equal(g, a)
    assert fused.launch_counts()["refine_block"] == 4


@pytest.mark.parametrize("shape", sorted(SHAPES) + ["deep_z"])
@pytest.mark.parametrize("warp", ["mild", "quadratic"])
def test_refine_brick_counts_match_the_plain_rule(dev, shape, warp):
    """The kernel's candidate count per brick, returned by the launch,
    equals ``brick_candidates_plain``'s on the same inputs."""
    size, k = SHAPES.get(shape, ((24, 17, 40), 33))
    betas, pos_t, sigma, c, y = _refine_inputs(size, k, dev, "normalized",
                                               True, warp)
    *_, counts = fused.refine_block(betas, pos_t, sigma, c, y, size,
                                    brick_counts=True)
    mask = fused.brick_candidates_plain(betas, pos_t, sigma, size)
    torch.cuda.synchronize()
    assert counts.dtype == torch.int32
    assert torch.equal(counts, mask.sum(-1).to(torch.int32))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("crossing", [False, True])
def test_tracked_c1_and_gram_match_float64(dev, shape, crossing):
    size, k = SHAPES[shape]
    betas, pos, sigma, _, y = _inputs(size, k, dev, aniso=True)
    pos_t = _tracked(pos, betas.shape[0], crossing=crossing)
    d = [t.double() for t in (betas, pos_t, sigma, y)]
    fused.reset_launch_counts()
    c1 = fused.c1_block(betas, pos_t, sigma, y, size)
    g, c1g = fused.gram_block(betas, pos_t, sigma, y, size)
    g_o, c1_o = fused.gram_block_tracked_plain(*d, size)
    torch.cuda.synchronize()
    assert rel_err(c1, c1_o) <= 1e-4
    assert rel_err(c1g, c1_o) <= 1e-4
    assert rel_err(g, g_o) <= 1e-4
    counts = fused.launch_counts()
    assert counts["c1_block_tracked"] == counts["gram_block_tracked"] == 1
    assert counts["c1_block"] == counts["gram_block"] == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    size, k = SHAPES["box"]
    betas, pos, sigma, c, y = _inputs(size, k, dev)
    with pytest.raises(TypeError):
        fused.c1_block(betas, pos, sigma, y.double(), size)
    with pytest.raises(ValueError):
        fused.c1_block(betas, pos, sigma, y[:, :-1], size)
    with pytest.raises(ValueError):
        fused.gram_block(betas, pos, sigma, y.t().contiguous().t(), size)
    with pytest.raises(ValueError):
        fused.refine_block(betas, _tracked(pos, 2), sigma, c, y, size)


# ---------------------------------- brick kernels: motion (A) and c1 (B)
BRICK_SHAPES = {  # name: (size, K)
    "odd": ((21, 13, 5), 30),  # M and N not multiples of 8
    "flat": ((19, 23, 1), 25),  # Z = 1: face voxels on fade ties
    "deep": ((12, 17, 41), 40),  # Z > 32: two z runs per column
    "few": ((40, 36, 6), 3),  # K below one brick's reach
}


def _brick_inputs(size, k, dev, scaling, aniso, b=5, seed=3):
    """Neurons on brick edges, on the volume's faces and outside it;
    frame 0 at the identity warp, the others strongly quadratic;
    per-frame positions ~1 px around the anchors."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(size, np.float64) - 1
    pos = rng.uniform(-1.0, 1.0, (k, 3)) * 0.55 * hi + 0.5 * hi
    pos[0] = [-2.0, -1.0, -0.5]  # outside, within reach
    if k > 2:
        pos[1] = hi + [1.5, 2.0, 0.5]
        pos[2, :2] = np.round(pos[2, :2] / 8) * 8  # on brick edges
    sigma = rng.uniform(0.8, 2.0, (k, 3) if aniso else (k,))
    betas = np.zeros((b, 10, 3))
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    quad = 0.15 if scaling == "normalized" else 0.02
    betas[1:, 4:] = quad * rng.uniform(-1, 1, (b - 1, 6, 3))
    betas[1:, 0] = 0.05 * rng.normal(size=(b - 1, 3))
    y = rng.uniform(0, 1, (b, size[0] * size[1] * size[2]))
    c = rng.uniform(0.2, 1, (b, k))
    pos_t = pos[None] + rng.normal(size=(b, k, 3))
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (betas, pos, pos_t, sigma, c, y)]


@pytest.mark.parametrize("shape", sorted(BRICK_SHAPES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("aniso", [False, True])
def test_brick_motion_and_c1_match_float64(dev, shape, scaling, aniso):
    """A, B at shared anchors and B at per-frame positions against
    float64; a second launch gives bit-equal outputs."""
    size, k = BRICK_SHAPES[shape]
    betas, pos, pos_t, sigma, c, y = _brick_inputs(size, k, dev, scaling,
                                                   aniso)
    d = [t.double() for t in (betas, pos, pos_t, sigma, c, y)]
    fused.reset_launch_counts()

    def run():
        return (*fused.motion_block(betas, pos, sigma, c, y, size, scaling),
                fused.c1_block(betas, pos, sigma, y, size, scaling),
                fused.c1_block(betas, pos_t, sigma, y, size, scaling))

    got, again = run(), run()
    ref = (*fused.motion_block_plain(d[0], d[1], d[3], d[4], d[5], size,
                                     scaling),
           fused.c1_block_plain(d[0], d[1], d[3], d[5], size, scaling),
           fused.c1_block_plain(d[0], d[2], d[3], d[5], size, scaling))
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert g.shape == r.shape
        assert rel_err(g, r) <= 1e-4
        assert torch.equal(g, a)
    counts = fused.launch_counts()
    assert counts["motion_block"] == counts["c1_block"] == 2
    assert counts["c1_block_tracked"] == 2


@pytest.mark.parametrize("aniso", [False, True])
def test_brick_kernels_give_a_frame_the_same_bits_in_any_call(dev, aniso):
    """A frame's mse, dbeta and c1 (shared and tracked) are bit-equal
    alone and inside a 16-frame call: the group count depends only on
    the volume and K."""
    size, k = (96, 64, 20), 100
    betas, pos, pos_t, sigma, c, y = _brick_inputs(size, k, dev,
                                                   "normalized", aniso, b=16)

    def outputs(sl):
        return (*fused.motion_block(betas[sl], pos, sigma, c[sl], y[sl],
                                    size),
                fused.c1_block(betas[sl], pos, sigma, y[sl], size),
                fused.c1_block(betas[sl], pos_t[sl], sigma, y[sl], size))

    full = outputs(slice(None))
    for b in (0, 7, 15):
        alone = outputs(slice(b, b + 1))
        torch.cuda.synchronize()
        for f, a in zip(full, alone):
            assert torch.equal(f[b:b + 1], a)


@pytest.mark.parametrize("shape", sorted(BRICK_SHAPES) + ["crowded"])
def test_brick_motion_and_c1_counts_match_the_plain_rule(dev, shape):
    """The candidate count per brick of A, B and B at per-frame positions,
    returned by the launch, equals ``brick_candidates_plain``'s; "crowded"
    lists more than one shared-memory chunk per brick."""
    size, k = BRICK_SHAPES.get(shape, ((20, 16, 6), 1500))
    betas, pos, pos_t, sigma, c, y = _brick_inputs(size, k, dev,
                                                   "normalized", True)
    for where, out in (
            (pos, fused.motion_block(betas, pos, sigma, c, y, size,
                                     brick_counts=True)),
            (pos, fused.c1_block(betas, pos, sigma, y, size,
                                 brick_counts=True)),
            (pos_t, fused.c1_block(betas, pos_t, sigma, y, size,
                                   brick_counts=True))):
        mask = fused.brick_candidates_plain(betas, where, sigma, size)
        torch.cuda.synchronize()
        assert out[-1].dtype == torch.int32
        assert torch.equal(out[-1], mask.sum(-1).to(torch.int32))


def test_brick_kernels_take_any_k(dev):
    """K = 6000 neurons crowd a small volume: every brick lists thousands of
    candidates, handed to A and B in several shared-memory chunks; both
    still match float64 (the kernel before the chunks raised past ~3,100
    neurons)."""
    size, k = (24, 16, 6), 6000
    betas, pos, pos_t, sigma, c, y = _brick_inputs(size, k, dev,
                                                   "normalized", False, b=2)
    d = [t.double() for t in (betas, pos, pos_t, sigma, c, y)]
    fused.reset_launch_counts()
    got = (*fused.motion_block(betas, pos, sigma, c, y, size),
           fused.c1_block(betas, pos, sigma, y, size),
           fused.c1_block(betas, pos_t, sigma, y, size))
    ref = (*fused.motion_block_plain(d[0], d[1], d[3], d[4], d[5], size),
           fused.c1_block_plain(d[0], d[1], d[3], d[5], size),
           fused.c1_block_plain(d[0], d[2], d[3], d[5], size))
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(g, r) <= 1e-4
    counts = fused.launch_counts()
    assert counts["motion_block"] == counts["c1_block"] == 1
    assert counts["c1_block_tracked"] == 1


@pytest.mark.parametrize("k", [6000, 20000])
def test_refine_runs_at_any_k(dev, k):
    """K = 6000 and 20000 neurons crowd a small volume: every brick lists
    thousands of candidates, handed to D in chunks of its shared buffer
    (listed twice: S, then the moments); with and without dsigma, D
    matches its plain version in float32 and float64 (the kernel that
    kept K rows in shared memory raised past ~3,000-3,600 neurons)."""
    size = (16, 16, 4)
    betas, _, pos_t, sigma, c, y = _brick_inputs(size, k, dev, "normalized",
                                                 True, b=2)
    d = [t.double() for t in (betas, pos_t, sigma, c, y)]
    fused.reset_launch_counts()
    for want in (False, True):
        got = fused.refine_block(betas, pos_t, sigma, c, y, size,
                                 want_dsigma=want, brick_counts=True)
        p32 = fused.refine_block_plain(betas, pos_t, sigma, c, y, size,
                                       want_dsigma=want)
        ref = fused.refine_block_plain(*d, size, want_dsigma=want)
        mask = fused.brick_candidates_plain(betas, pos_t, sigma, size)
        torch.cuda.synchronize()
        assert int(got[-1].max()) > 2 * 512  # several chunks per brick
        assert torch.equal(got[-1], mask.sum(-1).to(torch.int32))
        for g, p, r in zip(got[:-1], p32, ref):
            assert g.shape == r.shape
            assert rel_err(g, r) <= 1e-4
            assert rel_err(g, p.double()) <= 1e-4
    assert fused.launch_counts()["refine_block"] == 2


@pytest.mark.parametrize("aniso", [False, True])
def test_neuron_table_on_the_card_is_the_plain_table(dev, aniso):
    """``build_table`` (csrc/table.cu) against ``neuron_table_plain``: the
    same order (stable among ties in m) and rows, with K over several of
    the kernel's shared tiles and thread blocks."""
    size, k = (40, 36, 6), 2500
    _, pos, pos_t, sigma, _, _ = _brick_inputs(size, k, dev, "normalized",
                                               aniso)
    pos_t[:, 7, 0] = pos_t[:, 8, 0]
    pos_t[:, 100:140, 0] = 5.0
    for where in (pos[None], pos_t):
        table, order, rmax = fused.neuron_table(where, sigma)
        t_ref, o_ref, r_ref = fused.neuron_table_plain(where.cpu(),
                                                       sigma.cpu())
        torch.cuda.synchronize()
        assert torch.equal(rmax.cpu(), r_ref)
        assert order.dtype == torch.int64
        assert torch.equal(order.cpu(), o_ref)
        assert torch.equal(table.cpu()[..., :3], t_ref[..., :3])
        assert torch.equal(table.cpu()[..., 8:11], t_ref[..., 8:11])
        torch.testing.assert_close(table.cpu(), t_ref, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("aniso", [False, True])
def test_neuron_tables_per_recording_on_the_card(dev, aniso):
    """``build_table`` with a set of widths per table against
    ``neuron_table_plain``: one table per recording, rmax over all."""
    size, k = (40, 36, 6), 300
    _, pos, sigma, _, _, _ = _recordings(size, k, dev, aniso)
    table, order, rmax = fused.neuron_table(pos, sigma, per_table=True)
    t_ref, o_ref, r_ref = fused.neuron_table_plain(pos.cpu(), sigma.cpu(),
                                                   per_table=True)
    torch.cuda.synchronize()
    assert torch.equal(rmax.cpu(), r_ref)
    assert torch.equal(order.cpu(), o_ref)
    assert torch.equal(table.cpu()[..., :3], t_ref[..., :3])
    assert torch.equal(table.cpu()[..., 8:11], t_ref[..., 8:11])
    torch.testing.assert_close(table.cpu(), t_ref, rtol=1e-6, atol=0.0)


# ---------------------------- a recordings axis: A, B and C in one launch
RECORDINGS, REC_BLOCK = 3, 4


def _recordings(size, k, dev, aniso, t=7, seed=11):
    """Recordings with their own positions, widths (+-10% around 1.8 px
    per recording and neuron), warps and traces; ``y`` is the frame block
    ``[1, 1 + REC_BLOCK)`` of videos ``[R, t, P]``, a strided view, as
    ``batched_round`` cuts it.  Returns ``(betas, pos, sigma, c, y,
    videos)``."""
    rng = np.random.default_rng(seed)
    r, b = RECORDINGS, REC_BLOCK
    hi = np.asarray(size, np.float32) - 1
    pos = rng.uniform([1, 1, 0], hi - [1, 1, 0], (r, k, 3))
    sigma = 1.8 * (1.0 + 0.1 * rng.uniform(-1, 1, (r, k, 3) if aniso
                                           else (r, k)))
    betas = np.zeros((r, b, 10, 3))
    betas[..., 1, 0] = betas[..., 2, 1] = betas[..., 3, 2] = 1.0
    betas += 0.01 * rng.normal(size=betas.shape)
    c = rng.uniform(0.2, 1, (r, b, k))
    videos = rng.uniform(0, 1, (r, t, size[0] * size[1] * size[2]))
    out = [torch.tensor(x, dtype=torch.float32, device=dev)
           for x in (betas, pos, sigma, c, videos)]
    return (*out[:4], out[4][:, 1:1 + b], out[4])


def _passes(betas, pos, sigma, c, y, size, dt=None):
    """A's, B's and C's outputs (each a tuple) on one set of inputs; with
    ``dt`` the plain versions in that dtype."""
    if dt is not None:
        betas, pos, sigma, c, y = (t.to(dt) for t in (betas, pos, sigma, c,
                                                      y))
        return {"motion_block": fused.motion_block_plain(betas, pos, sigma,
                                                         c, y, size),
                "c1_block": (fused.c1_block_plain(betas, pos, sigma, y,
                                                  size),),
                "gram_block": fused.gram_block_plain(betas, pos, sigma, y,
                                                     size)}
    return {"motion_block": fused.motion_block(betas, pos, sigma, c, y, size,
                                               brick_counts=True),
            "c1_block": fused.c1_block(betas, pos, sigma, y, size,
                                       brick_counts=True),
            "gram_block": fused.gram_block(betas, pos, sigma, y, size,
                                           brick_counts=True)}


@pytest.mark.parametrize("shape", sorted(BRICK_SHAPES) + ["blocks"])
@pytest.mark.parametrize("aniso", [False, True])
def test_recordings_axis_is_bit_equal_per_recording(dev, shape, aniso):
    """A, B and C over every recording's frame block, one launch each,
    equal per recording, bit for bit (candidate counts too), the kernel
    launched on that recording alone (its own table and rmax), and lie
    within 1e-4 of float64."""
    size, k = {**BRICK_SHAPES, **SHAPES}[shape]
    betas, pos, sigma, c, y, _ = _recordings(size, k, dev, aniso)
    fused.reset_launch_counts()
    got = _passes(betas, pos, sigma, c, y, size)
    torch.cuda.synchronize()
    counts = fused.launch_counts()
    assert {n: counts[n] for n in got} == dict.fromkeys(got, 1)
    for r in range(RECORDINGS):
        one = _passes(betas[r], pos[r], sigma[r], c[r], y[r], size)
        ref = _passes(betas[r], pos[r], sigma[r], c[r], y[r], size,
                      torch.float64)
        torch.cuda.synchronize()
        for name in got:
            for g, o in zip(got[name], one[name]):
                assert torch.equal(g[r], o), (name, r)
            for g, q in zip(got[name], ref[name]):
                assert rel_err(g[r], q) < 1e-4, (name, r)


def test_batched_round_launches_each_pass_once_per_block(dev):
    """``batched_round`` with the kernels: per frame block one launch of A
    and of C (exact) or B (closed form) for every recording (the round's
    graph entry's warm-up, one eager round, aside), and the round equals
    the single-recording rounds (beta within rtol 1e-5 / atol 1e-7, C
    within rtol 1e-4 / atol 1e-6)."""
    from dnmf_tpu_torch import parallel
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import graphs

    size, k, t = (40, 36, 6), 30, 8
    _, pos, sigma, _, _, videos = _recordings(size, k, dev, False, t=t)
    model = tcfg.ModelConfig(size=size, num_neurons=k, num_frames=t,
                             shape_std=1.8)
    states = [tM.init_state(model, positions=pos[r], device=dev,
                            generator=torch.Generator().manual_seed(r))
              .replace(sigma=sigma[r]) for r in range(RECORDINGS)]
    adam = tM.Adam(1e-3)
    for gram_mode, pass_name in (("exact", "gram_block"),
                                 ("analytic", "c1_block")):
        graphs.clear()
        fused.reset_launch_counts()
        got, _ = parallel.batched_round(
            parallel.stack_states(states), videos, model, adam, 0.1, 10,
            frame_block=REC_BLOCK, use_kernels=True, gram_mode=gram_mode)
        counts = fused.launch_counts()
        (entry,) = graphs.entries()
        for name, n in entry.warmup_launches.items():
            counts[name] -= n
        assert counts["motion_block"] == counts[pass_name] == t // REC_BLOCK
        for r, st in enumerate(states):
            st, _ = tM.motion_epoch_parallel(st, videos[r], model, adam, 0.1,
                                             REC_BLOCK, True)
            g, c1 = tM.grams_local(st, videos[r], model, REC_BLOCK, True,
                                   gram_mode)
            ref = tM.footprint_update(st, g, c1, 10)
            torch.testing.assert_close(got.beta[r], ref.beta, rtol=1e-5,
                                       atol=1e-7)
            torch.testing.assert_close(got.c[r], ref.c, rtol=1e-4, atol=1e-6)
    graphs.clear()


# --------------------------------- closed-form Grams: csrc/gram_closed.cu
# name: (size, K, frames, layout, per-axis widths, scaling, position
# margin); the benchmark's whole-brain and ROI shapes, then the other
# layouts, widths and scalings, and thin volumes (the plane form).
CLOSED_CASES = {
    "whole_brain": ((512, 512, 20), 200, 16, "shared", False, "normalized",
                    (20.0, 20.0, 2.0)),
    "roi": ((256, 256, 10), 50, 8, "shared", False, "normalized",
            (10.0, 10.0, 1.0)),
    "wb_tracked_aniso": ((512, 512, 20), 200, 4, "tracked", True,
                         "normalized", (20.0, 20.0, 2.0)),
    "roi_recordings_pixel": ((256, 256, 10), 50, 8, "recordings", True,
                             "pixel", (10.0, 10.0, 1.0)),
    "roi_pixel": ((256, 256, 10), 50, 8, "shared", False, "pixel",
                  (10.0, 10.0, 1.0)),
    "odd_k_recordings": ((96, 64, 6), 37, 5, "recordings", False,
                         "normalized", (1.0, 1.0, 0.0)),
    "thin": ((40, 24, 2), 45, 5, "shared", False, "normalized",
             (1.0, 1.0, 0.0)),
    "thin_tracked_aniso_pixel": ((64, 3, 48), 60, 5, "tracked", True,
                                 "pixel", (1.0, 0.0, 1.0)),
}
CLOSED_TOL = 1e-5  # max|kernel - plain float32| / max|plain float32|


def _closed_inputs(dev, name, seed=7):
    size, k, t, layout, aniso, _, margin = CLOSED_CASES[name]
    rng = np.random.default_rng(seed)
    hi = np.asarray(size, np.float64) - 1 - np.asarray(margin)
    lead = (RECORDINGS, t) if layout == "recordings" else (t,)
    tables = {"shared": (), "tracked": (t,),
              "recordings": (RECORDINGS,)}[layout]
    pos = rng.uniform(margin, hi, tables + (k, 3))
    sigma = 3.0 * rng.uniform(0.8, 1.2, tables[:int(layout == "recordings")]
                              + ((k, 3) if aniso else (k,)))
    betas = np.zeros(lead + (10, 3))
    betas[..., 1, 0] = betas[..., 2, 1] = betas[..., 3, 2] = 1.0
    betas += 0.005 * rng.normal(size=betas.shape)
    return [torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (betas, pos, sigma)]


@pytest.mark.parametrize("name", list(CLOSED_CASES))
def test_closed_form_kernel_matches_plain(dev, name):
    """The kernel against the plain closed form on the card within
    CLOSED_TOL, G exactly symmetric, one launch, the same bits on a second
    call, and the evaluated entries per frame equal to the plain pair
    factors that are non-zero in float32 (those that are subnormal may
    round either way)."""
    from dnmf_tpu_torch.ops import gram_analytic as ga

    size, k, t, layout, aniso, scaling, _ = CLOSED_CASES[name]
    betas, pos, sigma = _closed_inputs(dev, name)
    kw = dict(scaling=scaling, window=ga.default_window(3.0))
    fused.reset_launch_counts()
    g, counts = fused.analytic_grams(betas, pos, sigma, size,
                                     pair_counts=True, **kw)
    assert fused.launch_counts()["analytic_grams"] == 1
    ref = ga.analytic_grams(betas, pos, sigma, size, **kw)
    torch.cuda.synchronize()
    assert g.shape == ref.shape and counts.shape == betas.shape[:-2]
    err = float((g - ref).abs().max() / ref.abs().max())
    assert err <= CLOSED_TOL, err
    assert torch.equal(g, g.transpose(-1, -2))
    assert torch.equal(fused.analytic_grams(betas, pos, sigma, size, **kw), g)
    sig = sigma if aniso else sigma[..., None].expand(sigma.shape + (3,))
    pos_t = pos if pos.ndim == 3 else pos[None]
    pf = ga.pair_terms(pos_t, sig if sig.ndim == 3 else sig[None])[-1]
    nonzero = torch.count_nonzero(pf, dim=(-2, -1))
    normal = torch.count_nonzero(pf >= torch.finfo(torch.float32).tiny,
                                 dim=(-2, -1))
    if layout == "recordings":
        nonzero, normal = nonzero[:, None], normal[:, None]
    assert bool(((counts >= normal) & (counts <= nonzero)).all())
    assert bool((counts >= k).all())


def test_closed_form_audit_through_the_kernel(dev):
    """The trust audit with the kernels evaluates the closed form through
    the kernel; its rel_err within 1e-6 of the plain closed form's against
    the same exact Gram."""
    from dnmf_tpu_torch.engine import trainer as ttr
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.ops import gram_analytic as ga

    model, state, _ = _graph_inputs(dev)
    window = ga.default_window(model.shape_std)
    fused.reset_launch_counts()
    audit = ttr.audit_analytic_gram(state, model, window=window,
                                    use_kernels=True)
    assert fused.launch_counts()["analytic_grams"] == 1
    t = audit["frame"]
    beta1 = state.beta[t:t + 1]
    g_exact, _ = tM.compute_grams(
        state.replace(beta=beta1, c=state.c[:, :1]),
        torch.zeros((1, model.num_voxels), device=dev), model, 1, True,
        "exact")
    g_plain = ga.analytic_grams(beta1, state.pos, state.sigma, model.size,
                                window=window)
    rel_plain = float(torch.max(torch.abs(g_plain - g_exact))
                      / torch.max(torch.abs(g_exact)))
    assert abs(audit["rel_err"] - rel_plain) <= 1e-6, (audit, rel_plain)


def test_captured_closed_form_grams_are_one_kernel_per_call(graph_cache,
                                                           dev):
    """A captured ``compute_grams`` (closed form) holds one
    ``gram_closed`` node and the c1 passes' nodes (a table, the brick walk
    and the finish per frame block): no elementwise chain."""
    model, state, video = _graph_inputs(dev)
    _graph_steps(model, state, video)["grams_analytic"]()
    (entry,) = graph_cache.entries()
    blocks = -(-GRAPH_T // GRAPH_FB)
    assert entry.launches == {"c1_block": blocks, "analytic_grams": 1}
    closed = sum(n for name, n in entry.nodes.items() if "gram_closed" in name)
    c1 = sum(n for name, n in entry.nodes.items()
             if any(s in name for s in ("build_table", "c1_bricks",
                                        "c1_finish")))
    assert closed == 1 and c1 == 3 * blocks
    assert sum(entry.nodes.values()) - closed - c1 <= 2, entry.nodes


# ------------------------------------------------ registration: F and G
PC_SHAPES = {  # name: ((m, n, z), patches)
    "box": ((16, 16, 4), 3),
    "odd": ((20, 24, 6), 2),
    "radix": ((33, 35, 7), 2),  # factors 3, 11, 5, 7; odd z
    "prime": ((67, 13, 5), 2),  # a prime above 13 (generic butterfly)
    "flat": ((30, 22, 1), 3),  # z = 1
    "odd_all": ((15, 21, 9), 2),  # odd m, n and z
    "long": ((264, 40, 2), 1),  # the pipeline's 264 = 8 * 11 * 3
}


def _pc_inputs(dev, shape, np_, b=3, seed=0):
    """Smooth template patches and frames shifted from them by known
    integer amounts (circularly), plus noise."""
    m, n, z = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tmpl = torch.rand((np_, m, n, z), generator=gen, dtype=torch.float64)
    true = torch.randint(-2, 3, (b, np_, 3), generator=gen)
    pats = torch.stack([torch.stack([
        torch.roll(tmpl[p], tuple(int(s) for s in true[i, p]), (0, 1, 2))
        for p in range(np_)]) for i in range(b)])
    pats = pats + 0.01 * torch.rand(pats.shape, generator=gen,
                                    dtype=torch.float64)
    return tmpl.to(dev), pats.to(dev), true


def _pc_bounds(dev, b, lb, ub):
    rows = torch.zeros((b, 8), device=dev)
    rows[:, :3] = torch.tensor(lb, dtype=torch.float32)
    rows[:, 3:6] = torch.tensor(ub, dtype=torch.float32)
    rows[-1, :3] += 1.0  # a frame of its own window
    return rows


@pytest.mark.parametrize("shape", sorted(PC_SHAPES))
@pytest.mark.parametrize("window", ["wide", "narrow", "empty"])
def test_phase_corr_kernel_matches_float64(dev, shape, window):
    """Exact integer shifts and product spectra within 1e-4 of float64 at
    lengths of every radix, a prime above 13, odd axes and z = 1."""
    size, np_ = PC_SHAPES[shape]
    tmpl, pats, _ = _pc_inputs(dev, size, np_)
    lb, ub = {"wide": ([-3, -3, -2], [4, 4, 3]),
              "narrow": ([-1, 0, -1], [2, 2, 1]),
              "empty": ([-3, 2, -2], [4, 2, 3])}[window]
    bounds = _pc_bounds(dev, pats.shape[0], lb, ub)
    tre, tim = phasecorr.patch_spectra(tmpl)
    zm_n = phasecorr.to_zm_n(pats)
    fused.reset_launch_counts()
    got = phasecorr.phase_corr_block(zm_n.float(), tre.float(), tim.float(),
                                     bounds, z=size[2])
    oracle = phasecorr.phase_corr_block_plain(zm_n, tre, tim, bounds,
                                              z=size[2])
    plain = phasecorr.phase_corr_block_plain(zm_n.float(), tre.float(),
                                             tim.float(), bounds, z=size[2])
    # A caller's bound on the windows (ub - lb) sizes them without a sync.
    capped = phasecorr.phase_corr_block(
        zm_n.float(), tre.float(), tim.float(), bounds, z=size[2],
        max_window=tuple(max(1, u - lo) for lo, u in zip(lb, ub)))
    again = phasecorr.phase_corr_block(zm_n.float(), tre.float(),
                                       tim.float(), bounds, z=size[2])
    torch.cuda.synchronize()
    assert fused.launch_counts()["phase_corr_block"] == 3
    assert torch.equal(got[0].double(), oracle[0])
    assert torch.equal(got[0], plain[0])
    for g, c, a in zip(got, capped, again):
        assert torch.equal(g, c)
        assert torch.equal(g, a)  # two launches: bit-equal
    if window == "empty":
        assert not got[0].any()
    for g, o in zip(got[1:], oracle[1:]):
        assert rel_err(g, o) <= 1e-4


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("size,grid", [((16, 16, 4), (2, 2, 1)),
                                       ((20, 24, 6), (3, 2, 2))])
def test_fused_warp_kernel_matches_float64(dev, size, grid, clip):
    """``clip``: patch shifts spread past max_deviation_rigid + 2 around
    the rigid shift, so the field clipping is active."""
    b, max_shifts, max_dev = 3, (3, 3, 2), 2
    gen = torch.Generator(device="cpu").manual_seed(1)
    base = (torch.rand((b, 3), generator=gen, dtype=torch.float64) * 6 - 3)
    spread = 6.0 if clip else 2.0
    ps = base[:, None] + (torch.rand((b, int(np.prod(grid)), 3),
                                     generator=gen, dtype=torch.float64)
                          - 0.5) * 2 * spread
    vol = torch.rand((b,) + size, generator=gen, dtype=torch.float64)
    vol, ps, base = vol.to(dev), ps.to(dev), base.to(dev)
    fused.reset_launch_counts()
    got = warp.fused_separable_warp(vol.float(), ps.float(), base.float(),
                                    grid, size, max_shifts, max_dev)
    oracle = warp.fused_separable_warp_plain(vol, ps, base, grid, size,
                                             max_shifts, max_dev)
    torch.cuda.synchronize()
    assert fused.launch_counts()["fused_separable_warp"] == 1
    assert rel_err(got, oracle) <= 1e-4


def test_registration_wrappers_refuse_what_the_kernels_do_not_take(dev):
    tmpl, pats, _ = _pc_inputs(dev, (16, 16, 4), 3)
    tre, tim = phasecorr.patch_spectra(tmpl.float())
    zm_n = phasecorr.to_zm_n(pats.float())
    bounds = _pc_bounds(dev, 3, [-2] * 3, [2] * 3)
    with pytest.raises(TypeError):
        phasecorr.phase_corr_block(zm_n.double(), tre, tim, bounds, z=4)
    with pytest.raises(ValueError):
        phasecorr.phase_corr_block(zm_n, tre[:2], tim[:2], bounds, z=4)
    with pytest.raises(ValueError):
        phasecorr.phase_corr_block(zm_n, tre, tim, bounds, z=5)
    vol = torch.rand((2, 16, 16, 4), device=dev)
    with pytest.raises(ValueError):
        warp.fused_separable_warp(vol, torch.zeros((2, 3, 3), device=dev),
                                  torch.zeros((2, 3), device=dev), (2, 2, 1),
                                  (16, 16, 4), (3, 3, 2), 2)
    with pytest.raises(TypeError):
        warp.fused_separable_warp(vol.double(),
                                  torch.zeros((2, 4, 3), device=dev),
                                  torch.zeros((2, 3), device=dev), (2, 2, 1),
                                  (16, 16, 4), (3, 3, 2), 2)


def _shifted_video(rng, shape, shifts):
    """A smooth noise template Fourier-shifted per frame, plus noise."""
    from scipy.ndimage import gaussian_filter

    tmpl = gaussian_filter(rng.normal(size=shape), 2.0).astype(np.float32)
    frames = fft_reg.apply_shifts_fourier(
        torch.from_numpy(np.stack([tmpl] * len(shifts))),
        torch.tensor(shifts, dtype=torch.float32), border_nan=False)
    return (frames.numpy()
            + 0.01 * rng.normal(size=frames.shape)).astype(np.float32)


@pytest.mark.parametrize("nd", [2, 3])
def test_motion_correct_runs_on_the_card(dev, nd):
    """Rigid then piecewise-rigid ``MotionCorrect`` on the card against
    the same run on the CPU (the plain paths); the 3-D card run goes
    through kernels F and G.  Shifts may part by one subpixel step where
    a float32 surface ties (cuFFT and the kernels sum in another order
    than the CPU; on these small patches that is a quarter of the
    piecewise-rigid entries), so the card run is also held to the planted
    rigid shifts."""
    rng = np.random.default_rng(3)
    if nd == 2:
        shape = (64, 56)
        shifts = [(0.0, 0.0), (2.3, -1.4), (-3.2, 2.1), (1.1, 3.3),
                  (-2.4, -2.2), (3.1, 0.4)]
        cfg = dict(max_shifts=(5, 5), strides=(24, 24), overlaps=(8, 8))
    else:
        shape = (64, 64, 8)
        shifts = [(0.0, 0.0, 0.0), (1.3, -0.6, 0.4), (-1.8, 1.2, -0.3),
                  (0.7, 2.2, 0.0), (-0.4, -1.3, 0.6)]
        cfg = dict(max_shifts=(4, 4, 2), strides=(24, 24, 8),
                   overlaps=(8, 8, 0), remap_mode="fused")
    video = _shifted_video(rng, shape, shifts)
    conf = RegistrationConfig(pw_rigid=True, max_deviation_rigid=2,
                              border_nan=False, frame_block=4, **cfg)
    fused.reset_launch_counts()
    card = MotionCorrect(video, conf, device=dev).motion_correct()
    launches = fused.launch_counts()
    host = MotionCorrect(video, conf, device="cpu").motion_correct()
    for attr in ("shifts_rig", "x_shifts_els", "y_shifts_els",
                 "z_shifts_els"):
        d = np.abs(np.asarray(getattr(card, attr))
                   - np.asarray(getattr(host, attr)))
        assert d.max() <= 0.1 + 1e-4, attr
    rig = np.asarray(card.shifts_rig)
    np.testing.assert_allclose(rig - rig[0], np.asarray(shifts[0])
                               - np.asarray(shifts), rtol=0, atol=0.25)
    assert (launches["phase_corr_block"] > 0) == (nd == 3)
    assert (launches["fused_separable_warp"] > 0) == (nd == 3)
    assert card.total_template_els.device.type == "cuda"
    assert np.isfinite(card.mc_els[0]).all()


# --------------------------------------------- C4: Gram from psi/fade rows
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
def test_gram_rows_kernel_matches_float64(dev, shape, scaling):
    size, k = SHAPES[shape]
    betas, pos, sigma, _, y = _inputs(size, k, dev)
    psi, w = fused.psi_rows(betas, size, scaling)
    fused.reset_launch_counts()
    g, c1 = fused.gram_block(betas, pos, sigma, y, size, scaling,
                             psi_source="stream")
    g_in, c1_in = fused.gram_block(betas, pos, sigma, y, size, scaling)
    g_o, c1_o = fused.gram_block_rows_plain(psi.double(), w.double(),
                                            pos.double(), sigma.double(),
                                            y.double())
    torch.cuda.synchronize()
    assert fused.launch_counts()["gram_block_rows"] == 1
    assert fused.launch_counts()["gram_block"] == 1
    assert rel_err(g, g_o) <= 1e-4 and rel_err(c1, c1_o) <= 1e-4
    assert rel_err(g, g_in.double()) <= 1e-4
    with pytest.raises(ValueError):
        fused.gram_block_rows(psi[:, :-1], w, pos, sigma, y, size)


# ------------------- C/E/C4: the exact Gram on the brick walk of cull.cuh
GRAM_SHAPES = {  # name: (size, K, frames, position margin as bench.py's)
    "roi": ((256, 256, 10), 50, 2, 10.0),
    "whole_brain": ((512, 512, 20), 200, 2, 20.0),
}


def _gram_run(source, betas, pos, pos_t, sigma, y, size, **kw):
    """The Gram kernel for ``source``: C (shared anchors), E (per-frame
    positions) or C4 (rows from ``psi_rows``), and its float64 oracle."""
    d = [t.double() for t in (betas, pos, pos_t, sigma, y)]
    if source == "rows":
        psi, w = fused.psi_rows(betas, size)
        got = fused.gram_block_rows(psi, w, pos, sigma, y, size, **kw)
        psi64, w64 = fused.psi_rows(d[0], size)
        return got, fused.gram_block_rows_plain(psi64, w64, d[1], d[3], d[4])
    where = pos_t if source == "tracked" else pos
    got = fused.gram_block(betas, where, sigma, y, size, **kw)
    return got, fused.gram_block_plain(d[0], where.double(), d[3], d[4],
                                       size)


@pytest.mark.parametrize("source", ["shared", "tracked", "rows"])
@pytest.mark.parametrize("shape", sorted(GRAM_SHAPES))
@pytest.mark.parametrize("aniso", [False, True])
def test_gram_kernels_match_float64_at_the_kernel_shapes(dev, source, shape,
                                                         aniso):
    """C, E (crossing tracks) and C4 at the ROI and whole-brain shapes
    against float64, isotropic and [K, 3] widths; G is symmetric and one
    launch ran."""
    size, k, b, margin = GRAM_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(0)
    extent = torch.tensor(size, dtype=torch.float32, device=dev)
    pos = margin + torch.rand((k, 3), generator=gen, device=dev) * (
        extent - 2 * margin)
    sigma = 3.0 * (0.8 + 0.4 * torch.rand((k, 3) if aniso else (k,),
                                          generator=gen, device=dev))
    betas = torch.zeros((b, 10, 3), device=dev)
    betas[:, 1, 0] = betas[:, 2, 1] = betas[:, 3, 2] = 1.0
    betas += 0.005 * torch.randn((b, 10, 3), generator=gen, device=dev)
    y = torch.rand((b, size[0] * size[1] * size[2]), generator=gen,
                   device=dev)
    pos_t = _tracked(pos, b, crossing=True)
    fused.reset_launch_counts()
    (g, c1), (g_o, c1_o) = _gram_run(source, betas, pos, pos_t, sigma, y,
                                     size)
    torch.cuda.synchronize()
    assert rel_err(g, g_o) <= 1e-4 and rel_err(c1, c1_o) <= 1e-4
    assert torch.equal(g, g.transpose(1, 2))
    name = {"shared": "gram_block", "tracked": "gram_block_tracked",
            "rows": "gram_block_rows"}[source]
    assert fused.launch_counts()[name] == 1


@pytest.mark.parametrize("source", ["shared", "tracked", "rows"])
def test_gram_kernels_take_any_k(dev, source):
    """K = 6000 neurons crowd a small volume: every brick lists thousands
    of candidates, more than one shared chunk, so the pairs of later
    chunks are listed again for each earlier one; C, E and C4 still match
    float64."""
    size, k = (24, 16, 6), 6000
    betas, pos, pos_t, sigma, _, y = _brick_inputs(size, k, dev,
                                                   "normalized", False, b=2)
    (g, c1, counts), (g_o, c1_o) = _gram_run(source, betas, pos, pos_t,
                                             sigma, y, size,
                                             brick_counts=True)
    torch.cuda.synchronize()
    assert int(counts.max()) > 2 * 256
    assert rel_err(g, g_o) <= 1e-4 and rel_err(c1, c1_o) <= 1e-4


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("source", ["shared", "tracked"])
def test_gram_kernels_give_a_frame_the_same_bits_in_any_call(dev, source,
                                                             crowded):
    """A frame's (G, c1) from C and E are bit-equal alone and inside a
    16-frame call: the group and split counts depend only on the volume
    and K ("crowded": 12 splits per group and staged tiles)."""
    size, k = ((20, 16, 6), 1500) if crowded else ((96, 64, 20), 100)
    betas, pos, pos_t, sigma, _, y = _brick_inputs(size, k, dev,
                                                   "normalized", True, b=16)
    where = pos_t if source == "tracked" else pos

    def run(sl):
        return fused.gram_block(betas[sl], where[sl] if where.ndim == 3
                                else where, sigma, y[sl], size)

    full = run(slice(None))
    for b in (0, 7, 15):
        alone = run(slice(b, b + 1))
        torch.cuda.synchronize()
        for f, a in zip(full, alone):
            assert torch.equal(f[b:b + 1], a)


@pytest.mark.parametrize("shape", sorted(BRICK_SHAPES) + ["crowded"])
def test_gram_counts_match_the_plain_rule(dev, shape):
    """The Gram kernel's own candidate count per brick (C, E and C4),
    returned by the launch, equals ``brick_candidates_plain``'s; a brick
    sums the pairs of those candidates."""
    size, k = BRICK_SHAPES.get(shape, ((20, 16, 6), 1500))
    betas, pos, pos_t, sigma, c, y = _brick_inputs(size, k, dev,
                                                   "normalized", True)
    psi, w = fused.psi_rows(betas, size)
    for where, out, rows in (
            (pos, fused.gram_block(betas, pos, sigma, y, size,
                                   brick_counts=True), None),
            (pos_t, fused.gram_block(betas, pos_t, sigma, y, size,
                                     brick_counts=True), None),
            (pos, fused.gram_block_rows(psi, w, pos, sigma, y, size,
                                        brick_counts=True), psi)):
        mask = fused.brick_candidates_plain(betas, where, sigma, size,
                                            psi=rows)
        torch.cuda.synchronize()
        assert out[-1].dtype == torch.int32
        assert torch.equal(out[-1], mask.sum(-1).to(torch.int32))


@pytest.mark.parametrize("size,grid,max_shifts,max_dev", [
    ((19, 37, 5), (3, 4, 2), (3, 3, 2), 2),
    ((23, 70, 3), (2, 3, 1), (6, 6, 1), 3),
    ((37, 131, 7), (2, 5, 2), (8, 8, 2), 3),
    ((17, 9, 4), (1, 1, 1), (2, 2, 1), 1)])
def test_fused_warp_kernel_at_odd_sizes_and_the_largest_shifts(
        dev, size, grid, max_shifts, max_dev):
    """G on odd sizes (tiles cut at the far faces, halos cut at the
    volume's edges) with rigid shifts at the base bound ``ceil(max_shifts)
    + 1`` and patch shifts past the clip, so the n pass takes taps at the
    halo's edge; one launch, within 1e-4 of float64."""
    b = 3
    gen = torch.Generator(device="cpu").manual_seed(2)
    bound = torch.tensor([math.ceil(float(m)) + 1.0 for m in max_shifts],
                         dtype=torch.float64)
    base = (torch.rand((b, 3), generator=gen, dtype=torch.float64) * 2 - 1
            ) * bound
    base[0] = bound * torch.tensor([1.0, -1.0, 1.0], dtype=torch.float64)
    base[1] = -bound
    spread = max_dev + 4.0
    ps = base[:, None] + (torch.rand((b, int(np.prod(grid)), 3),
                                     generator=gen, dtype=torch.float64)
                          * 2 - 1) * spread
    vol = torch.rand((b,) + size, generator=gen, dtype=torch.float64)
    vol, ps, base = vol.to(dev), ps.to(dev), base.to(dev)
    fused.reset_launch_counts()
    got = warp.fused_separable_warp(vol.float(), ps.float(), base.float(),
                                    grid, size, max_shifts, max_dev)
    oracle = warp.fused_separable_warp_plain(vol, ps, base, grid, size,
                                             max_shifts, max_dev)
    torch.cuda.synchronize()
    assert fused.launch_counts()["fused_separable_warp"] == 1
    assert rel_err(got, oracle) <= 1e-4


def test_fused_warp_raises_where_the_halo_outgrows_shared_memory(dev):
    """A halo that does not fit a block's shared memory raises ValueError
    naming the bound, with nothing launched."""
    size, grid = (8, 400, 100), (1, 2, 1)
    vol = torch.rand((1,) + size, device=dev)
    ps = torch.zeros((1, 2, 3), device=dev)
    fused.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        warp.fused_separable_warp(vol, ps, torch.zeros((1, 3), device=dev),
                                  grid, size, (60, 60, 2), 3)
    assert fused.launch_counts()["fused_separable_warp"] == 0


def _planted(rng, size, k, t):
    """Gaussian neurons with sparse transients on a noise floor, moved by
    a smooth drift."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in size],
                                indexing="ij"), -1).reshape(-1, 3)
    pos = rng.uniform([6, 6, 1], np.asarray(size) - [6, 6, 1], (k, 3))
    c = 0.2 + rng.exponential(1.0, (k, t)) * (rng.uniform(size=(k, t)) < 0.3)
    tt = np.arange(t)
    drift = np.stack([2 * np.sin(2 * np.pi * tt / t),
                      np.cos(2 * np.pi * tt / t) - 1, 0 * tt], -1)
    video = np.stack([np.exp(-((grid[:, None] - (pos + drift[i])[None]) ** 2)
                             .sum(-1) / 9.0) @ c[:, i] for i in range(t)])
    video = video / video.max() + 0.05 * rng.uniform(size=video.shape)
    return video.reshape((t,) + size).astype(np.float32), pos


def test_pipeline_streamed_equals_resident_on_the_card(dev, tmp_path):
    """``register_and_demix`` on the card from a NumPy array, from a
    ``StreamingVideo`` and from a ``RawFileVideo`` over the same frames:
    the JAX package's streamed == resident gates."""
    rng = np.random.default_rng(5)
    size, k, t = (64, 48, 6), 8, 24
    video, pos = _planted(rng, size, k, t)
    path = tmp_path / "rec.raw"
    video.tofile(path)
    kw = dict(points=pos, optimizer=tcfg.OptimizerConfig(
        learning_rate=1e-3, outer_rounds=2, motion_epochs=4, mu_iters=20),
        runtime=tcfg.RuntimeConfig(frame_block=8), refine_positions=True,
        refine_rounds=1, refine_epochs=4)
    fused.reset_launch_counts()
    res = register_and_demix(video, **kw)
    launches = fused.launch_counts()
    for kname in ("motion_block", "gram_block", "refine_block",
                  "phase_corr_block"):
        assert launches[kname] > 0, kname
    # The closed-form Grams' trust audit may fall back to exact Grams on
    # so shallow a stack: then the c1 passes give way to the Gram kernels.
    assert launches["c1_block_tracked"] + launches["gram_block_tracked"] > 0
    for src in (StreamingVideo(video, block=8),
                RawFileVideo(str(path), video.shape, block=8)):
        got = register_and_demix(src, **kw)
        np.testing.assert_array_equal(got.positions, res.positions)
        np.testing.assert_allclose(got.traces, res.traces, rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got.fit.beta, res.fit.beta, atol=1e-5)
    assert np.isfinite(res.traces).all()


# ------------------------------------------------------ the data layer
DATA_SIM = dict(num_neurons=6, num_frames=12, size=(40, 36, 6),
                shape_std=2.0, density=0.3, bg_snr_db=-90.0,
                min_separation=5.0, margin=3.0)


@pytest.mark.parametrize("motion", ["gp", "gpt", "sq", "q"])
def test_simulator_on_the_card_is_its_cpu_run(dev, motion):
    """A CPU generator's draws, moved to the card, give the CPU run's
    fixture: positions and traces within 1e-5 of their max, the video
    within 1e-5 of its max (float32 transforms on either device)."""
    from dnmf_tpu_torch.data import simulator

    cfg = tcfg.SimulatorConfig(motion=motion, motion_snr_db=(-100.0,) * 3,
                               **DATA_SIM)
    on_card = simulator.generate_video(
        cfg, torch.Generator().manual_seed(4), device=dev)
    on_cpu = simulator.generate_video(
        cfg, torch.Generator().manual_seed(4), device="cpu")
    for got, ref in zip(on_card, on_cpu):
        assert got.device.type == "cuda"
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    sig = simulator.roi_signals(on_card[0], on_card[1])
    ref = simulator.roi_signals(on_cpu[0], on_cpu[1])
    assert float((sig.cpu() - ref).abs().max()) <= 1e-5


def test_simulated_dataset_on_the_card_feeds_fit(dev):
    """``SimulatedVideoDataset(device="cuda")`` feeds ``fit`` through the
    kernels, bit for bit as its video does."""
    from dnmf_tpu_torch.data import SimulatedVideoDataset
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    ds = SimulatedVideoDataset(tcfg.SimulatorConfig(motion="gpt",
                                                    **DATA_SIM), device=dev)
    assert ds.video.device.type == "cuda" and float(ds.video.min()) >= 0.0
    model = tcfg.ModelConfig(size=DATA_SIM["size"], num_neurons=6,
                             num_frames=12, shape_std=2.0)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                               motion_epochs=2, mu_iters=20)

    def fit(source):
        return DeformableNMF(model, opt, tcfg.RuntimeConfig(frame_block=4),
                             positions=ds.positions[:, :, 0],
                             device=dev).fit(source)

    fused.reset_launch_counts()
    res = fit(ds)
    launches = fused.launch_counts()
    for kname in ("motion_block", "c1_block", "gram_block"):
        assert launches[kname] > 0, kname
    again = fit(ds.video)
    assert torch.equal(res.state.beta, again.state.beta)
    assert torch.equal(res.state.c, again.state.c)
    assert bool(torch.isfinite(res.state.c).all())


def test_recovery_harness_on_the_card(dev):
    """``recover`` on a card fixture: kernels vs ``use_kernels=False``
    within 1e-4 in trace correlation, warp and width error."""
    from dnmf_tpu_torch.tools import wb_recovery

    fixture = wb_recovery.recovery_fixture((48, 40, 8), 6, 16,
                                           sigma_aniso=True, device=dev)
    kw = dict(frame_block=8, fit_sigma=True, sigma_every=1)
    fused.reset_launch_counts()
    got = wb_recovery.recover(fixture, 2, 3, 20, **kw)
    launches = fused.launch_counts()
    for kname in ("motion_block", "c1_block", "refine_block"):
        assert launches[kname] > 0, kname
    ref = wb_recovery.recover(fixture, 2, 3, 20, use_kernels=False, **kw)
    np.testing.assert_allclose(got["corr"], ref["corr"], rtol=0, atol=1e-4)
    assert abs(got["warp_err_px"] - ref["warp_err_px"]) <= 1e-4
    assert abs(got["sigma_err"] - ref["sigma_err"]) <= 1e-4


# ------------------------------------------- parity path and checkpoints
def _parity_pair(deform, dev, t=8, k=4, size=(20, 20, 2)):
    """A model, a state with perturbed warps and a video, on the CPU and
    on ``dev``; resampled footprints get a half-pixel shift that keeps
    coordinates off the cell faces, where the trilinear gradient jumps
    (tests/test_torch_port_parity.py)."""
    from dnmf_tpu_torch.models import dnmf as tM

    model = tcfg.ModelConfig(size=size, num_neurons=k, num_frames=t,
                             shape_std=3.0,
                             deformation=tcfg.DeformationConfig(**deform))
    rng = np.random.default_rng(0)
    pos = np.array([[4.0, 4.0, 1.0], [15.0, 4.5, 0.5], [1.0, 14.0, 1.2],
                    [14.5, 18.5, 0.8]], np.float32)
    state = tM.init_state(model, positions=pos)
    beta = state.beta.numpy() + 0.01 * rng.normal(size=(t, 10, 3))
    if model.deformation.basis_scaling == "pixel":
        beta[:, 4:] *= 0.01
    if model.deformation.footprint_mode == "resample":
        beta[:, 0] += 0.5
    state = state.replace(beta=torch.tensor(beta, dtype=torch.float32))
    video = torch.tensor(rng.uniform(0, 1, (t, model.num_voxels)),
                         dtype=torch.float32)
    on_dev = tM.state_from_numpy(tM.state_to_numpy(state), device=dev)
    return model, state, video, on_dev, video.to(dev)


@pytest.mark.parametrize("deform", [
    {}, dict(footprint_mode="resample", basis_scaling="pixel",
             detach_regularizer=True)], ids=["analytic", "reference"])
def test_parity_motion_on_the_card_matches_the_cpu(dev, deform):
    """Two serial mini-batch epochs on the card against the same epochs
    on the CPU, from one state and the same batches: beta and the Adam
    moments within 1e-4 of the CPU's max magnitude (float32 sums in
    another order on each device)."""
    from dnmf_tpu_torch.models import dnmf as tM

    model, st, video, st_d, video_d = _parity_pair(deform, dev)
    lr = 1e-3 if not deform else 1e-4
    rng = np.random.default_rng(1)
    for _ in range(2):
        times = torch.as_tensor(rng.permutation(8).reshape(2, 4))
        weights = torch.ones((2, 4))
        st, _ = tM.motion_epoch_parity(st, video, times, weights, model,
                                       tM.Adam(lr), 0.5)
        st_d, _ = tM.motion_epoch_parity(st_d, video_d, times.to(dev),
                                         weights.to(dev), model, tM.Adam(lr),
                                         0.5)
    for name in ("beta", "mu", "nu"):
        got, ref = getattr(st_d, name).cpu(), getattr(st, name)
        assert rel_err(got, ref.double()) <= 1e-4, name
    assert int(st_d.count) == int(st.count) == 4


def test_parity_fit_on_the_card_runs_the_c1_and_gram_kernels(dev):
    """A parity-mode fit with analytic footprints: the closed-form Grams'
    c1 pass and the audit's exact Gram run on their kernels; the motion
    epoch is plain PyTorch (as the JAX package's parity epoch is)."""
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    model, st, video, _, video_d = _parity_pair({}, dev)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                               motion_epochs=2, mu_iters=20,
                               motion_mode="parity")
    from dnmf_tpu_torch.models import dnmf as tM

    def fit(device, source):
        eng = DeformableNMF(model, opt, tcfg.RuntimeConfig(frame_block=4),
                            device=device)
        eng.state = tM.state_from_numpy(tM.state_to_numpy(st), device=device)
        eng._base_sigma = eng.state.sigma
        return eng.fit(source)

    fused.reset_launch_counts()
    got = fit(dev, video_d)
    launches = fused.launch_counts()
    assert launches["c1_block"] > 0 and launches["gram_block"] > 0
    assert launches["motion_block"] == 0
    ref = fit("cpu", video)
    assert rel_err(got.state.c.cpu(), ref.state.c.double()) <= 1e-3
    assert rel_err(got.state.beta.cpu(), ref.state.beta.double()) <= 1e-4


def test_checkpoint_restores_across_devices(dev, tmp_path):
    """Saved on the card, restored on the CPU and back: the same bits."""
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    model, st, video, st_d, video_d = _parity_pair({}, dev)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=1,
                               motion_epochs=2, mu_iters=10)
    on_card = DeformableNMF(model, opt, device=dev)
    on_card.fit(video_d)
    on_card.refine(video_d, rounds=1, epochs=2, mu_iters=2)
    on_card.save(str(tmp_path / "card.pt"))
    on_cpu = DeformableNMF(model, opt, device="cpu")
    on_cpu.restore(str(tmp_path / "card.pt"))
    for name in ("beta", "c", "pos", "sigma", "count", "mu", "nu"):
        got = getattr(on_cpu.state, name)
        assert got.device.type == "cpu"
        assert torch.equal(got, getattr(on_card.state, name).cpu()), name
    assert torch.equal(on_cpu.pos_t, on_card.pos_t.cpu())
    on_cpu.save(str(tmp_path / "cpu.pt"))
    back = DeformableNMF(model, opt, device=dev)
    back.restore(str(tmp_path / "cpu.pt"))
    for name in ("beta", "c", "mu", "nu"):
        got = getattr(back.state, name)
        assert got.device.type == "cuda"
        assert torch.equal(got, getattr(on_card.state, name)), name


@pytest.mark.parametrize("deform,option", [
    (dict(footprint_mode="resample"), "footprint_mode='resample'"),
    (dict(mask_out_of_bounds=False), "mask_out_of_bounds=False"),
])
def test_use_kernels_true_raises_for_resample(dev, deform, option):
    """On the card too, the kernels are refused for the functions they do
    not compute; ``use_kernels=None`` resolves to the plain versions."""
    from dnmf_tpu_torch.engine.trainer import DeformableNMF

    model = tcfg.ModelConfig(size=(20, 20, 2), num_neurons=4,
                             num_frames=8,
                             deformation=tcfg.DeformationConfig(**deform))
    with pytest.raises(ValueError, match=option.replace("(", r"\(")):
        DeformableNMF(model, tcfg.OptimizerConfig(),
                      tcfg.RuntimeConfig(use_kernels=True), device=dev)
    eng = DeformableNMF(model, tcfg.OptimizerConfig(), device=dev)
    assert not eng._use_kernels
    assert DeformableNMF(tcfg.ModelConfig(size=(20, 20, 2), num_neurons=4,
                                          num_frames=8),
                         tcfg.OptimizerConfig(), device=dev)._use_kernels


# ------------------------------------------------------- captured steps
# The compiled-program layer (dnmf_tpu_torch.models.graphs): each step
# captured once and replayed, against the same step eager
# (graphs.disabled()), bit for bit.
GRAPH_SIZE, GRAPH_K, GRAPH_T, GRAPH_FB = (48, 40, 6), 20, 12, 5


def _graph_inputs(dev, seed=0):
    from dnmf_tpu_torch.models import dnmf as tM

    rng = np.random.default_rng(seed)
    hi = np.asarray(GRAPH_SIZE, np.float32) - 1
    pos = rng.uniform([2, 2, 0.5], hi - [2, 2, 0.5], (GRAPH_K, 3))
    beta = np.zeros((GRAPH_T, 10, 3))
    beta[:, 1, 0] = beta[:, 2, 1] = beta[:, 3, 2] = 1.0
    beta += 0.005 * rng.normal(size=beta.shape)
    state = tM.state_from_numpy({
        "beta": beta, "c": rng.uniform(0.2, 1.0, (GRAPH_K, GRAPH_T)),
        "pos": pos, "sigma": np.full(GRAPH_K, 2.0), "count": np.int32(2),
        "mu": 1e-4 * rng.normal(size=beta.shape),
        "nu": 1e-8 * rng.uniform(size=beta.shape)}, device=dev)
    video = torch.tensor(rng.uniform(0, 1, (GRAPH_T, int(np.prod(
        GRAPH_SIZE)))), dtype=torch.float32, device=dev)
    model = tcfg.ModelConfig(size=GRAPH_SIZE, num_neurons=GRAPH_K,
                             num_frames=GRAPH_T, shape_std=2.0)
    return model, state, video


def _graph_steps(model, state, video):
    """Each captured step of the main path as a call: ``name -> fn()``."""
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import graphs

    adam = tM.Adam(1e-3)
    g, c1 = tM.grams_local(state, video, model, GRAPH_FB, True, "exact")
    steps = {"motion": lambda: graphs.motion_epoch(
        state, video, model, adam, 0.5, GRAPH_FB, True)}
    for mode in ("exact", "analytic"):
        steps[f"grams_{mode}"] = (lambda m=mode: graphs.compute_grams(
            state, video, model, GRAPH_FB, True, m))
        steps[f"round_{mode}"] = (lambda m=mode: graphs.fused_rounds(
            state, video, model, adam, rounds=2, epochs=2, mu_iters=10,
            gamma=0.5, mu_gamma=0.05, frame_block=GRAPH_FB,
            use_kernels=True, gram_mode=m))
    for solver in ("mu", "fista"):
        steps[f"update_{solver}"] = (lambda s=solver: graphs.footprint_update(
            state, g, c1, 20, 0.05, s, True))
    return steps


def _flat(out):
    from dnmf_tpu_torch.models import dnmf as tM

    if isinstance(out, tM.DNMFState):
        return [getattr(out, f) for f in tM.STATE_FIELDS]
    if isinstance(out, dict):
        return list(out.values())
    return [t for part in out for t in _flat(part)] if isinstance(
        out, tuple) else [out]


@pytest.fixture
def graph_cache(dev):
    from dnmf_tpu_torch.models import graphs

    graphs.clear()
    yield graphs
    graphs.clear()


@pytest.mark.parametrize("step", ["motion", "grams_exact", "grams_analytic",
                                  "update_mu", "update_fista",
                                  "round_exact", "round_analytic"])
def test_captured_step_equals_eager(graph_cache, dev, step):
    model, state, video = _graph_inputs(dev)
    run = _graph_steps(model, state, video)[step]
    with graph_cache.disabled():
        ref = _flat(run())
    for _ in range(2):  # the capturing call, then a replay
        got = _flat(run())
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    (entry,) = graph_cache.entries()
    assert entry.graph is not None and sum(entry.nodes.values()) > 0


@pytest.mark.parametrize("step", ["motion", "grams_analytic", "update_fista",
                                  "round_exact"])
def test_one_graph_launch_per_step(graph_cache, dev, step):
    from torch.profiler import ProfilerActivity, profile

    model, state, video = _graph_inputs(dev)
    run = _graph_steps(model, state, video)[step]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        calls[e.name] = calls.get(e.name, 0) + 1
    replays = 2 if step.startswith("round") else 1  # fused: one per round
    assert calls.get("cudaGraphLaunch", 0) == replays, calls
    assert not calls.get("cudaLaunchKernel") and not calls.get(
        "cudaLaunchKernelExC"), calls


def test_replays_count_the_kernels_launches(graph_cache, dev):
    model, state, video = _graph_inputs(dev)
    steps = _graph_steps(model, state, video)
    fused.reset_launch_counts()
    with graph_cache.disabled():
        steps["round_exact"]()
    eager = fused.launch_counts()
    fused.reset_launch_counts()
    steps["round_exact"]()  # warm-up, capture, two replays
    steps["round_exact"]()  # two replays
    (entry,) = graph_cache.entries()
    got = fused.launch_counts()
    for name, n in eager.items():
        # A replay's launches, read from the graph's nodes, are the eager
        # round's (two rounds eager; one warm-up and four replays).
        assert 2 * entry.launches.get(name, 0) == n, name
        assert got[name] == 2 * n + entry.launches.get(name, 0), name
    assert eager["motion_block"] > 0 and eager["gram_block"] > 0
    for kernel, name in (("motion_bricks", "motion_block"),
                         ("gram_bricks", "gram_block")):
        assert sum(n for k, n in entry.nodes.items()
                   if kernel in k) == entry.launches[name]


def test_unsafe_step_raises(graph_cache, dev):
    from dnmf_tpu_torch.models import dnmf as tM

    class HostAdam(tM.Adam):  # bias corrections copied from host memory
        def update(self, param, grad, count, mu, nu):
            param, count, mu, nu = super().update(param, grad, count, mu, nu)
            return param * torch.tensor(1.0, device=param.device), count, \
                mu, nu

    model, state, video = _graph_inputs(dev)
    fused.reset_launch_counts()
    with pytest.raises(RuntimeError):
        graph_cache.motion_epoch(state, video, model, HostAdam(1e-3), 0.5,
                                 GRAPH_FB, True)
    assert graph_cache.entries() == []
    # Only the warm-up launched: the failed capture counts nothing.
    assert fused.launch_counts()["motion_block"] == -(-GRAPH_T // GRAPH_FB)
    st, m = graph_cache.motion_epoch(state, video, model, tM.Adam(1e-3), 0.5,
                                     GRAPH_FB, True)
    assert torch.isfinite(m["recon_mse"]) and len(graph_cache.entries()) == 1


def test_replayed_round_makes_no_sync(graph_cache, dev):
    model, state, video = _graph_inputs(dev)
    steps = _graph_steps(model, state, video)
    for run in steps.values():
        run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in steps.values():
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_captured_regularizer_backward(dev):
    """Autograd's backward runs on the stream of its forward, the capture
    stream: the captured corner regularizer's gradient follows new
    inputs as the eager one does."""
    from dnmf_tpu_torch.ops import jacobian

    rng = np.random.default_rng(1)
    b = np.zeros((GRAPH_T, 10, 3))
    b[:, 1, 0] = b[:, 2, 1] = b[:, 3, 2] = 1.0
    beta = torch.tensor(b + 0.01 * rng.normal(size=b.shape),
                        dtype=torch.float32, device=dev)
    buf = beta.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        jacobian.corner_regularizer_and_grad(buf, GRAPH_SIZE, False,
                                             "normalized")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        reg, grad = jacobian.corner_regularizer_and_grad(
            buf, GRAPH_SIZE, False, "normalized")
    for scale in (1.0, 1.02):
        buf.copy_(beta * scale)
        graph.replay()
        ref = jacobian.corner_regularizer_and_grad(beta * scale, GRAPH_SIZE,
                                                   False, "normalized")
        assert torch.equal(reg, ref[0]) and torch.equal(grad, ref[1])


def test_profiled_captured_fit_puts_its_spans_on_the_device_timeline(
        graph_cache, dev):
    """A captured fit under ``torch.profiler``: every ``motion_finish``
    kernel starts after a ``span.graphs.replay`` (or, in the capturing
    round, ``span.graphs.warmup``) label and ends before a later
    ``span.engine.read`` does, on the profiler's one clock; each entry's
    warm-up and instantiation lie within its capture seconds, inside its
    ``span.graphs.entry.*``; and the fit equals the eager one bit for
    bit."""
    from torch.profiler import ProfilerActivity, profile

    from dnmf_tpu_torch.engine.trainer import DeformableNMF
    from dnmf_tpu_torch.models import dnmf as tM

    model, state, video = _graph_inputs(dev)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                               motion_epochs=2, mu_iters=10)
    rt = tcfg.RuntimeConfig(frame_block=GRAPH_FB, use_kernels=True)

    def fit():
        return DeformableNMF(model, opt, rt, positions=state.pos,
                             device=dev, beta0=state.beta).fit(video)

    with graph_cache.disabled():
        ref = fit()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        got = fit()
        torch.cuda.synchronize()
    labels, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if "motion_finish" in e.name():
                kernels.append(span)
        elif e.name().startswith("span."):
            labels.append((e.name(),) + span)
    launches = [s for n, s, _ in labels
                if n in ("span.graphs.replay", "span.graphs.warmup")]
    reads = [e for n, _, e in labels if n == "span.engine.read"]
    assert kernels and sum(n == "span.graphs.replay"
                           for n, _, _ in labels) == 2 * (2 + 2)
    for start, end in kernels:
        assert any(s <= start for s in launches), (start, launches[:3])
        assert any(e >= end for e in reads), (end, reads[-3:])
    made = [lab for lab in labels if lab[0].startswith("span.graphs.entry.")]
    assert len(made) == len(graph_cache.entries()) == 3
    for part in ("warmup", "capture", "instantiate"):
        inner = [lab for lab in labels if lab[0] == "span.graphs." + part]
        assert len(inner) == 3 and all(
            any(m[1] <= s and e <= m[2] for m in made) for _, s, e in inner)
    for entry in graph_cache.entries():
        assert 0 < entry.warmup_seconds and 0 < entry.instantiate_seconds
        assert (entry.warmup_seconds + entry.instantiate_seconds
                <= entry.capture_seconds)
    for f in tM.STATE_FIELDS:
        assert torch.equal(getattr(got.state, f), getattr(ref.state, f)), f
    strip = [[{k: v for k, v in m.items() if k != "seconds"}
              for m in r.metrics] for r in (got, ref)]
    assert strip[0] == strip[1]


# Refinement, the width fit and the recordings round as captured programs
# (graphs.refine_positions, tracked_grams, refined_rounds, sigma_fit,
# batched_round): equal to eager bit for bit, one graph launch per step,
# the wrappers' launches of a replay those of the eager run (kernels that
# the tracked wrappers share with their twins included), no sync.
def _program_calls(model, state, video):
    """Each program as a call and its graph launches per call:
    ``name -> (fn(), steps)``."""
    from dnmf_tpu_torch import parallel
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import graphs

    gen = torch.Generator(device=video.device).manual_seed(3)
    pos_t = state.pos + 0.5 * torch.randn((GRAPH_T, GRAPH_K, 3),
                                          generator=gen, device=video.device)
    idx = torch.arange(0, GRAPH_T, 3, device=video.device)
    sub = (video[idx], state.beta[idx], state.c[:, idx].T)
    aniso = state.replace(sigma=state.sigma[:, None] * torch.tensor(
        [1.0, 1.2, 0.6], device=video.device))
    states = parallel.stack_states([state, state.replace(c=state.c * 0.5)])
    videos = torch.stack([video, video.flip(0)])
    calls = {
        "refine_positions": (lambda: graphs.refine_positions(
            state, pos_t, video, model, epochs=5, frame_block=GRAPH_FB,
            use_kernels=True), 1),
        # From given positions: from the anchors, a call first makes them
        # contiguous (one copy kernel launched from the host).
        "refined_rounds": (lambda: graphs.refined_rounds(
            state, video, model, rounds=2, epochs=3, mu_iters=10,
            frame_block=GRAPH_FB, pos_t=pos_t, use_kernels=True,
            gram_mode="analytic"), 6),
        "sigma": (lambda: graphs.sigma_fit(
            state, *sub, model, steps=3, frame_block=GRAPH_FB,
            use_kernels=True), 1),
        "sigma_aniso": (lambda: graphs.sigma_fit(
            aniso, *sub, model, steps=3, frame_block=GRAPH_FB,
            use_kernels=True), 1)}
    for mode in ("exact", "analytic"):
        calls[f"tracked_{mode}"] = (lambda m=mode: graphs.tracked_grams(
            state, pos_t, video, model, GRAPH_FB, True, m), 1)
        calls[f"batched_{mode}"] = (lambda m=mode: parallel.batched_round(
            states, videos, model, tM.Adam(1e-3), 0.5, 10,
            frame_block=GRAPH_FB, use_kernels=True, gram_mode=m), 1)
    return calls


PROGRAMS = ["refine_positions", "refined_rounds", "sigma", "sigma_aniso",
            "tracked_exact", "tracked_analytic", "batched_exact",
            "batched_analytic"]


@pytest.mark.parametrize("program", PROGRAMS)
def test_captured_program_equals_eager(graph_cache, dev, program):
    model, state, video = _graph_inputs(dev)
    run, _ = _program_calls(model, state, video)[program]
    with graph_cache.disabled():
        ref = _flat(run())
    for _ in range(2):  # the capturing call, then a replay
        got = _flat(run())
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert all(e.graph is not None and sum(e.nodes.values()) > 0
               for e in graph_cache.entries())


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_is_one_graph_launch_per_step(graph_cache, dev, program):
    from torch.profiler import ProfilerActivity, profile

    model, state, video = _graph_inputs(dev)
    run, steps = _program_calls(model, state, video)[program]
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        calls[e.name] = calls.get(e.name, 0) + 1
    assert calls.get("cudaGraphLaunch", 0) == steps, calls
    assert not calls.get("cudaLaunchKernel") and not calls.get(
        "cudaLaunchKernelExC"), calls


@pytest.mark.parametrize("program", PROGRAMS)
def test_program_replay_launches_equal_eager(graph_cache, dev, program):
    model, state, video = _graph_inputs(dev)
    run, _ = _program_calls(model, state, video)[program]
    fused.reset_launch_counts()
    with graph_cache.disabled():
        run()
    eager = fused.launch_counts()
    run()  # warm-up and capture
    fused.reset_launch_counts()
    run()  # replays only
    assert fused.launch_counts() == eager
    wanted = {"refine_positions": ["refine_block"],
              "refined_rounds": ["refine_block", "c1_block_tracked",
                                 "analytic_grams"],
              "sigma": ["refine_block"], "sigma_aniso": ["refine_block"],
              "tracked_exact": ["gram_block_tracked"],
              "tracked_analytic": ["c1_block_tracked", "analytic_grams"],
              "batched_exact": ["motion_block", "gram_block"],
              "batched_analytic": ["motion_block", "c1_block",
                                   "analytic_grams"]}[program]
    assert all(eager[name] > 0 for name in wanted), eager
    # The closed form: one launch per Grams call, every frame at once.
    if program in ("tracked_analytic", "batched_analytic"):
        assert eager["analytic_grams"] == 1, eager
    # The tracked passes count as themselves, not as their twins.
    if program.startswith(("tracked", "refined")):
        assert eager["c1_block"] == eager["gram_block"] == 0, eager


def test_replayed_programs_make_no_sync(graph_cache, dev):
    model, state, video = _graph_inputs(dev)
    calls = _program_calls(model, state, video)
    for run, _ in calls.values():
        run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run, _ in calls.values():
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# Registration's and seeding's block steps as captured graphs
# (graphs.rigid_block, pwrigid_block, summary_blocks): equal to eager bit
# for bit, one graph launch per step, kernels F and G counted from the
# graph's nodes as the eager run launches them, no sync in a replay.
REG_PW = dict(max_shifts=(3, 3, 1), strides=(16, 16, 6), overlaps=(8, 8, 0),
              max_deviation_rigid=2, border_nan=False)
REG_PW2 = dict(max_shifts=(5, 5), strides=(24, 24), overlaps=(8, 8),
               max_deviation_rigid=2)
REG_STEPS = {  # name: (entry, frame shape, config, F and G launched)
    "rigid_3d": ("rigid", (48, 40, 6), dict(max_shifts=(3, 3, 1)), ()),
    "rigid_gsig": ("rigid", (64, 56), dict(max_shifts=(5, 5),
                                           gSig_filt=(3, 3),
                                           border_nan=False), ()),
    "pw_exact_F": ("pw", (48, 40, 6), dict(REG_PW, remap_mode="exact"),
                   ("phase_corr_block",)),
    "pw_fused_FG": ("pw", (48, 40, 6), dict(REG_PW, remap_mode="fused"),
                    ("phase_corr_block", "fused_separable_warp")),
    "pw_decimated_FG": ("pw", (48, 40, 6), dict(
        REG_PW, remap_mode="fused", rigid_decimate=4),
        ("phase_corr_block", "fused_separable_warp")),
    "pw_plain_3d": ("pw", (48, 40, 6), dict(REG_PW, remap_mode="separable",
                                            phasecorr_impl="xla"), ()),
    "pw_plain_2d": ("pw", (64, 56), dict(REG_PW2, remap_mode="exact"), ()),
    "pw_dft_2d": ("pw", (64, 56), dict(REG_PW2, use_remap=False), ()),
    "pw_dft_3d": ("pw", (48, 40, 6), dict(REG_PW, use_remap=False,
                                          upsample_factor_grid=2), ()),
    "summary": ("summary", (24, 20, 6), None, ()),
    "summary_shifted": ("summary", (24, 20, 6), None, ()),
}


def _reg_step_call(dev, name, seed=0):
    """The step of ``name`` as a call on device inputs (frames, template,
    offset or the seeding pass's blocks made beforehand), as a pass makes
    them: nothing made on the host at the call."""
    from dnmf_tpu_torch.models import graphs

    kind, shape, kw, _ = REG_STEPS[name]
    rng = np.random.default_rng(seed)
    if kind == "summary":
        b, t, p = 8, 21, int(np.prod(shape))
        video = torch.tensor(rng.normal(1.0, 1.0, (t, p)),
                             dtype=torch.float32, device=dev)
        sh = torch.tensor(np.pad(rng.uniform(-2, 2, (t, 3)), ((0, b), (0, 0))),
                          dtype=torch.float32, device=dev)
        blocks = []
        for s in range(0, t, b):
            blk = torch.nn.functional.pad(video[s:s + b],
                                          (0, 0, 0, b - min(b, t - s)))
            valid = torch.tensor(min(b, t - s), device=dev)
            blocks.append((blk, valid, sh[s:s + b]
                           if name.endswith("shifted") else None))
        zeros = torch.zeros(p, device=dev)
        carry = (zeros, zeros, zeros, torch.zeros((3, p), device=dev), zeros,
                 torch.full((p,), -torch.inf, device=dev), zeros,
                 torch.zeros((), dtype=torch.int64, device=dev))
        return lambda: graphs.summary_blocks(carry, blocks, shape,
                                             clamp=True), len(blocks)
    nd = len(shape)
    shifts = [(0.0,) * nd, (1.3, -0.6) + (0.4,) * (nd - 2),
              (-1.8, 1.2) + (-0.3,) * (nd - 2)]
    video = _shifted_video(rng, shape, shifts) + 2.0
    frames = torch.from_numpy(video).to(dev)
    template = frames.mean(0) * 1.01
    add = torch.full((), -1.5, device=dev)
    fn = graphs.rigid_block if kind == "rigid" else graphs.pwrigid_block
    cfg = RegistrationConfig(**kw)
    return lambda: fn(frames, template, add, cfg, collect=True), 1


def _bits(t):
    if t.is_floating_point():
        return t.contiguous().view(torch.int32).cpu()
    return t.cpu()


@pytest.mark.parametrize("name", sorted(REG_STEPS))
def test_captured_registration_step_equals_eager(graph_cache, dev, name):
    run, _ = _reg_step_call(dev, name)
    with graph_cache.disabled():
        ref = [_bits(t) for t in run()]
    for _ in range(2):  # the capturing call, then a replay
        got = [_bits(t) for t in run()]
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    (entry,) = graph_cache.entries()
    assert entry.graph is not None and sum(entry.nodes.values()) > 0


@pytest.mark.parametrize("name", sorted(REG_STEPS))
def test_registration_step_is_one_graph_launch(graph_cache, dev, name):
    from torch.profiler import ProfilerActivity, profile

    run, steps = _reg_step_call(dev, name)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        calls[e.name] = calls.get(e.name, 0) + 1
    assert calls.get("cudaGraphLaunch", 0) == steps, calls
    for launch in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx"):
        assert not calls.get(launch), calls


@pytest.mark.parametrize("name", sorted(REG_STEPS))
def test_registration_replay_launches_equal_eager(graph_cache, dev, name):
    """Per wrapper, a replay's launches (read from the graph's nodes of
    ``window_argmax`` and ``warp_tile``) are the eager step's; cuFFT's
    nodes stand beside them, counted by no wrapper."""
    run, _ = _reg_step_call(dev, name)
    fused.reset_launch_counts()
    with graph_cache.disabled():
        run()
    eager = fused.launch_counts()
    run()  # warm-up and capture
    fused.reset_launch_counts()
    run()  # a replay only
    assert fused.launch_counts() == eager
    want = REG_STEPS[name][3]
    assert {k for k, n in eager.items() if n} == set(want), eager
    (entry,) = graph_cache.entries()
    for wrapper, kernel in (("phase_corr_block", "window_argmax"),
                            ("fused_separable_warp", "warp_tile")):
        nodes = sum(n for k, n in entry.nodes.items() if kernel in k)
        assert nodes == eager[wrapper] == entry.launches.get(wrapper, 0)


def test_replayed_registration_steps_make_no_sync(graph_cache, dev):
    """No synchronizing call in a replayed step; the pass reads the
    block's shifts after it (the one sync per block, outside the
    graph)."""
    runs = [_reg_step_call(dev, name)[0] for name in REG_STEPS]
    for run in runs:
        run()
    torch.cuda.synchronize()
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in runs:
            outs.append(run())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out in outs:
        assert all(bool(torch.isfinite(t.float()).any()) for t in out
                   if t is not None)


def test_unsafe_registration_step_raises(graph_cache, dev, monkeypatch):
    """A host copy inside a registration step (a constant made from host
    data) raises at capture, and the card works on."""
    from dnmf_tpu_torch.ops import fft_reg as F

    correlate = F.correlate

    def host_correlate(*args):
        shifts, ccmax, coarse = correlate(*args)
        return (shifts * torch.tensor(1.0, device=shifts.device), ccmax,
                coarse)

    run, _ = _reg_step_call(dev, "rigid_3d")
    monkeypatch.setattr(F, "correlate", host_correlate)
    with pytest.raises(RuntimeError):
        run()
    assert graph_cache.entries() == []
    monkeypatch.setattr(F, "correlate", correlate)
    out = run()
    assert bool(torch.isfinite(out[1]).all())
    assert len(graph_cache.entries()) == 1


# The parity epoch and StaticFootprintNMF.fit as captured programs
# (graphs.motion_epoch_parity, graphs.static_nmf_fit): equal to eager bit
# for bit, one graph launch per step with as many kernel nodes as the eager
# step launches, no sync in a replayed epoch.  The entries' one memory
# pool: entries replayed in any order hand out eager's results, and a
# registration entry's pool stays near its step's eager working set.
def _parity_epoch_call(dev, pad=False):
    """A shuffled parity epoch on the card (batches of 4, the last one
    padded with ``pad``) through the cache, as a call, and its entry's
    step function."""
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import graphs

    model, state, video = _graph_inputs(dev)
    t = GRAPH_T - 1 if pad else GRAPH_T
    order = np.random.default_rng(3).permutation(t)
    nb = -(-t // 4)
    times = torch.zeros(nb * 4, dtype=torch.int64)
    times[:t] = torch.from_numpy(order)
    weights = torch.zeros(nb * 4)
    weights[:t] = 1.0
    times, weights = times.reshape(nb, 4).to(dev), weights.reshape(nb, 4).to(
        dev)
    adam = tM.Adam(1e-3)
    return (lambda: graphs.motion_epoch_parity(
        state, video, times, weights, model, adam, 0.5, True),
        graphs._parity_step(video, model, adam, 0.5), nb)


def _static_call(dev):
    from dnmf_tpu_torch.engine import trainer as ttr
    from dnmf_tpu_torch.models import graphs

    model, state, video = _graph_inputs(dev)
    eng = ttr.StaticFootprintNMF(model, state.pos, device=dev)
    start = (eng.a, eng.c)

    def run():
        eng.a, eng.c = start
        return eng.fit(video, iters=5)
    return run, graphs._static_step(eng.d, eng.gamma_a), 5


def _replay_calls(entry, replays):
    """Host calls by name of ``replays`` replays of ``entry``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(replays):
            entry.replay()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        calls[e.name] = calls.get(e.name, 0) + 1
    return calls


LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


@pytest.mark.parametrize("program", ["parity", "parity_padded", "static"])
def test_captured_parity_and_static_equal_eager(graph_cache, dev, program):
    run = (_static_call(dev) if program == "static" else
           _parity_epoch_call(dev, program.endswith("padded")))[0]
    with graph_cache.disabled():
        ref = _flat(run())
    assert graph_cache.entries() == []
    for _ in range(2):  # the capturing call, then replays only
        got = _flat(run())
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    (entry,) = graph_cache.entries()
    assert sum(entry.nodes.values()) > 0


@pytest.mark.parametrize("program", ["parity", "static"])
def test_parity_and_static_steps_are_one_graph_launch(graph_cache, dev,
                                                       program):
    """A replay is one graph launch and no kernel launch; the graph has as
    many kernel nodes as the eager step launches kernels."""
    from torch.profiler import ProfilerActivity, profile

    run, step, steps = (_static_call(dev) if program == "static" else
                        _parity_epoch_call(dev))
    run()
    (entry,) = graph_cache.entries()
    bufs = [b.clone() for b in entry.inputs]
    if program == "parity":  # the step index, back to the first batch
        entry.inputs[10].zero_()
        bufs[10].zero_()
    calls = _replay_calls(entry, steps)
    assert calls.get("cudaGraphLaunch", 0) == steps, calls
    assert not any(calls.get(k) for k in LAUNCHES), calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*bufs)
        torch.cuda.synchronize()
    launched = sum(e.name in LAUNCHES for e in prof.events())
    assert launched == sum(entry.nodes.values()) > 0


def test_replayed_parity_epoch_and_static_fit_make_no_sync(graph_cache,
                                                           dev):
    parity, static = _parity_epoch_call(dev)[0], _static_call(dev)[0]
    parity()
    static()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, m = parity()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(m["recon_mse"])) and bool(
        torch.isfinite(st.beta).all())


def test_entries_share_one_pool_and_replay_in_any_order(graph_cache, dev):
    """Two entries captured into the one pool, replayed X, Y, X and Y, X,
    Y: each call's outputs, read right after its own replay, equal the
    eager step's."""
    model, state, video = _graph_inputs(dev)
    steps = _graph_steps(model, state, video)
    x, y = steps["grams_exact"], steps["motion"]
    with graph_cache.disabled():
        ref = {"x": _flat(x()), "y": _flat(y())}
    x()
    y()
    pools = {tuple(e.graph.pool()) for e in graph_cache.entries()}
    assert len(graph_cache.entries()) == 2 and len(pools) == 1
    for order in ("xyx", "yxy"):
        for name in order:
            got = _flat({"x": x, "y": y}[name]())
            assert all(torch.equal(a, b) for a, b in zip(got, ref[name]))


POOL_SIZES = {"small": (128, 128, 16), "whole_brain": (512, 512, 20)}


def _pool_configs(size):
    """The block steps' settings: the pipeline default's rigid and
    ``"exact"`` pw-rigid pass and ``bench``'s F + G pass at whole-brain,
    patches of half and a quarter of the frame at the small size."""
    from dnmf_tpu_torch.tools.kernel_check import BENCH_PW, PIPE_REG

    if size == POOL_SIZES["whole_brain"]:
        return (dict(PIPE_REG, border_nan=False),
                dict(BENCH_PW, remap_mode="fused"))
    return (dict(max_shifts=(4, 4, 1), strides=(64, 64, 16),
                 overlaps=(16, 16, 0), max_deviation_rigid=2,
                 border_nan=False),
            dict(max_shifts=(4, 4, 1), strides=(32, 32, 16),
                 overlaps=(16, 16, 0), max_deviation_rigid=2,
                 border_nan=False, remap_mode="fused"))


@pytest.mark.parametrize("size", sorted(POOL_SIZES))
@pytest.mark.parametrize("name", ["rigid", "pw_exact_F", "pw_fused_FG",
                                  "summary_shifted"])
def test_registration_entry_pool_near_its_eager_working_set(graph_cache,
                                                            dev, name, size):
    """A registration or seeding entry captured alone (16 frames) holds a
    pool (its segments, by ``segment_pool_id``) no larger than the same
    step run eagerly into a pool of its own (``torch.cuda.MemPool``): the
    capture keeps no more than the allocator's own segments for the
    step's allocations.  At whole-brain, where F1 was measured, the pool
    is also at most 1.5 times the step's eager working set (the rise of
    ``max_memory_allocated`` over one call); at the small size requests of
    1-10 MB take 20 MB segments eagerly and captured alike."""
    from dnmf_tpu_torch.models import graphs
    from dnmf_tpu_torch.ops import seeding
    from dnmf_tpu_torch.registration import motion_correct as mc_lib

    from scipy.ndimage import gaussian_filter

    shape = POOL_SIZES[size]
    rng = np.random.default_rng(5)
    shifts = torch.tensor([(0.3 * i, -0.2 * i, 0.05 * i) for i in range(16)],
                          dtype=torch.float32, device=dev)
    tmpl = torch.from_numpy(gaussian_filter(rng.normal(size=shape), 2.0)
                            .astype(np.float32)).to(dev)
    frames = fft_reg.apply_shifts_fourier(tmpl.expand((16,) + shape),
                                          shifts, border_nan=False)
    frames = frames + 0.01 * torch.randn(frames.shape, device=dev)
    template = frames.mean(0)
    add = torch.zeros((), device=dev)
    if name.startswith("summary"):
        p = int(np.prod(shape))
        zeros = torch.zeros(p, device=dev)
        carry = (zeros, zeros, zeros, torch.zeros((3, p), device=dev), zeros,
                 torch.full((p,), -torch.inf, device=dev), zeros,
                 torch.zeros((), dtype=torch.int64, device=dev))
        valid = torch.full((), 16, device=dev)
        flat = frames.reshape(16, p)

        def eager():
            return seeding.fold_block(carry, flat, valid, shifts, shape,
                                      True)

        def captured():
            return graphs.summary_blocks(carry, [(flat, valid, shifts)],
                                         shape, True)
    else:
        pipe, bench = _pool_configs(shape)
        cfg = RegistrationConfig(**(
            dict(max_shifts=pipe["max_shifts"], border_nan=False)
            if name == "rigid" else dict(pipe, remap_mode="exact")
            if "exact" in name else bench), pw_rigid=name != "rigid",
            is3d=True)
        step = mc_lib.rigid_block if name == "rigid" else mc_lib.pwrigid_block
        fn = graphs.rigid_block if name == "rigid" else graphs.pwrigid_block

        def eager():
            corrected, out = step(frames, template, cfg, add)
            return (corrected, out) + mc_lib.block_sums(corrected)

        def captured():
            return fn(frames, template, add, cfg, collect=True)
    def pool_bytes(pool):
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", (0, 0))) == tuple(pool))

    eager()  # cuFFT's plans made
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref = eager()
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated() - base
    own = torch.cuda.MemPool()
    with torch.cuda.use_mem_pool(own):
        out = eager()
        torch.cuda.synchronize()
    reserved = pool_bytes(own.id)
    del out
    got = [t for t in captured() if t is not None]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, ref))
    (entry,) = graph_cache.entries()
    held = pool_bytes(entry.graph.pool())
    assert 0 < held <= reserved, (held, reserved, working)
    if size == "whole_brain":
        assert held <= 1.5 * working, (held, working)


# The streamed block steps as captured graphs (graphs.motion_epoch_streaming,
# compute_grams_streaming, refined_rounds_streaming): one entry per step
# serving every block of a StreamingVideo or a RawFileVideo, the padded
# tail included, equal to the eager streamed functions bit for bit.
STREAM_BLOCK = 5  # of GRAPH_T = 12 frames: the last block holds 2
STREAM_STEPS = ["motion", "grams_exact", "grams_analytic", "refine_mu",
                "refine_fista"]


def _streamed_source(dev, video, kind, tmp_path):
    host = video.cpu().numpy()
    if kind == "stream":
        return StreamingVideo(host, block=STREAM_BLOCK, device=dev)
    path = tmp_path / "rec.raw"
    host.tofile(path)
    return RawFileVideo(str(path), host.shape, block=STREAM_BLOCK,
                        device=dev)


def _streamed_call(dev, step, kind, tmp_path):
    """``(fn(), model, state)``: one streamed call of ``step`` on a source
    over ``_graph_inputs``' recording."""
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import graphs

    model, state, video = _graph_inputs(dev)
    src = _streamed_source(dev, video, kind, tmp_path)
    if step == "motion":
        return (lambda: graphs.motion_epoch_streaming(
            state, src, model, tM.Adam(1e-3), 0.5, True)), model, state
    if step.startswith("grams"):
        return (lambda: graphs.compute_grams_streaming(
            state, src, model, True, step.split("_")[1])), model, state
    return (lambda: graphs.refined_rounds_streaming(
        state, src, model, rounds=2, epochs=3, mu_iters=10,
        use_kernels=True, gram_mode="analytic",
        trace_solver=step.split("_")[1])), model, state


def _streamed_step(step, model, bufs):
    """The block step that ``step``'s entry captures, eagerly on ``bufs``
    (copies of the entry's buffers, in its order)."""
    from dnmf_tpu_torch.models import dnmf as tM
    from dnmf_tpu_torch.models import refine as tR

    if step == "motion":
        pos, sigma, beta, c, frames, valid = bufs
        return tM.stream_block_grads(tM.DNMFState(beta, c, pos, sigma, None,
                                                  None, None),
                                     frames, valid, model, 0.5,
                                     STREAM_BLOCK, True)
    if step.startswith("grams"):
        pos, sigma, beta, frames = bufs
        return tM.grams_local(tM.DNMFState(beta, None, pos, sigma, None,
                                           None, None),
                              frames, model, STREAM_BLOCK, True,
                              step.split("_")[1])
    pos, sigma, beta, c, pos_b, frames, valid = bufs
    return tR.refine_block_rounds(
        tM.DNMFState(beta, c, pos, sigma, None, None, None), pos_b, frames,
        valid, model, 2, 3, 10, 0.05, 1e-3, True, "analytic",
        trace_solver=step.split("_")[1])


@pytest.mark.parametrize("kind", ["stream", "raw"])
@pytest.mark.parametrize("step", STREAM_STEPS)
def test_captured_streamed_step_equals_eager(graph_cache, dev, tmp_path,
                                             step, kind):
    run, _, _ = _streamed_call(dev, step, kind, tmp_path)
    with graph_cache.disabled():
        ref = _flat(run())
    assert graph_cache.entries() == []
    for call in range(2):  # the capturing call, then replays only
        got = _flat(run())
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        (entry,) = graph_cache.entries()
        assert entry.replays == 3 * (call + 1)  # one per block
    assert sum(entry.nodes.values()) > 0


@pytest.mark.parametrize("step", STREAM_STEPS)
def test_streamed_block_replay_is_one_graph_launch(graph_cache, dev,
                                                   tmp_path, step):
    """A block's replay is one graph launch and no kernel launch; the
    graph has as many kernel nodes as the eager block step launches
    kernels; a streamed call launches one graph per block."""
    from torch.profiler import ProfilerActivity, profile

    run, model, _ = _streamed_call(dev, step, "stream", tmp_path)
    run()
    (entry,) = graph_cache.entries()
    bufs = [b.clone() for b in entry.inputs]
    calls = _replay_calls(entry, 1)
    assert calls.get("cudaGraphLaunch", 0) == 1, calls
    assert not any(calls.get(k) for k in LAUNCHES), calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _streamed_step(step, model, bufs)
        torch.cuda.synchronize()
    launched = sum(e.name in LAUNCHES for e in prof.events())
    assert launched == sum(entry.nodes.values()) > 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    assert sum(e.name == "cudaGraphLaunch" for e in prof.events()) == 3


@pytest.mark.parametrize("step", STREAM_STEPS)
def test_streamed_replay_launches_equal_eager(graph_cache, dev, tmp_path,
                                              step):
    run, _, _ = _streamed_call(dev, step, "raw", tmp_path)
    fused.reset_launch_counts()
    with graph_cache.disabled():
        run()
    eager = fused.launch_counts()
    run()  # warm-up and capture
    fused.reset_launch_counts()
    run()  # replays only
    assert fused.launch_counts() == eager
    # Per block: one pass; refinement 2 rounds x (3 epochs + a c1 pass).
    wanted = {"motion": {"motion_block": 3}, "grams_exact": {"gram_block": 3},
              "grams_analytic": {"c1_block": 3, "analytic_grams": 3},
              "refine_mu": {"refine_block": 18, "c1_block_tracked": 6,
                            "analytic_grams": 6},
              "refine_fista": {"refine_block": 18, "c1_block_tracked": 6,
                               "analytic_grams": 6}}[step]
    assert {k: eager[k] for k in wanted} == wanted, eager


def test_replayed_streamed_block_makes_no_sync(graph_cache, dev, tmp_path):
    """One block step of each kind, its load (the block's state, frames
    and valid count) and replay and its outputs' copies, under
    ``set_sync_debug_mode("error")``."""
    entries = []
    for step in ("motion", "grams_exact", "refine_mu"):
        run, _, _ = _streamed_call(dev, step, "stream", tmp_path)
        run()
        entries.append(graph_cache.entries()[-1])
    loads = [[b.clone() for b in e.inputs] for e in entries]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        for entry, bufs in zip(entries, loads):
            entry.load(bufs)
            if bufs[-1].dtype == torch.int64:
                entry.inputs[-1].fill_(2)  # the tail's valid count
            entry.replay()
            outs += [o.clone() for o in entry.outputs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_streamed_and_resident_entries_share_the_pool(graph_cache, dev,
                                                      tmp_path):
    """A streamed entry and a resident one in the one pool, called X, Y, X
    and Y, X, Y: each call's outputs equal the eager call's."""
    x, model, state = _streamed_call(dev, "refine_mu", "stream", tmp_path)
    _, _, video = _graph_inputs(dev)
    y = _graph_steps(model, state, video)["motion"]
    with graph_cache.disabled():
        ref = {"x": _flat(x()), "y": _flat(y())}
    x()
    y()
    pools = {tuple(e.graph.pool()) for e in graph_cache.entries()}
    assert len(graph_cache.entries()) == 2 and len(pools) == 1
    for order in ("xyx", "yxy"):
        for name in order:
            got = _flat({"x": x, "y": y}[name]())
            assert all(torch.equal(a, b) for a, b in zip(got, ref[name]))


def test_streamed_entries_share_one_frame_buffer_on_the_card(
        graph_cache, dev, tmp_path):
    """The motion and refinement entries hold one frame buffer; called in
    alternation, each call equals its eager call."""
    x, _, _ = _streamed_call(dev, "motion", "raw", tmp_path)
    y, _, _ = _streamed_call(dev, "refine_mu", "raw", tmp_path)
    with graph_cache.disabled():
        ref = {"x": _flat(x()), "y": _flat(y())}
    for name in "xyxy":
        got = _flat({"x": x, "y": y}[name]())
        assert all(torch.equal(a, b) for a, b in zip(got, ref[name]))
    shape = (STREAM_BLOCK, int(np.prod(GRAPH_SIZE)))
    frames = [[b for b in e.inputs if tuple(b.shape) == shape]
              for e in graph_cache.entries()]
    assert [len(f) for f in frames] == [1, 1]
    assert frames[0][0] is frames[1][0]
    assert graph_cache.shared_bytes() == frames[0][0].numel() * 4


def test_streamed_source_reuses_its_blocks_across_passes(dev):
    """One copy stream serves every pass of a source, so the allocator
    reuses the frame blocks that the last pass freed: passes after the
    first reserve nothing more."""
    _, _, video = _graph_inputs(dev)
    src = StreamingVideo(video.cpu().numpy(), block=STREAM_BLOCK, device=dev)

    def one_pass():
        for frames, _, _ in src.blocks():
            frames.sum()
        torch.cuda.synchronize()

    one_pass()
    one_pass()
    side, reserved = src._side, torch.cuda.memory_reserved()
    for _ in range(8):
        one_pass()
    assert src._side is side
    assert torch.cuda.memory_reserved() == reserved


# A mesh's steps between its collectives (graphs.mesh_steps for the
# sharded epoch, Grams, trace updates and streamed blocks; the entries of
# one device for refinement, the width fit, the recordings round and
# registration's blocks) on a one-rank gloo group whose rank keeps its
# tensors on the card: captured equal to eager bit for bit, the replays'
# launches (held to each graph's kernel nodes at its capture) equal to the
# eager run's, every entry in the one pool.
MESH_STEPS = ["motion", "grams_exact", "grams_analytic", "mu", "fista",
              "mu_halo", "fista_halo", "refine", "sigma", "batched",
              "stream_motion", "stream_grams", "reg_rigid", "reg_pwrigid"]
MESH_KERNELS = {  # the kernels that each mesh step's eager run launches
    "motion": {"motion_block"}, "grams_exact": {"gram_block"},
    "grams_analytic": {"c1_block", "analytic_grams"}, "mu": set(),
    "fista": set(),
    "mu_halo": set(), "fista_halo": set(),
    "refine": {"refine_block", "gram_block_tracked"},
    "sigma": {"refine_block"}, "batched": {"motion_block", "gram_block"},
    "stream_motion": {"motion_block"}, "stream_grams": {"gram_block"},
    "reg_rigid": set(),
    "reg_pwrigid": {"phase_corr_block", "fused_separable_warp"}}


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = tmp_path_factory.mktemp("pg")
    dist.init_process_group("gloo", init_method=f"file://{path}/pg",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_call(dev, step):
    """One call of the mesh step ``step`` on a one-rank time mesh with the
    kernels, as the engine makes it (``graphs.disabled()`` runs it
    eagerly)."""
    from dnmf_tpu_torch import parallel
    from dnmf_tpu_torch.engine import trainer as ttr
    from dnmf_tpu_torch.models import dnmf as tM

    mesh = parallel.make_mesh(num_time=1)
    model, state, video = _graph_inputs(dev)
    adam = tM.Adam(1e-3)

    if step == "motion":
        return lambda: parallel.sharded_motion_epoch(
            state, video, model, adam, 0.5, mesh, GRAPH_FB, True)
    if step.startswith("grams"):
        return lambda: parallel.sharded_compute_grams(
            state, video, model, mesh, GRAPH_FB, True, step.split("_")[1])
    if step.split("_")[0] in ("mu", "fista"):
        g, c1 = tM.grams_local(state, video, model, GRAPH_FB, True, "exact")
        gamma = 0.05 if step.endswith("halo") else 0.0
        return lambda: parallel.sharded_footprint_update(
            state, g, c1, mesh, 20, gamma, step.split("_")[0], True)
    if step == "refine":
        return lambda: parallel.sharded_refined_rounds(
            state, video, model, mesh, rounds=2, epochs=3, mu_iters=10,
            frame_block=GRAPH_FB, use_kernels=True)
    if step == "sigma":
        opt = tcfg.OptimizerConfig(learning_rate=1e-3, sigma_steps=3,
                                   sigma_frames=6, seed=0)
        rt = tcfg.RuntimeConfig(frame_block=GRAPH_FB, mesh_time=1,
                                use_kernels=True)

        def sigma():
            eng = ttr.DeformableNMF(model, opt, rt, positions=state.pos,
                                    device=dev)
            eng.update_sigma(video)
            return eng.state.sigma
        return sigma
    if step == "batched":
        states = parallel.stack_states([state, state.replace(
            c=state.c.flip(1))])
        videos = torch.stack([video, video.flip(0)])
        return lambda: parallel.batched_round(
            states, videos, model, adam, 0.5, 5, frame_block=GRAPH_FB,
            use_kernels=True, mesh=mesh)
    if step.startswith("stream"):
        src = StreamingVideo(video.cpu().numpy(), block=STREAM_BLOCK,
                             device=dev)
        if step == "stream_motion":
            return lambda: parallel.sharded_motion_epoch_streaming(
                state, src, model, adam, 0.5, mesh, True)
        return lambda: parallel.sharded_compute_grams_streaming(
            state, src, model, mesh, True)
    rng = np.random.default_rng(0)
    shape = (48, 40, 6)
    shifts = [(0.0, 0.0, 0.0), (1.3, -0.6, 0.4), (-1.8, 1.2, -0.3)] * 2
    frames = _shifted_video(rng, shape, shifts) + 2.0
    template = frames.mean(0) * 1.01
    if step == "reg_rigid":
        cfg = RegistrationConfig(max_shifts=(3, 3, 1), frame_block=4)
        fn = parallel.sharded_register_rigid
    else:
        cfg = RegistrationConfig(**REG_PW, pw_rigid=True, frame_block=4,
                                 remap_mode="fused")
        fn = parallel.sharded_register_pwrigid
    return lambda: fn(frames, cfg, mesh, template=template, device=dev)


def _mesh_flat(out):
    """A mesh step's outputs as tensors (host arrays and floats too)."""
    if isinstance(out, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(out))]
    if isinstance(out, float):
        return [torch.tensor(out)]
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _mesh_flat(part)]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _mesh_flat(v)]
    return _flat(out)


@pytest.mark.parametrize("step", MESH_STEPS)
def test_captured_mesh_step_equals_eager(one_rank_group, graph_cache, dev,
                                         step):
    run = _mesh_call(dev, step)
    with graph_cache.disabled():
        ref = _mesh_flat(run())
    assert graph_cache.entries() == []
    for _ in range(2):  # the capturing call, then replays only
        got = _mesh_flat(run())
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))
    assert graph_cache.entries()
    assert all(e.graph is not None and e.replays >= 2
               for e in graph_cache.entries())


@pytest.mark.parametrize("step", MESH_STEPS)
def test_mesh_replay_launches_equal_eager(one_rank_group, graph_cache, dev,
                                          step):
    run = _mesh_call(dev, step)
    fused.reset_launch_counts()
    with graph_cache.disabled():
        run()
    eager = {k: n for k, n in fused.launch_counts().items() if n}
    run()  # warm-ups and captures
    fused.reset_launch_counts()
    run()  # replays only
    assert {k: n for k, n in fused.launch_counts().items() if n} == eager
    assert set(eager) == MESH_KERNELS[step]


def test_mesh_entries_share_the_pool(one_rank_group, graph_cache, dev):
    """The mesh's entries of several steps, captured one after another,
    hold one pool; replayed again in another order each equals its eager
    run."""
    names = ("motion", "fista_halo", "refine", "stream_grams",
             "reg_pwrigid")
    runs = {name: _mesh_call(dev, name) for name in names}
    with graph_cache.disabled():
        ref = {name: _mesh_flat(run()) for name, run in runs.items()}
    for run in runs.values():
        run()
    pools = {tuple(e.graph.pool()) for e in graph_cache.entries()}
    assert len(graph_cache.entries()) >= len(names) and len(pools) == 1
    for name in reversed(names):
        got = _mesh_flat(runs[name]())
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got, ref[name]))
