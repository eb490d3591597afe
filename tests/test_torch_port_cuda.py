"""The port's CUDA kernels (motion, c1, Gram, refine; c1 and Gram also at
per-frame positions; the Gram from precomputed coordinate rows, C4;
phase correlation F and the fused warp G) against their plain PyTorch
versions on the card, and the streamed pipeline on the card.  The brick
kernels (motion, c1, Gram, refine) also at odd shapes, at K = 6000 and
20000 crowding a small volume, repeated bit for bit, frame for frame
alone or inside a 16-frame call, and with their candidate counts held to
the plain rule; G also at odd sizes and the largest shifts its halo
takes.  The data layer on the card: the simulator against its CPU run on
one CPU generator's draws, a ``SimulatedVideoDataset`` on the card
feeding ``fit``, and the recovery harness with and without the kernels.
Marked ``cuda``; every test skips where no CUDA device exists.

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
        "gram_block_rows": 0,
        "phase_corr_block": 0, "fused_separable_warp": 0}


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
