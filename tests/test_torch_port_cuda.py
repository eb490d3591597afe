"""The port's CUDA kernels (motion, c1, Gram, refine; c1 and Gram also at
per-frame positions) against their plain PyTorch versions on the card.
Marked ``cuda``; every test skips where no CUDA device exists.

Run on a machine with an H100:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda``.

Tolerance: 1e-4 of the float64 oracle's max magnitude (the kernels sum
in float32, per thread and then per chunk in a fixed order).
"""

import numpy as np
import pytest
import torch

from dnmf_tpu_torch.ops import fused

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
        "refine_block": 0, "c1_block_tracked": 0, "gram_block_tracked": 0}


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


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("scaling", ["normalized", "pixel"])
@pytest.mark.parametrize("aniso", [False, True])
def test_refine_kernel_matches_float64(dev, shape, scaling, aniso):
    size, k = SHAPES[shape]
    betas, pos, sigma, c, y = _inputs(size, k, dev, aniso=aniso)
    pos_t = _tracked(pos, betas.shape[0])
    d = [t.double() for t in (betas, pos_t, sigma, c, y)]
    fused.reset_launch_counts()
    for want in (False, True):
        got = fused.refine_block(betas, pos_t, sigma, c, y, size, scaling,
                                 want_dsigma=want)
        ref = fused.refine_block_plain(*d, size, scaling, want_dsigma=want)
        torch.cuda.synchronize()
        assert len(got) == len(ref) == 2 + want
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert rel_err(g, r) <= 1e-4
    assert fused.launch_counts()["refine_block"] == 2


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
