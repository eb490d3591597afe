"""The frozen roofline arithmetic counts what the port's kernel checks
count (``dnmf_tpu_torch.tools.kernel_check``) at a tiny size."""

import pytest
import torch

from cardbench import roofline


@pytest.mark.parametrize("size,k,frames", [((24, 20, 6), 5, 3),
                                           ((16, 16, 4), 3, 2)])
def test_counts_equal_kernel_check(size, k, frames):
    from dnmf_tpu_torch.tools import kernel_check as kc

    betas, pos, sigma, _, _ = kc.kernel_inputs(torch.device("cpu"), size, k,
                                               frames, 2.0, seed=3)
    theirs = kc.active_pairs(betas, pos, sigma, size)
    ours = roofline.active_pairs(betas, pos, 3.0, size)
    assert ours == theirs
    # per-frame positions, as the refinement's count takes them
    pos_t = pos + torch.randn((frames,) + tuple(pos.shape),
                              generator=torch.Generator().manual_seed(4))
    tracked = roofline.active_pairs(betas, pos_t, 3.0, size)
    assert tracked == kc.active_pairs(betas, pos_t, sigma, size)
    assert tracked != ours
    p = size[0] * size[1] * size[2]
    for kernel in ("motion_block", "c1_block", "gram_block",
                   "refine_block"):
        flops = roofline.footprint_flops(kernel, frames, p, *ours)
        assert flops == kc.footprint_flops(kernel, frames, p, *theirs)
        secs, by = roofline.bound(4.0 * p * frames, flops)
        ms, by_ms = kc.bound(4.0 * p * frames, flops)
        assert by == by_ms and secs * 1e3 == pytest.approx(ms, rel=1e-12)


def test_bytes_count_each_input_once():
    p, k = 1000, 7
    assert roofline.kernel_bytes("c1_block", 2, p, k) == 4.0 * (
        2 * p + 2 * 30 + k * 4 + 2 * k)
    assert roofline.kernel_bytes("motion_block", 2, p, k) == 4.0 * (
        2 * p + 2 * 30 + k * 4 + 2 * k + 2 * 31)
    # frames, warps, positions [B, K, 3], traces [B, K], widths [K] read;
    # mse [B] and dpos [B, K, 3] written
    assert roofline.kernel_bytes("refine_block", 2, p, k) == 4.0 * (
        2 * p + 2 * 30 + 2 * k * 3 + 2 * k + k + 2 + 2 * k * 3)
