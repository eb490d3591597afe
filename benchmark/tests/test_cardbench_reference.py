"""The plain reference agrees with the port's plain route on tiny data:
piece by piece, and the whole schedule through the harness's check."""

import math

import pytest
import torch

from references import deformable_nmf as ref

SIZE = (24, 20, 6)


def _data(seed=5, k=4, frames=3):
    gen = torch.Generator().manual_seed(seed)
    ext = torch.tensor(SIZE, dtype=torch.float32)
    pos = 3.0 + torch.rand((k, 3), generator=gen) * (ext - 6.0)
    pos[:, 2] = 1.0 + torch.rand(k, generator=gen) * 3.0
    beta = ref.identity(frames) + 0.01 * torch.randn((frames, 10, 3),
                                                     generator=gen)
    y = torch.rand((frames, SIZE[0] * SIZE[1] * SIZE[2]), generator=gen)
    c = 0.5 + torch.rand((k, frames), generator=gen)
    return pos, beta, y, c


def test_pieces_equal_the_ports_plain_versions():
    from dnmf_tpu_torch.ops import fused
    from dnmf_tpu_torch.ops import gram_analytic as ga
    from dnmf_tpu_torch.ops import jacobian

    pos, beta, y, c = _data()
    model = ref.Model(SIZE, pos, 3.0)
    sigma = torch.full((pos.shape[0],), 3.0)
    mse, reg, grad = model.frame_losses(beta, c, y, 1.0, True)
    p_mse, p_dbeta = fused.motion_block_plain(beta, pos, sigma, c.T, y, SIZE)
    p_reg, p_dreg = jacobian.corner_regularizer_and_grad(beta, SIZE, False,
                                                         "normalized")
    torch.testing.assert_close(mse, p_mse, rtol=1e-5, atol=0)
    torch.testing.assert_close(reg, p_reg, rtol=1e-5, atol=1e-9)
    torch.testing.assert_close(grad, p_dbeta + p_dreg, rtol=1e-4, atol=1e-7)
    c1, gram = model.c1_and_exact(beta, y, True)
    p_g, p_c1 = fused.gram_block_plain(beta, pos, sigma, y, SIZE)
    torch.testing.assert_close(c1, p_c1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gram, p_g, rtol=1e-5, atol=1e-6)
    window = ref.default_window(3.0)
    assert window == ga.default_window(3.0)
    torch.testing.assert_close(model.closed_form(beta, window),
                               ga.analytic_grams(beta, pos, sigma, SIZE,
                                                 window=window),
                               rtol=1e-6, atol=1e-9)


def _tracked(seed=7, size=(32, 32, 4), k=6, frames=8):
    """Anchors, near-identity warps, per-frame positions (the anchors plus
    offsets of ~1.5 px in plane, ~0.1 px across planes), traces and the
    noisy frames that the positions draw."""
    gen = torch.Generator().manual_seed(seed)
    ext = torch.tensor(size, dtype=torch.float32)
    pos = 6.0 + torch.rand((k, 3), generator=gen) * (ext - 12.0)
    pos[:, 2] = 1.0 + torch.rand(k, generator=gen) * (size[2] - 2.0)
    beta = ref.identity(frames) + 0.01 * torch.randn((frames, 10, 3),
                                                     generator=gen)
    off = torch.randn((frames, k, 3), generator=gen) * torch.tensor(
        [1.5, 1.5, 0.1])
    c = 1.0 + torch.rand((k, frames), generator=gen)
    model = ref.Model(size, pos, 3.0)
    box, _ = ref.passes(model, beta, off.abs().amax(dim=(0, 1)))
    y = model.recon(model.footprints(beta, box, pos + off), c, box)
    y = y + 0.01 * torch.randn(y.shape, generator=gen)
    return model, beta, pos + off, c, y


def test_refinement_pieces_equal_the_ports_plain_versions():
    from dnmf_tpu_torch.ops import fused
    from dnmf_tpu_torch.ops import gram_analytic as ga

    model, beta, pos_t, c, y = _tracked()
    size, k = model.size, pos_t.shape[1]
    sigma = torch.full((k,), 3.0)
    moved = pos_t + 0.3  # off the positions that drew the frames
    box, _ = ref.passes(model, beta, (moved - model.pos).abs().amax(
        dim=(0, 1)))
    mse, dpos = model.position_losses(beta, moved, c, y, box)
    p_mse, p_dpos = fused.refine_block_plain(beta, moved, sigma, c.T, y,
                                             size)
    torch.testing.assert_close(mse, p_mse, rtol=1e-5, atol=0)
    torch.testing.assert_close(dpos, p_dpos, rtol=1e-4, atol=1e-9)
    c1, gram = model.c1_and_exact(beta, y, True, box, moved)
    p_g, p_c1 = fused.gram_block_plain(beta, moved, sigma, y, size)
    torch.testing.assert_close(c1, p_c1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gram, p_g, rtol=1e-5, atol=1e-6)
    window = ref.default_window(3.0)
    torch.testing.assert_close(model.closed_form(beta, window, moved),
                               ga.analytic_grams(beta, moved, sigma, size,
                                                 window=window),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("gram_mode", ["analytic", "exact"])
def test_follow_refine_agrees_with_the_ports_refined_rounds(gram_mode):
    from dnmf_tpu_torch import config as cfg_lib
    from dnmf_tpu_torch.models import refine as refine_lib
    from dnmf_tpu_torch.models.dnmf import DNMFState

    model, beta, pos_t, _, y = _tracked()
    k, t = pos_t.shape[1], pos_t.shape[0]
    c0 = 0.5 + torch.rand((k, t), generator=torch.Generator().manual_seed(3))
    sched = dict(rounds=2, epochs=10, mu_iters=20, learning_rate=0.08,
                 prior=3e-4)
    out = ref.follow_refine(model, y, beta, c0, sched, gram_mode)
    cfg = cfg_lib.ModelConfig(
        size=model.size, num_neurons=k, num_frames=t, shape_std=3.0,
        deformation=cfg_lib.DeformationConfig(
            footprint_mode="analytic", basis_scaling="normalized",
            mask_out_of_bounds=True))
    state = DNMFState(beta, c0, model.pos, torch.full((k,), 3.0),
                      torch.zeros((), dtype=torch.int32),
                      torch.zeros_like(beta), torch.zeros_like(beta))
    p_state, p_pos, p_m = refine_lib.refined_rounds(
        state, y, cfg, frame_block=4, gram_mode=gram_mode, **sched)
    # The positions moved by up to ~1.6 px (20 steps of at most 0.08).
    assert float((out["pos"] - model.pos).abs().max()) > 1.0
    # Float32 round-off in the data gradient, carried through 20 Adam
    # steps, whose normalized step turns a gradient's relative error into
    # a position error of up to lr times it where the gradient is small:
    # ~3e-5 px seen, 1e-3 px allowed.
    torch.testing.assert_close(out["pos"], p_pos, rtol=0, atol=1e-3)
    # The traces follow the positions through 2 x 20 updates: ~1e-5
    # relative seen; the check's own measure, per frame.
    gap = torch.linalg.vector_norm(out["c"] - p_state.c, dim=0) / (
        torch.linalg.vector_norm(out["c"], dim=0))
    assert float(gap.max()) < 1e-4
    torch.testing.assert_close(out["mse"], p_m["recon_mse"], rtol=1e-4,
                               atol=0)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -9, -3.0 - 2.0 ** -12])
    assert ref.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -3.0]


@pytest.mark.parametrize("workload,frames", [("roi_demix", "all"),
                                             ("wb_demix", 3),
                                             ("wb_round", 2),
                                             ("wb_refine", 3)])
def test_the_whole_fit_agrees_through_the_check(workload, frames, capsys):
    from conftest import tiny_args, tiny_cell

    from cardbench import harness

    cell = tiny_cell(workload, frames)
    assert harness.run_cell(cell, tiny_args(), 0.0,
                            torch.device("cpu")) == 0
    import json

    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"], name
