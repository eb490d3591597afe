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


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -9, -3.0 - 2.0 ** -12])
    assert ref.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -3.0]


@pytest.mark.parametrize("workload,frames", [("roi_demix", "all"),
                                             ("wb_demix", 3),
                                             ("wb_round", 2)])
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
