"""The port's other measuring tools (``config_runs``, ``reg_bench``,
``tail_experiment``) and the shared kernel checks (``kernel_check``) on
the CPU at tiny shapes, with the plain versions of the kernels.

Each tool runs one tiny case and returns the JAX tool's keys; each
refuses to run without a card.  The recovery harness's isotropic width
spread draws widths in ``shape_std * [1 - s, 1 + s]``, and its exact-Gram
fit agrees with its analytic one (the Grams differ by the closed form's
residual only).  A kernel that disagrees with its float64 oracle makes
``kernel_check`` raise.
"""

import functools

import numpy as np
import pytest
import torch

from dnmf_tpu_torch.ops import fused
from dnmf_tpu_torch.tools import (config_runs, kernel_check, reg_bench,
                                  tail_experiment, wb_recovery)

REC = dict(size=(32, 32, 6), k=6)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tools run many small ops, which a
    thread pool per test worker (the suite runs several) slows ~10x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("gram_mode,fit_sigma,spread", [
    ("analytic", True, 0.2), ("exact", False, 0.0)])
def test_config4_tiny(gram_mode, fit_sigma, spread):
    out = config_runs.run_config4(frames=16, rounds=2, epochs=2, mu_iters=5,
                                  gram_mode=gram_mode, fit_sigma=fit_sigma,
                                  sigma_spread=spread, device="cpu", **REC)
    for key in ("config", "workload", "protocol", "sigma_err_px", "synth_s",
                "registration_seed_s", "trace_corr_mean", "trace_corr_p10",
                "trace_corr_min", "warp_err_px", "round_s_steady",
                "frames_per_sec_full_round"):
        assert key in out, key
    assert f"grams={gram_mode}" in out["protocol"]
    assert out["trace_corr_min"] <= out["trace_corr_p10"] <= 1.0


def test_config5_tiny():
    out = config_runs.run_config5(recordings=2, t=8, size=(24, 20, 4), k=6,
                                  reps=1, device="cpu")
    for key in ("single_recording_round_s", "batched_round_s",
                "throughput_vs_serial", "frames_per_sec_batched"):
        assert out[key] > 0.0, key


def test_reg_bench_tiny():
    out = reg_bench.run(frames=2, reps=1, size=(48, 48, 4),
                        strides=(24, 24, 4), overlaps=(8, 8, 0),
                        max_shifts=(3, 3, 1), device="cpu",
                        say=lambda msg: None)
    rows = out["reg_bench_ms_per_frame"]
    assert "pw-rigid est+apply (dec=4, torch.fft pc)" in rows
    for dec in (1, 2, 4):
        assert f"pw-rigid est+apply (sep, dec={dec})" in rows
    assert not any("prec" in r or "tm=" in r or "DFT" in r for r in rows)
    # On the CPU "fused" remap means the separable one: the same movie.
    assert rows["fused_warp_max_abs_diff"] == 0.0
    # A template moved by (2.3, -1.7, 0.6) px is found to 1/10 px.
    assert rows["fused_max_shift_err_px"] <= 0.1 + 1e-5
    assert set(out["timing"]) == set(rows) - {"fused_warp_max_abs_diff",
                                             "fused_max_shift_err_px"}


@pytest.mark.parametrize("extra", [[], ["--skip-polish"]])
def test_tail_experiment_tiny(extra):
    args = tail_experiment.parser().parse_args(
        ["--k", "6", "--t", "16", "--size", "32", "32", "6", "--mu-extra",
         "5", "--fista", "5", "--refine-rounds", "1", "--refine-epochs",
         "2"] + extra)
    out = tail_experiment.run(args, device="cpu", say=lambda msg: None)
    names = ["baseline", "refine", "refine_fista"]
    if not extra:
        names[1:1] = ["extra_mu", "fista", "oracle_gt_warp"]
    assert list(out) == names
    for stats in out.values():
        assert {"mean", "p10", "min", "n_below_097"} <= set(stats)
        assert stats["min"] <= stats["p10"] <= stats["mean"] <= 1.0


@pytest.mark.parametrize("main", [config_runs.main, reg_bench.main,
                                  tail_experiment.main])
def test_tools_refuse_without_a_card(monkeypatch, capsys, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_recovery_fixture_width_spread():
    a = wb_recovery.recovery_fixture((32, 32, 6), 50, 4, seed=1,
                                     device="cpu", sigma_spread=0.2)
    b = wb_recovery.recovery_fixture((32, 32, 6), 50, 4, seed=1,
                                     device="cpu")
    sig = a["sigma_gt"].numpy()
    assert sig.shape == (50,)
    assert (sig >= 3.0 * 0.8 - 1e-6).all() and (sig <= 3.0 * 1.2 + 1e-6).all()
    assert sig.std() > 0.1
    assert torch.equal(b["sigma_gt"], torch.full((50,), 3.0))
    # The spread draws after the positions: those stay the same.
    assert torch.equal(a["pos_gt"], b["pos_gt"])


def test_recover_exact_grams_agree_with_analytic():
    fx = wb_recovery.recovery_fixture((32, 32, 6), 6, 16, seed=0,
                                      device="cpu")
    runs = [wb_recovery.recover(fx, 2, 2, 5, gram_mode=mode)
            for mode in ("analytic", "exact")]
    np.testing.assert_allclose(runs[0]["corr"], runs[1]["corr"], atol=1e-3)
    assert len(runs[0]["round_s"]) == 2


def test_kernel_check_counts_each_gate():
    """Every gated comparison counts once, the one that misses too."""
    kernel_check.reset_check_count()
    kernel_check.gate(True, "ok")
    with pytest.raises(kernel_check.KernelCheckError, match="missed"):
        kernel_check.gate(False, "missed")
    assert kernel_check.check_count() == 2
    kernel_check.reset_check_count()
    assert kernel_check.check_count() == 0


def test_kernel_check_raises_on_a_wrong_kernel():
    """``check_kernels`` with a "kernel" that is the plain version plus
    1e-3 of its max: beyond ``KERNEL_TOL`` of the float64 oracle."""
    size = (24, 20, 4)
    betas, pos, sigma, _, y = kernel_check.kernel_inputs(
        torch.device("cpu"), size, 6, 2, 2.0, 0)
    plain = functools.partial(fused.c1_block_plain, size=size)

    def wrong(*args):
        out = plain(*args)
        return out + 1e-3 * out.abs().max()

    case = {"c1_block": (wrong, plain, ("c1",), (betas, pos, sigma, y),
                         (1, 0, 0, 1), 1.0)}
    with pytest.raises(kernel_check.KernelCheckError, match="c1_block"):
        kernel_check.check_kernels("t", 2, case)
    case["c1_block"] = (plain,) + case["c1_block"][1:]
    assert kernel_check.check_kernels("t", 2, case)["c1_block"][
        "max_rel_err"] <= kernel_check.KERNEL_TOL
