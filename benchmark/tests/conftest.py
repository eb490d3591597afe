"""Shared pieces of the benchmark's own tests (``python -m pytest
benchmark/tests``): the benchmark's folder and the checkout on the path,
and a tiny cell that runs on the CPU."""

import argparse
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def tiny_cell(workload: str = "roi_demix", check_frames="all") -> dict:
    """The workload's files at a size the CPU runs in seconds: 24x20x6
    voxels, K=4, T=6, 2 rounds of 3 epochs (1 for a one-epoch traffic);
    a refinement of 2 rounds of 4 epochs and 10 trace updates."""
    from cardbench import spec

    cell = spec.cell(workload)
    cfg = cell["config_spec"]
    cfg.update(size=[24, 20, 6], num_neurons=4, num_frames=6,
               runtime={"frame_block": 4})
    cfg["assumed"]["anchor_margin_px"] = [3.0, 3.0, 1.0]
    opt = cell["traffic_spec"]["optimizer"]
    opt["outer_rounds"] = 2
    opt["motion_epochs"] = min(opt["motion_epochs"], 3)
    if "refine" in cell["traffic_spec"]:
        cell["traffic_spec"]["refine"].update(rounds=2, epochs=4,
                                              mu_iters=10)
    cell["limits"]["check_frames"] = check_frames
    return cell


def tiny_args(seed: int = (1 << 31) + 17, trace: int = 0):
    return argparse.Namespace(workload="tiny", seed=seed, seconds=0.2,
                              trace=trace)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
