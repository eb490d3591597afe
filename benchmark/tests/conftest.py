"""Shared pieces of the benchmark's own tests (``python -m pytest
benchmark/tests``): the benchmark's folder and the checkout on the path,
and a tiny cell that runs on the CPU."""

import argparse
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


# Cells whose files are in the benchmark's folder but not yet in
# BENCHMARK.json: the cell whose traffic they take, and their configuration.
HELD = {"wb_stream_raw": ("wb_round", "whole_brain_k200_raw")}


def held_config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def tiny_cell(workload: str = "roi_demix", check_frames="all") -> dict:
    """The workload's files at a size the CPU runs in seconds: 24x20x6
    voxels, K=4, T=6, 2 rounds of 3 epochs (1 for a one-epoch traffic);
    a refinement of 2 rounds of 4 epochs and 10 trace updates; a stored
    recording streamed in blocks of 4 frames (the last one padded)."""
    from cardbench import spec

    base, config = HELD.get(workload, (workload, None))
    cell = spec.cell(base)
    if config is not None:
        cell["name"] = workload
        cell["config_spec"] = held_config(config)
        with open(os.path.join(BENCH, "limits", f"{workload}.json")) as f:
            cell["limits"] = json.load(f)
    cfg = cell["config_spec"]
    cfg.update(size=[24, 20, 6], num_neurons=4, num_frames=6,
               runtime={"frame_block": 4})
    if "storage" in cfg:
        cfg["storage"]["block"] = 4
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
def scratch(tmp_path, monkeypatch):
    """A directory that holds every temporary directory the test makes."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def stored_files() -> list:
    """This process's open descriptors and maps of a stored recording's
    in-memory file."""
    from cardbench import recording

    found = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            target = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if f"memfd:{recording.STORED_NAME}" in target:
            found.append(target)
    with open("/proc/self/maps") as f:
        found += [line for line in f
                  if f"memfd:{recording.STORED_NAME}" in line]
    return found


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
