"""The check's numbers on the reference's own outputs, and what it holds
a cell to: the numbers that the cell's limits file lists."""

import json
import math

import pytest
import torch

from conftest import tiny_cell

from cardbench import check, recording


@pytest.fixture(scope="module")
def refined():
    cell = tiny_cell("wb_refine")
    rec = recording.make(cell["config_spec"], 29, torch.device("cpu"))
    return cell, check.Reference(cell, rec, 29, [0])


def test_pos_err_reads_zero_on_the_references_own_outputs(refined):
    cell, reference = refined
    readings = check.numbers(reference.view(), reference)
    assert readings["pos_err"] == 0.0
    assert readings["c_err"] == readings["beta_err"] == 0.0
    assert check.verdict(readings, cell["limits"])["correct"]


def test_pos_err_flags_one_frame_shifted_by_half_a_pixel(refined):
    cell, reference = refined
    view = reference.view()
    pos = view["pos"].clone()
    pos[1] += 0.5
    readings = check.numbers({**view, "pos": pos}, reference)
    moved = torch.linalg.vector_norm(
        (reference.pos[1] - reference.anchors).flatten())
    shift = 0.5 * math.sqrt(pos.shape[1] * 3)
    assert readings["pos_err"] == pytest.approx(float(shift / moved),
                                                rel=1e-5)
    judged = check.verdict(readings, cell["limits"])
    assert not judged["correct"]
    assert judged["checks"]["pos_err"]["value"] > judged["checks"][
        "pos_err"]["limit"]
    # no positions at all is infinitely far off
    assert check.numbers({**view, "pos": None}, reference)[
        "pos_err"] == math.inf


@pytest.mark.parametrize("workload", ["wb_demix", "roi_demix", "wb_round"])
def test_cells_without_a_refinement_keep_their_four_checks(workload):
    from cardbench import spec

    limits = spec.cell(workload)["limits"]
    readings = {"loss_err": 0.0, "beta_err": 0.0, "c_err": 0.0,
                "audit_gap": 0.0}
    judged = check.verdict(readings, limits)
    assert list(judged["checks"]) == ["loss_err", "beta_err", "c_err",
                                      "audit_gap"]
    assert judged["correct"]


def test_a_listed_number_without_a_reading_fails():
    limits = json.loads(json.dumps(tiny_cell("wb_refine")["limits"]))
    readings = {"loss_err": 0.0, "beta_err": 0.0, "c_err": 0.0,
                "audit_gap": 0.0}
    judged = check.verdict(readings, limits)
    assert judged["checks"]["pos_err"]["value"] == math.inf
    assert not judged["correct"]
