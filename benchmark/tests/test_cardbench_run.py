"""A run on the CPU at a tiny size, past the harness's look for a card:
its last line has the contract's shape, and with the timed path broken
underneath its check comes out false, once per fault the cells can have
(one chip: no exchange between chips to leave out)."""

import json

import pytest
import torch

from conftest import tiny_args, tiny_cell


def _run(cell, capsys, trace=0):
    from cardbench import harness

    assert harness.run_cell(cell, tiny_args(trace=trace), 0.0,
                            torch.device("cpu")) == 0
    lines = capsys.readouterr()
    return json.loads(lines.out.strip().splitlines()[-1]), lines.err


def test_the_last_line_has_the_contracts_shape(capsys):
    out, err = _run(tiny_cell(), capsys)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2
    assert {"setup_s", "frames_per_s"} <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # the checks are the last lines of standard error too, in order
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])


def _motion_unchanged(orig):
    def step(state, video, *args, **kwargs):
        _, m = orig(state, video, *args, **kwargs)
        return state, m
    return step


def _motion_half(orig):
    from dnmf_tpu_torch.models import dnmf

    def step(state, video, model, optimizer, gamma, frame_block=16,
             use_kernels=False):
        h = video.shape[0] // 2
        part = state.replace(beta=state.beta[:h], c=state.c[:, :h],
                             mu=state.mu[:h], nu=state.nu[:h])
        new, m = dnmf.motion_epoch_parallel(part, video[:h], model,
                                            optimizer, gamma, frame_block,
                                            use_kernels)
        keep = lambda a, b: torch.cat([a, b[h:]])  # noqa: E731
        return state.replace(beta=keep(new.beta, state.beta),
                             mu=keep(new.mu, state.mu),
                             nu=keep(new.nu, state.nu), count=new.count), m
    return step


def _traces_altered(orig):
    def step(*args, **kwargs):
        state = orig(*args, **kwargs)
        return state.replace(c=state.c * 1.01)
    return step


def _grams_altered(orig):
    def step(*args, **kwargs):
        grams, c1 = orig(*args, **kwargs)
        return grams, c1 * 1.01
    return step


@pytest.mark.parametrize("workload", ["roi_demix", "wb_round"])
@pytest.mark.parametrize("attr,fault", [
    ("motion_epoch", _motion_unchanged),   # a step returns its state
    ("motion_epoch", _motion_half),        # half the frames left out
    ("footprint_update", _traces_altered),  # an answer altered
    ("compute_grams", _grams_altered),     # a statistic altered
])
def test_a_broken_timed_path_is_not_correct(workload, attr, fault,
                                            monkeypatch, capsys):
    from dnmf_tpu_torch.models import graphs

    monkeypatch.setattr(graphs, attr, fault(getattr(graphs, attr)))
    out, _ = _run(tiny_cell(workload), capsys)
    assert out["correct"] is False, out["checks"]


def test_the_control_is_not_correct():
    """The reference in TF32 in the program's place fails the limits."""
    from cardbench import check, recording

    cell = tiny_cell()
    rec = recording.make(cell["config_spec"], 23, torch.device("cpu"))
    ref = check.Reference(cell, rec, 23, [0])
    control = check.Reference(cell, rec, 23, [0], precision="tf32")
    readings = check.numbers(control.view(), ref)
    assert not check.verdict(readings, cell["limits"])["correct"], readings
