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


@pytest.mark.parametrize("workload", ["roi_demix", "wb_round", "wb_refine"])
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


def _positions_unchanged(orig):
    def step(state, pos_t, video, *args, **kwargs):
        _, m = orig(state, pos_t, video, *args, **kwargs)
        t, k = video.shape[0], state.pos.shape[0]
        return (state.pos.expand(t, k, 3) if pos_t is None else pos_t), m
    return step


def _positions_half(orig):
    def step(state, pos_t, video, *args, **kwargs):
        t, k = video.shape[0], state.pos.shape[0]
        start = state.pos.expand(t, k, 3) if pos_t is None else pos_t
        h = t // 2
        part = state.replace(beta=state.beta[:h], c=state.c[:, :h])
        new, m = orig(part, start[:h], video[:h], *args, **kwargs)
        return torch.cat([new, start[h:]]), m
    return step


def _tracked_altered(orig):
    def step(*args, **kwargs):
        grams, c1 = orig(*args, **kwargs)
        return grams, c1 * 1.01
    return step


@pytest.mark.parametrize("attr,fault", [
    ("refine_positions", _positions_unchanged),  # a step returns its state
    ("refine_positions", _positions_half),       # half the frames left out
    ("tracked_grams", _tracked_altered),         # a statistic altered
])
def test_a_broken_refinement_is_not_correct(attr, fault, monkeypatch,
                                            capsys):
    from dnmf_tpu_torch.models import refine

    monkeypatch.setattr(refine, attr, fault(getattr(refine, attr)))
    out, _ = _run(tiny_cell("wb_refine"), capsys)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ["roi_demix", "wb_round", "wb_refine"])
def test_the_job_and_warm_up_call_what_the_traffic_names(workload,
                                                         monkeypatch,
                                                         capsys):
    """Without ``refine`` a job is one ``fit`` and the warm-up one
    ``fit(rounds=1)``; with it each is followed by ``refine``, the warm-up's
    of one round with the traffic's other arguments."""
    from dnmf_tpu_torch.engine import trainer

    calls = []

    def spy(name):
        orig = getattr(trainer.DeformableNMF, name)

        def method(self, video, **kwargs):
            calls.append((name, kwargs))
            return orig(self, video, **kwargs)
        return method

    for name in ("fit", "refine"):
        monkeypatch.setattr(trainer.DeformableNMF, name, spy(name))
    cell = tiny_cell(workload)
    out, _ = _run(cell, capsys)
    refine = cell["traffic_spec"].get("refine")
    if refine is None:
        warm_up, job = [("fit", {"rounds": 1})], [("fit", {})]
    else:
        warm_up = [("fit", {"rounds": 1}),
                   ("refine", {**refine, "rounds": 1})]
        job = [("fit", {}), ("refine", refine)]
    jobs = (len(calls) - len(warm_up)) // len(job)
    assert jobs >= 1 and calls == warm_up + job * jobs
    assert out["attempted"] == jobs * (
        cell["traffic_spec"]["optimizer"]["outer_rounds"]
        + (refine["rounds"] if refine else 0))


@pytest.mark.parametrize("workload", ["roi_demix", "wb_refine"])
def test_the_control_is_not_correct(workload):
    """The reference in TF32 in the program's place fails the limits."""
    from cardbench import check, recording

    cell = tiny_cell(workload)
    rec = recording.make(cell["config_spec"], 23, torch.device("cpu"))
    ref = check.Reference(cell, rec, 23, [0])
    control = check.Reference(cell, rec, 23, [0], precision="tf32")
    readings = check.numbers(control.view(), ref)
    assert not check.verdict(readings, cell["limits"])["correct"], readings
