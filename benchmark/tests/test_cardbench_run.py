"""A run on the CPU at a tiny size, past the harness's look for a card:
its last line has the contract's shape, and with the timed path broken
underneath its check comes out false, once per fault the cells can have
(one chip: no exchange between chips to leave out); a stored cell fits
what the same cell fits resident, and leaves no file behind."""

import json

import pytest
import torch

from conftest import stored_files, tiny_args, tiny_cell


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


def _streamed_half(orig):
    def step(state, source, *args, **kwargs):
        new, m = orig(state, source, *args, **kwargs)
        h = state.beta.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:h], b[h:]])  # noqa: E731
        return state.replace(beta=keep(new.beta, state.beta),
                             mu=keep(new.mu, state.mu),
                             nu=keep(new.nu, state.nu), count=new.count), m
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


@pytest.mark.parametrize("attr,fault", [
    ("motion_epoch_streaming", _motion_unchanged),
    ("motion_epoch_streaming", _streamed_half),  # half the frames' updates
    ("footprint_update", _traces_altered),
    ("compute_grams_streaming", _grams_altered),
])
def test_a_broken_streamed_path_is_not_correct(attr, fault, monkeypatch,
                                               capsys, scratch):
    """The same faults in the steps a stored recording's fit takes."""
    from dnmf_tpu_torch.models import graphs

    monkeypatch.setattr(graphs, attr, fault(getattr(graphs, attr)))
    out, _ = _run(tiny_cell("wb_stream_raw"), capsys)
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


@pytest.mark.parametrize("workload", ["roi_demix", "wb_round", "wb_refine",
                                      "wb_stream_raw"])
def test_the_job_and_warm_up_call_what_the_traffic_names(workload,
                                                         monkeypatch,
                                                         capsys, scratch):
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


@pytest.mark.parametrize("workload", ["roi_demix", "wb_refine",
                                      "wb_stream_raw"])
def test_the_control_is_not_correct(workload, scratch):
    """The reference in TF32 in the program's place fails the limits."""
    from cardbench import check, harness

    cell = tiny_cell(workload)
    with harness.fit_source(cell, 23, torch.device("cpu")) as (rec, _):
        ref = check.Reference(cell, rec, 23, [0])
        control = check.Reference(cell, rec, 23, [0], precision="tf32")
    readings = check.numbers(control.view(), ref)
    assert not check.verdict(readings, cell["limits"])["correct"], readings


def _jobs_of(cell, monkeypatch, capsys):
    """A tiny run of ``cell``: its jobs, last line and standard error."""
    from cardbench import harness

    jobs = []

    def spy(*args, **kwargs):
        jobs.append(run_job(*args, **kwargs))
        return jobs[-1]

    run_job = harness.run_job
    monkeypatch.setattr(harness, "run_job", spy)
    out, err = _run(cell, capsys)
    monkeypatch.setattr(harness, "run_job", run_job)
    return jobs, out, err


def test_a_stored_cell_fits_what_the_resident_cell_fits(monkeypatch, capsys,
                                                        scratch):
    """The same draw, streamed from its file in blocks of 4 frames (the
    last one padded), gives bit-equal warps and traces to the resident
    fit; the file is gone after the run."""
    stored = tiny_cell("wb_stream_raw")
    resident = tiny_cell("wb_stream_raw")
    del resident["config_spec"]["storage"]
    got, out, err = _jobs_of(stored, monkeypatch, capsys)
    want, _, resident_err = _jobs_of(resident, monkeypatch, capsys)
    assert "fit source: " in err and "fit source: " not in resident_err
    assert out["correct"] is True, out["checks"]
    assert not stored_files() and not list(scratch.iterdir())
    for a in (got[0], want[0]):
        assert a.beta.shape == (6, 10, 3) and a.c.shape == (4, 6)
    assert torch.equal(got[0].beta, want[0].beta)
    assert torch.equal(got[0].c, want[0].c)


def test_a_stored_run_that_raises_leaves_no_file(monkeypatch, scratch):
    from cardbench import harness
    from dnmf_tpu_torch.engine import trainer

    def fit(self, video, **kwargs):
        assert stored_files()
        raise RuntimeError("the fit failed")

    monkeypatch.setattr(trainer.DeformableNMF, "fit", fit)
    with pytest.raises(RuntimeError, match="the fit failed"):
        harness.run_cell(tiny_cell("wb_stream_raw"), tiny_args(), 0.0,
                         torch.device("cpu"))
    assert not stored_files() and not list(scratch.iterdir())
