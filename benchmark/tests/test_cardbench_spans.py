"""The readers of the program's spans and graph counters on a made-up
profiled job and made-up entries: what each reads, and nothing where the
program has no such labels or counters (a program without spans); the
reader's metrics from a streamed source's fills."""

import types

import numpy as np
import pytest

from cardbench import harness, spec, trace

SPAN_READERS = ("read_wait_ms_per_round", "host_reads_per_round",
                "audit_ms_per_job", "replay_host_ms_per_round")
COUNTER_READERS = ("warmup_s", "instantiate_s")


def _profile(labels):
    prof = trace.Profile.__new__(trace.Profile)
    prof.wall_s, prof.device, prof.labels = 1.0, [], list(labels)
    return prof


def _job(rounds=2, epochs=3):
    """A job's labels in microseconds: ``engine.fit`` around an audit of
    2 ms and ``rounds`` rounds, each with ``epochs`` reads of 0.5 ms, one
    mean-trace read of 1 ms and ``epochs + 2`` replays of 0.25 ms."""
    labels, t = [("job", 0.0, 1e9)], 10.0
    labels.append(("span.engine.audit", t, t + 2000.0))
    t += 3000.0
    for _ in range(rounds):
        start = t
        for _ in range(epochs):
            labels.append(("span.graphs.replay", t, t + 250.0))
            labels.append(("span.engine.read", t + 300.0, t + 800.0))
            t += 1000.0
        for _ in range(2):
            labels.append(("span.graphs.replay", t, t + 250.0))
            t += 300.0
        labels.append(("span.engine.read", t, t + 1000.0))
        t += 1100.0
        labels.append(("span.engine.round", start, t))
    labels.append(("span.engine.fit", 5.0, t + 5.0))
    return labels


def _run(labels=None, entries=()):
    run = harness.Run()
    run.profile = None if labels is None else _profile(labels)
    run.entries = list(entries)
    return run


def test_span_readers_read_the_profiled_job():
    run = _run(_job(rounds=2, epochs=3))
    got = {name: spec.reader(name)(run) for name in SPAN_READERS}
    assert got == pytest.approx({
        "read_wait_ms_per_round": 3 * 0.5 + 1.0,
        "host_reads_per_round": 4.0,
        "audit_ms_per_job": 2.0,
        "replay_host_ms_per_round": 5 * 0.25})


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_nothing_without_the_programs_labels(name):
    # the benchmark's own labels alone, as a program without spans leaves
    theirs = [("job", 0.0, 1e6), ("span.motion", 10.0, 500.0),
              ("span.grams", 600.0, 900.0)]
    assert spec.reader(name)(_run(theirs)) is None
    assert spec.reader(name)(_run(None)) is None
    no_rounds = [lab for lab in _job() if lab[0] not in (
        "span.engine.round", "span.engine.fit")]
    assert spec.reader(name)(_run(no_rounds)) is None


def _entry(**counters):
    return types.SimpleNamespace(capture_seconds=1.0, **counters)


def test_counter_readers_sum_the_entries():
    run = _run(entries=[_entry(warmup_seconds=0.25, instantiate_seconds=0.5),
                        _entry(warmup_seconds=0.125,
                               instantiate_seconds=0.0625)])
    assert spec.reader("warmup_s")(run) == 0.375
    assert spec.reader("instantiate_s")(run) == 0.5625


@pytest.mark.parametrize("name", COUNTER_READERS)
def test_counter_readers_read_nothing_without_the_counters(name):
    assert spec.reader(name)(_run(entries=[_entry(), _entry()])) is None
    assert spec.reader(name)(_run(entries=[])) is None


def _job_with(phases):
    return harness.Job(None, None, [{"phase": p, **kw} for p, kw in phases])


def test_rounds_done_counts_the_refinements_rounds():
    fit = [("round", {"seconds": 0.5})] * 5
    run = _run()
    run.jobs = [_job_with(fit), _job_with(fit + [("refine", {"rounds": 3,
                                                            "seconds": 9.0})])]
    assert run.refine_rounds == 3
    assert run.rounds_done == 13
    assert len(run.round_seconds) == 10
    run.frames, run.window_s = 1000, 10.0
    assert spec.reader("frames_per_s")(run) == 1300.0


def test_refinement_readers_read_per_refine_round():
    run = _run()
    run.jobs = [_job_with([("round", {"seconds": 0.5}),
                           ("refine", {"rounds": 3, "seconds": 9.0})])] * 2
    run.spans = {"motion": 0.1, "refine": 6.0, "tracked_grams": 0.9}
    assert spec.reader("refine_ms_per_round")(run) == pytest.approx(1000.0)
    assert spec.reader("tracked_grams_ms_per_round")(run) == pytest.approx(
        150.0)
    # the fit's rounds alone: the refinement's spans lie outside them
    assert spec.reader("host_ms_per_round")(run) is None


@pytest.mark.parametrize("name", ["refine_ms_per_round",
                                  "tracked_grams_ms_per_round",
                                  "refine_kernel_roofline"])
def test_refinement_readers_read_nothing_without_a_refinement(name):
    run = _run()
    run.jobs = [_job_with([("round", {"seconds": 0.5})])]
    run.spans = {"motion": 0.1, "refine": 0.0, "tracked_grams": 0.0}
    assert spec.reader(name)(run) is None


def test_stream_readers_read_the_windows_fills():
    run = _run()
    run.jobs = [_job_with([("round", {"seconds": 2.0})] * 5)]
    run.window_s = 10.0
    run.fill_seconds, run.fill_bytes = 7.5, 25_000_000_000
    assert spec.reader("stream_gb_per_s")(run) == pytest.approx(2.5)
    assert spec.reader("fill_ms_per_round")(run) == pytest.approx(1500.0)


@pytest.mark.parametrize("name", ["stream_gb_per_s", "fill_ms_per_round"])
def test_stream_readers_read_nothing_where_nothing_streamed(name):
    run = _run()
    run.jobs = [_job_with([("round", {"seconds": 2.0})] * 5)]
    run.window_s = 10.0
    assert run.fill_bytes is None
    assert spec.reader(name)(run) is None


def test_fills_count_every_frame_a_source_hands_out_once():
    """Two passes over 6 frames of 10 voxels in blocks of 4: each frame's
    40 bytes twice (the padded tail's zeros are not filled), then nothing
    once cleared and taken off."""
    import torch

    from dnmf_tpu_torch.data import streaming

    source = streaming.StreamingVideo(
        np.arange(60, dtype=np.float32).reshape(6, 10), block=4,
        device="cpu")
    fills = trace.Fills(source)
    fills.install()
    for _ in range(2):
        got = torch.cat([f[:n] for f, _, n in source.blocks()])
    assert torch.equal(got, torch.arange(60.0).reshape(6, 10))
    assert fills.bytes == 2 * 6 * 10 * 4 and fills.seconds > 0
    fills.clear()
    fills.uninstall()
    list(source.blocks())
    assert (fills.bytes, fills.seconds) == (0, 0.0)
