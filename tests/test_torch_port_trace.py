"""The port's spans (:mod:`dnmf_tpu_torch.utils.trace`) on the CPU: labels
of ``torch.profiler`` at the engine's steps and reads and at the graph
cache's load, replay and outputs, present only while a profiler records,
nested in the job's ``engine.fit``, and moving no bit of the fit.

A tiny fit with the kernels' plain versions goes through the cache
(``use_kernels=True``), whose entries call their steps eagerly at each
replay on the CPU: a span inside a step would show inside
``span.graphs.replay``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch.data.datasets import VideoDataset
from dnmf_tpu_torch.engine.trainer import DeformableNMF
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.utils import trace

SIZE = (16, 12, 4)
K, T, FB = 6, 7, 3
ROUNDS = 2


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


def _dataset(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (K, 3)).astype(np.float32)
    ds = VideoDataset()
    ds.video = torch.from_numpy(
        rng.uniform(0, 1, (T,) + SIZE).astype(np.float32))
    return ds, pos


def _engine(pos, epochs=2):
    model = tcfg.ModelConfig(size=SIZE, num_neurons=K, num_frames=T,
                             shape_std=2.0)
    opt = tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=ROUNDS,
                               motion_epochs=epochs, mu_iters=3)
    rt = tcfg.RuntimeConfig(frame_block=FB, use_kernels=True)
    return DeformableNMF(model, opt, rt, positions=pos, device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    labels = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("span.")]
    return out, labels


def _count(labels, name):
    return sum(1 for n, _, _ in labels if n == name)


def _inside(label, outer):
    return outer[1] <= label[1] and label[2] <= outer[2]


def test_without_a_profiler_a_span_is_one_shared_null_context():
    off = trace.span("engine.round")
    assert off is trace.span("graphs.replay")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("engine.round")
        assert on is not off
        with on:
            pass
    assert trace.span("engine.round") is off


@pytest.mark.parametrize("epochs", [1, 2])
def test_a_profiled_fit_names_its_rounds_steps_and_reads(epochs):
    """One ``engine.read`` per epoch's metrics and one per round's mean
    trace; one cache call, load, replay and outputs per epoch, the Grams
    and the trace update, the call inside its engine step and the rest
    inside the call; the entries made inside the first round's calls; all
    inside ``engine.fit`` and none inside a replay (where the CPU runs the
    step)."""
    ds, pos = _dataset()
    eng = _engine(pos, epochs)
    _, labels = _profiled(lambda: eng.fit(ds))
    (fit,) = [lab for lab in labels if lab[0] == "span.engine.fit"]
    assert all(_inside(lab, fit) for lab in labels)
    counts = {name: _count(labels, "span." + name) for name in (
        "engine.round", "engine.prepare", "engine.motion", "engine.grams",
        "engine.traces", "engine.audit", "engine.read",
        "graphs.call", "graphs.load", "graphs.replay", "graphs.outputs")}
    replays = ROUNDS * (epochs + 2)
    assert counts == {
        "engine.round": ROUNDS, "engine.prepare": 1,
        "engine.motion": ROUNDS * epochs, "engine.grams": ROUNDS,
        "engine.traces": ROUNDS, "engine.audit": 1,
        "engine.read": ROUNDS * (epochs + 1),
        "graphs.call": replays, "graphs.load": replays, "graphs.replay": replays,
        "graphs.outputs": replays}
    steps = [lab for lab in labels if lab[0] in (
        "span.engine.motion", "span.engine.grams", "span.engine.traces")]
    calls = [lab for lab in labels if lab[0] == "span.graphs.call"]
    assert all(any(_inside(c, step) for step in steps) for c in calls)
    made = [lab for lab in labels if lab[0].startswith("span.graphs.entry.")]
    for lab in labels:
        if lab in made or lab[0] in ("span.graphs.load", "span.graphs.replay",
                                     "span.graphs.outputs"):
            assert any(_inside(lab, call) for call in calls), lab
    assert sorted(n for n, _, _ in made) == [
        "span.graphs.entry.compute_grams",
        "span.graphs.entry.footprint_update",
        "span.graphs.entry.motion_epoch"]
    for replay in [lab for lab in labels if lab[0] == "span.graphs.replay"]:
        assert not [lab for lab in labels
                    if lab is not replay and _inside(lab, replay)]
    for lab in labels:
        if lab[0] in ("span.engine.read", "span.engine.audit"):
            assert not [r for r in labels if r[0] == "span.engine.read"
                        and r is not lab and _inside(r, lab)]
    for e in graphs.entries():
        assert e.warmup_seconds + e.instantiate_seconds <= e.capture_seconds


def test_the_spans_move_no_bit_of_the_fit():
    ds, pos = _dataset(1)
    runs = []
    for profiled in (False, True):
        graphs.clear()
        eng = _engine(pos)
        if profiled:
            res, labels = _profiled(lambda: eng.fit(ds))
            assert _count(labels, "span.engine.round") == ROUNDS
        else:
            res = eng.fit(ds)
        runs.append(res)
    off, on = runs
    for f in tM.STATE_FIELDS:
        assert torch.equal(getattr(off.state, f), getattr(on.state, f)), f
    strip = [[{k: v for k, v in m.items() if k != "seconds"}
              for m in r.metrics] for r in runs]
    assert strip[0] == strip[1]


def test_a_second_fit_over_the_same_dataset_makes_no_entry():
    ds, pos = _dataset(2)
    _engine(pos).fit(ds)
    before = [id(e) for e in graphs.entries()]
    _, labels = _profiled(lambda: _engine(pos).fit(ds))
    assert not [n for n, _, _ in labels
                if n.startswith("span.graphs.entry")]
    assert sorted(id(e) for e in graphs.entries()) == sorted(before)
    assert _count(labels, "span.engine.init") == 1
