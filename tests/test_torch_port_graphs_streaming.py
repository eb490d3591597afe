"""The compiled-program layer's streamed block steps
(``graphs.motion_epoch_streaming``, ``compute_grams_streaming`` and
``refined_rounds_streaming``) on the CPU, where an entry keeps its step
function and calls it eagerly on its static buffers.

* Through the cache against the port's plain streamed functions
  (``models/dnmf.py``, ``models/refine.py``), bit for bit, on a
  ``StreamingVideo`` and a ``RawFileVideo`` whose last block is
  zero-padded (T = 11 frames in blocks of 4): one entry per step serves
  every block, replayed once per block.
* Against the JAX package's streamed functions at the tolerances of
  ``tests/test_torch_port_streaming.py``: 1e-5 of the reference's max
  (refinement: rtol 1e-5, atol 1e-6; with FISTA 1e-4 of the max).
* The host probe of ``tests/test_torch_port_graphs.py`` over every
  replayed block step: no tensor made from host data, no host read.
* ``DeformableNMF.fit`` and ``.refine`` on a streamed source go through
  the entries on one device (in parity mode too), and ``fit`` through the
  mesh's streamed entries on a one-rank ``gloo`` mesh.
"""

import contextlib

import numpy as np
import pytest
import torch

from dnmf_tpu.models import dnmf as jM
from dnmf_tpu.models import refine as jR
from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import native
from dnmf_tpu_torch.data import streaming as tS
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.models import graphs
from dnmf_tpu_torch.models import refine as tR

import test_torch_port_graphs as G
import test_torch_port_streaming as S

BLOCKS = -(-S.T // S.BLOCK)  # 3 blocks, the last with 3 valid frames
STEPS = ("motion", "grams_exact", "grams_analytic", "refine_mu",
         "refine_fista")
ENTRY = {"motion": "motion_epoch_streaming",
         "grams": "compute_grams_streaming",
         "refine": "refined_rounds_streaming"}
REFINE = dict(rounds=2, epochs=4, mu_iters=10, learning_rate=0.05,
              prior=1e-3)


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.clear()
    yield
    graphs.clear()


def _flat(out):
    if isinstance(out, tM.DNMFState):
        return [getattr(out, f) for f in tM.STATE_FIELDS]
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for part in out for t in _flat(part)]
    return [out]


def _same(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(
        x.shape == y.shape and x.stride() == y.stride() and torch.equal(x, y)
        for x, y in zip(fa, fb))


def _source(kind, tsrc, tmp_path):
    if kind == "stream":
        return tsrc
    if native.load_blockreader() is None:
        pytest.skip("no C++ compiler for the native block reader")
    path = tmp_path / "rec.raw"
    tsrc.array.tofile(path)
    return tS.RawFileVideo(str(path), tsrc.array.shape, block=S.BLOCK,
                           device="cpu")


def _call(name, state, source, model, cached=True):
    """One streamed call of ``name`` through the cache (``cached``) or the
    port's plain streamed function, with the kernel wrappers (their plain
    versions on CPU tensors)."""
    if name == "motion":
        fn = (graphs.motion_epoch_streaming if cached
              else tM.motion_epoch_streaming)
        return fn(state, source, model, tM.Adam(1e-3), 0.1, True)
    if name.startswith("grams"):
        fn = (graphs.compute_grams_streaming if cached
              else tM.compute_grams_streaming)
        return fn(state, source, model, True, name.split("_")[1])
    fn = (graphs.refined_rounds_streaming if cached
          else tR.refined_rounds_streaming)
    return fn(state, source, model, use_kernels=True,
              trace_solver=name.split("_")[1], **REFINE)


def _carry(name, state, out):
    """The state that the next call starts from: the epoch's or the
    refinement's (the Grams change nothing)."""
    return state if name.startswith("grams") else out[0]


# ------------------------------------------------ the cache's own protocol
@pytest.mark.parametrize("kind", ["stream", "raw"])
@pytest.mark.parametrize("name", STEPS)
def test_streamed_steps_equal_the_plain_functions(rng, tmp_path, name,
                                                  kind):
    """Two calls (a state carried from one into the next) through one
    entry, replayed once per block, the padded tail included: bit for bit
    the plain streamed function's results and layouts."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    src = _source(kind, tsrc, tmp_path)
    got_state = ref_state = ts
    for call in range(2):
        got = _call(name, got_state, src, tm)
        ref = _call(name, ref_state, src, tm, cached=False)
        assert _same(got, ref), (name, call)
        (entry,) = graphs.entries()
        assert entry.name == ENTRY[name.split("_")[0]]
        assert entry.replays == BLOCKS * (call + 1)
        got_state = _carry(name, got_state, got)
        ref_state = _carry(name, ref_state, ref)


def test_refined_rounds_streaming_from_positions(rng):
    """A second refinement starts from the first one's positions: the
    same entry, and the plain function's bits."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    kw = dict(use_kernels=True, **REFINE)
    st, pos, _ = graphs.refined_rounds_streaming(ts, tsrc, tm, **kw)
    got = graphs.refined_rounds_streaming(st, tsrc, tm, pos_t=pos, **kw)
    ref = tR.refined_rounds_streaming(st, tsrc, tm, pos_t=pos, **kw)
    assert _same(got, ref)
    (entry,) = graphs.entries()
    assert entry.replays == 2 * BLOCKS


class _DirtyPadding:
    """A source whose padded tail rows hold frames (ones), where a real
    source writes zeros: only the valid mask keeps them out."""

    def __init__(self, source):
        self.block, self.source = source.block, source
        self.num_frames = source.num_frames

    def blocks(self):
        for frames, start, valid in self.source.blocks():
            frames = frames.clone()
            frames[valid:] = 1.0
            yield frames, start, valid


@pytest.mark.parametrize("name", ["motion", "refine_mu"])
def test_each_block_masks_by_its_own_valid_count(rng, name):
    """The valid count is loaded per block: the tail's 3 frames, not the
    first block's 4, enter the sums."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    src = _DirtyPadding(tsrc)
    got = _call(name, ts, src, tm)
    assert _same(got, _call(name, ts, src, tm, cached=False))
    # Frames are independent: the valid frames' sums are the clean
    # source's, which a stale count of 4 would break.
    clean = _call(name, ts, tsrc, tm, cached=False)
    metric = 1 if name == "motion" else 2
    assert torch.equal(got[metric]["recon_mse"], clean[metric]["recon_mse"])


def test_disabled_and_plain_route_make_no_entry(rng):
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    with graphs.disabled():
        for name in STEPS:
            _call(name, ts, tsrc, tm)
    graphs.motion_epoch_streaming(ts, tsrc, tm, tM.Adam(1e-3), 0.1, False)
    graphs.compute_grams_streaming(ts, tsrc, tm, False)
    graphs.refined_rounds_streaming(ts, tsrc, tm, rounds=1, epochs=1)
    assert graphs.entries() == []


def test_returned_tensors_share_no_storage_with_the_cache(rng):
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    handed = []
    for name in STEPS:
        handed += _flat(_call(name, ts, tsrc, tm))
    kept = [t for e in graphs.entries() for t in e.inputs + e.outputs]
    assert not G._storages(handed) & G._storages(kept)
    before = [t.clone() for t in handed]
    for name in STEPS:
        _call(name, ts, tsrc, tm)
    assert all(torch.equal(a, b) for a, b in zip(handed, before))


def test_streamed_entries_share_one_frame_buffer(rng):
    """The three steps' entries hold one frame buffer, which no entry's
    ``buffer_bytes`` counts and which goes with the last entry."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    for name in ("motion", "grams_exact", "refine_mu"):
        _call(name, ts, tsrc, tm)
    frames = (S.BLOCK, tsrc.num_voxels)
    held = [[t for t in e.inputs if tuple(t.shape) == frames]
            for e in graphs.entries()]
    assert [len(h) for h in held] == [1, 1, 1]
    assert held[0][0] is held[1][0] is held[2][0]
    assert graphs.shared_bytes() == S.BLOCK * tsrc.num_voxels * 4
    shared = held[0][0]
    assert all(e.buffer_bytes == sum(t.numel() * t.element_size()
                                     for t in e.inputs if t is not shared)
               for e in graphs.entries())
    del held, shared
    graphs.clear()
    assert graphs.shared_bytes() == 0


def _cut(source, n):
    """A ``StreamingVideo`` of the recording's first ``n`` frames (or
    more: zero frames after the last), in the source's blocks."""
    array = np.zeros((n,) + source.array.shape[1:], np.float32)
    m = min(n, source.num_frames)
    array[:m] = source.array[:m]
    return tS.StreamingVideo(array, block=source.block, device="cpu")


@pytest.mark.parametrize("frames", [S.T - 3, S.T + 2])
@pytest.mark.parametrize("cached", [True, False])
@pytest.mark.parametrize("name", STEPS)
def test_a_source_of_another_length_raises(rng, name, cached, frames):
    """A source that holds more or fewer frames than the state raises in
    both routes, as the sharded streamed steps do, before any block
    runs: no output row is left unwritten."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng)
    src = _cut(tsrc, frames)
    with pytest.raises(ValueError, match=f"holds {frames}"):
        _call(name, ts, src, tm, cached=cached)
    assert graphs.entries() == []


@pytest.mark.parametrize("stage", ["fit", "refine"])
def test_trainer_raises_on_a_short_streamed_source(rng, stage):
    """``fit`` and ``refine`` on one device refuse a ``StreamingVideo``
    shorter than the model, captured and inside ``graphs.disabled()``
    alike."""
    for cached in (True, False):
        eng, src = _engine(np.random.default_rng(3))
        short = _cut(src, S.T - 3)
        with contextlib.nullcontext() if cached else graphs.disabled():
            with pytest.raises(ValueError, match="holds 8"):
                getattr(eng, stage)(short)


# ------------------------------------------------------------- host probe
@pytest.mark.parametrize("sigma_axes", [1, 3])
@pytest.mark.parametrize("name", STEPS)
def test_block_steps_make_no_host_tensor_and_read_nothing(
        rng, monkeypatch, name, sigma_axes):
    """Every replayed block step (on the CPU: the step on the entry's
    buffers), the padded tail's included, under the probe."""
    _, tm, _, _, _, ts, _, tsrc = S._pair(rng, sigma_axes)
    probe = G._HostProbe()
    replay = graphs.Entry.replay

    def probed(entry):
        with probe:
            replay(entry)

    monkeypatch.setattr(graphs.Entry, "replay", probed)
    _call(name, ts, tsrc, tm)
    assert graphs.entries()[0].replays == BLOCKS
    assert probe.hits == [], probe.hits


# ---------------------------------------------------- against the JAX package
def test_motion_epochs_streaming_through_the_cache_match_jax(rng):
    jm, tm, jopt, topt, js, ts, jsrc, tsrc = S._pair(rng)
    for _ in range(2):  # one state carried across epochs
        js, jmet = jM.motion_epoch_streaming(js, jsrc, jm, jopt, 0.1)
        ts, tmet = graphs.motion_epoch_streaming(ts, tsrc, tm, topt, 0.1,
                                                 use_kernels=True)
        ref = S._jax_to_numpy(js)
        for name, val in tM.state_to_numpy(ts).items():
            if name == "count":
                assert int(val) == int(ref[name])
            else:
                S.close(val, ref[name])
        for key in ("recon_mse", "reg"):
            S.close(tmet[key], jmet[key])
    (entry,) = graphs.entries()
    assert entry.replays == 2 * BLOCKS


@pytest.mark.parametrize("mode", ["exact", "analytic"])
@pytest.mark.parametrize("sigma_axes", [1, 3])
def test_grams_streaming_through_the_cache_match_jax(rng, mode, sigma_axes):
    jm, tm, _, _, js, ts, jsrc, tsrc = S._pair(rng, sigma_axes)
    g_r, c1_r = jM.compute_grams_streaming(js, jsrc, jm, gram_mode=mode)
    g, c1 = graphs.compute_grams_streaming(ts, tsrc, tm, use_kernels=True,
                                           gram_mode=mode)
    S.close(g, g_r)
    S.close(c1, c1_r)
    (entry,) = graphs.entries()
    assert entry.replays == BLOCKS


@pytest.mark.parametrize("solver", ["mu", "fista"])
def test_refined_rounds_streaming_through_the_cache_match_jax(rng, solver):
    jm, tm, _, _, js, ts, jsrc, tsrc = S._pair(rng)
    kw = dict(trace_solver=solver, **REFINE)
    st_j, pos_j, m_j = jR.refined_rounds_streaming(js, jsrc, jm, **kw)
    st_t, pos_t, m_t = graphs.refined_rounds_streaming(
        ts, tsrc, tm, use_kernels=True, **kw)
    if solver == "mu":
        np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st_t.c.numpy(), np.asarray(st_j.c),
                                   rtol=1e-5, atol=1e-6)
        S.close(m_t["recon_mse"], m_j["recon_mse"])
    else:  # held at 1e-4 of the max, as test_torch_port_streaming.py does
        S.close(pos_t, pos_j, 1e-4)
        S.close(st_t.c, st_j.c, 1e-4)
    (entry,) = graphs.entries()
    assert entry.replays == BLOCKS


# ------------------------------------------------------------------ routing
def _engine(rng, mesh_time=None, **opt):
    """A port engine with the kernels' route (their plain versions on CPU
    tensors) and a ``StreamingVideo`` of its recording."""
    _, tm, *_ = S._pair(rng)
    pos = rng.uniform([2, 2, 0.5], [13, 9, 2.5], (S.K, 3)).astype(np.float32)
    eng = ttr.DeformableNMF(
        tm, tcfg.OptimizerConfig(learning_rate=1e-3, outer_rounds=2,
                                 motion_epochs=2, mu_iters=20,
                                 gamma_motion=0.1, **opt),
        tcfg.RuntimeConfig(frame_block=S.BLOCK, use_kernels=True,
                           mesh_time=mesh_time),
        positions=pos, device="cpu")
    return eng, tS.StreamingVideo(S._video(rng, pos), block=S.BLOCK,
                                  device="cpu")


@pytest.mark.parametrize("motion_mode", ["parallel", "parity"])
def test_trainer_streamed_steps_go_through_the_cache(rng, motion_mode):
    """``fit`` (with the closed-form Grams' audit) and ``refine`` on a
    ``StreamingVideo`` replay the streamed entries once per block, bit
    for bit the same run inside ``graphs.disabled()``; in parity mode the
    streamed epoch is the parallel one, as in the JAX package."""
    runs = []
    for cached in (True, False):
        graphs.clear()
        eng, src = _engine(np.random.default_rng(3), motion_mode=motion_mode)
        with contextlib.nullcontext() if cached else graphs.disabled():
            eng.fit(src)
            res = eng.refine(src, rounds=2, epochs=3, mu_iters=5)
        runs.append((eng, res, {e.name: e.replays for e in graphs.entries()}))
    (eng, got, entries), (eng_e, ref, none) = runs
    assert none == {}
    # 2 rounds x 2 epochs, 2 Gram passes, one refinement: per block.
    assert entries == {"motion_epoch_streaming": 4 * BLOCKS,
                       "compute_grams_streaming": 2 * BLOCKS,
                       "footprint_update": 2,
                       "refined_rounds_streaming": BLOCKS}
    assert _same(got.state, ref.state) and torch.equal(eng.pos_t, eng_e.pos_t)
    strip = [[{k: v for k, v in m.items() if k != "seconds"}
              for m in r.metrics] for r in (got, ref)]
    assert strip[0] == strip[1]


def test_streamed_fit_on_a_mesh_stays_eager(tmp_path, rng):
    """On a one-rank ``gloo`` mesh a streamed ``fit`` runs the sharded
    streamed steps through the mesh's entries (one per step, replayed
    once per block), bit for bit the ``graphs.disabled()`` run, which
    makes none."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    runs = []
    try:
        for cached in (True, False):
            graphs.clear()
            eng, src = _engine(np.random.default_rng(3), mesh_time=1)
            with contextlib.nullcontext() if cached else graphs.disabled():
                res = eng.fit(src)
            runs.append((res, {e.name: e.replays for e in graphs.entries()}))
    finally:
        dist.destroy_process_group()
    (got, entries), (ref, none) = runs
    assert none == {}
    # 2 rounds x 2 epochs and 2 Gram passes per block; 2 trace updates.
    assert entries == {"sharded_motion_epoch_streaming": 4 * BLOCKS,
                       "sharded_compute_grams_streaming": 2 * BLOCKS,
                       "sharded_mu": 2}
    assert _same(got.state, ref.state)
