"""Rank workers of the port's process-group tests (imports no JAX).

The tests of ``tests/test_torch_port_parallel*.py`` compute the JAX
package's sharded results on its 8-virtual-device CPU mesh, and hand the
same NumPy inputs to :func:`spawn`, which starts a ``gloo`` process group
of CPU ranks (``init_method=file://``, so concurrent test processes do
not share a port) that runs the port's sharded functions, case by case,
in one start-up.  Rank 0's results (whole arrays, gathered over the mesh)
come back as NumPy.  A case that raises on every rank comes back as
``{"error": traceback}``; a rank that dies, or a run past its time limit,
fails the spawn.  The ``captured_*`` cases of
``tests/test_torch_port_graphs_mesh.py`` run their call through the graph
cache and inside ``graphs.disabled()`` on every rank
(:func:`_captured_and_eager`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dnmf_tpu_torch import config as tcfg
from dnmf_tpu_torch import parallel
from dnmf_tpu_torch.data.streaming import StreamingVideo, open_memmap_video
from dnmf_tpu_torch.engine import trainer as ttr
from dnmf_tpu_torch.models import dnmf as tM
from dnmf_tpu_torch.parallel import mesh as mesh_lib

COLLECTIVE_TIMEOUT_S = 60


def spawn(cases, world: int, tmp_path, timeout: float = 300.0) -> dict:
    """Run ``cases`` (``[(name, case function name, inputs)]``) on
    ``world`` CPU ranks; returns ``{name: rank 0's result}``."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world} ranks ran past {timeout} s")
    with open(tmp / "results.pkl", "rb") as f:
        return pickle.load(f)


def _rank_main(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/pg", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = {}
    for name, fn, inp in cases:
        try:
            results[name] = globals()[fn](inp)
        except Exception:  # noqa: BLE001 — reported to the test
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        with open(os.path.join(tmp, "results.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------- helpers
def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _model(inp) -> tcfg.ModelConfig:
    kw = dict(inp["model"])
    deform = kw.pop("deformation", None)
    if deform is not None:
        kw["deformation"] = tcfg.DeformationConfig(**deform)
    return tcfg.ModelConfig(**kw)


def _mesh(inp):
    b, t, p = inp["mesh"]
    return parallel.make_mesh(num_time=t, num_batch=b, num_pixel=p)


def _whole_state(state, mesh) -> dict:
    return tM.state_to_numpy(parallel.gather_state(state, mesh))


# --------------------------------------------------------------- cases
def motion(inp):
    """``sharded_motion_epoch`` from the given state and video."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)
    state, m = parallel.sharded_motion_epoch(
        state, video, model, tM.Adam(inp["lr"]), inp["gamma"], mesh,
        frame_block=inp["frame_block"], use_kernels=inp.get("use_kernels",
                                                            False))
    out = _whole_state(state, mesh)
    out.update({k: float(v) for k, v in m.items()})
    return out


def grams(inp):
    """``sharded_compute_grams``: the whole recording's ``(G, c1)``."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)
    g, c1 = parallel.sharded_compute_grams(
        state, video, model, mesh, frame_block=inp["frame_block"],
        use_kernels=inp.get("use_kernels", False),
        gram_mode=inp.get("gram_mode", "exact"))
    return {"grams": _np(parallel.gather_time(g, mesh)),
            "c1": _np(parallel.gather_time(c1, mesh))}


def footprint(inp):
    """``sharded_footprint_update`` on given Grams: the whole ``C``."""
    mesh = _mesh(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    f = mesh_lib.video_sharding(mesh).frames(inp["grams"].shape[0])
    out = {}
    for label, (iters, gamma, solver) in inp["runs"].items():
        st = parallel.sharded_footprint_update(
            state, torch.as_tensor(inp["grams"])[f].contiguous(),
            torch.as_tensor(inp["c1"])[f].contiguous(), mesh, iters=iters,
            gamma=gamma, solver=solver)
        out[label] = _np(parallel.gather_time(st.c, mesh, dim=1))
    return out


def tp_round(inp):
    """Grams on a (time x pixel) mesh, then the halo'd trace update."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)
    g, c1 = parallel.sharded_compute_grams(state, video, model, mesh,
                                           frame_block=inp["frame_block"])
    st = parallel.sharded_footprint_update(state, g, c1, mesh,
                                           iters=inp["iters"],
                                           gamma=inp["gamma"])
    return {"c": _np(parallel.gather_time(st.c, mesh, dim=1))}


def refine(inp):
    """``sharded_refined_rounds``: whole ``pos_t``, ``C`` and the
    per-frame ``recon_mse``."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)
    st, pos_t, m = parallel.sharded_refined_rounds(
        state, video, model, mesh, use_kernels=inp.get("use_kernels", False),
        **inp["kw"])
    return {"pos_t": _np(parallel.gather_time(pos_t, mesh)),
            "c": _np(parallel.gather_time(st.c, mesh, dim=1)),
            "recon_mse": _np(parallel.gather_time(m["recon_mse"], mesh))}


def engine(inp):
    """A ``DeformableNMF`` on a mesh, from the given initial state, through
    ``inp["calls"]``: whole beta, C (and ``pos_t`` after a refine)."""
    model = _model(inp)
    eng = ttr.DeformableNMF(model, tcfg.OptimizerConfig(**inp["opt"]),
                            tcfg.RuntimeConfig(**inp["runtime"]),
                            device="cpu")
    eng.state = parallel.shard_state(tM.state_from_numpy(inp["state"]),
                                     eng._mesh)
    eng._base_sigma = eng.state.sigma
    video = inp["video"]
    if inp.get("stream_block"):
        video = StreamingVideo(video, block=inp["stream_block"],
                               device="cpu")
    out = {"gram_mode": eng._gram_mode, "after": []}
    for method, kw in inp["calls"]:
        res = getattr(eng, method)(video, **kw)
        snap = _whole_state(eng.state, eng._mesh)
        if eng.pos_t is not None:
            snap["pos_t"] = _np(parallel.gather_time(eng.pos_t, eng._mesh))
        if isinstance(res, ttr.FitResult):
            snap["result"] = tM.state_to_numpy(res.state)
        out["after"].append(snap)
    out["metrics"] = eng.metrics
    out["positions"] = eng.positions_all()
    return out


def mesh_shapes(inp):
    """Axis sizes of ``make_mesh`` for each requested shape, and this
    rank's helpers."""
    out = {}
    for shape in inp["shapes"]:
        b, t, p = shape
        m = parallel.make_mesh(num_time=t, num_batch=b, num_pixel=p)
        out[shape] = {a: mesh_lib.axis_size(m, a) for a in mesh_lib.AXES}
    out["is_distributed"] = parallel.is_distributed()
    out["summary"] = parallel.process_summary()
    return out


def shard_fields(inp):
    """How ``shard_state`` treats each field, and that ``gather_state``
    restores the whole state."""
    mesh = _mesh(inp)
    full = tM.state_from_numpy(inp["state"])
    loc = parallel.shard_state(full, mesh)
    back = parallel.gather_state(loc, mesh)
    return {"local_shapes": {n: tuple(getattr(loc, n).shape)
                             for n in tM.STATE_FIELDS},
            "roundtrip": {n: bool(torch.equal(getattr(back, n),
                                              getattr(full, n)))
                          for n in tM.STATE_FIELDS}}


def batched(inp):
    """``batched_round`` with the recordings split over a batch axis."""
    mesh, model = _mesh(inp), _model(inp)
    states = parallel.stack_states([tM.state_from_numpy(s)
                                    for s in inp["states"]])
    new, m = parallel.batched_round(
        states, torch.as_tensor(inp["videos"]), model, tM.Adam(inp["lr"]),
        inp["gamma"], inp["mu_iters"], frame_block=inp["frame_block"],
        mesh=mesh)
    return {"beta": _np(new.beta), "c": _np(new.c),
            "recon_mse": _np(m["recon_mse"])}


def stream(inp):
    """Sharded streamed epoch and Grams over a ``StreamingVideo`` (or a
    memmap of it), then the halo'd trace update."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    if inp.get("memmap"):
        path = inp["memmap"]
        if dist.get_rank() == 0:
            mm = np.memmap(path, dtype=np.float32, mode="w+",
                           shape=inp["video"].shape)
            mm[:] = inp["video"]
            mm.flush()
        dist.barrier()
        src = open_memmap_video(path, inp["video"].shape,
                                block=inp["block"], device="cpu")
    else:
        src = StreamingVideo(inp["video"], block=inp["block"], device="cpu")
    kw = dict(use_kernels=inp.get("use_kernels", False))
    state, m = parallel.sharded_motion_epoch_streaming(
        state, src, model, tM.Adam(inp["lr"]), inp["gamma"], mesh, **kw)
    out = _whole_state(state, mesh)
    out["recon_mse"] = m["recon_mse"]
    if inp.get("grams", True):
        g, c1 = parallel.sharded_compute_grams_streaming(state, src, model,
                                                         mesh, **kw)
        out["grams"] = _np(parallel.gather_time(g, mesh))
        out["c1"] = _np(parallel.gather_time(c1, mesh))
        if inp.get("mu_iters"):
            st = parallel.sharded_footprint_update(
                state, g, c1, mesh, iters=inp["mu_iters"],
                gamma=inp["mu_gamma"])
            out["c_final"] = _np(parallel.gather_time(st.c, mesh, dim=1))
    return out


def stream_guard(inp):
    """The sharded streamed epoch of a resampled model on a pixel mesh:
    its error message."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    src = StreamingVideo(inp["video"], block=4, device="cpu")
    try:
        parallel.sharded_motion_epoch_streaming(
            state, src, model, tM.Adam(1e-3), 0.1, mesh)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def checkpoint(inp):
    """Save on a time mesh after one sharded epoch; restore onto the mesh
    and continue; the restored whole state and the continued beta."""
    model = _model(inp)
    opt = tcfg.OptimizerConfig(learning_rate=inp["lr"], motion_epochs=1,
                               gamma_motion=0.1)
    rt = tcfg.RuntimeConfig(mesh_time=inp["mesh"][1], frame_block=4)
    eng = ttr.DeformableNMF(model, opt, rt, device="cpu")
    eng.state = parallel.shard_state(tM.state_from_numpy(inp["state"]),
                                     eng._mesh)
    eng.update_motion(inp["video"], epochs=1)
    saved = _whole_state(eng.state, eng._mesh)
    eng.save(inp["path"])
    fresh = ttr.DeformableNMF(model, opt, rt, device="cpu")
    fresh.restore(inp["path"])
    restored = _whole_state(fresh.state, fresh._mesh)
    fresh.update_motion(inp["video"], epochs=1)
    return {"saved": saved, "restored": restored,
            "continued": _whole_state(fresh.state, fresh._mesh)["beta"]}


def register(inp):
    """``sharded_register_rigid`` / ``_pwrigid``: template, whole
    corrected movie and shifts."""
    mesh = _mesh(inp)
    cfg = tcfg.RegistrationConfig(**inp["cfg"])
    fn = getattr(parallel, inp["fn"])
    templ, corrected, shifts = fn(inp["video"], cfg, mesh,
                                  template=inp["template"], device="cpu")
    return {"template": _np(templ),
            "corrected": _np(parallel.gather_time(
                torch.from_numpy(corrected), mesh)),
            "shifts": _np(parallel.gather_time(torch.from_numpy(
                np.ascontiguousarray(shifts)), mesh))}


def pod_check(inp):
    """The port's pod checks on this group: the failed checks' names."""
    from dnmf_tpu_torch.tools import pod_check as pc

    return {"failed": pc.run_all(device="cpu", verbose=False)}


# ------------------------------------------- the captured mesh steps
def _same(a, b) -> bool:
    """Bit-for-bit equality of nested results (dicts, sequences, tensors,
    arrays, numbers)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(_np(a), _np(b))


def _captured_and_eager(run) -> dict:
    """``run()`` through the graph cache, every replay under the host
    probe (``tests/torch_host_probe.py``), then again inside
    ``graphs.disabled()``.  Returns the captured result and, from every
    rank: whether the two runs are equal bit for bit, the entries made
    (``(name, replays)``) and the probe's hits."""
    from torch_host_probe import probed_replays

    from dnmf_tpu_torch.models import graphs

    graphs.clear()
    with probed_replays() as hits:
        got = run()
    entries = sorted((e.name, e.replays) for e in graphs.entries())
    graphs.clear()
    with graphs.disabled():
        ref = run()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, (_same(got, ref), entries, hits))
    return {"got": got, "equal": [r[0] for r in ranks],
            "entries": [r[1] for r in ranks],
            "hits": [h for r in ranks for h in r[2]]}


def captured_steps(inp):
    """The sharded epoch, Grams and trace updates with the kernels (the
    step runner ``graphs.mesh_steps(True)``), captured and eager."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)
    f = mesh_lib.video_sharding(mesh).frames(inp["grams"].shape[0])
    grams = torch.as_tensor(inp["grams"])[f].contiguous()
    c1 = torch.as_tensor(inp["c1"])[f].contiguous()

    def run():
        st, m = parallel.sharded_motion_epoch(
            state, video, model, tM.Adam(inp["lr"]), inp["gamma"], mesh,
            frame_block=inp["frame_block"], use_kernels=True)
        out = _whole_state(st, mesh)
        out.update({k: float(v) for k, v in m.items()})
        g, c = parallel.sharded_compute_grams(
            state, video, model, mesh, frame_block=inp["frame_block"],
            use_kernels=True, gram_mode=inp["gram_mode"])
        out["grams"] = _np(parallel.gather_time(g, mesh))
        out["c1"] = _np(parallel.gather_time(c, mesh))
        for label, (iters, gamma, solver) in inp["runs"].items():
            st = parallel.sharded_footprint_update(
                state, grams, c1, mesh, iters=iters, gamma=gamma,
                solver=solver, use_kernels=True)
            out[label] = _np(parallel.gather_time(st.c, mesh, dim=1))
        return out

    return _captured_and_eager(run)


def _source(inp):
    """The streamed source of a case: a ``StreamingVideo`` of the array,
    or a ``RawFileVideo`` of it that rank 0 writes."""
    from dnmf_tpu_torch.data.streaming import RawFileVideo

    video = inp["video"]
    if not inp.get("raw"):
        return StreamingVideo(video, block=inp["block"], device="cpu")
    if dist.get_rank() == 0:
        video.tofile(inp["raw"])
    dist.barrier()
    return RawFileVideo(inp["raw"], video.shape, block=inp["block"],
                        device="cpu")


def captured_stream(inp):
    """The sharded streamed epoch and Grams, then the halo'd trace update,
    with the kernels, captured and eager."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    src = _source(inp)

    def run():
        st, m = parallel.sharded_motion_epoch_streaming(
            state, src, model, tM.Adam(inp["lr"]), inp["gamma"], mesh,
            use_kernels=True)
        out = _whole_state(st, mesh)
        out["recon_mse"] = m["recon_mse"]
        g, c1 = parallel.sharded_compute_grams_streaming(
            st, src, model, mesh, use_kernels=True)
        out["grams"] = _np(parallel.gather_time(g, mesh))
        out["c1"] = _np(parallel.gather_time(c1, mesh))
        st = parallel.sharded_footprint_update(
            st, g, c1, mesh, iters=inp["mu_iters"], gamma=inp["mu_gamma"],
            use_kernels=True)
        out["c_final"] = _np(parallel.gather_time(st.c, mesh, dim=1))
        return out

    return _captured_and_eager(run)


def captured_engine(inp):
    """A ``DeformableNMF`` on a mesh with the kernels (their plain versions
    on the CPU) through ``inp["calls"]``, captured and eager: the whole
    state and ``pos_t`` after each call, and the metrics without their
    seconds."""
    model = _model(inp)

    def run():
        eng = ttr.DeformableNMF(
            model, tcfg.OptimizerConfig(**inp["opt"]),
            tcfg.RuntimeConfig(use_kernels=True, **inp["runtime"]),
            device="cpu")
        eng.state = parallel.shard_state(
            tM.state_from_numpy(inp["state"]), eng._mesh)
        eng._base_sigma = eng.state.sigma
        video = _source(inp) if inp.get("block") else inp["video"]
        after = []
        for method, kw in inp["calls"]:
            getattr(eng, method)(video, **kw)
            snap = _whole_state(eng.state, eng._mesh)
            if eng.pos_t is not None:
                snap["pos_t"] = _np(parallel.gather_time(eng.pos_t,
                                                         eng._mesh))
            after.append(snap)
        metrics = [{k: v for k, v in m.items() if k != "seconds"}
                   for m in eng.metrics]
        return {"after": after, "metrics": metrics}

    return _captured_and_eager(run)


def captured_register(inp):
    """``sharded_register_rigid`` / ``_pwrigid``, each rank's frame blocks
    through the registration entries, captured and eager."""
    mesh = _mesh(inp)
    cfg = tcfg.RegistrationConfig(**inp["cfg"])
    fn = getattr(parallel, inp["fn"])

    def run():
        templ, corrected, shifts = fn(inp["video"], cfg, mesh,
                                      template=inp["template"], device="cpu")
        return {"template": _np(templ),
                "corrected": _np(parallel.gather_time(
                    torch.from_numpy(corrected), mesh)),
                "shifts": _np(parallel.gather_time(torch.from_numpy(
                    np.ascontiguousarray(shifts)), mesh))}

    return _captured_and_eager(run)


def captured_batched(inp):
    """``batched_round`` over a batch axis with the kernels, each rank's
    recordings one replay, captured and eager."""
    mesh, model = _mesh(inp), _model(inp)
    states = parallel.stack_states([tM.state_from_numpy(s)
                                    for s in inp["states"]])

    def run():
        new, m = parallel.batched_round(
            states, torch.as_tensor(inp["videos"]), model,
            tM.Adam(inp["lr"]), inp["gamma"], inp["mu_iters"],
            frame_block=inp["frame_block"], use_kernels=True, mesh=mesh)
        return {"beta": _np(new.beta), "c": _np(new.c),
                "recon_mse": _np(m["recon_mse"])}

    return _captured_and_eager(run)


def captured_refine(inp):
    """``sharded_refined_rounds`` with the kernels (through
    ``graphs.refined_rounds``), captured and eager."""
    mesh, model = _mesh(inp), _model(inp)
    state = parallel.shard_state(tM.state_from_numpy(inp["state"]), mesh)
    video = parallel.shard_video(torch.as_tensor(inp["video"]), mesh)

    def run():
        st, pos_t, m = parallel.sharded_refined_rounds(
            state, video, model, mesh, use_kernels=True, **inp["kw"])
        return {"pos_t": _np(parallel.gather_time(pos_t, mesh)),
                "c": _np(parallel.gather_time(st.c, mesh, dim=1)),
                "recon_mse": _np(parallel.gather_time(m["recon_mse"],
                                                      mesh))}

    return _captured_and_eager(run)


def probe_collectives(inp):
    """The host probe around the mesh's collectives: the ops it logs."""
    from torch_host_probe import HostProbe

    mesh = _mesh(inp)
    x = torch.arange(4.0)
    with HostProbe() as probe:
        mesh_lib.all_reduce(x, mesh, mesh_lib.TIME_AXIS)
        mesh_lib.all_gather(x, mesh, mesh_lib.TIME_AXIS)
    return {"ops": sorted({op for op, _ in probe.hits})}
