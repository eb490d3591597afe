"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the recording on the card from the seed, builds the engine's
configuration from the cell's files and runs one warm-up round: the
kernel library's build or load, every captured graph of the job, the
audit's eager Gram; where the traffic has ``refine``, one round of the
refinement after it, which captures the refinement's graphs.  Where the
configuration has ``storage``, set-up first writes the recording to a
raw float32 file in memory and frees the card's copy, and every ``fit``
streams the file through the program's own reader (:func:`fit_source`).
The window then runs whole jobs, each a new ``DeformableNMF`` and one
``fit`` over the same recording (then ``refine`` with the traffic's
``refine`` arguments, where it has them), until ``--seconds`` have
passed; the last job ends past that.  ``--trace 1`` adds the spans of
:mod:`cardbench.trace` to the window and profiles one more whole job
after it, the spans still in place to name its idle gaps.  Then the
program's state is freed and every job is checked
(:mod:`cardbench.check`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import List, Optional

import torch

from cardbench import check, recording, roofline, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "dnmf_tpu")


@dataclasses.dataclass
class Job:
    beta: torch.Tensor
    c: torch.Tensor
    metrics: list
    pos_t: Optional[torch.Tensor] = None  # [T, K, 3] after a refinement

    @property
    def rounds(self) -> List[dict]:
        return [m for m in self.metrics if m.get("phase") == "round"]

    @property
    def refine_rounds(self) -> int:
        return sum(int(m["rounds"]) for m in self.metrics
                   if m.get("phase") == "refine")


class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.jobs: List[Job] = []
        self.frames = None  # T
        self.peak_reserved_bytes = None
        self.spans = None  # span name -> seconds over the window
        # a streamed source's reads in the window (cardbench.trace.Fills):
        # host seconds in its _fill and the bytes filled; None unstreamed
        self.fill_seconds = None
        self.fill_bytes = None
        self.entries = []  # graphs.entries() after set-up
        self.shared_bytes = 0
        self.profile: Optional[trace.Profile] = None
        self.launches = {}  # wrapper -> launches in the profiled job
        self.graph_launches = {}  # wrapper -> of them, by graph replays
        self.kernel_counts = {}  # wrapper -> what the count check read
        # (size, K, T, frame_block, pos, sigma, beta, pos_t): the profiled
        # job's work; pos_t None where it has no refinement
        self.work = None

    @property
    def round_seconds(self) -> List[float]:
        return [r["seconds"] for j in self.jobs for r in j.rounds]

    @property
    def refine_rounds(self) -> int:
        return sum(j.refine_rounds for j in self.jobs)

    @property
    def rounds_done(self) -> int:
        """The fit's rounds and the refinement's (``refine`` logs one
        entry with its ``rounds``)."""
        return len(self.round_seconds) + self.refine_rounds

    def kernel_roofline(self, wrapper: str, kernels,
                        tracked: bool = False) -> Optional[float]:
        """100 x the least time of the wrapper's passes in the profiled job
        over the device time of its kernels (``kernels``: substrings of the
        profiler's names).  A pass is one launch per ``frame_block`` over
        the anchors, or, ``tracked``, one launch over all the frames at
        the job's per-frame positions (the refinement's).  None where it
        launched nothing, or where the profile's count of any of those
        kernels differs from its launches (recorded in
        :attr:`kernel_counts`, never divided by)."""
        n = self.launches.get(wrapper, 0)
        if self.profile is None or not n:
            return None
        counted = {k: self.profile.kernel_count(k) for k in kernels}
        self.kernel_counts[wrapper] = {
            "launches": n, "by_graph_replays": self.graph_launches.get(
                wrapper, 0), "profiled": counted}
        if any(c != n for c in counted.values()):
            return None
        size, k, t, fb, pos, sigma, beta, pos_t = self.work
        if tracked and pos_t is None:
            return None
        blocks = ([t] if tracked
                  else [min(s + fb, t) - s for s in range(0, t, fb)])
        if n % len(blocks):
            return None
        passes = n // len(blocks)
        p = size[0] * size[1] * size[2]
        idx = torch.linspace(0, t - 1, 4).round().long()
        n1, n2 = roofline.active_pairs(
            beta[idx], pos_t[idx] if tracked else pos, sigma, size)
        n1, n2 = n1 / 4.0, n2 / 4.0  # per frame
        seconds = passes * sum(
            roofline.bound(roofline.kernel_bytes(wrapper, b, p, k),
                           roofline.footprint_flops(wrapper, b, p, n1 * b,
                                                    n2 * b))[0]
            for b in blocks)
        device = self.profile.kernel_seconds(kernels)
        return 100.0 * seconds / device if device > 0 else None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, t_process: float) -> int:
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        _say(f"needs {cell['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return run_cell(cell, args, t_process, torch.device("cuda"))


def engine_configs(cell: dict, seed: int):
    """The port's ``(ModelConfig, OptimizerConfig, RuntimeConfig)`` of the
    cell's configuration and traffic files."""
    from dnmf_tpu_torch import config as cfg_lib

    cfg, traffic = cell["config_spec"], cell["traffic_spec"]
    model = cfg_lib.ModelConfig(
        size=tuple(cfg["size"]), num_neurons=cfg["num_neurons"],
        num_frames=cfg["num_frames"], shape_std=cfg["shape_std"],
        deformation=cfg_lib.DeformationConfig(**cfg["deformation"]))
    opt = cfg_lib.OptimizerConfig(**traffic["optimizer"],
                                  seed=check.traffic_seed(seed))
    runtime = cfg_lib.RuntimeConfig(**{**cfg["runtime"],
                                       **traffic["runtime"]})
    return model, opt, runtime


def run_job(eng, source, refine: Optional[dict], device) -> Job:
    """One whole job on a new engine: ``fit``, then ``refine`` with the
    traffic's ``refine`` arguments where it has them."""
    res = eng.fit(source)
    if refine is not None:
        res = eng.refine(source, **refine)
    _sync(device)
    return Job(res.state.beta, res.state.c, res.metrics, eng.pos_t)


@contextlib.contextmanager
def fit_source(cell: dict, seed: int, device):
    """``(rec, source)``: the cell's recording, drawn on ``device`` from the
    seed, and what every ``fit`` of the run gets.  Without ``storage`` in
    the configuration both are the resident recording.  With it the
    recording is written to a raw float32 file in memory
    (:func:`cardbench.recording.store`), the card's copy freed, and the
    source is the program's reader over the file, opened as
    ``engine/pipeline.py`` takes a raw file (``open_raw_video``); on a card
    it has to be the native reader, never the memmap fallback.  The file
    and the reader are closed on exit, also when the run raises."""
    rec = recording.make(cell["config_spec"], seed, device)
    storage = cell["config_spec"].get("storage")
    if storage is None:
        yield rec, rec
        return
    from dnmf_tpu_torch.data import streaming

    rec = recording.store(rec, storage)
    source = None
    try:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        source = streaming.open_raw_video(
            rec.path, rec.shape, block=int(storage["block"]),
            num_threads=int(storage["reader_threads"]), device=device)
        kind = type(source).__name__
        if device.type == "cuda" and not isinstance(source,
                                                    streaming.RawFileVideo):
            raise RuntimeError(f"the fit's source is a {kind}: the native "
                               "block reader did not load")
        _say(f"fit source: {kind} over a raw float32 file of "
             f"{'x'.join(map(str, rec.shape))} in memory, block "
             f"{source.block}, {int(storage['reader_threads'])} reader "
             "threads")
        yield rec, source
    finally:
        if isinstance(source, streaming.RawFileVideo):
            source._reader.close()  # joins a prefetch still in flight
        rec.close()


def run_cell(cell: dict, args, t_process: float, device) -> int:
    with fit_source(cell, args.seed, device) as (rec, source):
        return _run(cell, args, t_process, device, rec, source)


def _run(cell: dict, args, t_process: float, device, rec, source) -> int:
    from dnmf_tpu_torch.engine.trainer import DeformableNMF
    from dnmf_tpu_torch.models import graphs
    from dnmf_tpu_torch.ops import fused

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run()
    cfg = cell["config_spec"]
    model, opt, runtime = engine_configs(cell, args.seed)
    run.frames = int(cfg["num_frames"])
    refine = cell["traffic_spec"].get("refine")
    streamed = source is not rec

    def engine():
        return DeformableNMF(model, opt, runtime, positions=rec.pos,
                             device=device, beta0=rec.beta0)

    def job() -> Job:
        return run_job(engine(), source, refine, device)

    # Warm-up: one round builds or loads the kernels and captures every
    # graph of the job (one round of the refinement captures its three);
    # set-up ends with it.
    warm = engine()
    warm.fit(source, rounds=1)
    if refine is not None:
        warm.refine(source, **{**refine, "rounds": 1})
    del warm
    _sync(device)
    gc.collect()
    setup_peak = _peak(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    run.entries = graphs.entries()
    run.shared_bytes = graphs.shared_bytes()
    spans = fills = None
    if args.trace:
        spans = trace.Spans(graphs)
        spans.install()
        if streamed:
            fills = trace.Fills(source)
            fills.install()
    t_window = time.perf_counter()
    run.setup_s = t_window - t_process
    while True:
        run.jobs.append(job())
        if time.perf_counter() - t_window >= args.seconds:
            break
    _sync(device)
    run.window_s = time.perf_counter() - t_window
    run.peak_reserved_bytes = _peak(device)
    window_rounds = run.rounds_done
    window_jobs = list(run.jobs)
    breakdown = None
    if args.trace:
        run.spans = spans.seconds()
        spans.clear()
        if fills is not None:
            run.fill_seconds, run.fill_bytes = fills.seconds, fills.bytes
            fills.clear()
        before = fused.launch_counts()
        replays = {id(e): e.replays for e in graphs.entries()}
        extra, run.profile = trace.profile(job)
        spans.uninstall()
        if fills is not None:
            fills.uninstall()
        run.launches = {k: n - before[k]
                        for k, n in fused.launch_counts().items()
                        if n != before[k]}
        for e in graphs.entries():
            for k, n in e.launches.items():
                run.graph_launches[k] = run.graph_launches.get(k, 0) + n * (
                    e.replays - replays.get(id(e), 0))
        run.jobs.append(extra)
        # a streamed pass launches once per block of the source
        run.work = (tuple(int(s) for s in cfg["size"]),
                    int(cfg["num_neurons"]), run.frames,
                    int(source.block if streamed else runtime.frame_block),
                    rec.pos,
                    float(cfg["shape_std"]), extra.beta, extra.pos_t)
        breakdown = {"device_ops": run.profile.top_ops(),
                     "idle_gaps": run.profile.idle_gaps()}
    memory_peak = max(setup_peak, run.peak_reserved_bytes)

    # The metrics, read before the program's state is freed.
    wanted = cell["per_layer"] if args.trace else cell["end_to_end"]
    all_jobs = run.jobs
    run.jobs = window_jobs
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if args.trace:
        _say("kernel count check (launches, of them by graph replays, "
             "profiled kernels): " + json.dumps(run.kernel_counts))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(memory_peak)}
    if args.trace:
        device_info["busy_s"] = run.profile.busy_s()
        device_info["window_s"] = run.profile.wall_s
    limit = power_limit()
    if limit:
        device_info["name_power_limit"] = limit

    # Free the program's state (the jobs keep their warps and traces),
    # then check every job.
    del run, window_jobs
    graphs.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    audits = sorted({f for j in all_jobs for f in check.audit_frames(
        j.metrics)})
    reference = check.Reference(cell, rec, args.seed, audits)
    gamma = cell["traffic_spec"]["optimizer"]["gamma_motion"]
    readings = check.worst([
        check.numbers(check.job_view(j, reference.frames, gamma), reference)
        for j in all_jobs])
    judged = check.verdict(readings, cell["limits"])
    _say(f"check: {len(all_jobs)} jobs, {len(reference.frames)} frames, "
         f"reference {time.perf_counter() - t_check:.3f} s")

    bad = forbidden_modules()
    if bad:
        _say(f"loaded in this process: {', '.join(bad)}")
        return 3
    result = {"correct": judged["correct"], "attempted": window_rounds,
              "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = judged["checks"]
    for name, c in judged["checks"].items():
        _say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0

