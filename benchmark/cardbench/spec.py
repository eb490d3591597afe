"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells; each one's
configuration, traffic mix, limits and metrics are files of their own,
found by name, so a cell or a metric is added by adding files:

* ``configs/<config>.json``: the recording's sizes, ``source``,
  ``assumed``, ``reduced``, the engine's ``runtime`` settings and the name
  of its plain reference (``references/<reference>.py``);
* ``traffic/<traffic>.json``: the job's schedule (``optimizer``,
  ``runtime``, and ``refine`` where ``refine`` follows the fit);
* ``limits/<workload>.json``: the correctness check's frames and limits;
* ``metrics/<metric>.py``: a reader ``read(run) -> float or None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(workload: str) -> dict:
    """The workload's entry with its ``config`` and ``traffic`` files
    loaded, its ``limits`` and the metrics it reports."""
    man = manifest()
    found = [w for w in man["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = dict(found[0])
    cfg = [c for c in man["configs"] if c["name"] == entry["config"]][0]
    entry["config_spec"] = _json(ROOT / cfg["file"])
    entry["traffic_spec"] = _json(BENCH / "traffic" /
                                  f"{entry['traffic']}.json")
    entry["limits"] = _json(BENCH / "limits" / f"{workload}.json")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    entry["end_to_end"] = [m for m in man["end_to_end"] if mine(m)]
    entry["per_layer"] = [m for m in man["per_layer"] if mine(m)]
    entry["run_seconds"] = man["run_seconds"]
    return entry


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return load_module("metrics", metric).read
