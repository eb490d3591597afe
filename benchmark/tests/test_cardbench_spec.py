"""The harness finds a cell's configuration, traffic mix, limits and
metrics by name, from new files alone."""

import importlib.util
import json
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _spec_of(root):
    spec = importlib.util.spec_from_file_location(
        "copied_spec", root / "benchmark" / "cardbench" / "spec.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_cell_and_metric_of_the_manifest_is_found():
    from cardbench import spec

    man = spec.manifest()
    for w in man["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config_spec"]["name"] == w["config"]
        assert set(cell["limits"]["limits"]) >= {"loss_err", "beta_err",
                                                 "c_err", "audit_gap"}
        names = {m["name"] for m in cell["end_to_end"]}
        assert names >= {"setup_s", "frames_per_s"}
        assert cell["per_layer"]
        # each per-layer metric moves an end-to-end metric the cell reports
        assert {m["moves"] for m in cell["per_layer"]} <= names
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_and_metric_are_found_from_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "roi_k50.json").read_text())
    cfg.update(name="roi_k30", num_neurons=30)
    (b / "configs" / "roi_k30.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "demix.json").read_text())
    traffic["optimizer"]["mu_iters"] = 20
    (b / "traffic" / "short_mu.json").write_text(json.dumps(traffic))
    (b / "limits" / "roi30_short_mu.json").write_text(
        (b / "limits" / "roi_demix.json").read_text())
    (b / "metrics" / "jobs_in_window.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    man["configs"].append({"name": "roi_k30", "source": "x",
                           "file": "benchmark/configs/roi_k30.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "roi30_short_mu", "config": "roi_k30",
                             "traffic": "short_mu", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine", "moves": "frames_per_s",
                             "workloads": ["roi30_short_mu"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    spec = _spec_of(tmp_path)
    cell = spec.cell("roi30_short_mu")
    assert cell["config_spec"]["num_neurons"] == 30
    assert cell["traffic_spec"]["optimizer"]["mu_iters"] == 20
    assert [m["name"] for m in cell["per_layer"]] == ["jobs_in_window"]

    class Run:
        jobs = [1, 2, 3]

    assert spec.reader("jobs_in_window")(Run()) == 3.0
    # the cells already there are untouched by the addition
    assert "jobs_in_window" not in [m["name"] for m in
                                    spec.cell("roi_demix")["per_layer"]]
