"""``demo_torch.py`` on the CPU prints the JAX demo's summary keys, and
neither it nor the port's package (nor ``chip_smoke.py``) imports JAX or
the JAX package."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUMMARY_KEYS = {"seconds", "final_recon_mse", "trace_corr_mean",
                "trace_corr_min", "trace_r2_mean"}


def _summary(stdout: str) -> dict:
    start = stdout.index("{")
    return json.loads(stdout[start:stdout.index("}", start) + 1])


def test_demo_small_on_the_cpu_prints_the_summary():
    out = subprocess.run(
        [sys.executable, str(ROOT / "demo_torch.py"), "--cpu", "--small",
         "--rounds", "2"], capture_output=True, text=True, cwd=ROOT,
        check=True, timeout=600).stdout
    summary = _summary(out)
    assert set(summary) == SUMMARY_KEYS
    assert all(isinstance(v, float) for v in summary.values())
    # demo.py prints the same keys (its summary dict, read from source).
    src = (ROOT / "demo.py").read_text()
    tree = ast.parse(src)
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "summary" for t in node.targets):
            keys = {k.value for k in node.value.keys}
    assert keys == SUMMARY_KEYS


def test_demo_flags_match_demo_py():
    def flags(path):
        tree = ast.parse(path.read_text())
        return {a.value for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                for a in node.args if isinstance(a, ast.Constant)}

    assert flags(ROOT / "demo.py") <= flags(ROOT / "demo_torch.py")


def test_demo_exits_nonzero_without_a_card():
    code = ("import torch, sys, runpy; "
            "torch.cuda.is_available = lambda: False; "
            f"sys.argv = ['demo_torch.py', '--small']; "
            f"runpy.run_path({str(ROOT / 'demo_torch.py')!r}, "
            "run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert res.returncode == 1
    assert "no CUDA device" in res.stderr
    assert "{" not in res.stdout


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("target", ["dnmf_tpu_torch", "demo_torch.py",
                                    "chip_smoke.py"])
def test_port_imports_no_jax(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "dnmf_tpu", "optax",
                            "orbax"}, f
