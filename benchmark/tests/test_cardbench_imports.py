"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
references import nothing of the measured package: each module's
top-level name, the part before the first dot, compared whole."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "dnmf_tpu"}


def _top_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(set(_top_names(p))
                                               & FORBIDDEN)
             for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # The port's name begins with the JAX package's: a prefix test would
    # refuse it, a whole-name test does not.
    assert "dnmf_tpu_torch" not in FORBIDDEN


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "references").glob("*.py"):
        assert "dnmf_tpu_torch" not in set(_top_names(path)), path


def test_the_harness_refuses_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    import dnmf_tpu_torch  # noqa: F401
    from cardbench import harness

    monkeypatch.delitem(sys.modules, "dnmf_tpu", raising=False)
    assert "dnmf_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dnmf_tpu.engine",
                        types.ModuleType("dnmf_tpu.engine"))
    assert "dnmf_tpu" in harness.forbidden_modules()
