"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's ``or4d_tpu_torch`` begins with the JAX
package's ``or4d_tpu``); nothing under ``reference/`` imports the program;
and the run's own look at ``sys.modules`` compares names the same way."""

from __future__ import annotations

import ast
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "or4d_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _files():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p.relative_to(BENCH), m) for p in _files() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p.name, m) for p in (BENCH / "reference").rglob("*.py") for m in _imports(p)
           if m.split(".")[0] == "or4d_tpu_torch"]
    assert not bad, bad


def test_the_port_is_not_taken_for_the_jax_package(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "or4d_tpu_torch_fixture", object())
    assert "or4d_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "or4d_tpu.models", object())
    assert run.forbidden_modules() == ["or4d_tpu"]
