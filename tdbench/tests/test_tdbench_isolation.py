"""Nothing the benchmark runs loads JAX or the JAX package: the run's
check on whole top-level names, and the sources' imports."""
import ast
import os
import sys
import types

import pytest

from tdbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TDB = os.path.join(ROOT, "tdbench")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(TDB, sub)):
        if "tests" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("name,bad", [("repro", True), ("repro.core", True),
                                      ("jax", True), ("jaxlib.xla", True),
                                      ("flax", True), ("repro_torch", False),
                                      ("repro_torch.models", False),
                                      ("jaxtyping", False)])
def test_the_check_compares_whole_top_level_names(name, bad, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness._isolation()) == bad


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("repro_torch",) + harness.FORBIDDEN, \
                (path, mod)
            assert not mod.startswith("tdbench.") or \
                mod.startswith("tdbench.reference"), (path, mod)
