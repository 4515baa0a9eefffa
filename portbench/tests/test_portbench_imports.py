"""What the benchmark may load: no module under portbench/ imports JAX, flax
or the JAX package, compared by whole top-level name (the port's name
begins with the JAX package's), and the reference imports nothing of the
system under test."""

import ast
import os
import sys
import types

from portbench.lib.result import FORBIDDEN, forbidden_modules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "iv_slam_tpu_torch"


def _imports(path):
    """Top-level names of every import in the file; relative imports are
    the benchmark's own."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def _modules(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, HERE), name) for p in _modules(HERE)
             for name in _imports(p) if name in FORBIDDEN}
    assert not found
    # the port itself is imported, by its whole name
    assert any(name == PORT for p in _modules(os.path.join(HERE, "drivers"))
               for name in _imports(p))


def test_the_reference_imports_nothing_of_the_system_under_test():
    ref = os.path.join(HERE, "reference")
    found = {(os.path.relpath(p, HERE), name) for p in _modules(ref) for name in _imports(p)
             if name == PORT or name in FORBIDDEN}
    assert not found
    allowed = {"__future__", "contextlib", "dataclasses", "functools", "math", "os", "types",
               "typing", "numpy", "torch"}
    assert {name for p in _modules(ref) for name in _imports(p)} <= allowed


def test_loaded_modules_are_matched_by_whole_top_level_name():
    assert forbidden_modules([PORT, PORT + ".slam", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "iv_slam_tpu.ops", "flax", "jaxlib"]) == [
        "flax", "iv_slam_tpu.ops", "jax.numpy", "jaxlib"]


def test_a_run_that_loaded_jax_prints_no_result(tiny, monkeypatch):
    from portbench.tests.conftest import run_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run_cell(tiny, "costmap.kitti", seconds=0.2)
    assert rc == 4 and line is None
