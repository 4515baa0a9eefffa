"""The cell's specification, found by name: its entry in BENCHMARK.json,
its configuration file, its workload file (traffic parameters and the name
of its driver), and the metrics it reports."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # portbench/
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, root: str = ROOT, here: str = HERE) -> dict:
    """{here, cell, config, workload, end_to_end, per_layer} of the named cell;
    KeyError when BENCHMARK.json does not name it."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return dict(
        here=here,
        cell=cell,
        config=load_json(os.path.join(root, conf["file"])),
        workload=load_json(os.path.join(here, "workloads", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_module(kind: str, name: str, here: str = HERE) -> ModuleType:
    """portbench/<kind>/<name>.py as a module of the package portbench.<kind>
    (drivers and metric readers are found by name; a name may hold dots)."""
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # worker processes find their entry by this name
    spec.loader.exec_module(mod)
    return mod
