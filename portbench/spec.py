"""Where the benchmark finds each piece by its name.

- ``BENCHMARK.json`` at the root of the checkout: the cells and metrics;
- ``portbench/configs/<config>.json``: a configuration's sizes;
- ``portbench/traffic/<traffic>.json``: a traffic mix's parameters, whose
  ``kind`` names its driver, ``portbench/drivers/<kind>.py``;
- ``portbench/limits/<cell>.json``: the limit of each number a cell's
  check compares;
- ``portbench/metrics/<metric>.py``: the reader of a per-layer metric.

A later change adds a cell, a configuration, a mix or a metric by adding
files of these names.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, pkg: str = PKG) -> dict:
    return _json(os.path.join(pkg, "configs", name + ".json"))


def traffic(name: str, pkg: str = PKG) -> dict:
    return _json(os.path.join(pkg, "traffic", name + ".json"))


def limits(cell: str, pkg: str = PKG) -> dict:
    return _json(os.path.join(pkg, "limits", cell + ".json"))


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{kind}")


def metric_reader(name: str, pkg: str = PKG) -> ModuleType:
    """The module ``portbench/metrics/<name>.py`` (a name may hold dots)."""
    path = os.path.join(pkg, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, bench: dict, group: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports: those
    that list it under ``workloads``, and those with no such list."""
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]
