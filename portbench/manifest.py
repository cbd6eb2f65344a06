"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells, the metrics and
the configurations.  A cell names a configuration and a traffic mix; each
is a file of its own, found by that name:

* ``portbench/configs/<config>.json``: the deployment's sizes and settings;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, among them
  ``driver``, the module ``portbench/traffic/<driver>.py`` that drives the
  program under that mix;
* ``portbench/limits/<cell>.json``: the limits of its correctness check;
* ``portbench/metrics/<metric>.py``: each per-layer metric's reader.

A later cell, mix, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "configs", f"{name}.json"))


def traffic(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, here: str = HERE):
    return _module(os.path.join(here, "traffic", f"{name}.py"), f"portbench_driver_{name}")


def reader(metric: str, here: str = HERE):
    safe = metric.replace(".", "_").replace("-", "_")
    return _module(os.path.join(here, "metrics", f"{metric}.py"), f"portbench_metric_{safe}")


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and those
    that list no cells and move an end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]
