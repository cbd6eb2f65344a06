"""BENCHMARK.json against the benchmark's contract, and its files found by name."""

import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes(bench):
    assert set(bench) == KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in bench[k]}) == len(bench[k])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and one_line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            reported = {e["name"] for e in manifest.end_to_end(bench, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e2e = {e["name"] for e in manifest.end_to_end(bench, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(bench, cell)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_files_are_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = manifest.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in bench["workloads"]:
        t = manifest.traffic(w["traffic"])
        assert callable(manifest.driver(t["driver"]).window)
        assert os.path.exists(os.path.join(manifest.HERE, "limits", f"{w['name']}.json"))
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


@pytest.mark.parametrize("cell", ["replay.seeg128_1024hz", "online.seeg128_1024hz"])
def test_metric_selection(bench, cell):
    e2e = {m["name"] for m in manifest.end_to_end(bench, cell)}
    layer = {m["name"] for m in manifest.per_layer(bench, cell)}
    if cell.startswith("replay"):
        assert e2e == {"replay_xrt", "setup_s"}
        assert {"frontend_roofline", "vocoder_roofline", "replay.device_idle_pct"} <= layer
    else:
        assert e2e == {"online_p50_ms", "online_p99_ms", "setup_s"}
        assert "online.step_device_ms" in layer and "frontend_roofline" not in layer
