"""A configuration, a traffic mix, a cell and a metric added as files of their
own are found by name, with no file that is there edited."""

import copy
import json
import shutil

from portbench import harness, manifest


def test_a_new_cell_is_found_from_new_files(tmp_path, bench):
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(f"{manifest.HERE}/{d}", here / d)
    cfg = json.loads((here / "configs" / "seeg128_1024hz.json").read_text())
    cfg.update(n_channels=64)
    (here / "configs" / "seeg64_1024hz.json").write_text(json.dumps(cfg))
    mix = {"driver": "replay", "session_s": 600, "trace_s": 1.0, "why": "a 10-min session"}
    (here / "traffic" / "replay_10min.json").write_text(json.dumps(mix))
    (here / "limits" / "replay.seeg64_1024hz.json").write_text(
        (here / "limits" / "replay.seeg128_1024hz.json").read_text())
    (here / "metrics" / "replay.extra_ms.py").write_text("def read(run):\n    return 1.5\n")

    b = copy.deepcopy(bench)
    b["workloads"].append({"name": "replay.seeg64_1024hz", "config": "seeg64_1024hz",
                           "traffic": "replay_10min", "chips": 1, "why": "a 64-channel replay"})
    b["end_to_end"][0]["workloads"].append("replay.seeg64_1024hz")
    b["per_layer"].append({"name": "replay.extra_ms", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "replay pipeline and device",
                           "moves": "replay_xrt", "workloads": ["replay.seeg64_1024hz"]})

    run = harness.Run(b, "replay.seeg64_1024hz", 7, 1.0, True, "cpu", 0.0, here=str(here))
    assert run.cfg["n_channels"] == 64 and run.traffic["session_s"] == 600
    assert run.driver.__name__ == "portbench_driver_replay"
    layer = [m["name"] for m in manifest.per_layer(b, "replay.seeg64_1024hz")]
    assert layer == ["replay.extra_ms"]
    assert manifest.reader("replay.extra_ms", str(here)).read(run) == 1.5
    assert [m["name"] for m in manifest.end_to_end(b, "replay.seeg64_1024hz")] == ["replay_xrt", "setup_s"]


def test_a_metric_without_cells_follows_what_it_moves(bench):
    b = copy.deepcopy(bench)
    b["per_layer"].append({"name": "all.online", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "x", "moves": "online_p50_ms"})
    assert "all.online" in [m["name"] for m in manifest.per_layer(b, "online.seeg128_2048hz")]
    assert "all.online" not in [m["name"] for m in manifest.per_layer(b, "replay.seeg128_1024hz")]
