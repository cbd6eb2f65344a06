"""The readers of the program's spans (``portbench/spans.py``): traced CPU
runs at a small size report them, and an untraced run, or a program that
opens no ``seeg.*`` span, gives None from every one."""

import math
import time
import types

import pytest

from portbench import harness, manifest, profiling, spans

SEED = 2**31 + 977
READERS = ("replay.frontend_host_ms", "online.dispatch_ms", "online.wait_ms", "online.emit_ms")


def run_cell(bench, here, cell, seconds, trace):
    run = harness.Run(bench, cell, SEED, seconds, trace, "cpu", time.perf_counter(), here=here)
    return run, harness.execute(run)


def test_traced_replay_reports_the_front_ends_host_time(bench, small_here):
    run, result = run_cell(bench, small_here, "replay.seeg128_1024hz", 1.0, True)
    ms = result["metrics"]["replay.frontend_host_ms"]
    assert ms["unit"] == "ms" and math.isfinite(ms["value"]) and ms["value"] > 0
    names = [n for n, _, _ in spans.program_spans(run)]
    assert names.count("seeg.frontend") == names.count("seeg.vocode") == run.trace_units


def test_traced_online_reports_dispatch_and_emit(bench, small_here):
    run, result = run_cell(bench, small_here, "online.seeg128_2048hz", 1.0, True)
    assert result["correct"]
    for name in ("online.dispatch_ms", "online.emit_ms"):
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0
    assert "online.wait_ms" not in result["metrics"]  # the CPU decoder has no event to wait on
    names = [n for n, _, _ in spans.program_spans(run)]
    assert names.count("seeg.online.dispatch") == names.count("seeg.online.emit") == run.trace_units


@pytest.fixture(scope="module")
def untraced(bench, small_here):
    return run_cell(bench, small_here, "online.seeg128_1024hz", 0.3, False)[0]


@pytest.mark.parametrize("name", READERS)
def test_untraced_run_reads_none(untraced, small_here, name):
    assert untraced.profile is None
    assert manifest.reader(name, small_here).read(untraced) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_none(small_here, name):
    run = types.SimpleNamespace(profile=object(), trace_units=4,
                                program_spans=spans.select([(profiling.WINDOW, 0.0, 9.0),
                                                            ("portbench.frontend", 1.0, 2.0)]))
    assert run.program_spans == []
    assert manifest.reader(name, small_here).read(run) is None


def test_only_spans_inside_the_window_count():
    events = [("seeg.frontend", 0.0, 1.0), (profiling.WINDOW, 2.0, 10.0),
              ("seeg.vocode", 6.0, 7.0), ("seeg.frontend", 3.0, 5.0),
              ("seeg.frontend.plan", 3.5, 4.0), ("aten::add", 4.0, 4.5),
              ("seeg.vocode", 9.0, 11.0)]
    assert spans.select(events) == [("seeg.frontend", 3.0 * 1e-6, 5.0 * 1e-6),
                                    ("seeg.frontend.plan", 3.5 * 1e-6, 4.0 * 1e-6),
                                    ("seeg.vocode", 6.0 * 1e-6, 7.0 * 1e-6)]
    assert spans.select(events[:1]) == []
