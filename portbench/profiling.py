"""torch.profiler over part of a run's window, read back from its Chrome trace.

A traced run starts ``Profile`` before the part of the window it traces
and stops it after, and opens ``record_function`` ranges of its own
(names starting ``portbench.``), the outermost ``portbench.window``.
``summarize`` reduces the trace to what the per-layer readers take:

* device operations (kernels, copies, sets) inside the window range, with
  their names, intervals and the benchmark range their launch was made in
  (through the profiler's launch correlation);
* the CUDA runtime and driver calls the host made in it;
* its length, the union of the device operations (busy), and the idle gaps
  labelled by the innermost host event open at each gap's middle.

Times are microseconds on the trace's clock and seconds in the summary.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "portbench.window"
TOP = 10


class Profile:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = torch.device(device)
        self.prof = profile(activities=acts)
        self.host_s = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.host_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return summarize(events)


def _union(intervals):
    end, merged = None, []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    total = sum(b - a for a, b in merged)
    return total, merged


def busy_seconds(device_ops) -> float:
    """Seconds of the union of the device operations."""
    return _union([(a, b) for _, a, b, _ in device_ops])[0]


def summarize(events) -> dict:
    done = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in done if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not windows:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": [], "runtime_calls": 0,
                "runtime_by_name": {}, "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    inside = lambda e: w0 <= e["ts"] and e["ts"] + e["dur"] <= w1
    ranges = [e for e in done if e.get("cat") == "user_annotation"
              and e["name"].startswith("portbench.") and e["name"] != WINDOW]
    runtime = [e for e in done if e.get("cat") in RUNTIME_CATS and inside(e)]
    # the benchmark range a launch was made in, by its correlation id
    stage_of = {}
    for e in runtime:
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        open_ = [r for r in ranges if r["tid"] == e["tid"] and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        if open_:
            stage_of[corr] = min(open_, key=lambda r: r["dur"])["name"][len("portbench."):]
    device_ops = []
    for e in done:
        if e.get("cat") in DEVICE_CATS and w0 <= e["ts"] <= w1:
            corr = (e.get("args") or {}).get("correlation")
            device_ops.append((e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                               stage_of.get(corr)))
    busy, merged = _union([(a, b) for _, a, b, _ in device_ops])
    by_name = {}
    for name, a, b, _ in device_ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    host = sorted((e for e in done if e.get("cat") in HOST_CATS and inside(e)),
                  key=lambda e: e["ts"])
    gaps, cursor, active, i = {}, w0 * 1e-6, [], 0
    for a, b in merged + [[w1 * 1e-6, w1 * 1e-6]]:
        if a > cursor:  # an idle gap [cursor, a): swept in order of its middle
            mid = (a + cursor) / 2 * 1e6
            while i < len(host) and host[i]["ts"] <= mid:
                active.append(host[i])
                i += 1
            active = [e for e in active if e["ts"] + e["dur"] >= mid]
            label = min(active, key=lambda e: e["dur"])["name"] if active else "(no host event)"
            gaps[label] = gaps.get(label, 0.0) + (a - cursor)
        cursor = max(cursor, b)
    runtime_by_name = {}
    for e in runtime:
        runtime_by_name[e["name"]] = runtime_by_name.get(e["name"], 0) + 1
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    every = [e["ts"] for e in done if e.get("cat") in DEVICE_CATS]
    span = (min(every) - w0, max(every) - w0) if every else (0.0, 0.0)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy, "device_ops": device_ops,
            "device_ops_traced": len(every), "device_span_vs_window_s": [span[0] * 1e-6, span[1] * 1e-6],
            "runtime_calls": len(runtime), "runtime_by_name": runtime_by_name,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


def stage_seconds(summary: dict, stages) -> float:
    """Device seconds of the operations launched in the given ranges (names
    without the ``portbench.`` prefix)."""
    return sum(b - a for _, a, b, stage in summary["device_ops"] if stage in stages)
