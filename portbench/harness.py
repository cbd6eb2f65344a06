"""One run of one cell: set-up, the measured window, the check, one result line.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``:

1. the cell's entry in ``BENCHMARK.json`` names its configuration and its
   traffic mix, and the mix its driver (``manifest``);
2. the driver builds the decoder, makes the inputs from the seed and warms
   every shape the window uses (set-up: process start to the window);
3. the driver runs the window; with ``--trace 1`` it profiles part of it
   (``profiling``) and the per-layer readers take their numbers from that;
4. the run fails if JAX or the JAX package was loaded;
5. the program's state is freed and its answers are held against the
   plain reference (``judge``): ``correct``.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit.
Those numbers are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from . import judge, manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "closed_loop_seeg_speech_synthesis_tpu")


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name only begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


class Run:
    """One run's settings, what its driver builds, and what it measured."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float, here: str = manifest.HERE):
        self.bench, self.name, self.here = bench, cell, here
        self.cell = manifest.cell(bench, cell)
        self.cfg = manifest.config(self.cell["config"], here)
        self.traffic = manifest.traffic(self.cell["traffic"], here)
        self.driver = manifest.driver(self.traffic["driver"], here)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        # the configuration's dtype on the card; the program's CPU route is float64
        self.dtype = getattr(torch, self.cfg["dtype"]) if self.device.type == "cuda" else torch.float64
        self.t_start = t_start
        self.timings, self.info = {}, {}
        self.profile, self.trace_units = None, None
        self.attempted = self.failed = self.never_came = 0


def execute(run: Run) -> dict:
    """Set-up, window, check; the result's dict (printing nothing but the
    stderr report).  Raises SystemExit(3) where JAX was loaded."""
    run.timings["imports_s"] = time.perf_counter() - run.t_start
    run.driver.setup(run)
    t_window = time.perf_counter()
    setup_s = t_window - run.t_start
    e2e = run.driver.window(run)
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    found = forbidden_modules()
    if found:
        say(f"portbench: the process loaded {found}; the benchmark runs the port alone")
        raise SystemExit(3)
    summary = run.profile.summary() if run.profile is not None else None
    run.summary = summary
    t_check = time.perf_counter()
    numbers = judge.worst([judge.compare(a["spec"], a["audio"], a["eeg"], run.cfg, run.weights,
                                         run.gl_seed, run.dtype, a["never_came"])
                           for a in run.driver.answers(run)])
    run.info["check s"] = time.perf_counter() - t_check
    correct, checks = judge.verdict(numbers, judge.limits(run.name, run.here))
    metrics = {}
    if run.trace:
        for m in manifest.per_layer(run.bench, run.name):
            value = manifest.reader(m["name"], run.here).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in manifest.end_to_end(run.bench, run.name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": device}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["checks"] = checks
    say(f"card: {card_line() if cuda else 'none (CPU)'}")
    say(f"setup_s {setup_s:.3f}, build_params_s {run.timings.get('build_params_s', 0):.3f}, "
        f"memory peak {peak} bytes")
    if summary is not None:
        say(f"trace: window {summary['window_s']:.6f} s, {len(summary['device_ops'])} of "
            f"{summary['device_ops_traced']} device operations in it (first and last start "
            f"{summary['device_span_vs_window_s']} s from its start), {run.trace_units} units")
    say("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in run.timings.items()))
    for k, v in run.info.items():
        say(f"{k}: {v}")
    for k, c in checks.items():
        say(f"check {k}: {c['value']} (limit {c['limit']})")
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.benchmark()
    chips = manifest.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"portbench: the cell {args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    run = Run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start)
    result = execute(run)
    print(json.dumps(result), flush=True)
    return 0
