"""The control of the correctness check, at a cell's own size, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds 40]
                                 [--program-bf16]

For each seed it makes the cell's inputs as a run does (the same weights,
sEEG and Griffin-Lim key; a replay's whole session, an online window's
packets), puts the reference computed one precision below the
configurations' float32 (TF32 products, ``reference.arith``) in the
program's place, and prints the numbers ``judge.compare`` reads for it,
one JSON line a seed.  ``--program-bf16`` also reads the program's own
lower-precision path on a replay cell: ``offline_decode`` with
``DecoderConfig.gl_bf16`` (bf16 Griffin-Lim products).  The benchmark's
runs never run this; its readings set the upper end of each limit
(PERF.md).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness, inputs, judge, manifest, program, schedule  # noqa: E402


def cell_samples(run) -> int:
    if "session_s" in run.traffic:
        return int(round(float(run.traffic["session_s"]) * float(run.cfg["sr"])))
    period = int(run.cfg["packet_size"]) / float(run.cfg["sr"])
    return schedule.packet_count(run.seconds, period) * int(run.cfg["packet_size"])


def readings(run, program_bf16: bool) -> dict:
    T = cell_samples(run)
    run.weights = inputs.weights(run.cfg, run.seed, run.device)
    eeg = inputs.session(run.cfg, T, run.seed, run.device)
    key = inputs.gl_seed(run.seed)
    out = {"seed": run.seed, "samples": T}
    t0 = time.perf_counter()
    spec, audio = judge.control(eeg, run.cfg, run.weights, key, run.dtype)
    out["control_s"] = time.perf_counter() - t0
    out["control"] = judge.compare(spec, audio, eeg, run.cfg, run.weights, key, run.dtype)
    if program_bf16:
        from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

        program.load_kernels(run, ("frontend_decode", "gl_audio", "prng"))
        pcfg, dec = program.decoder(run)
        pcfg = dataclasses.replace(pcfg, gl_bf16=True)
        spec, audio = pipeline.offline_decode(dec, pcfg, eeg, seed=key)
        spec, audio = spec.cpu().numpy(), audio.cpu().numpy()
        del dec
        torch.cuda.empty_cache()
        out["program_bf16"] = judge.compare(spec, audio, eeg, run.cfg, run.weights, key, run.dtype)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--program-bf16", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = manifest.benchmark()
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        run = harness.Run(bench, args.workload, seed, seconds, False, torch.device("cuda", 0), 0.0)
        r = readings(run, args.program_bf16)
        r["workload"] = args.workload
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
