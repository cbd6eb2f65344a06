#!/usr/bin/env python3
"""Experiment 2's whole protocol with the PyTorch/CUDA port
(closed_loop_seeg_speech_synthesis_tpu_torch) on one GPU: ``chip_smoke.py``'s
exp2-exp4 phase with the protocol's 1,000 chance segments a decoding run
(configs/evaluation.ini:13) on ``benchmarks/eval_full.py``'s operating point
(100 words, 64 ch, 1024 Hz, 48 kHz audio, seed 0; 120 s of ``RandomState(3)``
other-task noise; chance draws from ``RandomState(1)``).  Run from the
repository root:

    python3 exp2_protocol_torch.py [--runs 1000]

Prints the phase's lines (the card's name and power limit beside each time;
times are host wall clock, the stages of a run synchronized with the card)
under the same gates, then one JSON line of its figures.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=1000,
                        help="chance segments a decoding run (default 1000)")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("exp2_protocol_torch: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    chip_smoke.say(card)
    zero_counts, read_counts = chip_smoke.launch_counters(torch)
    out = chip_smoke.exp2_phase(torch, torch.device("cuda", 0), card, zero_counts, read_counts,
                                runs=args.runs)
    chip_smoke.say(json.dumps({**out["figures"], "chance_runs": args.runs, "device": card},
                              default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
