#!/usr/bin/env python3
"""Experiment 1's whole protocol with the PyTorch/CUDA port
(closed_loop_seeg_speech_synthesis_tpu_torch) on one GPU: ``chip_smoke.py``'s
exp1 phase with the protocol's 100 chance runs of 10 folds (1,000
retrain+decodes) on the session of ``benchmarks/exp1_protocol.py`` (100
words, 128 ch, 1024 Hz, 48 kHz audio, seed 0, ``RandomState(0)``).  Run from
the repository root:

    python3 exp1_protocol_torch.py [--runs 100]

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
    parser.add_argument("--runs", type=int, default=100, help="chance runs (default 100)")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("exp1_protocol_torch: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    import chip_smoke

    card = chip_smoke.card_line()
    chip_smoke.say(card)
    zero_counts, read_counts = chip_smoke.launch_counters(torch)
    out = chip_smoke.exp1_phase(torch, torch.device("cuda", 0), card, zero_counts, read_counts,
                                runs=args.runs)
    chip_smoke.say(json.dumps({**out["figures"], "device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
