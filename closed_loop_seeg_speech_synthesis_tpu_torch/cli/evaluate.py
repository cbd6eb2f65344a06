"""Evaluation CLI (public surface of the reference's ``eval_steps/*``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/evaluate.py``, its
``exp1`` step:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.evaluate evaluation.ini exp1 \\
        [--device cuda|cpu]

runs experiment 1 on the config's session (General -> storage_dir, session;
``speech1.hdf`` and ``params.h5`` there) and writes its artifacts to
``<temp_dir>/<session>/exp1``, with Experiment1 -> nb_randomization_runs
chance runs.  ``--device`` defaults to cuda and fails where there is no GPU;
``--device cpu`` runs the float64 path.  The other steps (exp2, exp3, exp4,
figure3, figure4, extract_trials) are not ported yet and are rejected with a
usage error.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from ..io import config as config_mod

logger = logging.getLogger("cli.evaluate")

STEPS = ["exp1", "exp2", "exp3", "exp4", "figure3", "figure4", "extract_trials"]
PORTED = ["exp1"]


def main(argv=None):
    parser = argparse.ArgumentParser("Run evaluation experiments.")
    parser.add_argument("config", help="Path to evaluation config file.")
    parser.add_argument("step", choices=STEPS)
    parser.add_argument("--channels_file", help="File with one channel name per line (exp4).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda); --device cpu runs on the CPU.")
    args = parser.parse_args(argv)
    if args.step not in PORTED:
        parser.error(f"step {args.step} is not ported yet (ported: {', '.join(PORTED)}; "
                     f"not yet: {', '.join(s for s in STEPS if s not in PORTED)})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is visible; pass --device cpu "
                     "to run on the CPU")

    config = config_mod.load_config(args.config)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s] [%(name)-20s] [%(levelname)8s]: %(message)s")
    session_dir = config_mod.session_dir(config)
    temp_root = os.path.join(config["General"]["temp_dir"], config["General"]["session"])

    from ..eval.exp1 import Experiment1

    dest = os.path.join(temp_root, "exp1")
    os.makedirs(dest, exist_ok=True)
    exp = Experiment1(config, session_dir, dest, device=device)
    return exp.run(randomization_runs=config.getint("Experiment1", "nb_randomization_runs"))


if __name__ == "__main__":
    main()
