"""Evaluation CLI (public surface of the reference's ``eval_steps/*``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/evaluate.py``:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.evaluate evaluation.ini \\
        {exp1,exp2,exp3,exp4,figure3,figure4,extract_trials} [--channels_file names.txt] \\
        [--device cuda|cpu]

runs one step on the config's session (General -> storage_dir, session;
``speech1.hdf``, ``params.h5`` and the decoding runs' directories there) and
writes its artifacts under ``<temp_dir>/<session>``: exp1 and exp2 (the
decodes, through kernel K1, and for exp1's proposed method K2) run on
``--device``, exp3, exp4 (``--channels_file``: one channel name per line,
else the recording's names), the figures and extract_trials on the host.
``--device`` defaults to cuda and fails where there is no GPU, whatever the
step; ``--device cpu`` runs the float64 path.  matplotlib is imported where
a figure is drawn; without it exp4 writes its activations and skips their
plots.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np
import torch

from ..io import config as config_mod

logger = logging.getLogger("cli.evaluate")

STEPS = ["exp1", "exp2", "exp3", "exp4", "figure3", "figure4", "extract_trials"]


def main(argv=None):
    parser = argparse.ArgumentParser("Run evaluation experiments.")
    parser.add_argument("config", help="Path to evaluation config file.")
    parser.add_argument("step", choices=STEPS)
    parser.add_argument("--channels_file", help="File with one channel name per line (exp4).")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda); --device cpu runs on the CPU.")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is visible; pass --device cpu "
                     "to run on the CPU")

    config = config_mod.load_config(args.config)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s] [%(name)-20s] [%(levelname)8s]: %(message)s")
    session_dir = config_mod.session_dir(config)
    temp_root = os.path.join(config["General"]["temp_dir"], config["General"]["session"])

    if args.step == "exp1":
        from ..eval.exp1 import Experiment1

        dest = os.path.join(temp_root, "exp1")
        os.makedirs(dest, exist_ok=True)
        exp = Experiment1(config, session_dir, dest, device=device)
        return exp.run(randomization_runs=config.getint("Experiment1", "nb_randomization_runs"))

    if args.step == "exp2":
        from ..eval.exp2 import Experiment2

        dest = os.path.join(temp_root, "exp2")
        runs = [r.strip() for r in config["Experiment2"]["decoding_runs"].split(",")]
        others = [o.strip() for o in config["Experiment2"]["other_xdf"].split(",") if o.strip()]
        for run in runs:
            exp = Experiment2(config, session_dir, os.path.join(session_dir, run), others, dest,
                              device=device)
            exp.run(runs=config.getint("Experiment2", "nb_randomization_runs"),
                    which=config["Experiment2"]["which"])

    elif args.step == "exp3":
        from ..eval.exp3 import run_experiment3

        return run_experiment3(config, session_dir, os.path.join(temp_root, "exp3"))

    elif args.step == "exp4":
        from ..eval.exp4 import Experiment4
        from ..io.loaders import load_hdf5

        if args.channels_file:
            with open(args.channels_file) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = load_hdf5(os.path.join(session_dir, "speech1.hdf"))[4]
        exp = Experiment4(session_dir, names)
        matrix = exp.compute_activations()
        dest = os.path.join(temp_root, "exp4")
        os.makedirs(dest, exist_ok=True)
        np.save(os.path.join(dest, "activations.npy"), matrix)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            logger.info("matplotlib is not installed: activations.png and activation_map.png "
                        "skipped")
        else:
            exp.plot(matrix, os.path.join(dest, "activations.png"))
            exp.plot_activation_map(matrix, os.path.join(dest, "activation_map.png"))
        return matrix

    elif args.step == "figure3":
        from ..eval.figures import figure_3

        return figure_3(os.path.join(temp_root, "exp1"), os.path.join(temp_root, "figure_3.png"))

    elif args.step == "figure4":
        from ..eval.figures import figure_4

        figure_4(session_dir, temp_root, os.path.join(temp_root, "figure_4.png"))

    elif args.step == "extract_trials":
        from ..eval.figures import (extract_wavs_from_decoding_trials,
                                    extract_wavs_from_session, generate_trial_label_file)

        os.makedirs(temp_root, exist_ok=True)
        extract_wavs_from_session(session_dir, temp_root)
        for entry in os.listdir(session_dir):
            run_dir = os.path.join(session_dir, entry)
            if os.path.isdir(run_dir):
                try:
                    extract_wavs_from_decoding_trials(run_dir, temp_root)
                    generate_trial_label_file(run_dir, temp_root)
                except (OSError, ValueError, KeyError) as e:
                    logger.warning("Skipping %s: %s", run_dir, e)


if __name__ == "__main__":
    main()
