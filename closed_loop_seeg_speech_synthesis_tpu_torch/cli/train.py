"""Training CLI (public surface of reference ``train.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/train.py``:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.train config.ini \\
        [--file ...] [--session ...] [--storage_dir ...] [--channels ...] [--device cuda|cpu]

Config file first positional argument; CLI flags are merged into the config
and the merged config is stored as ``train.ini`` next to the artifacts
(train.py:208-236).  Artifacts: params.h5 / LDAs.pkl /
training_features.npy / train.log, and trainset.png / coeffs.png when
Training->draw_plots is set (train.py:171-205).  The same files as the JAX
CLI writes; both packages' ``load_params`` read them.

``--device`` defaults to cuda, and without a visible GPU that is an error:
nothing falls back to the CPU, which runs only with ``--device cpu``.
Training runs in float32 on CUDA and float64 on the CPU.  The audio is dithered with
N(0, 1e-4) noise (train.py:99) drawn from ``main``'s ``rng``, by default
numpy's global generator, as the JAX CLI draws it.  The artifacts are
written without h5py or sklearn (``io.hdf5``, ``models.lda.estimators_pickle``);
matplotlib is imported where the plots are drawn.
"""

from __future__ import annotations

import argparse
import logging
import os
import platform

import numpy as np
import torch

from ..io import config as config_mod
from ..io.loaders import load_speech_file
from ..io.utils import select_channels, squeeze_audio_to_float64
from ..ops import quantization
from ..runtime import params as params_io
from ..runtime import trainer

logger = logging.getLogger("cli.train")


def visualize_train_data(x_train, d_spectrogram, filename, max_samples=5000):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 4))
    m1 = ax1.imshow(x_train[:max_samples].T, aspect="auto", origin="lower")
    fig.colorbar(m1, ax=ax1)
    m2 = ax2.imshow(d_spectrogram[:max_samples].T, aspect="auto", origin="lower")
    fig.colorbar(m2, ax=ax2)
    fig.tight_layout()
    fig.savefig(filename, dpi=300)
    plt.close(fig)


def visualize_model_parameters(lda_params, filename):
    """Per-bin first-discriminant coefficients (reference train.py:46-64)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    coeffs = lda_params.coef[:, 0, :].cpu().numpy()  # (n_bins, n_features)
    fig, ax = plt.subplots(figsize=(5.5, 5))
    m = ax.imshow(coeffs.T, aspect="auto", origin="lower")
    ax.set_title("LDA coefficients")
    ax.set_xlabel("models (mel bins)")
    ax.set_ylabel("coefficients")
    fig.colorbar(m, ax=ax)
    fig.tight_layout()
    fig.savefig(filename, dpi=300)
    plt.close(fig)


def main(argv=None, rng: np.random.RandomState | None = None):
    """``rng`` draws the audio dither; None means numpy's global generator
    (``np.random.normal``, as the JAX CLI draws it), so ``np.random.seed``
    before the call fixes the dither."""
    parser = argparse.ArgumentParser("Train per-bin LDA models on aligned neural and audio data.")
    parser.add_argument("config", help="Path to config file.")
    parser.add_argument("--file", help="Comma separated recording files (XDF/HDF5).")
    parser.add_argument("--session", help="Name of the session.")
    parser.add_argument("--storage_dir", help="Path to the storage_dir.")
    parser.add_argument("--channels", help="Comma separated channel regex patterns.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda); --device cpu runs on the CPU.")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is visible; pass --device cpu "
                     "to run on the CPU")
    rng = rng if rng is not None else np.random

    config = config_mod.load_config(args.config)
    config_mod.merge_args(config, {
        ("Training", "file"): args.file,
        ("General", "session"): args.session,
        ("General", "storage_dir"): args.storage_dir,
        ("Training", "channels"): args.channels,
    })

    session_dir = config_mod.session_dir(config)
    config_mod.make_output_dir(session_dir, config["Training"].get("overwrite_on_rerun") == "True")
    config_mod.setup_logging(os.path.join(session_dir, "train.log"))

    files = config["Training"]["file"].split(",")
    line_noise = config.getint("Training", "power_line", fallback=50)
    logger.info("Recording files: %s", files)
    logger.info("Session: %s", config["General"]["session"])
    logger.info("Power line noise at %d Hz", line_noise)
    logger.info("Running on %s, training on %s.", platform.system(), device)

    eeg_parts, audio_parts = [], []
    eeg_sr = audio_sr = None
    ch_names = None
    for path in files:
        logger.info("Loading %s", path.strip())
        eeg_i, eeg_sr, audio_i, audio_sr, ch_names = load_speech_file(path.strip())
        audio_i = squeeze_audio_to_float64(audio_i)
        eeg_i = eeg_i.astype(np.float64)
        audio_i = audio_i + rng.normal(0, 0.0001, len(audio_i))
        minimum = min(len(eeg_i) / eeg_sr, len(audio_i) / audio_sr)
        eeg_parts.append(eeg_i[: int(minimum * eeg_sr)])
        audio_parts.append(audio_i[: int(minimum * audio_sr)])
        logger.info("EEG sr: %s, Audio sr: %s, duration: %.2f min",
                    eeg_sr, audio_sr, len(eeg_parts[-1]) / eeg_sr / 60)

    eeg = np.vstack(eeg_parts)
    audio = np.hstack(audio_parts)
    logger.info("In total: %.2f min of speech data for training.", len(eeg) / eeg_sr / 60)

    if config["Training"].get("channels"):
        patterns = [p.strip() for p in config["Training"]["channels"].split(",")]
        selected = select_channels(ch_names, patterns)
    else:
        selected = ch_names
    bad_channels = [c for c in ch_names if c not in selected]
    bad_idx = [ch_names.index(c) for c in bad_channels]
    logger.info("Using channels: [%s]", " ".join(c for c in ch_names if c not in bad_channels))
    logger.info("Excluding bad channel indices: [%s]", " ".join(map(str, bad_idx)))

    # headless twin of the reference's interactive channel view
    # (train.py:328-334): PSD/variance QC report instead of a blocking GUI
    if (config.getboolean("Training", "show_interactive_channel_view", fallback=False)
            or config.getboolean("Training", "inspect_channels", fallback=False)):
        from ..io.inspection import inspect_channels

        suspects = inspect_channels(
            eeg, eeg_sr, ch_names, bad_idx,
            os.path.join(session_dir, "channel_inspection.png"),
            os.path.join(session_dir, "channel_report.csv"),
            line_noise=line_noise)
        if suspects:
            logger.warning("%d suspect channel(s) flagged — see channel_report.csv; "
                           "extend the 'channels' exclusion patterns to drop them",
                           len(suspects))

    result = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_idx, line_noise=line_noise,
                           device=device)
    for b, missing in result.missing.items():
        logger.info('Spec_bin "%d" misses samples for interval index/indices "%s"', b, missing)

    path = params_io.store_training(session_dir, result, bad_idx, config=config)
    logger.info("Model parameters written to %s", path)

    if config.getboolean("Training", "draw_plots", fallback=False):
        d_spec = quantization.dequantize(torch.as_tensor(result.y_train),
                                         torch.as_tensor(result.medians)).numpy()
        visualize_train_data(result.x_train, d_spec, os.path.join(session_dir, "trainset.png"))
        visualize_model_parameters(result.lda, os.path.join(session_dir, "coeffs.png"))

    logger.info("Training completed.")
    return path


if __name__ == "__main__":
    main()
