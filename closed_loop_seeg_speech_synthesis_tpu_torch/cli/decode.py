"""Decoding CLI, offline (replay) mode.

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/decode.py``:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.decode config.ini \\
        --seeg_file replay.hdf [--run ...] [--session ...] [--gl_norm ...] \\
        [--device cuda|cpu] [--rand_init inits.npy]

Decodes a recorded sEEG file (datasets ``sEEG``, ``sEEG_sr``) with the
session's ``params.h5`` and writes the same artifacts as the JAX CLI into
``<storage_dir>/<session>/<run>/``: audio.wav, spectrogram.npy, sEEG.hdf,
decode.ini, decode.log, and decoding.png when matplotlib is installed.

Not ported yet, and rejected with an error: online mode (no seeg_file),
``--persistent``, ``--profile``, ``--dispatch-chunk`` and
``--vocoder exact-host``.  h5py is imported where files are read or
written; matplotlib where the plot is drawn.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..io import config as config_mod
from ..io.utils import in_offline_mode
from ..runtime import params as params_io
from ..runtime import pipeline

logger = logging.getLogger("cli.decode")


def plot_streamed_data(spectrogram, audio, filename):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_spec, ax_audio) = plt.subplots(2, 1, figsize=(9, 5), height_ratios=[2, 1])
    if len(spectrogram):
        m = ax_spec.imshow(np.asarray(spectrogram).T, aspect="auto", origin="lower")
        fig.colorbar(m, ax=ax_spec)
    ax_spec.set_title("Decoded speech signal")
    ax_spec.set_ylabel("logMels (dequantized)")
    ax_audio.plot(audio, linewidth=1)
    ax_audio.set_ylabel("Amplitude (int16)")
    ax_audio.set_xlabel("Samples @16 kHz")
    fig.tight_layout()
    fig.savefig(filename, dpi=300)
    plt.close(fig)


def _build_decoder(loaded, sr, n_channels_total, gl_norm, dtype, device):
    n_used = n_channels_total - len(loaded["bad_channels"])
    cfg = pipeline.DecoderConfig(sr=float(sr), n_channels=n_used, gl_norm=float(gl_norm),
                                 dtype=dtype)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                        loaded["select"], device=device)
    return cfg, dec


def perform_offline_decoding(loaded, eeg, sfreq, gl_norm, dtype=None, device=None,
                             rand_init=None, generator=None, vocoder="device"):
    """Batch replay (reference decode.py:71-96).

    eeg: (T, C) array or tensor including bad channels.  ``device`` defaults
    to the tensor's device (the CPU for an array); ``dtype`` to float64 on
    the CPU and float32 on CUDA.  Returns (spectrogram, audio) tensors plus
    the input and its rate."""
    if vocoder != "device":
        raise NotImplementedError(f"vocoder={vocoder!r} is not ported yet; use 'device'")
    eeg_t = torch.as_tensor(eeg)
    device = torch.device(device) if device is not None else eeg_t.device
    dtype = dtype or pipeline.default_compute_dtype(device)
    mask = np.ones(eeg_t.shape[1], bool)
    mask[np.asarray(loaded["bad_channels"], int)] = False
    used = eeg_t if mask.all() else eeg_t[:, torch.as_tensor(mask, device=eeg_t.device)]
    cfg, dec = _build_decoder(loaded, sfreq, eeg_t.shape[1], gl_norm, dtype, device)
    spec, audio = pipeline.offline_decode(dec, cfg, used, rand_init=rand_init,
                                          generator=generator)
    logger.info("Decoding completed.")
    return spec, audio, eeg, sfreq


def store_decoding_to_file(run_dir, config, spectrogram, output_audio, received_sEEG, sfreq):
    import h5py
    from scipy.io.wavfile import write as wavwrite

    spectrogram = torch.as_tensor(spectrogram).cpu().numpy()
    output_audio = torch.as_tensor(output_audio).cpu().numpy().astype(np.int16)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        logger.info("matplotlib is not installed: decoding.png skipped")
    else:
        plot_streamed_data(spectrogram, output_audio, os.path.join(run_dir, "decoding.png"))
    wavwrite(os.path.join(run_dir, "audio.wav"), 16000, output_audio)
    with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=torch.as_tensor(received_sEEG).cpu().numpy())
        hf.create_dataset("sEEG_sr", data=sfreq, dtype=np.int32)
    np.save(os.path.join(run_dir, "spectrogram.npy"), spectrogram)
    with open(os.path.join(run_dir, "decode.ini"), "w") as f:
        config.write(f)
    logger.info("Artifacts written to %s", run_dir)


def main(argv=None):
    parser = argparse.ArgumentParser("Decode a recorded sEEG file with a pretrained model.")
    parser.add_argument("config", help="Path to config file.")
    parser.add_argument("--storage_dir")
    parser.add_argument("--stream_name")
    parser.add_argument("--marker_stream_name")
    parser.add_argument("--gl_norm")
    parser.add_argument("--run")
    parser.add_argument("--session")
    parser.add_argument("--seeg_file", help="Decode from file (the only mode ported).")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda when available, else cpu.")
    parser.add_argument("--rand_init", metavar="NPY", default=None,
                        help="(n_frames-1, 480) Griffin-Lim inits; default: drawn from "
                             "a torch.Generator seeded 0.")
    for flag in ("--backend", "--max_packets", "--dispatch-chunk", "--profile"):
        parser.add_argument(flag, default=None, help="online/profiling: not ported yet")
    parser.add_argument("--persistent", action="store_true", help="not ported yet")
    parser.add_argument("--vocoder", choices=["device", "exact-host"], default="device",
                        help="'exact-host' is not ported yet")
    args = parser.parse_args(argv)
    for flag in ("backend", "max_packets", "dispatch_chunk", "profile"):
        if getattr(args, flag) is not None:
            parser.error(f"--{flag.replace('_', '-')} is not ported yet")
    if args.persistent:
        parser.error("--persistent (online mode) is not ported yet")
    if args.vocoder != "device":
        parser.error("--vocoder exact-host is not ported yet")

    config = config_mod.load_config(args.config)
    config_mod.merge_args(config, {
        ("General", "storage_dir"): args.storage_dir,
        ("Decoding", "stream_name"): args.stream_name,
        ("Decoding", "marker_stream_name"): args.marker_stream_name,
        ("Decoding", "griffin_lim_norm"): args.gl_norm,
        ("Decoding", "run"): args.run,
        ("General", "session"): args.session,
        ("Development", "seeg_file"): args.seeg_file,
    })
    if not in_offline_mode(config):
        parser.error("online decoding is not ported yet: give --seeg_file (or "
                     "Development->seeg_file) to replay a recording")

    session_dir = config_mod.session_dir(config)
    if not os.path.isdir(session_dir):
        raise FileNotFoundError(f"session directory does not exist: {session_dir}")
    run_dir = config_mod.run_dir(config)
    config_mod.make_output_dir(run_dir, config.getboolean("Decoding", "overwrite_on_rerun", fallback=True))
    config_mod.setup_logging(os.path.join(run_dir, "decode.log"))

    device = torch.device(args.device or ("cuda" if torch.cuda.is_available() else "cpu"))
    dtype = pipeline.default_compute_dtype(device)
    loaded = params_io.load_params(os.path.join(session_dir, "params.h5"), dtype=dtype)
    logger.info("Ignoring channel indices: [%s]", " ".join(map(str, loaded["bad_channels"])))
    gl_norm = config.getint("Decoding", "griffin_lim_norm")
    rand_init = np.load(args.rand_init) if args.rand_init else None

    import h5py

    with h5py.File(config["Development"]["seeg_file"], "r") as hf:
        eeg = hf["sEEG"][:]
        sfreq = int(np.asarray(hf["sEEG_sr"]).reshape(-1)[0])
    spectrogram, audio, received, sfreq = perform_offline_decoding(
        loaded, eeg, sfreq, gl_norm, dtype=dtype, device=device, rand_init=rand_init)
    store_decoding_to_file(run_dir, config, spectrogram, audio, received, sfreq)
    return run_dir


if __name__ == "__main__":
    main()
