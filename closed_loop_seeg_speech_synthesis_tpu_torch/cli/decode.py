"""Decoding CLI (public surface of reference ``decode.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/decode.py``:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.decode config.ini \\
        [--seeg_file replay.hdf] [--run ...] [--session ...] [--gl_norm ...] \\
        [--device cuda|cpu] [--rand_init inits.npy] [--vocoder device|exact-host] \\
        [--profile DIR] [--backend lsl|nsx] [--max_packets N] [--dispatch-chunk K]
        [--persistent]

Offline mode (``--seeg_file`` or Development->seeg_file): decodes a recorded
sEEG file (datasets ``sEEG``, ``sEEG_sr``).  Online mode (no seeg_file):
pulls the config's Decoding->stream_name stream (LSL, or the native NSX
transport), runs the closed loop packet by packet and logs markers in a side
thread.  Both use the session's ``params.h5`` and write the JAX CLI's
artifacts into ``<storage_dir>/<session>/<run>/``: audio.wav,
spectrogram.npy, sEEG.hdf, decode.ini, decode.log, decoding.png when
matplotlib is installed, and online first_timestamp.npy and markers.csv.

``--device`` defaults to cuda and fails where there is no GPU; nothing
falls back to the CPU, which runs only with ``--device cpu``.
``--vocoder exact-host`` (offline mode) re-synthesizes the audio of the
decoded spectrogram with the numpy ``ops/host_vocoder`` (the reference node's
emission grid), its phase inits from ``--rand_init`` or, as the JAX CLI
draws them, the float64 rows of ``PRNGKey(0)``.  ``--profile DIR``
records the decode with ``torch.profiler`` (CPU activity, and CUDA activity
on the card) and writes a Chrome trace, ``DIR/trace.json``.  ``--persistent``
(online mode) decodes the session as one device dispatch
(``runtime.online.PersistentOnlineDecoder``: on the card one launch of a
CUDA graph whose device-side while loop runs the step once per packet; on
the CPU the same body as a host loop).  HDF5 files go through the port's
``io.hdf5`` (no h5py); matplotlib is imported where the plot is drawn.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import threading

import numpy as np
import torch

from ..io import config as config_mod
from ..io import hdf5
from ..io.utils import in_offline_mode
from ..runtime import online
from ..runtime import params as params_io
from ..runtime import pipeline
from ..runtime.audio import make_sink

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


def _build_decoder(loaded, sr, n_channels_total, gl_norm, dtype, device, packet_size=32,
                   **options):
    """(DecoderConfig, DecoderParams); ``options`` are further DecoderConfig
    fields (e.g. ``use_cuda_epilogue=False`` for the split front end)."""
    n_used = n_channels_total - len(loaded["bad_channels"])
    cfg = pipeline.DecoderConfig(sr=float(sr), n_channels=n_used, packet_size=packet_size,
                                 gl_norm=float(gl_norm), dtype=dtype, **options)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                        loaded["select"], device=device)
    return cfg, dec


def perform_offline_decoding(loaded, eeg, sfreq, gl_norm, dtype=None, device=None,
                             rand_init=None, seed=0, vocoder="device", **options):
    """Batch replay (reference decode.py:71-96).

    eeg: (T, C) array or tensor including bad channels.  ``device`` defaults
    to the card whatever the input's device (pass ``"cpu"`` to decode on the
    CPU); ``dtype`` to float64 on the CPU and float32 on CUDA.  ``options``
    are further DecoderConfig fields.  Returns (spectrogram, audio) tensors
    plus the input and its rate.

    ``seed`` (an int seed, meaning ``PRNGKey(seed)``, or a key pair) keys
    the Griffin-Lim inits when ``rand_init`` is None: the JAX CLI's draws of
    its default ``PRNGKey(0)``, in the decode's dtype.

    ``vocoder="exact-host"`` runs the front end on ``device`` and
    re-synthesizes the audio on the host with
    ``ops.host_vocoder.decode_audio_exact`` (byte-equal to the JAX package's
    given the same inits): its inits are ``rand_init`` or the float64 rows
    of ``seed``, as the JAX CLI draws them (on ``device``: the kernel draws
    the same bits as the CPU); the audio comes back as a CPU int16 tensor.
    The spectrogram is the same either way."""
    if vocoder not in ("device", "exact-host"):
        raise ValueError(f"vocoder must be 'device' or 'exact-host'; got {vocoder!r}")
    device = pipeline.resolve_device(device)
    eeg_t = torch.as_tensor(eeg)
    dtype = dtype or pipeline.default_compute_dtype(device)
    mask = np.ones(eeg_t.shape[1], bool)
    mask[np.asarray(loaded["bad_channels"], int)] = False
    used = eeg_t if mask.all() else eeg_t[:, torch.as_tensor(mask, device=eeg_t.device)]
    cfg, dec = _build_decoder(loaded, sfreq, eeg_t.shape[1], gl_norm, dtype, device, **options)
    if vocoder == "device":
        spec, audio = pipeline.offline_decode(dec, cfg, used, rand_init=rand_init, seed=seed)
    else:
        from ..ops import griffinlim as gl
        from ..ops.host_vocoder import decode_audio_exact

        spec = pipeline._mel_frames(dec, cfg, used)
        spec_np = spec.cpu().numpy().astype(np.float64)
        rows = (np.asarray(rand_init, np.float64) if rand_init is not None else
                gl.default_rand_init(spec_np.shape[0] - 1, 0, seed, torch.float64,
                                     device).cpu().numpy())
        audio = torch.from_numpy(decode_audio_exact(spec_np, rows, norm_factor=float(gl_norm)))
        logger.info("Exact-host vocoder: %d samples (reference-exact emission grid)", len(audio))
    logger.info("Decoding completed.")
    return spec, audio, eeg, sfreq


def perform_online_decoding(config, loaded, gl_norm, run_dir, stop_event=None,
                            max_packets=None, backend=None, dtype=None, device=None,
                            chunk_steps=1, rand_init=None, persistent=False):
    """Closed loop against a live stream (reference decode.py:99-149).

    ``device`` defaults to the card (pass ``"cpu"`` to decode on the CPU),
    ``dtype`` to float64 on the CPU and float32 on CUDA.  A packet is one
    dispatch of the recorded step (one CUDA-graph replay on the card);
    ``chunk_steps=K`` decodes K buffered packets per dispatch (bit-identical
    output, (K-1) packet periods more playout latency).  ``persistent=True``
    decodes the session as one device dispatch
    (``online.PersistentOnlineDecoder``), where ``chunk_steps`` has no
    meaning and is ignored with a warning.
    ``rand_init``: a (n_blocks, 480) table of Griffin-Lim inits indexed by
    global block index; by default the JAX decoder's draws of
    ``PRNGKey(0)`` by global block index.
    Returns (spectrogram, audio, received sEEG, rate) as numpy arrays.

    The stream's rate and channel count are read without subscribing; the
    decoder is built and warmed up, and only then is the stream opened, so
    a sender faster than real time (``dev_streamer --asap``) does not drop
    a subscriber that is still building.  With ``max_packets``, a stream
    that ends short raises (``OnlineDecoder.run_stream``)."""
    from ..runtime import streams

    device = pipeline.resolve_device(device)
    dtype = dtype or pipeline.default_compute_dtype(device)
    stream_name = config["Decoding"]["stream_name"]
    channels, srate = streams.stream_info(stream_name, backend=backend)
    sfreq = int(srate)
    packet_size = 64 if sfreq == 2048 else 32
    logger.info("Using a sampling rate of %s, packet size %d.", sfreq, packet_size)
    cfg, dec = _build_decoder(loaded, sfreq, channels, gl_norm, dtype, device, packet_size)
    sink = make_sink("auto", wav_path=None, sample_rate=cfg.audio_sr)
    rand_source = 0 if rand_init is None else rand_init
    if persistent:
        decoder = online.PersistentOnlineDecoder(cfg, dec, bad_channels=loaded["bad_channels"],
                                                 sink=sink, rand_source=rand_source)
        if chunk_steps > 1:
            logger.warning("--dispatch-chunk is a per-packet-mode knob; the "
                           "persistent loop already amortizes dispatch overhead")
    else:
        decoder = online.OnlineDecoder(cfg, dec, bad_channels=loaded["bad_channels"], sink=sink,
                                       chunk_steps=chunk_steps, rand_source=rand_source)
    decoder.warmup()
    inlet = streams.StreamInlet(stream_name, backend=backend)

    stop = stop_event or threading.Event()
    # marker logging off the hot path, in a daemon thread (the reference
    # forks a process, decode.py:128-137; the logger is IO-bound)
    marker_stop = threading.Event()
    marker_thread = threading.Thread(
        target=online.read_markers,
        args=(run_dir, config["Decoding"].get("marker_stream_name", "SingleWordsMarkerStream")),
        kwargs={"stop_event": marker_stop, "backend": backend},
        daemon=True,
    )
    marker_thread.start()
    logger.info("Started marker logger thread")
    try:
        if stop_event is None and max_packets is None:
            waiter = threading.Thread(target=lambda: (input("Press Enter to stop decoding...\n"),
                                                      stop.set()))
            waiter.daemon = True
            waiter.start()
        spectrogram, audio, received = decoder.run_stream(
            inlet, stop_event=stop, max_packets=max_packets,
            store_first_timestamp_to=os.path.join(run_dir, "first_timestamp.npy"), backend=backend)
    finally:
        marker_stop.set()
        marker_thread.join(timeout=3)
        sink.close()
    decoder.latency_report()
    logger.info("Decoding completed.")
    return spectrogram, audio, received, sfreq


def store_decoding_to_file(run_dir, config, spectrogram, output_audio, received_sEEG, sfreq):
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
    with hdf5.File(os.path.join(run_dir, "sEEG.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=torch.as_tensor(received_sEEG).cpu().numpy())
        hf.create_dataset("sEEG_sr", data=sfreq, dtype=np.int32)
    np.save(os.path.join(run_dir, "spectrogram.npy"), spectrogram)
    with open(os.path.join(run_dir, "decode.ini"), "w") as f:
        config.write(f)
    logger.info("Artifacts written to %s", run_dir)


def main(argv=None):
    parser = argparse.ArgumentParser("Decode an sEEG stream or file with a pretrained model.")
    parser.add_argument("config", help="Path to config file.")
    parser.add_argument("--storage_dir")
    parser.add_argument("--stream_name")
    parser.add_argument("--marker_stream_name")
    parser.add_argument("--gl_norm")
    parser.add_argument("--run")
    parser.add_argument("--session")
    parser.add_argument("--seeg_file", help="Decode from file instead of the live stream.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda); --device cpu runs on the CPU.")
    parser.add_argument("--rand_init", metavar="NPY", default=None,
                        help="Griffin-Lim inits, one 480-sample row per block (offline: "
                             "(n_frames-1, 480); online: indexed by global block index); "
                             "default: the JAX package's draws of PRNGKey(0).")
    parser.add_argument("--backend", choices=["lsl", "nsx"], default=None,
                        help="online: stream transport (default lsl when pylsl imports)")
    parser.add_argument("--max_packets", type=int, default=None,
                        help="online: stop after N packets (else Enter stops)")
    parser.add_argument("--dispatch-chunk", type=int, default=1, metavar="K",
                        help="online: decode K buffered packets per dispatch (one CUDA-graph "
                             "replay on the card); (K-1) packet periods more playout latency")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="record the decode with torch.profiler into DIR/trace.json "
                             "(a Chrome trace, viewable with perfetto)")
    parser.add_argument("--persistent", action="store_true",
                        help="online: decode the session as one device dispatch (a CUDA "
                             "graph's device-side while loop on the card)")
    parser.add_argument("--vocoder", choices=["device", "exact-host"], default="device",
                        help="offline: 'device' (Griffin-Lim on --device, kernel K2 on the "
                             "card) or 'exact-host' (numpy vocoder byte-reproducing the "
                             "reference GriffinLim node incl. its FP-jittered emission grid)")
    args = parser.parse_args(argv)
    if args.profile and os.path.exists(args.profile) and not os.path.isdir(args.profile):
        parser.error(f"--profile {args.profile}: not a directory")
    if args.dispatch_chunk < 1:
        parser.error("--dispatch-chunk must be >= 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {device}: no CUDA device is visible; pass --device cpu "
                     "to run on the CPU")

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
    offline = in_offline_mode(config)
    if args.vocoder != "device" and not offline:
        parser.error("--vocoder exact-host re-synthesizes an offline decode; pass --seeg_file")

    session_dir = config_mod.session_dir(config)
    if not os.path.isdir(session_dir):
        raise FileNotFoundError(f"session directory does not exist: {session_dir}")
    run_dir = config_mod.run_dir(config)
    config_mod.make_output_dir(run_dir, config.getboolean("Decoding", "overwrite_on_rerun", fallback=True))
    config_mod.setup_logging(os.path.join(run_dir, "decode.log"))

    dtype = pipeline.default_compute_dtype(device)
    loaded = params_io.load_params(os.path.join(session_dir, "params.h5"), dtype=dtype)
    logger.info("Ignoring channel indices: [%s]", " ".join(map(str, loaded["bad_channels"])))
    gl_norm = config.getint("Decoding", "griffin_lim_norm")
    rand_init = np.load(args.rand_init) if args.rand_init else None

    with _profiled(args.profile, device):
        if offline:
            with hdf5.File(config["Development"]["seeg_file"], "r") as hf:
                eeg = hf["sEEG"][:]
                sfreq = int(np.asarray(hf["sEEG_sr"]).reshape(-1)[0])
            spectrogram, audio, received, sfreq = perform_offline_decoding(
                loaded, eeg, sfreq, gl_norm, dtype=dtype, device=device, rand_init=rand_init,
                vocoder=args.vocoder)
        else:
            spectrogram, audio, received, sfreq = perform_online_decoding(
                config, loaded, gl_norm, run_dir, backend=args.backend,
                max_packets=args.max_packets, dtype=dtype, device=device,
                chunk_steps=args.dispatch_chunk, rand_init=rand_init, persistent=args.persistent)
    store_decoding_to_file(run_dir, config, spectrogram, audio, received, sfreq)
    return run_dir


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device) and write its Chrome trace to
    ``trace_dir/trace.json``; nothing when ``trace_dir`` is None (the
    counterpart of the JAX CLI's ``jax.profiler.trace``)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    logger.info("Profiling decode into %s", trace_dir)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Profile trace written to %s", path)


if __name__ == "__main__":
    main()
