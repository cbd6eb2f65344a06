"""Fake amplifier: replays a recorded file over the transport at the real
packet cadence (twin of reference ``dev_lsl_streamer.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/dev_streamer.py``:

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.dev_streamer config.ini \\
        [--file rec.hdf] [--stream_name dev_sEEG] [--backend lsl|nsx] [--asap] [--markers]

Micromed cadence: 32-sample packets @1024 Hz, 64 @2048 Hz
(dev_lsl_streamer.py:16-17); wall-clock pacing with sample-counter drift
correction; optional fake marker stream emitting a dummy word every ~3 s.
It needs neither jax nor h5py: ``stream_eeg`` streams an array, ``main``
reads HDF5 and XDF recordings through ``io.loaders``.
"""

from __future__ import annotations

import argparse
import logging
import threading
import time

import numpy as np

from ..io import config as config_mod
from ..io.loaders import load_speech_file
from ..runtime.streams import StreamOutlet, local_clock

logger = logging.getLogger("cli.dev_streamer")

DUMMY_WORDS = ["amper", "copex", "molen", "gister", "vrede", "boot", "akker", "diep"]


def stream_eeg(eeg: np.ndarray, sr: int, stream_name: str = "dev_sEEG",
               stop_event: threading.Event | None = None, asap: bool = False,
               backend=None, loop: bool = False, wait_for_consumers: float = 0.0):
    packet = 64 if sr == 2048 else 32
    outlet = StreamOutlet(stream_name, "EEG", eeg.shape[1], float(sr),
                          source_id="amp", backend=backend)
    logger.info("Streaming %d channels @%d Hz in %d-sample packets on %r",
                eeg.shape[1], sr, packet, stream_name)
    if wait_for_consumers:
        deadline = time.perf_counter() + wait_for_consumers
        while not outlet.have_consumers() and time.perf_counter() < deadline:
            time.sleep(0.02)
    start = time.perf_counter()
    sent = 0
    while not (stop_event and stop_event.is_set()):
        for i in range(0, len(eeg) - packet + 1, packet):
            if stop_event and stop_event.is_set():
                return sent
            outlet.push_chunk(eeg[i : i + packet], local_clock())
            sent += packet
            if not asap:
                # pace by absolute sample count to avoid drift
                target = start + sent / float(sr)
                while time.perf_counter() < target:
                    time.sleep(0.0005)
        if not loop:
            break
    return sent


def stream_fake_markers(words=None, interval: float = 3.0,
                        stream_name: str = "SingleWordsMarkerStream",
                        stop_event: threading.Event | None = None, backend=None,
                        n_words: int | None = None):
    words = words or DUMMY_WORDS
    outlet = StreamOutlet(stream_name, "Markers", 1, 0.0, string_fmt=True, backend=backend)
    outlet.push_sample("experimentStarted", local_clock())
    i = 0
    while not (stop_event and stop_event.is_set()):
        if n_words is not None and i >= n_words:
            break
        w = words[i % len(words)]
        outlet.push_sample(f"start;{w}", local_clock())
        time.sleep(interval * 2 / 3)
        outlet.push_sample(f"end;{w}", local_clock())
        time.sleep(interval / 3)
        i += 1
    outlet.push_sample("experimentEnded", local_clock())


def main(argv=None):
    parser = argparse.ArgumentParser("Replay a recorded file as a fake amplifier stream.")
    parser.add_argument("config", help="Path to config file (Development->file).")
    parser.add_argument("--file", help="Recording to replay (overrides config).")
    parser.add_argument("--stream_name", default="dev_sEEG")
    parser.add_argument("--backend", choices=["lsl", "nsx"], default=None)
    parser.add_argument("--asap", action="store_true", help="No realtime pacing.")
    parser.add_argument("--markers", action="store_true", help="Emit fake experiment markers.")
    parser.add_argument("--marker_stream_name", default=None,
                        help="Marker stream name (defaults to the config's "
                             "Decoding->marker_stream_name, else the reference default).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    config = config_mod.load_config(args.config)
    path = args.file or config["Development"]["file"]
    eeg, eeg_sr, *_ = load_speech_file(path)
    logger.info("Loaded %s: %s @%d Hz", path, eeg.shape, eeg_sr)

    stop = threading.Event()
    if args.markers:
        mk_name = (args.marker_stream_name
                   or config.get("Decoding", "marker_stream_name", fallback="SingleWordsMarkerStream"))
        t = threading.Thread(target=stream_fake_markers,
                             kwargs={"stream_name": mk_name, "stop_event": stop, "backend": args.backend})
        t.daemon = True
        t.start()
    try:
        stream_eeg(eeg.astype(np.float32), eeg_sr, args.stream_name,
                   stop_event=stop, asap=args.asap, backend=args.backend)
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()


if __name__ == "__main__":
    main()
