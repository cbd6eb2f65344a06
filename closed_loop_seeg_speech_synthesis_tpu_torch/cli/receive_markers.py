"""Marker-stream debug listener (twin of ``experiment/receiveMarkers.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/cli/receive_markers.py``:
prints ``<timestamp + time correction>  <label>`` for every marker on a
marker stream until interrupted.

    python -m closed_loop_seeg_speech_synthesis_tpu_torch.cli.receive_markers \\
        [--stream_name SingleWordsMarkerStream] [--backend lsl|nsx]
"""

from __future__ import annotations

import argparse

from ..runtime.streams import StreamInlet


def main(argv=None):
    parser = argparse.ArgumentParser("Print markers from a marker stream.")
    parser.add_argument("--stream_name", default="SingleWordsMarkerStream")
    parser.add_argument("--backend", choices=["lsl", "nsx"], default=None)
    args = parser.parse_args(argv)

    inlet = StreamInlet(args.stream_name, backend=args.backend)
    print(f"listening on {args.stream_name} ({inlet.backend})", flush=True)
    while True:
        label, ts = inlet.pull_string(timeout=1.0)
        if label is not None:
            correction = inlet.time_correction()
            print(f"{ts + correction:.6f}  {label}", flush=True)


if __name__ == "__main__":
    main()
