"""Stage tracing of the online loop.

Copy of ``closed_loop_seeg_speech_synthesis_tpu/runtime/tracing.py`` (numpy
only).  The reference hangs timestamping Receivers off every node when
``Node.activate_timing()`` is set (Node.py:11-19,52-69,133-140); here the
online loop marks named stages instead: ``packet_in`` when a packet reaches
the decoder, ``step_done`` when its outputs are back on the host, and
``audio_out`` when the audio went to the sink.  ``percentiles`` gives the
latency percentiles of the closed-loop budget (p99 < 10 ms).
"""

from __future__ import annotations

import collections
import time

import numpy as np

_ACTIVE = False


def activate_timing() -> None:
    global _ACTIVE
    _ACTIVE = True


def timing_active() -> bool:
    return _ACTIVE


class StageTracer:
    def __init__(self, enabled: bool | None = None):
        self.enabled = _ACTIVE if enabled is None else enabled
        self.events = collections.OrderedDict()

    def mark(self, stage: str, meta=None) -> float:
        t = time.perf_counter()
        if self.enabled:
            self.events.setdefault(stage, []).append((t, meta))
        return t

    def get_timing_info(self):
        return self.events

    def latencies(self, start_stage: str, end_stage: str) -> np.ndarray:
        a = np.asarray([t for t, _ in self.events.get(start_stage, [])])
        b = np.asarray([t for t, _ in self.events.get(end_stage, [])])
        n = min(len(a), len(b))
        return b[:n] - a[:n]

    def percentiles(self, start_stage: str, end_stage: str, qs=(50, 95, 99)):
        lat = self.latencies(start_stage, end_stage)
        if len(lat) == 0:
            return {q: float("nan") for q in qs}
        return {q: float(np.percentile(lat, q)) for q in qs}
