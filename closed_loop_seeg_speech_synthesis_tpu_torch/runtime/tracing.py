"""Tracing of the decoder: profiler spans and the online loop's stage marks.

``span(name)`` names a stretch of host work in the profiler's trace.  While
a ``torch.profiler`` records (the decode CLI's ``--profile DIR``, or a
caller's own profiler) it is a ``torch.profiler.record_function`` range, in
the same Chrome trace as the device operations, on the same clock and with
the profiler's launch correlation; otherwise it is one shared no-op context
after one check of the profiler's state, and never enters
``record_function``, whose enter and exit cost tens of times that check
even with no profiler running.  The spans are named ``seeg.<stage>``.

``StageTracer`` marks named stages of the online loop on the host clock:
``packet_in`` when a packet reaches the decoder, ``launched`` when its run
was dispatched, ``step_done`` when its outputs are back on the host, and
``audio_out`` when the audio went to the sink.  ``percentiles`` gives the
latency percentiles of the closed-loop budget (p99 < 10 ms).  The
reference hangs timestamping Receivers off every node when
``Node.activate_timing()`` is set (Node.py:11-19,52-69,133-140).
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while the profiler records, else a
    no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class StageTracer:
    def __init__(self):
        self.events = collections.OrderedDict()

    def mark(self, stage: str) -> float:
        t = time.perf_counter()
        self.events.setdefault(stage, []).append(t)
        return t

    def latencies(self, start_stage: str, end_stage: str) -> np.ndarray:
        a = np.asarray(self.events.get(start_stage, []))
        b = np.asarray(self.events.get(end_stage, []))
        n = min(len(a), len(b))
        return b[:n] - a[:n]

    def percentiles(self, start_stage: str, end_stage: str, qs=(50, 95, 99)):
        lat = self.latencies(start_stage, end_stage)
        if len(lat) == 0:
            return {q: float("nan") for q in qs}
        return {q: float(np.percentile(lat, q)) for q in qs}
