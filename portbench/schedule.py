"""The amplifier's open loop and the arithmetic of the end-to-end numbers.

Packets fall due every ``period`` seconds from the window's start, whether
or not the decoder has finished the last one; a packet's latency runs from
its due time to its outputs' arrival, so a stall counts against every
packet that had to wait behind it.  The generator's own lateness (handed
to the decoder after its due time) is reported beside it.

The generator stands for the amplifier, so it hands each packet over at
its due time: it spins on the clock and never sleeps.  A sleeping thread
wakes up late (on an H100 host, measured: by up to 15 ms, 1.5-3.5 ms at
the 99th percentile), and that lateness, not the decoder's, would make the
tail.
"""

from __future__ import annotations

import time

import numpy as np

def wait_until(t: float, clock=time.perf_counter) -> float:
    """Spin on the clock until host time t; returns the time it returned."""
    while True:
        now = clock()
        if now >= t:
            return now


def due_times(start: float, period: float, n: int) -> np.ndarray:
    return start + period * np.arange(n)


def packet_count(seconds: float, period: float) -> int:
    """Packets due in a window of ``seconds``: one at its start and every period after."""
    return int(np.floor(seconds / period + 1e-9))


def latencies(due: np.ndarray, arrived) -> np.ndarray:
    """Seconds from each due time to its arrival, for the packets that arrived."""
    arrived = np.asarray(arrived, np.float64)
    return arrived - due[: len(arrived)]


def percentile_ms(lat_s: np.ndarray, q: float) -> float:
    """The q-th percentile (numpy's linear interpolation) in milliseconds."""
    return float(np.percentile(lat_s, q) * 1e3)


def rate(units: float, seconds: float) -> float:
    return units / seconds
