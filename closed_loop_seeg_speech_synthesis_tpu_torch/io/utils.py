"""Host-side utilities (twin of reference ``local/utils.py``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/io/utils.py``:
``select_channels``, ``squeeze_audio_to_float64``, ``benchmark``,
``suppress_stdout`` and ``in_offline_mode``.
"""

from __future__ import annotations

import functools
import logging
import os
import re
import sys
import time
from contextlib import contextmanager

import numpy as np

logger = logging.getLogger("io.utils")


def select_channels(ch_names, patterns):
    """Channels matching at least one anchored regex (utils.py:36-52)."""
    compiled = [re.compile(r"^{}$".format(p)) for p in patterns]
    return [c for c in ch_names if any(p.match(c) for p in compiled)]


def squeeze_audio_to_float64(audio: np.ndarray) -> np.ndarray:
    """Coerce audio into [-1, 1] float64 (utils.py:55-76): integer input or
    out-of-range floats are divided by 2**15 (repeatedly for min/max checks,
    as the reference does)."""
    audio = np.asarray(audio)
    if audio.dtype.kind == "i":
        audio = audio / (2**15)
    if np.max(audio) > 1:
        audio = audio / (2**15)
    if np.min(audio) < -1:
        audio = audio / (2**15)
    return np.asarray(audio, np.float64)


def benchmark(func):
    """Wall-clock logging decorator (utils.py:108-121)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        logger.info("Finished method [%s] in %.4f seconds.", func.__name__, time.perf_counter() - t0)
        return out

    return wrapper


@contextmanager
def suppress_stdout():
    """Silence a noisy block (utils.py:96-105)."""
    with open(os.devnull, "w") as devnull:
        saved = sys.stdout
        sys.stdout = devnull
        try:
            yield
        finally:
            sys.stdout = saved


def in_offline_mode(config) -> bool:
    """True when Development->seeg_file points at an existing file
    (reference utils.py:19-33)."""
    if not config.has_option("Development", "seeg_file"):
        return False
    path = config["Development"]["seeg_file"]
    if not os.path.exists(path):
        raise FileNotFoundError(f"Development seeg_file does not exist: {path}")
    return True
