"""General utilities: channel selection, audio coercion, wall-clock
benchmarking, platform checks.

Port of ``closed_loop_seeg_speech_synthesis_tpu/utils/__init__.py``, the
framework's utility surface (mirroring the reference's ``local/utils.py``):
the host-side file helpers of ``io.utils`` re-exported, plus
``check_if_python_shell_is_x64`` and ``dtw_warping``.  ``honor_platform_env``
(a JAX backend knob) and the JAX package's re-exports of its tracing flag
are left out: the port's tracing is ``runtime.tracing``.
"""

from __future__ import annotations

import logging
import struct

from ..io.utils import benchmark, in_offline_mode, select_channels, squeeze_audio_to_float64  # noqa: F401

logger = logging.getLogger("utils")


def check_if_python_shell_is_x64() -> bool:
    """Warn on 32-bit interpreters (reference utils.py:78-84)."""
    mode = struct.calcsize("P") * 8
    if mode != 64:
        logger.warning("Python shell is running in x%d, not x64; large "
                       "recordings may exhaust memory.", mode)
        return False
    return True


def dtw_warping(query_spec, reference):
    """Re-export of the DTW warping helper (reference utils.py:124-138)."""
    from ..eval.dtw import dtw_warping as _dtw

    return _dtw(query_spec, reference)
