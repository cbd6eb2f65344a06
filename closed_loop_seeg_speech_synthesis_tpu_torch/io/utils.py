"""Host-side utilities: copy of ``in_offline_mode`` from
``closed_loop_seeg_speech_synthesis_tpu/io/utils.py``."""

from __future__ import annotations

import os


def in_offline_mode(config) -> bool:
    """True when Development->seeg_file points at an existing file
    (reference utils.py:19-33)."""
    if not config.has_option("Development", "seeg_file"):
        return False
    path = config["Development"]["seeg_file"]
    if not os.path.exists(path):
        raise FileNotFoundError(f"Development seeg_file does not exist: {path}")
    return True
