"""Config system: the reference's configparser ``.ini`` public surface.

Copy of ``closed_loop_seeg_speech_synthesis_tpu/io/config.py`` (the helpers
that ``cli/decode.py`` uses).  CLI flags are merged back into the config
object and the merged config is written next to the outputs.
"""

from __future__ import annotations

import configparser
import logging
import os
import sys


def load_config(path: str) -> configparser.ConfigParser:
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file not found: {path}")
    cfg = configparser.ConfigParser()
    cfg.read(path)
    return cfg


def merge_args(config: configparser.ConfigParser, mapping: dict) -> None:
    """Apply CLI overrides: mapping of (section, key) -> value-or-None."""
    for (section, key), value in mapping.items():
        if value is not None:
            if not config.has_section(section):
                config.add_section(section)
            config[section][key] = str(value)


def session_dir(config) -> str:
    return os.path.join(config["General"]["storage_dir"], config["General"]["session"])


def run_dir(config) -> str:
    return os.path.join(session_dir(config), config["Decoding"]["run"])


def make_output_dir(path: str, overwrite: bool) -> None:
    try:
        os.makedirs(path, exist_ok=overwrite)
    except FileExistsError:
        raise FileExistsError(
            f'output directory "{path}" exists and overwrite_on_rerun is False'
        )


def setup_logging(log_file: str) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
        handlers=[logging.FileHandler(log_file, "w+"), logging.StreamHandler(sys.stdout)],
        force=True,
    )
