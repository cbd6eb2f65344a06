"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's data
files cut to a size the CPU decodes in seconds (8 channels, 20 selected
features, a 4-s replay session), read through the same harness."""

import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import manifest  # noqa: E402



@pytest.fixture(scope="session", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="session")
def small_here(tmp_path_factory):
    """A benchmark folder whose configurations and mixes are cut to CPU size."""
    here = tmp_path_factory.mktemp("portbench_small")
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(manifest.HERE, d), here / d)
    for f in (here / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(n_channels=8, n_features=20)
        f.write_text(json.dumps(c))
    for f in (here / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update({k: v for k, v in (("session_s", 4), ("trace_s", 0.2), ("trace_packets", 4))
                  if k in t})
        f.write_text(json.dumps(t))
    return str(here)


@pytest.fixture(scope="session")
def bench():
    return manifest.benchmark()
