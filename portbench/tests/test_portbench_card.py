"""The benchmark's command on the card: each cell runs, briefly, and is correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest.benchmark()["workloads"]])
def test_each_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "5", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "online.seeg128_1024hz",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
