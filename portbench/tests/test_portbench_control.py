"""The control, the reference one precision below the configurations'
float32 (TF32 products) in the program's place, fails the check.

On the card the control runs at each cell's own size on three seeds or
more (``python3 portbench/control.py``); here at a size the CPU holds,
against the cells' own limits.
"""

import pytest
import torch

from portbench import inputs, judge, manifest

SMALL_SEED = 2**31 + 4321


@pytest.mark.parametrize("cell", ["replay.seeg128_1024hz", "online.seeg128_2048hz"])
def test_the_control_is_not_correct(cell, bench):
    cfg = dict(manifest.config(manifest.cell(bench, cell)["config"]), n_channels=16, n_features=40)
    w = inputs.weights(cfg, SMALL_SEED, "cpu")
    eeg = inputs.session(cfg, int(cfg["sr"]) * 5, SMALL_SEED, "cpu")
    key = inputs.gl_seed(SMALL_SEED)
    spec, audio = judge.control(eeg, cfg, w, key, torch.float32)
    numbers = judge.compare(spec, audio, eeg, cfg, w, key, torch.float32)
    ok, checks = judge.verdict(numbers, judge.limits(cell))
    assert not ok, checks
    assert numbers["audio_off_share"] > 0.5
