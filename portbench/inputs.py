"""What the benchmark hands to both the program and the reference, made from --seed.

* ``weights``: a decoder at the published widths (per mel bin an LDA of
  ``n_classes`` classes over ``n_features`` selected context features,
  sorted per-bin class medians), random from the seed, made on the device
  in float32 (the type the decoder serves them in) and held as float64
  numpy copies of those values.
* ``session``: a word-locked session on sEEG noise, made on the device:
  N(0, 1) on every channel plus, on the first half of the channels, a
  120 Hz burst during the first 2 s of every 3 s trial (gain 1.0 to 2.6 by
  word), as ``examples/demo.py`` lays out a session.

Every seed gets the same sizes; only the values differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TRIAL_S, BURST_S, BURST_HZ = 3, 2, 120.0


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's independent streams."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def weights(cfg: dict, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 1))
    bins, k, feats = int(cfg["n_mel"]), int(cfg["n_classes"]), int(cfg["n_features"])
    stacked = (int(cfg["model_order"]) + 1) * int(cfg["n_channels"])
    draw = torch.randn(bins * k * (feats + 2), generator=g, device=device)
    coef = draw[: bins * k * feats].reshape(bins, k, feats) * 0.1
    intercept = draw[bins * k * feats : bins * k * (feats + 1)].reshape(bins, k)
    medians = torch.sort(draw[bins * k * (feats + 1) :].reshape(bins, k), dim=1).values
    select = torch.randperm(stacked, generator=g, device=device)[:feats]
    host = lambda t: t.double().cpu().numpy()
    return {"coef": host(coef), "intercept": host(intercept), "medians": host(medians),
            "select": select.cpu().numpy().astype(np.int64),
            "classes": np.tile(np.arange(k, dtype=np.int32), (bins, 1)),
            "valid": np.ones((bins, k), bool)}


def session(cfg: dict, n_samples: int, seed: int, device) -> torch.Tensor:
    """(n_samples, n_channels) float32 on the device."""
    sr, C = int(cfg["sr"]), int(cfg["n_channels"])
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 2))
    eeg = torch.randn((n_samples, C), generator=g, device=device)
    t = torch.arange(n_samples, device=device, dtype=torch.float64)
    trial = torch.div(t, TRIAL_S * sr, rounding_mode="floor")
    env = torch.where(t - trial * TRIAL_S * sr < BURST_S * sr, 1.0 + 0.4 * (trial % 5), 0.0)
    burst = (env * torch.sin(2 * math.pi * BURST_HZ / sr * t)).to(torch.float32)
    eeg[:, : C // 2] += burst[:, None]
    return eeg


def gl_seed(seed: int) -> int:
    """The Griffin-Lim inits' key seed (PRNGKey of it), within int64."""
    return stream_seed(seed, 3)
