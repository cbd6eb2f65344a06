"""A plain reference of the decoder, for the benchmark's correctness check.

Plain PyTorch and numpy, written from the decoder's definition (the
upstream closed-loop-seeg-speech-synthesis decode path) and not from the
program under test: it imports nothing of it and takes nothing it made.
It works everything out again from the configuration and the inputs the
harness hands to both sides: the filter design and warm start, the frame
grid, the mel filterbank and DFT matrices, and the Griffin-Lim inits.
Float64 on the card, in blocks; ``Arith(torch.float32, tf32=True)`` gives
the control one precision below the configurations' float32.
"""

from __future__ import annotations

import torch

from . import frontend, vocoder
from .arith import Arith


def decode(eeg: torch.Tensor, cfg: dict, weights: dict, seed: int, init_dtype: torch.dtype,
           arith: Arith):
    """(log-mel frames (N, n_mel), int16 audio ((N - 1) * 160,), score
    margins (N, n_mel)) of the raw sEEG (T, C) on its device."""
    mel, margin = frontend.mels(eeg, cfg, weights, arith)
    audio = vocoder.Vocoder(cfg, arith, eeg.device).audio(mel, seed, init_dtype)
    return mel, audio, margin
