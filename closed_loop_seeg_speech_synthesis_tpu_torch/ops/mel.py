"""Triangular mel filterbank with the reference's exact quirks.

Copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/mel.py``:
``mel_matrices`` (float64 numpy, bit-identical), ``to_log_mels`` (the 1e-7
fuzz before the log, MelFilterBank.py:64-83), ``from_log_mels`` and
``from_mels`` (torch), each with the NaN/Inf scrub of MelFilterBank.py:82-83.
The "inverse" is the column-normalized transpose, not a pseudo-inverse
(MelFilterBank.py:38-39).
"""

from __future__ import annotations

import math

import numpy as np
import torch

FUZZ = 1e-7


def _freq_to_mel(freq: float) -> float:
    return 2595.0 * math.log10(1.0 + freq / 700.0)


def _mel_to_freq(mel: float) -> float:
    return 700.0 * (math.pow(10.0, mel / 2595.0) - 1.0)


def _freq_to_bin(freq: float, sample_rate: float, spec_size: int) -> int:
    return int(math.floor((freq / (sample_rate / 2.0)) * spec_size))


def _norm_columns(x: np.ndarray) -> np.ndarray:
    s = np.sum(x, axis=0)
    s[s == 0] = 1.0
    out = x / s
    out[~np.isfinite(out)] = 0.0
    return out


def mel_matrices(spec_size: int, num_coefficients: int, sample_rate: float):
    """Returns (M, Minv): forward (spec_size, n_mel) and the normalized
    transpose (n_mel, spec_size), float64."""
    num_bands = int(num_coefficients)
    max_mel = _freq_to_mel(sample_rate / 2.0)
    mel_step = max_mel / (num_bands + 1)
    edges = np.arange(0, num_bands + 2) * mel_step
    centers = [_freq_to_bin(math.floor(_mel_to_freq(m)), sample_rate, spec_size) for m in edges]

    fm = np.zeros((num_bands, spec_size), dtype=np.float64)
    for i in range(num_bands):
        start, center, end = centers[i : i + 3]
        k1 = float(center - start)
        k2 = float(end - center)
        if center > start:
            fm[i, start:center] = (np.arange(start, center) - start) / k1
        if end > center:
            fm[i, center:end] = (end - np.arange(center, end)) / k2

    M = _norm_columns(fm.T)          # (spec_size, n_mel)
    Minv = _norm_columns(M.T)        # (n_mel, spec_size)
    return M, Minv


def _scrub(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def to_log_mels(spec_mag: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """|spectrogram| (..., spec_size) -> logMels (..., n_mel)."""
    return _scrub(torch.log(spec_mag @ M + FUZZ))


def from_log_mels(log_mels: torch.Tensor, Minv: torch.Tensor) -> torch.Tensor:
    """logMels (..., n_mel) -> linear magnitude estimate (..., spec_size)."""
    return _scrub(torch.exp(log_mels) @ Minv)


def from_mels(mels: torch.Tensor, Minv: torch.Tensor) -> torch.Tensor:
    """Linear mels (..., n_mel) -> linear magnitude estimate (..., spec_size)."""
    return _scrub(mels @ Minv)
