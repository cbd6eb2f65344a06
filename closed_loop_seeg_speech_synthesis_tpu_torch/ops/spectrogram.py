"""Training-target logMel spectrogram (twin of ``local/offline.py:219-241``).

Port of ``compute_spectrogram`` in
``closed_loop_seeg_speech_synthesis_tpu/ops/spectrogram.py``: 16 ms
symmetric-Hann windows every 10 ms over audio prepended with
``overlap = win - shift`` warm-start zeros; |rfft| (two matmuls with the real
DFT matrices) -> logMels.  Window count is
``floor((len(padded) - overlap) / shift)``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mel as mel_ops
from .stft import frame_signal, hann_sym, make_rdft


def compute_spectrogram(
    audio: torch.Tensor,
    sr: int = 16000,
    window_length: float = 0.05,
    window_shift: float = 0.01,
    mel_bins: int = 40,
) -> torch.Tensor:
    """audio: (T,) -> logMel spectrogram (num_windows, mel_bins), on the
    audio's device and in its dtype.

    NB: the trainer calls this with window_length=0.016 (train.py:128).
    """
    dtype, device = audio.dtype, audio.device
    win = int(sr * window_length)
    shift = int(sr * window_shift)
    overlap = win - shift
    padded = torch.cat([torch.zeros(overlap, dtype=dtype, device=device), audio])
    num_windows = int(np.floor((padded.shape[0] - overlap) / shift))
    frames = frame_signal(padded, win, shift, num_windows)  # (N, win)
    w = torch.as_tensor(hann_sym(win), dtype=dtype, device=device)
    xr, xi = make_rdft(win, dtype, device).rfft(frames * w)
    mag = torch.sqrt(xr * xr + xi * xi)
    M, _ = mel_ops.mel_matrices(win // 2 + 1, mel_bins, sr)
    return mel_ops.to_log_mels(mag, torch.as_tensor(M, dtype=dtype, device=device))
