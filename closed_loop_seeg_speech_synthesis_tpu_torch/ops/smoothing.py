"""Gaussian smoothing across mel bins (reference ``livenodes/Dequantization.py:17``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/smoothing.py``: the
numpy builders (``gaussian_kernel1d``, ``reflect_positions``,
``exact_smooth_table``) are bit-identical to the JAX package's
(tests/test_torch_host_builders.py); ``gaussian_smooth`` and
``smooth_by_table`` run in torch.

scipy.ndimage.gaussian_filter(sigma=0.5) is a 5-tap correlation with
'reflect' boundaries.  Its input is quantized (every dequantized value is one
of the K per-bin medians), so in float64 the smoothed output is gathered
from an exactly-rounded ``n_mel x K^5`` lattice and involves no float
arithmetic at run time: that is what makes the float64 spectrogram
bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float = 0.5, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d weights, float64, length 2r+1."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return phi / phi.sum()


def gaussian_smooth(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Correlate along the last axis with 'reflect' padding, in scipy's
    NI_Correlate1D order: ``center*w0`` first, then symmetric pairs from the
    outermost inward."""
    r = kernel.shape[0] // 2
    left = x[..., :r].flip(-1)
    right = x[..., -r:].flip(-1)
    xp = torch.cat([left, x, right], dim=-1)
    n = x.shape[-1]
    out = xp[..., r : r + n] * kernel[r]
    for j in range(r, 0, -1):
        out = out + (xp[..., r - j : r - j + n] + xp[..., r + j : r + j + n]) * kernel[r - j]
    return out


def reflect_positions(n: int, radius: int) -> np.ndarray:
    """Source bin for each (output bin, window offset) under 'reflect': (n, 2r+1)."""
    idx = np.arange(n)[:, None] + np.arange(-radius, radius + 1)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx >= n, 2 * n - idx - 1, idx)
    return idx


def exact_smooth_table(medians: np.ndarray, sigma: float = 0.5, truncate: float = 4.0):
    """(pos (n_mel, 2r+1) int32, table (n_mel, K**(2r+1)) float64):
    ``table[b, mixed-radix(labels at pos[b])]`` equals scipy's smoothed value."""
    k = gaussian_kernel1d(sigma, truncate)
    r = len(k) // 2
    med = np.asarray(medians, np.float64)
    n, K = med.shape
    w = 2 * r + 1
    pos = reflect_positions(n, r)
    combos = np.stack(np.unravel_index(np.arange(K**w), (K,) * w), axis=1)
    table = np.empty((n, K**w), np.float64)
    for b in range(n):
        vals = med[pos[b][None, :], combos]                 # (K^w, w)
        out = vals[:, r] * k[r]
        for j in range(r, 0, -1):                           # scipy's pair order
            out = out + (vals[:, r - j] + vals[:, r + j]) * k[r - j]
        table[b] = out
    return pos.astype(np.int32), table


def smooth_by_table(labels: torch.Tensor, pos: torch.Tensor, table: torch.Tensor,
                    n_intervals: int) -> torch.Tensor:
    """Bit-exact smoothing as a pure gather: labels (..., n_mel) integer ->
    smoothed (..., n_mel) in the table's dtype."""
    w = pos.shape[1]
    lab = labels.long()[..., pos.long()]                    # (..., n_mel, w)
    # made on the device: a copy from the host could not be recorded in a CUDA graph
    weights = n_intervals ** torch.arange(w - 1, -1, -1, device=lab.device)
    idx = (lab * weights).sum(-1)                           # mixed-radix index
    bins = torch.arange(table.shape[0], device=lab.device).expand_as(idx)
    return table[bins, idx]
