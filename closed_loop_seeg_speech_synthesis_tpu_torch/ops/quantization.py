"""Logistic spectrogram quantization (reference ``local/quantization.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/ops/quantization.py``.  Per
mel bin: interval borders/representatives sigmoid-spaced over the bin's
[min, max] (``quantization.py:83-109``); quantization assigns the smallest
interval index whose border is >= the value, leaving values above the last
border at 0 — a reference quirk kept here (``quantization.py:112-122``);
dequantization is a representative lookup (``quantization.py:125-135``).
All three are vectorized across bins and frames (torch).

The sigmoid grids are built on the host in float64 with the formula of
``jnp.linspace`` (``sigmoid_grids``).  XLA evaluates that formula with a
reciprocal multiply and fused multiply-adds, so ``jnp.linspace``'s values
may differ from these by up to two ulps (tests/test_torch_host_builders.py);
the borders then agree to 1e-13 (tests/test_torch_train.py).

``to_categorical`` and ``compute_borders_median_cut`` are host-numpy copies
of the legacy API (present in the reference but unused by its trainer).
"""

from __future__ import annotations

import numpy as np
import torch


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)``'s formula in float64 numpy:
    start * (1 - i/div) + stop * (i/div), with the stop itself appended."""
    div = num - 1
    step = np.arange(div, dtype=np.float64) / div
    return np.concatenate([start * (1 - step) + stop * step, [stop]])


def sigmoid_grids(nb_intervals: int):
    """(t_borders (nb-1,), t_medians (nb,)) float64: the sigmoid's arguments
    for the inner borders and for the representatives."""
    return _linspace(-10.0, 10.0, nb_intervals + 1)[1:-1], _linspace(-9.5, 9.5, nb_intervals)


def compute_borders_logistic(spectrogram: torch.Tensor, nb_intervals: int):
    """spectrogram: (T, n_bins) -> (medians (n_bins, nb), borders (n_bins, nb)).

    sigmoid(t) = L / (1 + exp(-0.5 t)) - |vmin| with L = |vmin| + vmax,
    borders at t = linspace(-10, 10, nb+1)[1:-1] plus vmax as the last
    border; representatives at t = linspace(-9.5, 9.5, nb).
    """
    vmin = torch.amin(spectrogram, dim=0)  # (n_bins,)
    vmax = torch.amax(spectrogram, dim=0)
    L = torch.abs(vmin) + vmax
    t_b, t_m = (torch.as_tensor(t, dtype=spectrogram.dtype, device=spectrogram.device)
                for t in sigmoid_grids(nb_intervals))

    def sigmoid(t):  # t: (n_points,) -> (n_bins, n_points)
        return L[:, None] / (1.0 + torch.exp(-0.5 * t)[None, :]) - torch.abs(vmin)[:, None]

    borders = torch.cat([sigmoid(t_b), vmax[:, None]], dim=1)
    return sigmoid(t_m), borders


def quantize(spectrogram: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """(T, n_bins) values -> (T, n_bins) interval indices (float, like ref).

    Reference semantics: reversed-loop assignment == index of first border
    >= value; values above all borders keep the init value 0
    (quantization.py:114-119).
    """
    above_all = spectrogram > borders[None, :, -1]
    idx = torch.sum(spectrogram[:, :, None] > borders[None, :, :], dim=-1)
    return torch.where(above_all, 0, idx).to(spectrogram.dtype)


def dequantize(q_spectrogram: torch.Tensor, medians: torch.Tensor) -> torch.Tensor:
    """(T, n_bins) indices + medians (n_bins, nb) -> (T, n_bins) values."""
    idx = q_spectrogram.long()  # (T, n_bins)
    # medians[bin, idx[t, bin]] for every (t, bin)
    return torch.gather(medians.expand(idx.shape[0], -1, -1), 2, idx[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# Legacy API parity (present in the reference but unused by its trainer)
# ---------------------------------------------------------------------------


def to_categorical(y, num_classes=None):
    """One-hot encode integer labels (quantization.py:4-17, unused there)."""
    y = np.asarray(y, int)
    shape = y.shape
    flat = y.reshape(-1)
    if not num_classes:
        num_classes = int(flat.max()) + 1
    out = np.zeros((flat.size, num_classes))
    out[np.arange(flat.size), flat] = 1
    return out.reshape(shape + (num_classes,))


def compute_borders_median_cut(spectrogram, nb_intervals):
    """Median-cut interval borders (quantization.py:20-80, the legacy
    quantizer superseded by the logistic one).  Host NumPy.

    Per bin: repeatedly split the largest interval at its median element
    until nb_intervals exist; borders are interval maxima, representatives
    interval medians.
    """
    spectrogram = np.asarray(spectrogram)
    n_bins = spectrogram.shape[1]
    borders = np.zeros((n_bins, nb_intervals))
    medians = np.zeros((n_bins, nb_intervals))
    for b in range(n_bins):
        intervals = [(spectrogram.shape[0], spectrogram[:, b])]
        while len(intervals) < nb_intervals:
            intervals.sort(key=lambda x: x[0])
            data = np.sort(intervals.pop()[1])
            med = data[len(data) // 2]
            left, right = data[data <= med], data[data > med]
            if len(left) > 0 and len(right) > 0:
                intervals += [(len(left), left), (len(right), right)]
            else:
                intervals.append((0, data))
        intervals.sort(key=lambda x: np.median(x[1]))
        borders[b] = [iv[1].max() for iv in intervals]
        medians[b] = [np.median(iv[1]) for iv in intervals]
    return medians, borders
