"""The decoder's front half: raw sEEG to dequantized, smoothed log-mel frames.

1. The high-gamma chain (``filters.high_gamma_chain``) with the decoder's
   warm start: every filter but the last starts as if the input had been
   its first sample forever; the last starts as if a unit input had been
   held forever and then ``prefill`` zeros fed, and its output over those
   zeros leads the framed signal.
2. Frames of ``win`` samples of that signal end at round-half-even(win +
   k * shift) samples, shift = sr * shift_ms / 1000 samples exactly (10.24
   at 1024 Hz): feature = log(sum of squares + 0.01), per frame and channel.
3. Context: the features of the frame and of the frames 5, 10, 15 and 20
   before it (zeros before the first), channel-major, oldest first.
4. Per mel bin an LDA over the selected context features: the first class
   slot of the highest score among the valid ones; its class's median.
5. Gaussian smoothing (sigma 0.5, radius 2, 'reflect') across the bins.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from . import filters
from .arith import Arith

SMOOTH_SIGMA = 0.5
FRAME_BLOCK = 4096  # frames whose windows are summed at once


def frame_len(cfg) -> int:
    return int((float(cfg["frame_len_ms"]) / 1000.0) * float(cfg["sr"]))


def prefill(cfg) -> int:
    return frame_len(cfg) - int((float(cfg["frame_shift_ms"]) / 1000.0) * float(cfg["sr"]))


def frame_ends(cfg, n_samples: int) -> np.ndarray:
    """Frame ends (exclusive) on the framed signal of n_samples + prefill samples."""
    win, total = frame_len(cfg), n_samples + prefill(cfg)
    shift = Fraction(str(float(cfg["frame_shift_ms"]))) * Fraction(str(float(cfg["sr"]))) / 1000
    p, q = shift.numerator, shift.denominator
    k = np.arange(max(total - win, 0) * q // p + 2, dtype=np.int64)
    lo = win + k * p // q                              # win + k p / q, rounded down
    twice_rem = 2 * (k * p % q)
    ends = lo + ((twice_rem > q) | ((twice_rem == q) & (lo % 2 == 1)))
    return ends[ends <= total]


def smoothing_taps():
    x = np.arange(-2, 3, dtype=np.float64)
    w = np.exp(-0.5 * x * x / SMOOTH_SIGMA**2)
    return w / w.sum()


def reflect_sources(n_bins: int) -> np.ndarray:
    """(n_bins, 5): the bin each tap of each output bin reads, 'reflect' at the edges."""
    idx = np.arange(n_bins)[:, None] + np.arange(-2, 3)[None, :]
    idx = np.where(idx < 0, -idx - 1, idx)
    return np.where(idx >= n_bins, 2 * n_bins - idx - 1, idx)


def filtered(eeg: torch.Tensor, cfg, arith: Arith, block: int = 1024, group: int = 64):
    """The framed signal (prefill + T, C): the warm-started chain's output
    after the last filter's zero-fill lead."""
    dev, C = eeg.device, eeg.shape[1]
    chain = filters.high_gamma_chain(float(cfg["sr"]), int(cfg["line_noise"]))
    head = chain[0]
    for f in chain[1:-1]:
        head = filters.series(head, f)
    last = chain[-1]
    lead, s_last = filters.free_response(last, filters.steady_state(last), prefill(cfg))
    whole = filters.series(head, last)
    x = eeg.to(arith.dtype)
    s0 = torch.cat([arith.tensor(filters.steady_state(head), dev)[:, None] * x[0][None, :],
                    arith.tensor(s_last, dev)[:, None].expand(last.dim, C)])
    y = filters.Blocked(whole, block, group, arith, dev)(x, s0)
    return torch.cat([arith.tensor(lead, dev)[:, None].expand(-1, C), y])


def logpower(sig: torch.Tensor, ends: np.ndarray, win: int) -> torch.Tensor:
    """log(sum over each frame's window of the squares + 0.01): (N, C)."""
    out = []
    offs = torch.arange(win, device=sig.device)
    for i in range(0, len(ends), FRAME_BLOCK):
        e = torch.as_tensor(ends[i : i + FRAME_BLOCK], device=sig.device)
        w = sig[(e[:, None] - win + offs[None, :]).reshape(-1)].reshape(len(e), win, -1)
        out.append(torch.log((w * w).sum(1) + 0.01))
    return torch.cat(out)


def selected_context(F: torch.Tensor, select: np.ndarray, cfg) -> torch.Tensor:
    """The selected context features (N, n_feats): feature f is channel
    f // taps at tap f % taps, tap 0 the oldest (model_order * step frames back)."""
    taps, step = int(cfg["model_order"]) + 1, int(cfg["step_size"])
    depth = (taps - 1) * step
    sel = np.asarray(select, np.int64)
    lag = (taps - 1 - sel % taps) * step
    Fp = torch.cat([F.new_zeros((depth, F.shape[1])), F])
    rows = torch.arange(F.shape[0], device=F.device)[:, None] + torch.as_tensor(depth - lag, device=F.device)
    return Fp[rows, torch.as_tensor(sel // taps, device=F.device)[None, :]]


def mels(eeg: torch.Tensor, cfg, weights: dict, arith: Arith):
    """(log-mel frames (N, n_mel), score margins (N, n_mel)): each bin's
    highest valid score less its second highest (inf with one valid class)."""
    dev = eeg.device
    sig = filtered(eeg, cfg, arith)
    F = logpower(sig, frame_ends(cfg, eeg.shape[0]), frame_len(cfg))
    del sig
    x = selected_context(F, weights["select"], cfg)
    coef = arith.tensor(weights["coef"], dev)                          # (bins, k, feats)
    bins, k, feats = coef.shape
    scores = arith.mm(x, coef.reshape(bins * k, feats).T).reshape(-1, bins, k)
    scores = scores + arith.tensor(weights["intercept"], dev)[None]
    valid = torch.as_tensor(np.asarray(weights["valid"], bool), device=dev)
    scores = torch.where(valid[None], scores, torch.full_like(scores, -torch.inf))
    slot = torch.argmax(scores, dim=-1)                                # first of the highest
    top = torch.topk(scores, 2, dim=-1).values
    margin = torch.where(torch.isfinite(top[..., 1]), top[..., 0] - top[..., 1],
                         torch.full_like(top[..., 0], torch.inf))
    classes = torch.as_tensor(np.asarray(weights["classes"], np.int64), device=dev)
    medians = arith.tensor(weights["medians"], dev)
    label = torch.gather(classes.expand(len(slot), -1, -1), 2, slot[..., None])[..., 0]
    deq = torch.gather(medians.expand(len(slot), -1, -1), 2, label[..., None])[..., 0]
    src = torch.as_tensor(reflect_sources(bins), device=dev)
    taps = arith.tensor(smoothing_taps(), dev)
    return (deq[:, src] * taps).sum(-1), margin
