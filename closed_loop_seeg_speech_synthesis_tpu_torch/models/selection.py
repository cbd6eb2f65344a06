"""Spearman-correlation feature selection (reference ``train.py:96-109``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/models/selection.py``.  Per
feature: Spearman rho against the frame-mean of the target logMels; features
whose column sum is ~0 are forced to rho=0; the 150 largest |rho| are kept in
``np.argsort`` order (ascending |rho|), which fixes the feature order the LDA
models are trained in.

Ranking (average ties, scipy.stats.rankdata semantics) and the correlation
run in torch on the features' device; the final argsort runs on the host
with numpy to match the reference's order, including the NaN-last placement
of zero-variance (railed) channels.
"""

from __future__ import annotations

import numpy as np
import torch


def _rank_average_cols(X: torch.Tensor) -> torch.Tensor:
    """scipy.stats.rankdata(col, method='average') for every column of X.

    With ``lo = #{elements < x}`` and ``hi = #{elements <= x}`` the average
    rank of x over its tie group (1-based positions lo+1..hi) is
    ``(lo + hi + 1) / 2``: two searchsorteds of the columns into their sorted
    copies, on the transposed (F, n) rows, with no scatter.  The integer sum
    is exact, and so is its half in float32 up to n = 2**23.
    """
    cols = X.T.contiguous()  # (F, n)
    srt = torch.sort(cols, dim=1).values
    lo = torch.searchsorted(srt, cols, side="left")
    hi = torch.searchsorted(srt, cols, side="right")
    return ((lo + hi + 1).to(X.dtype) / 2.0).T


def spearman_vs_target(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rho of every feature column of X (n, F) against y (n,)."""
    ry = _rank_average_cols(y[:, None])[:, 0]
    zero_col = torch.isclose(torch.sum(X, dim=0), torch.zeros((), dtype=X.dtype, device=X.device))

    rx = _rank_average_cols(X)
    rxc = rx - torch.mean(rx, dim=0)
    ryc = ry - torch.mean(ry)
    num = rxc.T @ ryc
    # zero variance -> NaN, matching scipy.stats.spearmanr: the reference's
    # np.argsort(|cs|) then sorts NaNs LAST, i.e. a constant-but-nonzero
    # (railed) channel lands INSIDE the selected features (train.py:96-109).
    denom = torch.sqrt(torch.sum(rxc * rxc, dim=0) * torch.sum(ryc * ryc))
    ok = denom > 0
    rhos = torch.where(ok, num / torch.where(ok, denom, 1.0), torch.nan)
    return torch.where(zero_col, 0.0, rhos)  # exact-zero columns forced to 0 (train.py:103-105)


def select_features(X: torch.Tensor, Y: torch.Tensor, nb_feats: int = 150) -> np.ndarray:
    """Indices of the nb_feats best features, in the reference's order
    (ascending |rho|, numpy argsort tie order).  Y: (n, n_bins) logMels."""
    target = torch.mean(Y, dim=1)
    cs = spearman_vs_target(X, target).cpu().numpy()
    return np.argsort(np.abs(cs))[max(-nb_feats, -len(cs)):]


def top_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values, largest first, in ``jax.lax.top_k``'s
    order: NaN above every number, ties lowest index first (a stable
    descending sort; ``torch.topk`` leaves the order of ties unspecified)."""
    return torch.sort(values, descending=True, stable=True).indices[:k]
