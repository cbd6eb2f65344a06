"""Quality metrics (twin of reference ``local/offline.py:195-263``).

Numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/eval/metrics.py``
(``pearson_per_bin``, ``pearson_correlation``, ``kfold_indices``,
``extract_corrs_for_distribution``, ``mann_whitney_u``); scipy is imported
where the Mann-Whitney test runs.
"""

from __future__ import annotations

import numpy as np


def pearson_per_bin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pearson r per column. a, b: (T, n_bins).

    Matches scipy.stats.pearsonr's constant-input semantics (which the
    reference uses per bin, offline.py:207): an exactly-constant column in
    either input yields NaN even when the centered denominator rounds to a
    nonzero ~1e-13 (a chance decode whose LDA predicts one class for every
    frame gives exactly-constant bins, and the reference drops such runs)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    const = np.all(a == a[:1], axis=0) | np.all(b == b[:1], axis=0)
    ac = a - a.mean(axis=0)
    bc = b - b.mean(axis=0)
    num = (ac * bc).sum(axis=0)
    den = np.sqrt((ac * ac).sum(axis=0) * (bc * bc).sum(axis=0))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = num / den
    r[const] = np.nan
    return r


def pearson_correlation(spec1, spec2, return_means=False):
    """Mean/std of per-bin Pearson r (offline.py:195-216); accepts paths."""
    if isinstance(spec1, str):
        spec1 = np.load(spec1)
    if isinstance(spec2, str):
        spec2 = np.load(spec2)
    assert spec1.shape == spec2.shape, "Shapes of spectrograms do not match."
    rs = pearson_per_bin(spec1, spec2)
    if return_means:
        return np.mean(rs), np.std(rs), list(rs)
    return np.mean(rs), np.std(rs)


def kfold_indices(n: int, n_splits: int):
    """sklearn KFold(shuffle=False) contiguous splits: first n % k folds get
    one extra sample."""
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    start = 0
    for s in sizes:
        test = np.arange(start, start + s)
        train = np.concatenate([np.arange(0, start), np.arange(start + s, n)])
        yield train, test
        start += s


def extract_corrs_for_distribution(orig: np.ndarray, reco: np.ndarray, n_folds: int = 10):
    """Distribution of per-bin correlations over contiguous folds
    (offline.py:244-263 uses 10 folds; exp1 uses 5)."""
    rs = np.zeros((n_folds, orig.shape[1]))
    for k, (_, test) in enumerate(kfold_indices(len(orig), n_folds)):
        rs[k] = pearson_per_bin(orig[test], reco[test])
    return np.mean(rs, axis=0), np.std(rs, axis=0)


def mann_whitney_u(x, y, alternative="two-sided"):
    """Mann-Whitney U (used for Fig 3/4 significance, figure_3.py:141-143)."""
    from scipy.stats import mannwhitneyu

    return mannwhitneyu(x, y, alternative=alternative)
