"""Dynamic time warping for spectrogram alignment (exp2, figure_4).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/eval/dtw.py`` (numpy on the
host): the same path, the backtrack's ``argmin`` tie order included.

The reference uses ``fastdtw(query, ref, dist=euclidean, radius=len(query))``
(utils.py:124-138) — a radius that large makes fastdtw exact, so we implement
exact DTW directly: an O(N*M) DP with (diag, up, left) transitions and
backtracking, vectorized over the feature dimension.  The warping-path
resampling then follows utils.get_warping_path (linear interpolation of the
path, first index pinned to the reference start).
"""

from __future__ import annotations

import numpy as np


def dtw_path(query: np.ndarray, reference: np.ndarray):
    """Exact DTW with euclidean point distance.

    query: (N, D); reference: (M, D).  Returns (distance, path) where path is
    a list of (i, j) pairs from (0,0) to (N-1, M-1).
    """
    q = np.asarray(query, np.float64)
    r = np.asarray(reference, np.float64)
    if q.ndim == 1:
        q = q[:, None]
    if r.ndim == 1:
        r = r[:, None]
    n, m = len(q), len(r)
    # pairwise euclidean distances
    d2 = np.maximum(
        (q * q).sum(1)[:, None] + (r * r).sum(1)[None, :] - 2.0 * (q @ r.T), 0.0
    )
    dist = np.sqrt(d2)

    INF = np.inf
    acc = np.full((n + 1, m + 1), INF)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        row = dist[i - 1]
        prev = acc[i - 1]
        cur = acc[i]
        # cur[j] = row[j-1] + min(prev[j-1], prev[j], cur[j-1]) — the cur[j-1]
        # dependency forces a scan; do it in one tight loop over j.
        best_prev = np.minimum(prev[:-1], prev[1:])  # min(acc[i-1,j-1], acc[i-1,j])
        c = INF
        for j in range(1, m + 1):
            c = row[j - 1] + min(best_prev[j - 1], c)
            cur[j] = c

    # backtrack
    path = []
    i, j = n, m
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        k = int(np.argmin(moves))
        if k == 0:
            i, j = i - 1, j - 1
        elif k == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return float(acc[n, m]), path


def get_warping_path(query_path: np.ndarray, reference_path: np.ndarray) -> np.ndarray:
    """utils.py:124-131: linear interpolation of (query -> reference) index
    mapping evaluated on an integer grid; first index pinned."""
    qp = np.asarray(query_path, np.float64)
    rp = np.asarray(reference_path, np.float64)
    grid = np.arange(qp.min(), rp.max() + 1)
    warping = np.interp(grid, qp, rp).astype(np.int64)
    warping[0] = int(rp.min())
    return warping


def dtw_warping(query_spec: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Warp ``reference`` onto ``query_spec``'s timeline (utils.py:133-138)."""
    _, path = dtw_path(query_spec, reference)
    q = np.asarray([p[0] for p in path])
    r = np.asarray([p[1] for p in path])
    return reference[get_warping_path(q, r)]
