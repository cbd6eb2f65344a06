"""Frame schedules, windowed log-power features, and context stacking.

Host half: numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/framing.py``
(``frame_size``, ``warm_start_prefill``, ``exact_frame_ends``,
``streaming_frame_ends``, ``shift_table``, ``periodic_window_matrix`` and the
training grid's ``offline_window_starts`` / ``offline_window_len``); the
schedules are bit-identical (tests/test_torch_host_builders.py).
``frame_count`` and ``periodic_window`` give the streaming grid's frame count
and periodic window plan without its array of frame ends.

Frame k ends at ``round_half_even(fsize + k * shift_samples)`` on the
reference's absolute-time grid (FrameBuffer.py:177), computed in exact
rational arithmetic; at 1024 Hz the grid repeats every 25 frames spanning
exactly 256 samples.  Features are ``log(sum(x^2) + 0.01)`` per window and
channel, stacked over 5 taps spaced 5 frames, channel-major.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side schedules (exact reference arithmetic)
# ---------------------------------------------------------------------------


def frame_size(frame_ms: float, sr: float) -> int:
    """int((frame_ms / 1000) * sr) — FrameBuffer.py:27."""
    return int((float(frame_ms) / 1000.0) * float(sr))


def warm_start_prefill(frame_ms: float, shift_ms: float, sr: float) -> int:
    """Zero-fill length for warm-started buffers — FrameBuffer.py:96."""
    return frame_size(frame_ms, sr) - int((float(shift_ms) / 1000.0) * float(sr))


def _exact_shift(shift_ms: float, sr: float) -> Fraction:
    """shift_ms * sr / 1000 as an exact Fraction of the decimal float reprs."""
    return Fraction(str(float(shift_ms))) * Fraction(str(float(sr))) / 1000


def exact_frame_ends(frame_ms: float, shift_ms: float, sr: float, n: int) -> np.ndarray:
    """The first ``n`` frame ends on the exact streaming grid:
    e_k = N_k + tie(k), N_k = fsize + (k*p)//q, x.5 ties round to even."""
    shift = _exact_shift(shift_ms, sr)
    return _frame_ends_at(frame_size(frame_ms, sr), shift.numerator, shift.denominator,
                          np.arange(n, dtype=np.int64))


def _frame_ends_at(fsize: int, p: int, q: int, k: np.ndarray) -> np.ndarray:
    """e_k at the frame indices ``k`` (int64) for the shift p/q."""
    N = fsize + (k * p) // q
    rem = (k * p) % q
    up = (2 * rem > q) | ((2 * rem == q) & (N % 2 == 1))
    return N + up.astype(np.int64)


def streaming_frame_ends(frame_ms: float, shift_ms: float, sr: float, total_len: int) -> np.ndarray:
    """All frame end positions e_k <= total_len on the streaming grid
    (``total_len`` counts samples including any warm-start prefill)."""
    fsize = frame_size(frame_ms, sr)
    if total_len < fsize:
        return np.zeros(0, dtype=np.int64)
    shift = _exact_shift(shift_ms, sr)
    n_max = int((total_len - fsize) / shift) + 2
    ends = exact_frame_ends(frame_ms, shift_ms, sr, n_max)
    return ends[ends <= total_len]


def frame_count(frame_ms: float, shift_ms: float, sr: float, total_len: int) -> int:
    """``len(streaming_frame_ends(frame_ms, shift_ms, sr, total_len))`` without
    the array.  The ends never decrease and lie within half a sample of
    fsize + k * shift, so frames k <= lo end before ``total_len`` and frames
    k >= hi after it: only the ~2 / shift frames between are evaluated."""
    fsize = frame_size(frame_ms, sr)
    if total_len < fsize:
        return 0
    shift = _exact_shift(shift_ms, sr)
    p, q = shift.numerator, shift.denominator
    n_max = int((total_len - fsize) / shift) + 2
    lo = max(0, (total_len - fsize - 1) * q // p)
    hi = min(n_max, -(-(total_len - fsize + 1) * q // p))
    k = np.arange(lo, hi, dtype=np.int64)
    return lo + int(np.count_nonzero(_frame_ends_at(fsize, p, q, k) <= total_len))


def shift_table(frame_ms: float, shift_ms: float, sr: float, check_horizon: int = 64) -> np.ndarray:
    """Exact periodic diff table d[i] = e_{k+1} - e_k for k = i (mod period);
    the period is q or 2q for shift_samples = p/q reduced."""
    shift = _exact_shift(shift_ms, sr)
    q = shift.denominator
    n = 2 * q * check_horizon + 4
    ends = exact_frame_ends(frame_ms, shift_ms, sr, n + 1)
    d = np.diff(ends)
    for P in (q, 2 * q):
        reps = np.tile(d[:P], len(d) // P + 1)[: len(d)]
        if np.array_equal(d, reps):
            return d[:P].astype(np.int32)
    raise AssertionError(
        f"exact frame schedule at sr={sr}, shift={shift_ms} ms did not repeat "
        f"with period {q} or {2*q}")


MAX_WINDOW_PERIOD = 4096  # the longest period the periodic window plan takes


def periodic_window_matrix(ends: np.ndarray, win: int):
    """(S (P, 2*Ls), Ls, P, origin) 0/1 window-selection matrix of a periodic
    schedule (e_{i+P} = e_i + Ls), or None if the schedule is not usable."""
    ends = np.asarray(ends)
    if len(ends) < 2:
        return None
    d = np.diff(ends)
    for P in range(1, min(len(d), MAX_WINDOW_PERIOD) + 1):
        cand = d[:P]
        reps = np.tile(cand, len(d) // P + 1)[: len(d)]
        if np.array_equal(reps, d):
            Ls = int(cand.sum())
            if win > Ls:
                return None
            origin = int(ends[0]) - win
            return window_matrix(ends[:P], win, Ls, origin), Ls, P, origin
    return None


def window_matrix(ends: np.ndarray, win: int, Ls: int, origin: int) -> np.ndarray:
    """S (P, 2*Ls) of ``periodic_window_matrix`` from the period's P frame ends."""
    S = np.zeros((len(ends), 2 * Ls), dtype=np.float64)
    for i, e in enumerate(ends):
        lo = int(e) - win - origin
        S[i, lo : lo + win] = 1.0
    return S


def periodic_window(frame_ms: float, sr: float, win: int, table: np.ndarray):
    """(Ls, P, origin) of ``periodic_window_matrix(streaming_frame_ends(...), win)``
    (its S: ``window_matrix(exact_frame_ends(..., P), win, Ls, origin)``), or
    None where that is None, from the grid's ``shift_table`` alone, for grids
    of at least 2 len(table) frames.  The diffs repeat with the table's
    period Q, so their smallest period P divides Q, and a prefix of 2 Q - 1
    or more diffs has no smaller one (Fine and Wilf): P is the smallest
    divisor of Q under which the table repeats."""
    Q = len(table)
    P = next(P for P in range(1, Q + 1)
             if Q % P == 0 and np.array_equal(table, np.tile(table[:P], Q // P)))
    Ls = int(table[:P].sum())
    if P > MAX_WINDOW_PERIOD or win > Ls:
        return None
    return Ls, P, frame_size(frame_ms, sr) - win  # the first frame ends at fsize


def offline_window_starts(win_s: float, shift_s: float, sr: float, total_len: int) -> np.ndarray:
    """Training grid (local/offline.py:100-106): start_k = int(round(k*shift*sr)),
    window [start, int(round(start + win*sr))); count = floor((T - win*sr)/(shift*sr)) + 1."""
    num = int(np.floor((total_len - win_s * sr) / (shift_s * sr))) + 1
    starts = np.asarray([int(round((k * shift_s) * sr)) for k in range(max(num, 0))], dtype=np.int64)
    return starts


def offline_window_len(win_s: float, sr: float, starts: np.ndarray | None = None) -> int:
    """stop - start on the training grid: int(round(start + win*sr)) - start,
    checked to be the same for every start (an exactly-.5 fraction of win*sr
    would make it depend on the start's parity)."""
    if starts is None or len(starts) == 0:
        return int(round(win_s * sr))
    lens = {int(round(float(s) + win_s * sr)) - int(s) for s in starts}
    if len(lens) != 1:
        raise ValueError(f"non-constant offline window length: {sorted(lens)}")
    return lens.pop()


# ---------------------------------------------------------------------------
# Device ops (torch)
# ---------------------------------------------------------------------------


def sliding_sumsq(x: torch.Tensor, win: int) -> torch.Tensor:
    """Sliding window sum of squares along axis 0.  x: (T, C) -> (T-win+1, C);
    out[t] = sum(x[t:t+win]**2)."""
    return (x * x).unfold(0, win, 1).sum(-1)


def windowed_logpower(x: torch.Tensor, ends: torch.Tensor, win: int) -> torch.Tensor:
    """log(sum(x[e-win:e]**2, axis=0) + 0.01) for each frame end e.
    x: (T, C); ends: (N,) integer frame ends (exclusive) -> (N, C)."""
    sums = sliding_sumsq(x, win)  # (T-win+1, C); row s covers [s, s+win)
    return torch.log(sums[ends.long() - win] + 0.01)


def windowed_logpower_periodic(x: torch.Tensor, S: torch.Tensor, Ls: int, n_frames: int,
                               origin: int) -> torch.Tensor:
    """log(window sum of squares + 0.01) on a periodic grid: one
    (P, 2*Ls) @ (2*Ls, C) product per period.  x: (T, C) -> (n_frames, C)."""
    P = S.shape[0]
    w = x * x
    T, C = w.shape
    n_periods = -(-n_frames // P)
    need = origin + (n_periods + 1) * Ls
    wp = torch.nn.functional.pad(w, (0, 0, 0, max(0, need - T)))[origin : origin + (n_periods + 1) * Ls]
    a = wp[: n_periods * Ls].reshape(n_periods, Ls, C)
    b = wp[Ls:].reshape(n_periods, Ls, C)
    span = torch.cat([a, b], dim=1)  # (K, 2*Ls, C)
    sums = torch.einsum("pt,ktc->kpc", S.to(x.dtype), span)
    sums = sums.reshape(n_periods * P, C)[:n_frames]
    return torch.log(sums + 0.01)


def stack_context(F: torch.Tensor, model_order: int = 4, step_size: int = 5,
                  zero_pad: bool = True) -> torch.Tensor:
    """out[j] = [F[j - m*step] for m = model_order..0] per channel,
    channel-major flattened (taps oldest-first within a channel).
    zero_pad=True is the streaming warm start (missing history is zeros)."""
    depth = model_order * step_size
    if zero_pad:
        Fp = torch.cat([F.new_zeros((depth,) + tuple(F.shape[1:])), F], dim=0)
    else:
        Fp = F
    n_out = Fp.shape[0] - depth
    taps = [Fp[m * step_size : m * step_size + n_out] for m in range(model_order + 1)]
    stacked = torch.stack(taps, dim=1)  # (N, taps, C) oldest-first
    return stacked.transpose(1, 2).reshape(n_out, -1)
