"""Causal IIR filtering as linear state-space block operators.

Host half: numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/iir.py``
(``StateSpace``, ``sos_to_statespace``, ``ba_to_statespace``,
``cascade_statespace``, ``_prefix_powers``, ``make_blocked_iir``,
``make_warmstart_chain``); the float64 arrays are bit-identical
(tests/test_torch_host_builders.py).  ``make_blocked_iir`` returns torch
tensors.  ``iir_scan`` (per sample, the plain sequential reference),
``zero_input_response`` and ``scale_zi_by_first_sample`` are the JAX
helpers in torch.

Device half: ``iir_blocked`` in torch.  An LTI filter

    s[t+1] = A s[t] + B u[t]        y[t] = C s[t] + D u[t]

over blocks of L samples is ``y_k = Tmat u_k + Cpow s_k`` with the block
boundary states ``s_{k+1} = A^L s_k + Pmat u_k``.  The JAX package walks the
boundary states with an associative scan; here ``_boundary_states`` is a
sequential loop over blocks (the replay path's hot filter chain runs in the
``cuda_frontend`` kernel instead).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# ---------------------------------------------------------------------------
# State-space construction (host-side, float64 numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """Scalar-in scalar-out LTI system; state dim S."""

    A: np.ndarray  # (S, S)
    B: np.ndarray  # (S,)
    C: np.ndarray  # (S,)
    D: float

    @property
    def dim(self) -> int:
        return self.A.shape[0]


def biquad_to_statespace(section: np.ndarray) -> StateSpace:
    """One SOS row [b0 b1 b2 a0 a1 a2] -> DF2T state-space whose state is
    scipy's per-section ``zi`` layout."""
    b0, b1, b2, a0, a1, a2 = [float(v) for v in section]
    if a0 != 1.0:
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    A = np.array([[-a1, 1.0], [-a2, 0.0]], dtype=np.float64)
    B = np.array([b1 - a1 * b0, b2 - a2 * b0], dtype=np.float64)
    C = np.array([1.0, 0.0], dtype=np.float64)
    return StateSpace(A, B, C, b0)


def series(first: StateSpace, second: StateSpace) -> StateSpace:
    """Feed ``first``'s output into ``second`` (same-sample cascade)."""
    s1, s2 = first.dim, second.dim
    A = np.zeros((s1 + s2, s1 + s2), dtype=np.float64)
    A[:s1, :s1] = first.A
    A[s1:, s1:] = second.A
    A[s1:, :s1] = np.outer(second.B, first.C)
    B = np.concatenate([first.B, second.B * first.D])
    C = np.concatenate([second.D * first.C, second.C])
    return StateSpace(A, B, C, second.D * first.D)


def sos_to_statespace(sos: np.ndarray) -> StateSpace:
    """Cascade of SOS rows -> one state-space; state = zi.reshape(-1)."""
    ss = biquad_to_statespace(sos[0])
    for row in sos[1:]:
        ss = series(ss, biquad_to_statespace(row))
    return ss


def ba_to_statespace(b: np.ndarray, a: np.ndarray) -> StateSpace:
    """(b, a) transfer function -> DF2T state-space matching scipy.lfilter,
    its state in scipy's ``lfiltic``/``lfilter`` zi layout:
        y    = b0*x + z0
        zi'  = b[i+1]*x + z[i+1] - a[i+1]*y      (z[n] treated as 0)"""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    n = max(len(a), len(b)) - 1
    b = np.pad(b, (0, n + 1 - len(b)))
    a = np.pad(a, (0, n + 1 - len(a)))
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    A = np.zeros((n, n), dtype=np.float64)
    A[:, 0] = -a[1:]
    A[: n - 1, 1:] += np.eye(n - 1)
    B = b[1:] - a[1:] * b[0]
    C = np.zeros(n, dtype=np.float64)
    C[0] = 1.0
    return StateSpace(A, B, C, float(b[0]))


def cascade_statespace(systems) -> StateSpace:
    """Series composition of several StateSpace systems."""
    out = systems[0]
    for nxt in systems[1:]:
        out = series(out, nxt)
    return out


def _prefix_powers(A: np.ndarray, L: int) -> np.ndarray:
    """(L+1, S, S) table of A^0 .. A^L via log-doubling."""
    S = A.shape[0]
    Apow = np.empty((L + 1, S, S), dtype=np.float64)
    Apow[0] = np.eye(S)
    if L >= 1:
        Apow[1] = A
    m = 1
    while m < L:
        k = min(m, L - m)
        np.einsum("tsu,uv->tsv", Apow[1 : k + 1], Apow[m],
                  out=Apow[m + 1 : m + k + 1], optimize=True)
        m += k
    return Apow


@dataclasses.dataclass
class BlockedIIR:
    """Block operators for one LTI system at block length L (tensors)."""

    Cpow: torch.Tensor  # (L, S)    row t = C @ A^t
    Tmat: torch.Tensor  # (L, L)    lower-tri Toeplitz of the impulse response
    Pmat: torch.Tensor  # (S, L)    col j = A^(L-1-j) @ B
    A_L: torch.Tensor   # (S, S)    A^L
    Apow: torch.Tensor  # (L+1, S, S)
    B: torch.Tensor     # (S,)
    C: torch.Tensor     # (S,)
    D: torch.Tensor     # ()
    A: torch.Tensor     # (S, S)

    @property
    def block(self) -> int:
        return self.Cpow.shape[0]

    @property
    def dim(self) -> int:
        return self.Cpow.shape[1]


def blocked_operators(ss: StateSpace, block: int) -> dict:
    """Host-side float64 block operators (numpy), keyed like BlockedIIR."""
    L = int(block)
    Apow = _prefix_powers(ss.A, L)
    Cpow = np.einsum("s,tsu->tu", ss.C, Apow[:L], optimize=True)  # (L, S)
    h = np.empty(L, dtype=np.float64)
    h[0] = ss.D
    if L > 1:
        h[1:] = Cpow[: L - 1] @ ss.B  # C A^(t-1) B for t = 1..L-1
    # Tmat[t, j] = h[t - j] for j <= t, built by striding a padded vector
    hp = np.concatenate([np.zeros(L - 1), h])
    st = hp.strides[0]
    Tmat = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        hp[L - 1 :], shape=(L, L), strides=(st, -st)))
    Pmat = np.ascontiguousarray(
        np.einsum("tsu,u->ts", Apow[L - 1 :: -1], ss.B, optimize=True).T)
    return dict(Cpow=Cpow, Tmat=Tmat, Pmat=Pmat, A_L=Apow[L], Apow=Apow,
                B=ss.B, C=ss.C, D=np.float64(ss.D), A=ss.A)


def make_blocked_iir(ss: StateSpace, block: int, dtype=torch.float64,
                     device=None) -> BlockedIIR:
    """Host-side (float64) construction of the block operators, as tensors."""
    ops = blocked_operators(ss, block)
    return BlockedIIR(**{k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                         for k, v in ops.items()})


@dataclasses.dataclass(frozen=True)
class WarmStartChain:
    """Closed-form warm start of the whole filter chain: the initial state is
    ``zi_scale * x0 + s_const`` and the last filter's zero-fill output prefix
    is ``zf_prefix`` (reference FrameBuffer.py:86-98)."""

    zi_scale: np.ndarray   # (S,)
    s_const: np.ndarray    # (S,)
    zf_prefix: np.ndarray  # (prefill,)
    dim: int
    prefill: int


def make_warmstart_chain(chain_sos, prefill: int) -> tuple[StateSpace, WarmStartChain]:
    """Compose a filter chain (list of SOS arrays) with reference warm-start
    semantics.  Returns (combined StateSpace, WarmStartChain constants)."""
    import scipy.signal as _sig

    systems = [sos_to_statespace(s) for s in chain_sos]
    combined = cascade_statespace(systems)
    zis = [_sig.sosfilt_zi(s).reshape(-1) for s in chain_sos]

    zi_scale = np.zeros(combined.dim)
    s_const = np.zeros(combined.dim)
    alpha = 1.0
    off = 0
    for ss, zi in zip(systems[:-1], zis[:-1]):
        zi_scale[off : off + ss.dim] = zi * alpha
        alpha *= float(ss.C @ zi + ss.D)
        off += ss.dim
    last, zi_last = systems[-1], zis[-1]
    Apow = _prefix_powers(last.A, prefill)
    zf = np.einsum("s,tsu,u->t", last.C, Apow[:prefill], zi_last, optimize=True)
    s_const[off : off + last.dim] = Apow[prefill] @ zi_last

    return combined, WarmStartChain(zi_scale=zi_scale, s_const=s_const,
                                    zf_prefix=zf, dim=combined.dim, prefill=prefill)


# ---------------------------------------------------------------------------
# Per-sample filtering (torch): the plain sequential reference
# ---------------------------------------------------------------------------


def iir_scan(A, B, C, D, x: torch.Tensor, s0: torch.Tensor):
    """Sequential filtering, one sample at a time (the JAX package's
    ``lax.scan``).  A (S, S), B (S,), C (S,), D () tensors; x: (T, C) in,
    s0: (S, C) state; returns (y (T, C), sT (S, C))."""
    ys = []
    s = s0
    for u in x:
        ys.append(C @ s + D * u)
        s = A @ s + B[:, None] * u[None, :]
    y = torch.stack(ys) if ys else x.new_zeros((0,) + x.shape[1:])
    return y, s


def zero_input_response(op: "BlockedIIR", s0: torch.Tensor, n: int):
    """y[t] = C @ A^t @ s0 for t < n, plus the state after n zero samples
    (the reference's warm-start zero-fill, FrameBuffer.py:94-98): filtering
    n zeros from state s0.  s0: (S, C) -> (y (n, C), s (S, C))."""
    parts = []
    s = s0
    for off in range(0, n, op.block):
        m = min(op.block, n - off)
        parts.append(op.Cpow[:m] @ s)
        s = op.Apow[m] @ s
    y = torch.cat(parts, dim=0) if parts else s0.new_zeros((0,) + s0.shape[1:])
    return y, s


def scale_zi_by_first_sample(zi_flat: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Reference cold-start: zi scaled per channel by the first input sample
    (FrameBuffer.py:90-92).  zi_flat: (S,), x0: (C,) -> (S, C)."""
    return zi_flat[:, None] * x0[None, :]


# ---------------------------------------------------------------------------
# Blocked filtering (torch)
# ---------------------------------------------------------------------------


def _boundary_states(A_L: torch.Tensor, q: torch.Tensor, s0: torch.Tensor):
    """States before each block: q (K, S, C), s0 (S, C) -> ((K, S, C), s_K).

    s_{k+1} = A_L s_k + q_k, walked sequentially over the K blocks."""
    K = q.shape[0]
    out = torch.empty_like(q)
    s = s0
    for k in range(K):
        out[k] = s
        s = A_L @ s + q[k]
    return out, s


def iir_blocked(op: BlockedIIR, x: torch.Tensor, s0: torch.Tensor):
    """Filter x: (T, C) from state s0: (S, C).  Returns (y (T, C), sT (S, C)).

    Equivalent to scipy.signal.sosfilt / lfilter with zi=s0.  For a single
    channel (the vocoder's audio low-pass) the block index is the matmul M
    dimension: (K, L) @ (L, L)."""
    T, C = x.shape
    L = op.block
    K = -(-T // L)
    pad = K * L - T
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    u = xp.reshape(K, L, C)

    if C == 1:
        u2 = u[:, :, 0]                                     # (K, L)
        q = (u2 @ op.Pmat.T)[:, :, None]                    # (K, S, 1)
        s_before, _ = _boundary_states(op.A_L, q, s0)
        y = s_before[:, :, 0] @ op.Cpow.T + u2 @ op.Tmat.T  # (K, L)
        y = y.reshape(K * L, 1)[:T]
    else:
        q = torch.einsum("sl,klc->ksc", op.Pmat, u)
        s_before, _ = _boundary_states(op.A_L, q, s0)
        y = (torch.einsum("ls,ksc->klc", op.Cpow, s_before)
             + torch.einsum("tj,kjc->ktc", op.Tmat, u))
        y = y.reshape(K * L, C)[:T]

    # exact state at sample T (padding zeros must not advance the state)
    r = T - (K - 1) * L
    s_last = s_before[K - 1]
    sT = op.Apow[r] @ s_last + op.Pmat[:, L - r:] @ u[K - 1, :r]
    return y, sT
