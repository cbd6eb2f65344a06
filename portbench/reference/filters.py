"""Butterworth filters and their blocked state-space form, in numpy and torch.

The decoder's filters are scipy's ``iirfilter(order, Wn, btype,
ftype='butter')``: the analog Butterworth prototype, its low-pass,
band-pass or band-stop transform at pre-warped edges, and the bilinear
transform, written here from those definitions in zeros, poles and gain.
Each filter is a cascade of second-order sections (conjugate pole pairs
with pairs of zeros) in transposed direct form II, composed into one
state-space system (A, B, C, D).  What the decoder computes depends only on
the transfer functions and on the warm start, which is stated as input
history (``steady_state``), so any realization serves.

Filtering runs in blocks of L samples: within a block the output is a
Toeplitz product of the impulse response with the input plus the free
response of the state at the block's start; the states at the blocks'
starts follow from one another by A^L, and are themselves walked in groups
of blocks (the same two parts one level up), so the host loops over
T / (L G) groups.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .arith import Arith

_FS = 2.0  # scipy designs on normalized frequencies with fs = 2


def _prototype(order: int):
    m = np.arange(-order + 1, order, 2)
    return np.zeros(0, complex), -np.exp(1j * np.pi * m / (2 * order)), 1.0


def _bilinear(z, p, k):
    fs2 = 2.0 * _FS
    degree = len(p) - len(z)
    zd = np.append((fs2 + z) / (fs2 - z), -np.ones(degree))
    pd = (fs2 + p) / (fs2 - p)
    return zd, pd, k * np.real(np.prod(fs2 - z) / np.prod(fs2 - p))


def butter_zpk(order: int, edges_hz, btype: str, sr: float):
    """Digital zeros, poles and gain of scipy's Butterworth design."""
    wn = np.atleast_1d(np.asarray(edges_hz, np.float64)) / (sr / 2.0)
    warped = 2.0 * _FS * np.tan(np.pi * wn / _FS)
    z, p, k = _prototype(order)
    degree = len(p) - len(z)
    if btype == "lowpass":
        z, p, k = z * warped[0], p * warped[0], k * warped[0] ** degree
    elif btype in ("bandpass", "bandstop"):
        bw = warped[1] - warped[0]
        wo = np.sqrt(warped[0] * warped[1])
        if btype == "bandpass":
            zl, pl = z * bw / 2, p * bw / 2
            k = k * bw ** degree
            extra = np.zeros(degree, complex)
        else:
            k = k * np.real(np.prod(-z) / np.prod(-p))
            zl, pl = (bw / 2) / z, (bw / 2) / p
            extra = np.concatenate([np.full(degree, 1j * wo), np.full(degree, -1j * wo)])
        root = lambda v: np.concatenate([v + np.sqrt(v * v - wo * wo), v - np.sqrt(v * v - wo * wo)])
        z, p = np.concatenate([root(zl), extra]), root(pl)
    else:
        raise ValueError(btype)
    return _bilinear(z, p, k)


def _pairs(roots):
    """Roots as real second-order polynomials' root pairs (conjugates
    together, real roots two at a time; a last lone real root alone)."""
    roots = np.asarray(roots, complex)
    cplx = sorted((r for r in roots if r.imag > 1e-12), key=lambda r: (r.real, r.imag))
    real = sorted(r.real for r in roots if abs(r.imag) <= 1e-12)
    if len(cplx) * 2 + len(real) != len(roots):
        raise ValueError("complex roots without their conjugates")
    out = [(r, np.conj(r)) for r in cplx]
    out += [tuple(real[i : i + 2]) for i in range(0, len(real), 2)]
    return out


def _poly2(pair):
    c = np.real(np.poly(pair)) if len(pair) else np.ones(1)
    return np.concatenate([c, np.zeros(3 - len(c))])


@dataclasses.dataclass(frozen=True)
class System:
    """s[t+1] = A s[t] + B u[t],  y[t] = C s[t] + D u[t]."""

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: float

    @property
    def dim(self) -> int:
        return len(self.B)


def _section(b, a) -> System:
    """Transposed direct form II of one section (a[0] = 1)."""
    A = np.array([[-a[1], 1.0], [-a[2], 0.0]])
    B = np.array([b[1] - a[1] * b[0], b[2] - a[2] * b[0]])
    return System(A, B, np.array([1.0, 0.0]), float(b[0]))


def series(first: System, second: System) -> System:
    """``first`` feeding ``second``; the state is the two states stacked."""
    n1, n2 = first.dim, second.dim
    A = np.zeros((n1 + n2, n1 + n2))
    A[:n1, :n1] = first.A
    A[n1:, n1:] = second.A
    A[n1:, :n1] = np.outer(second.B, first.C)
    return System(A, np.concatenate([first.B, second.B * first.D]),
                  np.concatenate([second.D * first.C, second.C]), second.D * first.D)


def zpk_system(z, p, k) -> System:
    """A cascade of sections with the given zeros, poles and gain."""
    zp, pp = _pairs(z), _pairs(p)
    if len(zp) != len(pp):
        raise ValueError("zeros and poles do not pair into sections")
    out = None
    for i, (zs, ps) in enumerate(zip(zp, pp)):
        b = _poly2(zs) * (k if i == 0 else 1.0)
        sec = _section(b, _poly2(ps))
        out = sec if out is None else series(out, sec)
    return out


def butter(order: int, edges_hz, btype: str, sr: float) -> System:
    return zpk_system(*butter_zpk(order, edges_hz, btype, sr))


def high_gamma_chain(sr: float, line_noise: int, order: int = 8):
    """The decoder's filters, in order: band-pass 70-170 Hz, then band-stops
    around the line frequency's harmonics below 170 Hz."""
    chain = [butter(order, (70.0, 170.0), "bandpass", sr)]
    stops = {50: ((98.0, 102.0), (148.0, 152.0)), 60: ((118.0, 122.0),)}[int(line_noise)]
    chain += [butter(order, edges, "bandstop", sr) for edges in stops]
    return chain


def output_lowpass(audio_sr: float, frame_shift_ms: float, cutoff: float = 7900.0) -> System:
    """The vocoder's output low-pass: order (audio_sr / 1000) * shift_ms / 32."""
    order = int((audio_sr / 1000.0) * frame_shift_ms / 32.0)
    return butter(order, (cutoff,), "lowpass", audio_sr)


def steady_state(sys_: System) -> np.ndarray:
    """The state after a unit input held forever."""
    return np.linalg.solve(np.eye(sys_.dim) - sys_.A, sys_.B)


def free_response(sys_: System, s0: np.ndarray, n: int):
    """(outputs y[0..n) for zero input from s0, the state after them)."""
    y, s = np.empty(n), s0.copy()
    for t in range(n):
        y[t] = sys_.C @ s
        s = sys_.A @ s
    return y, s


class Blocked:
    """``System`` operators at block length L, and the grouped walk of the
    blocks' start states, as tensors in an ``Arith``'s dtype."""

    def __init__(self, sys_: System, L: int, group: int, arith: Arith, device):
        A, B, C, D = sys_.A, sys_.B, sys_.C, sys_.D
        S = sys_.dim
        cpow = np.empty((L, S))        # row t: C A^t
        v = C.copy()
        for t in range(L):
            cpow[t] = v
            v = v @ A
        h = np.concatenate([[D], cpow[: L - 1] @ B])
        lag = np.arange(L)[:, None] - np.arange(L)[None, :]
        toe = np.where(lag >= 0, h[np.clip(lag, 0, None)], 0.0)
        pmat = np.empty((S, L))        # column j: A^(L-1-j) B
        w = B.copy()
        for j in range(L - 1, -1, -1):
            pmat[:, j] = w
            w = A @ w
        AL = np.linalg.matrix_power(A, L)
        powers = np.stack([np.linalg.matrix_power(AL, i) for i in range(group + 1)])
        # group Toeplitz: start state i of a group from the blocks' inputs j < i
        gt = np.zeros((group + 1, S, group, S))
        for i in range(1, group + 1):
            for j in range(i):
                gt[i, :, j, :] = powers[i - 1 - j]
        t = lambda a: arith.tensor(a, device)
        self.L, self.G, self.S, self.arith = L, group, S, arith
        self.cpow, self.toe, self.pmat = t(cpow), t(toe), t(pmat)
        self.powers = t(powers[:group])
        self.AG = t(powers[group])
        self.gt = t(gt.reshape((group + 1) * S, group * S))

    def _left(self, M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """M (a, b) times each matrix of X (K, b, n): (K, a, n), as one product."""
        K, b, n = X.shape
        Y = self.arith.mm(M, X.permute(1, 0, 2).reshape(b, K * n))
        return Y.reshape(M.shape[0], K, n).permute(1, 0, 2)

    def __call__(self, x: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
        """Filter x (T, n) from state s0 (S, n): y (T, n)."""
        L, G, S = self.L, self.G, self.S
        T, n = x.shape
        K = -(-T // L)
        Kg = -(-K // G)
        u = torch.nn.functional.pad(x, (0, 0, 0, Kg * G * L - T)).reshape(Kg * G, L, n)
        q = self._left(self.pmat, u)                           # (Kg G, S, n)
        r = self._left(self.gt, q.reshape(Kg, G * S, n)).reshape(Kg, G + 1, S, n)
        starts, s = [], s0
        for g in range(Kg):
            starts.append(s)
            s = self.arith.mm(self.AG, s) + r[g, G]
        sg = torch.stack(starts)                               # (Kg, S, n)
        sb = self.arith.mm(self.powers[None], sg[:, None]) + r[:, :G]  # (Kg, G, S, n)
        y = self._left(self.cpow, sb.reshape(Kg * G, S, n)) + self._left(self.toe, u)
        return y.reshape(Kg * G * L, n)[:T]
