"""Small real DFT as matmuls (the vocoder's 256-point frames).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/stft.py`` (``blackman``,
``hann_sym``, ``hann_periodic``, ``make_rdft``, ``RDFT.rfft``/``irfft``, ``frame_signal``): the
matrices are built in float64 numpy exactly as there, then cast; the windows
are the same scipy calls, byte-matched (docs/NUMERICS.md: a 1-ulp window
change decoheres whole Griffin-Lim blocks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal.windows as _win
import torch


@dataclasses.dataclass
class RDFT:
    """Real DFT operator of size N (N even). rfft: x(...,N) -> (Xr, Xi)(...,N/2+1)."""

    F_cos: torch.Tensor  # (N, K)
    F_sin: torch.Tensor  # (N, K)
    I_cos: torch.Tensor  # (K, N)
    I_sin: torch.Tensor  # (K, N)

    @property
    def n(self) -> int:
        return self.F_cos.shape[0]

    def rfft(self, x: torch.Tensor):
        """x: (..., N) real -> (real, imag) each (..., N//2+1)."""
        return x @ self.F_cos, -(x @ self.F_sin)

    def irfft(self, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        """(real, imag): (..., N//2+1) -> x: (..., N), matching np.fft.irfft."""
        return xr @ self.I_cos + xi @ self.I_sin


def rdft_matrices(n: int) -> dict:
    """float64 numpy (F_cos, F_sin, I_cos, I_sin); sin is zeroed at the
    exactly-real bins 0 and N/2."""
    k = n // 2 + 1
    nn, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    ang = 2.0 * np.pi * nn * kk / n
    cos = np.cos(ang)  # (N, K)
    sin = np.sin(ang)
    sin[:, 0] = 0.0
    if n % 2 == 0:
        sin[:, -1] = 0.0
    w = np.full(k, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    icos = (w[:, None] * cos.T) / n          # (K, N)
    isin = -(w[:, None] * sin.T) / n
    return dict(F_cos=cos, F_sin=sin, I_cos=icos, I_sin=isin)


def make_rdft(n: int, dtype=torch.float64, device=None) -> RDFT:
    return RDFT(**{k: torch.as_tensor(v, dtype=dtype, device=device)
                   for k, v in rdft_matrices(n).items()})


def blackman(n: int) -> np.ndarray:
    """scipy.blackman (symmetric) — GriffinLim.py:50,154."""
    return _win.blackman(n, sym=True).astype(np.float64)


def hann_sym(n: int) -> np.ndarray:
    """scipy.signal.windows.hann(n) — offline compute_spectrogram window."""
    return _win.hann(n, sym=True).astype(np.float64)


def hann_periodic(n: int) -> np.ndarray:
    """scipy.hanning(n+1)[:-1] — offline griffin_lim's 'better reconstruction
    trick' window (local/offline.py:148)."""
    return _win.hann(n + 1, sym=True)[:-1].astype(np.float64)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int, num_frames: int) -> torch.Tensor:
    """Strided framing: out[i] = x[i*hop : i*hop + frame_len].  x: (..., T)
    -> (..., num_frames, frame_len), a view of x."""
    return x.unfold(-1, frame_len, hop)[..., :num_frames, :]
