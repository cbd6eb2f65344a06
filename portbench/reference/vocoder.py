"""The decoder's back half: log-mel frames to int16 audio.

Block b (frames b and b + 1) is 480 samples at 16 kHz, two 256-sample
Blackman frames 160 apart.  Griffin-Lim starts from the block's inits and
iterates: the frames' real DFTs; each bin's new value is the target
magnitude (exp of the mel frame through the normalized transposed mel
filterbank) times exp(angle) of the old one, the upstream decoder's phase
term without the 1j (``phase_bug``), or times its unit phasor without it;
the inverse real DFTs, windowed again and overlapped within the block.
Audio chunk b overlaps blocks b, b - 1 and b - 2 and divides by the
Blackman segments they carry (where that sum is not 0); then the output
low-pass, and int16(clip(x / (1.01 gl_norm), -0.99, 0.99) * 32767),
truncated toward zero.  The DFTs are dense products with cos / sin
matrices, so a lower-precision ``Arith`` reaches them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import filters, threefry
from .arith import Arith

N_FFT, HOP, BLOCK = 256, 160, 480
BLOCK_CHUNK = 32768  # blocks iterated at once


def blackman(n: int) -> np.ndarray:
    """Symmetric Blackman window, summed as scipy's general cosine window sums it."""
    fac = np.linspace(-np.pi, np.pi, n)
    w = np.zeros(n)
    for k, a in enumerate((0.42, 0.50, 0.08)):
        w += a * np.cos(k * fac)
    return w


def mel_inverse(n_mel: int, spec_size: int, sample_rate: float) -> np.ndarray:
    """(n_mel, spec_size): the upstream MelFilterBank's triangular bank
    (edges at floor'd mel-spaced frequencies, floor'd to bins), normalized
    by columns, transposed and normalized by columns again."""
    to_mel = lambda f: 2595.0 * math.log10(1.0 + f / 700.0)
    to_hz = lambda m: 700.0 * (math.pow(10.0, m / 2595.0) - 1.0)
    step = to_mel(sample_rate / 2.0) / (n_mel + 1)
    edges = [int(math.floor(math.floor(to_hz(i * step)) / (sample_rate / 2.0) * spec_size))
             for i in range(n_mel + 2)]
    bank = np.zeros((n_mel, spec_size))
    for i in range(n_mel):
        a, c, b = edges[i : i + 3]
        if c > a:
            bank[i, a:c] = (np.arange(a, c) - a) / float(c - a)
        if b > c:
            bank[i, c:b] = (b - np.arange(c, b)) / float(b - c)

    def norm_columns(x):
        s = x.sum(0)
        s[s == 0] = 1.0
        out = x / s
        out[~np.isfinite(out)] = 0.0
        return out

    return norm_columns(norm_columns(bank.T).T)


class Vocoder:
    """The constants of one configuration's vocoder, in an ``Arith``."""

    def __init__(self, cfg, arith: Arith, device):
        t = lambda a: arith.tensor(a, device)
        n, kb = N_FFT, N_FFT // 2 + 1
        ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(kb)) / n
        sin = np.sin(ang)
        sin[:, [0, kb - 1]] = 0.0                 # bins 0 and N/2 are real
        wk = np.full(kb, 2.0)
        wk[[0, kb - 1]] = 1.0
        self.fcos, self.fsin = t(np.cos(ang)), t(sin)
        self.icos, self.isin = t(wk[:, None] * np.cos(ang).T / n), t(-wk[:, None] * sin.T / n)
        self.win, self.ola = t(blackman(N_FFT)), t(blackman(BLOCK))
        self.minv = t(mel_inverse(int(cfg["n_mel"]), kb, float(cfg["audio_sr"])))
        self.lowpass = filters.Blocked(filters.output_lowpass(float(cfg["audio_sr"]),
                                                              float(cfg["frame_shift_ms"])),
                                       1024, 128, arith, device)
        self.cfg, self.arith, self.device = cfg, arith, device

    def magnitudes(self, mel: torch.Tensor) -> torch.Tensor:
        m = self.arith.mm(torch.exp(mel.to(self.arith.dtype)), self.minv)
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))

    def iterate(self, wav: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One Griffin-Lim iteration on blocks wav (B, 480), target (B, 2, 129)."""
        mm = self.arith.mm
        frames = torch.stack([wav[:, :N_FFT], wav[:, HOP : HOP + N_FFT]], 1) * self.win
        xr, xi = mm(frames, self.fcos), -mm(frames, self.fsin)
        if self.cfg["phase_bug"]:
            ang = torch.atan2(xi, xr)
            edge = torch.where(xr < 0, math.pi, 0.0).to(ang.dtype)
            ang = torch.cat([edge[..., :1], ang[..., 1:-1], edge[..., -1:]], -1)
            t = mm(target * torch.exp(ang), self.icos)
        else:
            r = torch.sqrt(xr * xr + xi * xi)
            safe = r > 0
            inv = torch.where(safe, 1.0 / torch.where(safe, r, torch.ones_like(r)), torch.zeros_like(r))
            t = mm(target * torch.where(safe, xr * inv, torch.ones_like(r)), self.icos) \
                + mm(target * xi * inv, self.isin)
        t = t * self.win
        pad = torch.nn.functional.pad
        return pad(t[:, 0], (0, BLOCK - N_FFT)) + pad(t[:, 1], (HOP, BLOCK - HOP - N_FFT))

    def blocks(self, mel: torch.Tensor, seed: int, init_dtype: torch.dtype) -> torch.Tensor:
        """Griffin-Lim's blocks (N - 1, 480) of log-mel frames (N, n_mel)."""
        spec = self.magnitudes(mel)
        out = []
        for b0 in range(0, spec.shape[0] - 1, BLOCK_CHUNK):
            b1 = min(b0 + BLOCK_CHUNK, spec.shape[0] - 1)
            target = torch.stack([spec[b0:b1], spec[b0 + 1 : b1 + 1]], 1)
            wav = threefry.block_inits(seed, b0, b1 - b0, BLOCK, init_dtype, self.device)
            wav = wav.to(self.arith.dtype)
            for _ in range(int(self.cfg["gl_iterations"])):
                wav = self.iterate(wav, target)
            out.append(wav)
        return torch.cat(out)

    def audio(self, mel: torch.Tensor, seed: int, init_dtype: torch.dtype) -> torch.Tensor:
        """int16 audio ((N - 1) * 160,) of log-mel frames (N, n_mel)."""
        re = self.blocks(mel, seed, init_dtype)
        B = re.shape[0]
        z = re.new_zeros((2, HOP))
        acc = re[:, :HOP] + torch.cat([z[:1], re[:-1, HOP : 2 * HOP]]) \
            + torch.cat([z, re[:-2, 2 * HOP :]])[:B]
        rows = torch.arange(B, device=re.device)[:, None]
        wsum = (self.ola[None, :HOP] + (rows >= 1) * self.ola[None, HOP : 2 * HOP]
                + (rows >= 2) * self.ola[None, 2 * HOP :])
        chunks = torch.where(wsum != 0, acc / torch.where(wsum != 0, wsum, 1.0), acc)
        lp = self.lowpass(chunks.reshape(-1, 1),
                          chunks.new_zeros((self.lowpass.S, 1)))[:, 0]
        x = torch.clamp(lp / (float(self.cfg["gl_norm"]) * 1.01), -0.99, 0.99) * 32767
        return x.to(torch.int16)
