"""Kernel K2: logMel frames -> int16 audio (Griffin-Lim + the vocoder tail).

Port of ``gl_audio_pallas`` in ``closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py``:
Griffin-Lim on every 480-sample block, cross-block overlap-add times the
window-sum reciprocal, the 7.9 kHz output low-pass blocked at one 160-sample
hop per row, clip, scale and int16.  The CUDA source is ``csrc/gl_audio.cu``;
``gl_audio_plain`` is the same function in plain torch, with the low-pass
boundary states from the same 16-term truncated power sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from .griffinlim import BLOCK_SAMPLES, FFT_SIZE, HOP, StreamingGLOps, streaming_gl_blocks, to_int16
from .iir import BlockedIIR, StateSpace, blocked_operators, make_blocked_iir


@dataclasses.dataclass
class GLAudioOps:
    """Constants of the fused vocoder, in the decode dtype."""

    gl: StreamingGLOps
    lp: BlockedIIR        # output low-pass at block length HOP
    apow: torch.Tensor    # (n_pow, S, S) powers (A^HOP)^p, p < n_pow
    winv: torch.Tensor    # (3, HOP) window-sum reciprocal of rows 0, 1 and >= 2

    @property
    def n_pow(self) -> int:
        return self.apow.shape[0]


def make_gl_audio_ops(gl: StreamingGLOps, lowpass: StateSpace, dtype=torch.float64,
                      device=None, n_pow: int = 16) -> GLAudioOps:
    """Host-side (float64) construction.  ``n_pow`` = 16 puts the truncation of
    the low-pass boundary states at ~4e-14 (pallas_gl._gl_audio_kernel)."""
    A_L = blocked_operators(lowpass, HOP)["A_L"]
    apow = np.stack([np.linalg.matrix_power(A_L, p) for p in range(n_pow)])
    # per-row window sums (GriffinLim.py:156-166): rows 0 and 1 see partial sums
    w = gl.ola_window.to(dtype)
    wsum = torch.stack([w[:HOP], w[:HOP] + w[HOP : 2 * HOP],
                        w[:HOP] + w[HOP : 2 * HOP] + w[2 * HOP :]])
    winv = torch.where(wsum != 0, 1.0 / torch.where(wsum != 0, wsum, torch.ones_like(wsum)),
                       torch.ones_like(wsum))
    return GLAudioOps(gl=gl, lp=make_blocked_iir(lowpass, HOP, dtype, device),
                      apow=torch.as_tensor(apow, dtype=dtype, device=device),
                      winv=winv.to(device))


def gl_audio_plain(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
                   norm: float, iterations: int = 8, phase_bug: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, in the dtype of the constants."""
    dt = ops.winv.dtype
    re = streaming_gl_blocks(log_mels.to(dt), rand_init.to(dt), ops.gl, iterations, phase_bug)
    B = re.shape[0]
    rp = torch.nn.functional.pad(re, (0, 0, 2, 0))        # rows b-2, b-1 of block b
    acc = rp[2:, :HOP] + rp[1:-1, HOP : 2 * HOP] + rp[:-2, 2 * HOP :]
    rows = torch.clamp(torch.arange(B, device=re.device), max=2)
    chunk = acc * ops.winv[rows]
    q = chunk @ ops.lp.Pmat.T                              # (B, S)
    n_pow = ops.n_pow
    qp = torch.nn.functional.pad(q, (0, 0, n_pow, 0))
    s_before = torch.zeros_like(q)
    for p in range(n_pow):                                 # sum_p A^p q_{b-1-p}
        s_before = s_before + qp[n_pow - 1 - p : n_pow - 1 - p + B] @ ops.apow[p].T
    y = s_before @ ops.lp.Cpow.T + chunk @ ops.lp.Tmat.T
    return to_int16(y.reshape(-1), norm)


def gl_audio(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
             norm: float, iterations: int = 8, phase_bug: bool = True) -> torch.Tensor:
    """log_mels (B+1, n_mel), rand_init (B, 480) -> int16 audio (B*160,).
    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/gl_audio.cu`` (float32) or raises."""
    if log_mels.device.type == "cpu":
        return gl_audio_plain(log_mels, rand_init, ops, norm, iterations, phase_bug)
    dev = log_mels.device
    if dev.type != "cuda":
        raise ValueError(f"gl_audio: unsupported device {dev}")
    B = rand_init.shape[0]
    NM = log_mels.shape[1]
    S = ops.lp.dim
    for name, t, shape in (("log_mels", log_mels, (B + 1, NM)),
                           ("rand_init", rand_init, (B, BLOCK_SAMPLES))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"gl_audio: {name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if not 1 <= NM <= 256 or S > 32 or ops.gl.Minv.shape != (NM, FFT_SIZE // 2 + 1):
        raise ValueError(f"gl_audio kernel takes 1..256 mel bins matching Minv and <= 32 "
                         f"low-pass states; got {NM}, Minv {tuple(ops.gl.Minv.shape)}, {S}")
    if ops.winv.device != dev:
        raise ValueError(f"gl_audio: constants on {ops.winv.device}, data on {dev}")
    if B == 0:
        return torch.empty(0, dtype=torch.int16, device=dev)
    f32 = lambda a: a.to(torch.float32).contiguous()
    rd = ops.gl.rdft
    Km = FFT_SIZE // 2  # the Nyquist bin is split off (pallas_gl._split_nyquist)
    consts = (f32(ops.gl.Minv), f32(torch.cat([rd.F_cos[:, :Km], rd.F_sin[:, :Km]], 1)),
              f32(torch.cat([rd.I_cos[:Km], rd.I_sin[:Km]], 0)), f32(rd.F_cos[:, Km]),
              f32(rd.I_cos[Km]), f32(ops.gl.window), f32(ops.winv), f32(ops.lp.Pmat.T),
              f32(ops.apow), f32(ops.lp.Cpow), f32(ops.lp.Tmat[:, 0]))
    G = torch.empty((B, BLOCK_SAMPLES), dtype=torch.float32, device=dev)
    CH = torch.empty((B, HOP), dtype=torch.float32, device=dev)
    Q = torch.empty((B, S), dtype=torch.float32, device=dev)
    out = torch.empty(B * HOP, dtype=torch.int16, device=dev)
    fn = _build.bind(_build.load("gl_audio"), "gl_audio", 17, 6, 1)
    ptrs = (log_mels, rand_init, *consts, G, CH, Q, out)
    err = fn(*(a.data_ptr() for a in ptrs), B, NM, S, ops.n_pow, int(iterations),
             int(bool(phase_bug)), float(norm * 1.01), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gl_audio")
    gl_audio.launches += 1
    return out


gl_audio.launches = 0
