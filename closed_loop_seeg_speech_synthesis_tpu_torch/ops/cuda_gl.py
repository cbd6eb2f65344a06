"""Kernels K2 and K4: logMel frames -> int16 audio, and logMel frames ->
Griffin-Lim blocks.

Port of ``gl_audio_pallas`` and ``gl_blocks_pallas`` in
``closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py``.  K2 runs
Griffin-Lim on every 480-sample block, the cross-block overlap-add times the
window-sum reciprocal, the 7.9 kHz output low-pass blocked at one 160-sample
hop per row, clip, scale and int16; K4 stops after Griffin-Lim and returns
the (B, 480) blocks (the split vocoder and the online step).  The CUDA
source of both is ``csrc/gl_audio.cu``; ``gl_audio_plain`` and
``gl_blocks_plain`` are the same functions in plain torch, the former with
the low-pass boundary states from the same 16-term truncated power sum.
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
    """Constants of the vocoder kernels K2 and K4: the plain ones in the decode
    dtype and the kernels' float32 operands, built once with them (the online
    step launches K4 every packet)."""

    gl: StreamingGLOps
    lp: BlockedIIR        # output low-pass at block length HOP
    apow: torch.Tensor    # (n_pow, S, S) powers (A^HOP)^p, p < n_pow
    winv: torch.Tensor    # (3, HOP) window-sum reciprocal of rows 0, 1 and >= 2
    gl_f32: tuple         # Griffin-Lim operands of K2 and K4 (_gl_operands)
    tail_f32: tuple       # K2's tail: winv, Pmat^T, apow, Cpow, Tmat[:, 0]

    @property
    def n_pow(self) -> int:
        return self.apow.shape[0]


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous()


def _gl_operands(gl: StreamingGLOps) -> tuple:
    """Minv, forward [cos | sin] and inverse [cos; sin] DFT matrices without the
    Nyquist bin, the Nyquist column and row (split off as
    pallas_gl._split_nyquist does), and the frame window, float32."""
    rd, Km = gl.rdft, FFT_SIZE // 2
    return (_f32(gl.Minv), _f32(torch.cat([rd.F_cos[:, :Km], rd.F_sin[:, :Km]], 1)),
            _f32(torch.cat([rd.I_cos[:Km], rd.I_sin[:Km]], 0)), _f32(rd.F_cos[:, Km]),
            _f32(rd.I_cos[Km]), _f32(gl.window))


def make_gl_audio_ops(gl: StreamingGLOps, lowpass: StateSpace, dtype=torch.float64,
                      device=None, n_pow: int = 16) -> GLAudioOps:
    """Host-side (float64) construction.  ``n_pow`` = 16 puts the truncation of
    the low-pass boundary states at ~4e-14 (pallas_gl._gl_audio_kernel)."""
    A_L = blocked_operators(lowpass, HOP)["A_L"]
    apow = torch.as_tensor(np.stack([np.linalg.matrix_power(A_L, p) for p in range(n_pow)]),
                           dtype=dtype, device=device)
    # per-row window sums (GriffinLim.py:156-166): rows 0 and 1 see partial sums
    w = gl.ola_window.to(dtype)
    wsum = torch.stack([w[:HOP], w[:HOP] + w[HOP : 2 * HOP],
                        w[:HOP] + w[HOP : 2 * HOP] + w[2 * HOP :]])
    winv = torch.where(wsum != 0, 1.0 / torch.where(wsum != 0, wsum, torch.ones_like(wsum)),
                       torch.ones_like(wsum)).to(device)
    lp = make_blocked_iir(lowpass, HOP, dtype, device)
    return GLAudioOps(gl=gl, lp=lp, apow=apow, winv=winv, gl_f32=_gl_operands(gl),
                      tail_f32=(_f32(winv), _f32(lp.Pmat.T), _f32(apow), _f32(lp.Cpow),
                                _f32(lp.Tmat[:, 0])))


def _check_inputs(what: str, dev: torch.device, log_mels: torch.Tensor,
                  rand_init: torch.Tensor, gl: StreamingGLOps) -> None:
    """Raise unless log_mels (B+1, NM) and rand_init (B, 480) are contiguous
    float32 on ``dev`` and the kernel takes NM."""
    B, NM = rand_init.shape[0], log_mels.shape[1]
    for name, t, shape in (("log_mels", log_mels, (B + 1, NM)),
                           ("rand_init", rand_init, (B, BLOCK_SAMPLES))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if not 1 <= NM <= 256 or gl.Minv.shape != (NM, FFT_SIZE // 2 + 1):
        raise ValueError(f"{what} kernel takes 1..256 mel bins matching Minv; got {NM}, "
                         f"Minv {tuple(gl.Minv.shape)}")
    if gl.window.device != dev:
        raise ValueError(f"{what}: constants on {gl.window.device}, data on {dev}")


def gl_blocks_plain(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
                    iterations: int = 8, phase_bug: bool = True) -> torch.Tensor:
    """Plain torch version of kernel K4, in the dtype of the constants."""
    dt = ops.winv.dtype
    return streaming_gl_blocks(log_mels.to(dt), rand_init.to(dt), ops.gl, iterations, phase_bug)


def gl_blocks(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
              iterations: int = 8, phase_bug: bool = True) -> torch.Tensor:
    """Kernel K4: log_mels (B+1, n_mel), rand_init (B, 480) -> Griffin-Lim
    blocks (B, 480) before the overlap-add; block b uses frames b and b+1.
    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/gl_audio.cu`` (float32) or raises."""
    if log_mels.device.type == "cpu":
        return gl_blocks_plain(log_mels, rand_init, ops, iterations, phase_bug)
    dev = log_mels.device
    if dev.type != "cuda":
        raise ValueError(f"gl_blocks: unsupported device {dev}")
    _check_inputs("gl_blocks", dev, log_mels, rand_init, ops.gl)
    B, NM = rand_init.shape[0], log_mels.shape[1]
    G = torch.empty((B, BLOCK_SAMPLES), dtype=torch.float32, device=dev)
    if B == 0:
        return G
    fn = _build.bind(_build.load("gl_audio"), "gl_blocks", 9, 4)
    ptrs = (log_mels, rand_init, *ops.gl_f32, G)
    err = fn(*(a.data_ptr() for a in ptrs), B, NM, int(iterations), int(bool(phase_bug)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gl_blocks")
    gl_blocks.launches += 1
    return G


gl_blocks.launches = 0


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
    B, NM = rand_init.shape[0], log_mels.shape[1]
    S = ops.lp.dim
    _check_inputs("gl_audio", dev, log_mels, rand_init, ops.gl)
    if S > 32:
        raise ValueError(f"gl_audio kernel takes <= 32 low-pass states; got {S}")
    if ops.winv.device != dev:
        raise ValueError(f"gl_audio: constants on {ops.winv.device}, data on {dev}")
    if B == 0:
        return torch.empty(0, dtype=torch.int16, device=dev)
    G = torch.empty((B, BLOCK_SAMPLES), dtype=torch.float32, device=dev)
    CH = torch.empty((B, HOP), dtype=torch.float32, device=dev)
    Q = torch.empty((B, S), dtype=torch.float32, device=dev)
    out = torch.empty(B * HOP, dtype=torch.int16, device=dev)
    fn = _build.bind(_build.load("gl_audio"), "gl_audio", 17, 6, 1)
    ptrs = (log_mels, rand_init, *ops.gl_f32, *ops.tail_f32, G, CH, Q, out)
    err = fn(*(a.data_ptr() for a in ptrs), B, NM, S, ops.n_pow, int(iterations),
             int(bool(phase_bug)), float(norm * 1.01), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gl_audio")
    gl_audio.launches += 1
    return out


gl_audio.launches = 0
