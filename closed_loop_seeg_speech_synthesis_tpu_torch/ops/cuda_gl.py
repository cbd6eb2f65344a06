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

The Griffin-Lim launch has two regimes, picked by the number of blocks B:
up to ``CLUSTER_MAX_B`` blocks (the online step's 1-4; bf16:
``CLUSTER_MAX_B_BF16``) a thread-block
cluster of 8 CTAs per 4 blocks computes the DFTs in fp32 FMA from the f32
operands held in shared memory; above it (replay) one warp a block computes
them as 256-point complex FFTs in fp32 FMA, from a table of twiddles that
``make_gl_audio_ops`` builds once (``twiddle_table``, ``gl_twiddles``).  The
wrappers count every float32 launch in ``launches`` and those of the FFT
kernel also in ``launches_fft``.

``bf16=True`` (``DecoderConfig.gl_bf16``) is the JAX kernels' ``bf16=True``
branch (``pallas_gl._gl_loop`` with ``mm_t = bfloat16``): the 128 clean-bin
DFT products take bf16 operands and accumulate in float32; everything else
stays float32.  Its plain version is ``_gl_loop_plain``, float32 whatever
the constants' dtype.  On the card both regimes have a bf16 variant: above
``CLUSTER_MAX_B_BF16`` the ``wgmma`` kernel, whose two products read one
shared-memory image of the bf16 forward operand (``wgmma_layout``; the
inverse is that operand transposed, times powers of two), or the cluster's
fp32 FMA on bf16-rounded operands (``gl_bf16``).  The wrappers count its
launches in ``launches_bf16``, apart from the float32 ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build, tf32, wgmma_layout
from .griffinlim import BLOCK_SAMPLES, FFT_SIZE, HOP, StreamingGLOps, streaming_gl_blocks, to_int16
from .iir import BlockedIIR, StateSpace, blocked_operators, make_blocked_iir
from .stft import make_rdft

# Largest B that the cluster kernel takes; above it the FFT kernel (float32)
# or the wgmma kernel (bf16, which takes about as long at any B up to a wave:
# the two cross between 64 and 128 blocks; PERF.md).  In float32 the FFT
# kernel is the faster from 4 blocks on (gl_kernel_probe.py's sweep, PERF.md);
# up to 8 blocks, which holds the online step's 1-4, stay on the cluster.
CLUSTER_MAX_B = 8
CLUSTER_MAX_B_BF16 = 64


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
    gl_twiddles: torch.Tensor  # (256, 4) float32 cos, sin of 2 pi j / 256 and their
                               # remainders: the FFT kernel's (twiddle_table)
    gl_bf16: tuple        # the same two rounded to bf16, as float32 (the cluster
                          # kernel's and the plain version's), then the forward
                          # one's bf16 shared-memory image (the wgmma kernel's
                          # operand for both products: wgmma_layout.sw128_image)
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


def twiddle_table(dtype=torch.float32, device=None) -> torch.Tensor:
    """(256, 4): cos and sin of 2 pi j / 256, computed in float64 and rounded
    once to ``dtype`` (make_rdft's entries are made the same way), then what
    that rounding left of each, rounded (zero in float64): the FFT kernel's
    twiddles, and the second parts with which its ``exact_bin`` sums."""
    ang = 2.0 * np.pi * np.arange(FFT_SIZE) / FFT_SIZE
    cs = np.stack([np.cos(ang), np.sin(ang)], 1)
    hi = torch.as_tensor(cs, dtype=dtype)
    lo = torch.as_tensor(cs - hi.double().numpy(), dtype=dtype)
    return torch.cat([hi, lo], 1).to(device)


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
    gl_f32 = _gl_operands(gl)
    return GLAudioOps(gl=gl, lp=lp, apow=apow, winv=winv, gl_f32=gl_f32,
                      gl_twiddles=twiddle_table(torch.float32, gl_f32[0].device),
                      gl_bf16=(tf32.bf16_round(gl_f32[1]), tf32.bf16_round(gl_f32[2]),
                               wgmma_layout.sw128_image(gl_f32[1])),
                      tail_f32=(_f32(winv), _f32(lp.Pmat.T), _f32(apow), _f32(lp.Cpow),
                                _f32(lp.Tmat[:, 0])))


def _check_inputs(what: str, dev: torch.device, log_mels: torch.Tensor,
                  rand_init: torch.Tensor, gl: StreamingGLOps) -> None:
    """Raise unless log_mels (B+1, NM) and rand_init (B, 480) are contiguous
    float32 on ``dev``, rand_init 16-byte aligned, and the kernel takes NM."""
    B, NM = rand_init.shape[0], log_mels.shape[1]
    for name, t, shape in (("log_mels", log_mels, (B + 1, NM)),
                           ("rand_init", rand_init, (B, BLOCK_SAMPLES))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {dev}; got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if rand_init.data_ptr() % 16:
        raise ValueError(f"{what}: rand_init must start on a 16-byte boundary (the kernel "
                         "copies it in 16-byte pieces)")
    if not 1 <= NM <= 256 or gl.Minv.shape != (NM, FFT_SIZE // 2 + 1):
        raise ValueError(f"{what} kernel takes 1..256 mel bins matching Minv; got {NM}, "
                         f"Minv {tuple(gl.Minv.shape)}")
    if gl.window.device != dev:
        raise ValueError(f"{what}: constants on {gl.window.device}, data on {dev}")


def _gl_loop_plain(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
                   iterations: int, phase_bug: bool, dtype=torch.float32,
                   bf16: bool = True) -> torch.Tensor:
    """Griffin-Lim blocks (B, 480) of the JAX kernels' bf16 branch, in
    float32: ``pallas_gl._gl_loop`` with ``mm_t = bfloat16`` in its split
    form.  Rounded to bf16 (nearest even): the windowed frames before the
    forward product with the 128 clean columns of F_cos and F_sin, zr (and,
    with the converging estimator, zi) before the inverse product, and those
    DFT matrices (``ops.gl_bf16``).  Not rounded: exp(logmel) @ Minv, the
    Nyquist bin (from the unrounded frames) and its inverse row, the phase
    step, the overlap-add.  ``dtype=torch.float64`` evaluates the same
    rounded operands in float64 (the kernels' error budget).  Without
    ``bf16`` nothing is rounded and the DFT matrices are make_rdft's in
    ``dtype`` (in float64 the exact DFT on the float32 Minv and window: the
    float32 kernels' error budget)."""
    dt, Km = dtype, FFT_SIZE // 2
    minv, _, _, fnyq, inyq, win = (t.to(dt) for t in ops.gl_f32)
    if bf16:
        fwd, inv = (t.to(dt) for t in ops.gl_bf16[:2])
        rnd = lambda x: tf32.bf16_round(x).to(dt)
    else:
        rd = make_rdft(FFT_SIZE, dt, win.device)
        fwd = torch.cat([rd.F_cos[:, :Km], rd.F_sin[:, :Km]], 1)
        inv = torch.cat([rd.I_cos[:Km], rd.I_sin[:Km]], 0)
        rnd = lambda x: x
    e = torch.exp(log_mels.to(dt))
    spec_all = e @ minv                                          # (B+1, 129)
    spec_all = torch.where(torch.isfinite(spec_all), spec_all, torch.zeros_like(spec_all))
    zero = torch.zeros((), dtype=dt, device=e.device)
    pi = torch.tensor(np.pi, dtype=dt, device=e.device)

    def one_frame(fr, spec):
        x = rnd(fr) @ fwd                                        # (B, [cos | sin])
        xr, xi = x[:, :Km], -x[:, Km:]
        xrn = (fr * fnyq).sum(dim=1, keepdim=True)
        sp, spn = spec[:, :Km], spec[:, Km:]
        if phase_bug:
            ang = torch.atan2(xi, xr)
            ang = torch.cat([torch.where(xr[:, :1] < 0, pi, zero), ang[:, 1:]], dim=1)
            zr = sp * torch.exp(ang)
            zrn = spn * torch.exp(torch.where(xrn < 0, pi, zero))
            t = rnd(zr) @ inv[:Km]
        else:
            r = torch.sqrt(xr * xr + xi * xi)
            safe = r > 0
            rinv = torch.where(safe, 1.0 / torch.where(safe, r, torch.ones_like(r)), zero)
            zr = sp * torch.where(safe, xr * rinv, torch.ones_like(r))
            zi = sp * (xi * rinv)
            zrn = spn * torch.where(xrn < 0, -1.0, 1.0).to(dt)
            t = rnd(zr) @ inv[:Km] + rnd(zi) @ inv[Km:]
        return (t + zrn * inyq) * win

    pad = torch.nn.functional.pad
    wav = rand_init.to(dt)
    for _ in range(iterations):
        t0 = one_frame(wav[:, :FFT_SIZE] * win, spec_all[:-1])
        t1 = one_frame(wav[:, HOP : HOP + FFT_SIZE] * win, spec_all[1:])
        wav = (pad(t0, (0, BLOCK_SAMPLES - FFT_SIZE))
               + pad(t1, (HOP, BLOCK_SAMPLES - HOP - FFT_SIZE)))
    return wav


def gl_blocks_plain(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
                    iterations: int = 8, phase_bug: bool = True,
                    bf16: bool = False) -> torch.Tensor:
    """Plain torch version of kernel K4, in the dtype of the constants; with
    ``bf16`` the bf16 branch (``_gl_loop_plain``), in float32."""
    if bf16:
        return _gl_loop_plain(log_mels, rand_init, ops, iterations, phase_bug)
    dt = ops.winv.dtype
    return streaming_gl_blocks(log_mels.to(dt), rand_init.to(dt), ops.gl, iterations, phase_bug)


def regime(B: int, bf16: bool = False) -> str:
    """Which Griffin-Lim kernel a launch of B blocks runs: "cluster", else
    "fft" (float32) or "wgmma" (``bf16``); the wrappers pass the choice to
    launch_gl_blocks in csrc/gl_audio.cu.  Reads CLUSTER_MAX_B (bf16:
    CLUSTER_MAX_B_BF16) at each call, so setting it forces a regime (0:
    always the large-B kernel)."""
    if B <= (CLUSTER_MAX_B_BF16 if bf16 else CLUSTER_MAX_B):
        return "cluster"
    return "wgmma" if bf16 else "fft"


def _kernel_operands(ops: GLAudioOps, bf16: bool) -> tuple:
    """The Griffin-Lim launch's constants, in the C entries' order: Minv, the
    forward and inverse DFT operands (in bf16 rounded: the cluster kernel's),
    the Nyquist column and row, the window, then the large-B kernel's
    operand: the FFT's twiddle table, or the bf16 forward operand's image."""
    if not bf16:
        return (*ops.gl_f32, ops.gl_twiddles)
    minv, _, _, fnyq, inyq, win = ops.gl_f32
    fwd, inv, image = ops.gl_bf16
    return (minv, fwd, inv, fnyq, inyq, win, image)


def _count(wrapper, kind: str, bf16: bool) -> None:
    """Count a launch that ran the regime ``kind``."""
    if bf16:
        wrapper.launches_bf16 += 1
        return
    wrapper.launches += 1
    wrapper.launches_fft += int(kind == "fft")


def gl_blocks(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
              iterations: int = 8, phase_bug: bool = True, bf16: bool = False) -> torch.Tensor:
    """Kernel K4: log_mels (B+1, n_mel), rand_init (B, 480) -> Griffin-Lim
    blocks (B, 480) before the overlap-add; block b uses frames b and b+1.
    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/gl_audio.cu`` (float32; with ``bf16`` its bf16 variant) in the
    regime ``regime(B, bf16)`` names, or raises."""
    if log_mels.device.type == "cpu":
        return gl_blocks_plain(log_mels, rand_init, ops, iterations, phase_bug, bf16)
    dev = log_mels.device
    if dev.type != "cuda":
        raise ValueError(f"gl_blocks: unsupported device {dev}")
    _check_inputs("gl_blocks", dev, log_mels, rand_init, ops.gl)
    B, NM = rand_init.shape[0], log_mels.shape[1]
    G = torch.empty((B, BLOCK_SAMPLES), dtype=torch.float32, device=dev)
    if B == 0:
        return G
    fn = _build.bind(_build.load("gl_audio"), "gl_blocks", 10, 6)
    ptrs = (log_mels, rand_init, *_kernel_operands(ops, bf16), G)
    kind = regime(B, bf16)
    err = fn(*(a.data_ptr() for a in ptrs), B, NM, int(iterations), int(bool(phase_bug)),
             int(kind == "cluster"), int(bool(bf16)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gl_blocks")
    _count(gl_blocks, kind, bf16)
    return G


gl_blocks.launches = 0
gl_blocks.launches_fft = 0
gl_blocks.launches_bf16 = 0


def gl_audio_plain(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: GLAudioOps,
                   norm: float, iterations: int = 8, phase_bug: bool = True,
                   bf16: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, in the dtype of the constants; with
    ``bf16`` its Griffin-Lim is the bf16 branch's (``_gl_loop_plain``)."""
    re = gl_blocks_plain(log_mels, rand_init, ops, iterations, phase_bug, bf16)
    return audio_tail_plain(re.to(ops.winv.dtype), ops, norm)


def audio_tail_plain(re: torch.Tensor, ops: GLAudioOps, norm: float) -> torch.Tensor:
    """K2's tail in plain torch: Griffin-Lim blocks (B, 480) -> overlap-add
    times the window-sum reciprocal, the low-pass with its boundary states
    from the truncated power sum, int16 (B*160,)."""
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
             norm: float, iterations: int = 8, phase_bug: bool = True,
             bf16: bool = False) -> torch.Tensor:
    """log_mels (B+1, n_mel), rand_init (B, 480) -> int16 audio (B*160,).
    A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/gl_audio.cu`` (float32, Griffin-Lim in the regime ``regime(B, bf16)``
    names; with ``bf16`` its bf16 variant) or raises."""
    if log_mels.device.type == "cpu":
        return gl_audio_plain(log_mels, rand_init, ops, norm, iterations, phase_bug, bf16)
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
    fn = _build.bind(_build.load("gl_audio"), "gl_audio", 18, 8, 1)
    ptrs = (log_mels, rand_init, *_kernel_operands(ops, bf16), *ops.tail_f32, G, CH, Q, out)
    kind = regime(B, bf16)
    err = fn(*(a.data_ptr() for a in ptrs), B, NM, S, ops.n_pow, int(iterations),
             int(bool(phase_bug)), int(kind == "cluster"), int(bool(bf16)),
             float(norm * 1.01), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gl_audio")
    _count(gl_audio, kind, bf16)
    return out


gl_audio.launches = 0
gl_audio.launches_fft = 0
gl_audio.launches_bf16 = 0
