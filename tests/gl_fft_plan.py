"""The FFT plan of the large-B Griffin-Lim kernel (``gl_fft_kernel`` in
``closed_loop_seeg_speech_synthesis_tpu_torch/csrc/gl_audio.cu``), emulated
step for step in torch for the tests (tests/test_torch_gl_fft.py on the CPU;
tests/test_torch_cuda.py holds the kernel's own blocks against it).

The kernel gives each 480-sample audio block one warp.  The block's two
windowed frames go into one 256-point complex FFT, z = f0 + i f1, whose bins
give both frames' real DFTs, the Nyquist bin included: X0[k] = (Z[k] +
conj Z[256 - k]) / 2 and X1[k] = (Z[k] - conj Z[256 - k]) / 2i, k = 0..128.
The inverse runs the same way backwards: W = Y0 + i Y1 of the two corrected
spectra, each extended Hermitian (W[256 - k] = conj Y0[k] + i conj Y1[k]),
through the inverse FFT; frame 0 is the real part and frame 1 the imaginary
part, over 256.  That is make_rdft's inverse exactly: its weights w_k / 256
(w_0 = w_128 = 1, else 2) are the Hermitian extension's, and its sin rows
0 and 128 are 0, so the imaginary parts of Y at DC and Nyquist drop out.

The FFT is 256 = 8 x 8 x 4, decimation in frequency.  Each lane of the
warp holds 8 complex values, in one of three states:

* A: lane a holds n = a + 32 b, b = 0..7: the natural order.  A block's two
  frames are 160 = 5 x 32 samples apart, so the overlap-add stays in the
  lane;
* B: lane ap + 4 kb holds, for b' = 0..7, bin kb of the first stage's
  8-point DFT in lane ap + 4 b';
* C: lane L holds two groups (kb, kc), bin kc of the second stage's 8-point
  DFT of bin kb, each with its 4 final bins k = kb + 8 kc + 64 ka, ka = 0..3
  (``groups``).  The two groups of a lane are partners, k <-> 256 - k, so
  both frames' bins are unpacked, phase-corrected and packed again in the
  lane (``slots``).

Forward: in A an 8-point DFT and the twiddles W256^(a kb); through the
warp's buffer (slot a + 36 kb) into B, an 8-point DFT and the twiddles
W32^(ap kc); through the buffer (slot 4 kb + 33 kc + ap) into C, a 4-point
DFT.  The inverse is the forward's adjoint: the same states backwards, with
conjugate twiddles and inverse DFTs.  In every exchange the 16 lanes of
each half-warp touch 16 distinct 8-byte bank pairs (``bank_ways``).  The
twiddles come from one table of cos and sin of 2 pi j / 256, computed in
float64 and rounded once (``cuda_gl.twiddle_table``, which the kernel
takes).

The phase step divides by the bin (its angle): where a bin is small beside
the block's norm, or under exp(angle) near the branch cut (real and
negative, where the angle jumps between pi and -pi and e^angle between 23
and 0.04), the FFT's rounding would set the result.  Those bins are summed
again as if in twice the precision (``TQ1``, ``TQ2``: the kernel's
``exact_bin``, a compensated dot product over the warp): under exp(angle),
whose spectra come out nearly real, about one in 7,000 (at the cut), with
the converging estimator about one in 10^6.
"""

from __future__ import annotations

import numpy as np
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops.griffinlim import (BLOCK_SAMPLES, FFT_SIZE,
                                                                     HOP)

LANES = 32
SLOTS = 36 * 7 + 31 + 1  # float2 slots of a warp's exchange buffer (A <-> B uses the most)
# Bins summed again (``exact_bins``): |2X|^2 < TQ1 sum |z|^2 (|X| below 2^-12
# of the block's norm), and under exp(angle) real and negative with
# (2 Im X)^2 < TQ2 sum |z|^2 (within 2^-18 of the norm of the branch cut)
TQ1, TQ2 = 2.0**-22, 2.0**-34
# A bin at the branch cut in the error-budget test's own inputs
# (tests/test_torch_cuda.py::test_gl_kernel_tracks_float64, seed 2, 179,999
# blocks): bin 8 of block 61,350's frame 0 is real and negative, its
# imaginary part 2^-27 of the block's norm.  Without the cut rule the FFT's
# rounding puts it on the wrong side, and one iteration under exp(angle) is
# 2.3e-2 off float64 at the frame's centre (sample 128).
CUT_SEED, CUT_B, CUT_BLOCK = 2, 179_999, 61_350


def walk_inputs(seed: int, B: int, lo: int = 0, n: int | None = None) -> tuple:
    """The Griffin-Lim tests' inputs of B blocks from np.random.RandomState(seed):
    log-mel frames (a walk of 40 mel bins around -1, coefficient 0.95,
    steps of standard deviation 0.15) and uniform inits, float32 on the CPU
    (tests/test_torch_cuda.py's ``_gl_inputs``, walk "ar1"); only blocks
    [lo, lo + n) and their n + 1 frames, the inits before block lo drawn in
    pieces and dropped."""
    n = B - lo if n is None else n
    rs = np.random.RandomState(seed)
    x = np.zeros((B + 1, 40))
    e = rs.randn(B + 1, 40) * 0.15
    for i in range(1, B + 1):
        x[i] = 0.95 * x[i - 1] + e[i]
    for c in range(0, lo, 8192):
        rs.rand(min(8192, lo - c), BLOCK_SAMPLES)
    return (torch.as_tensor(x[lo : lo + n + 1] - 1.0, dtype=torch.float32),
            torch.as_tensor(rs.rand(n, BLOCK_SAMPLES), dtype=torch.float32))


def slot_a_to_b(a, kb):
    """Buffer slot of lane a's first-stage bin kb (state A <-> B)."""
    return a + 36 * kb


def slot_b_to_c(kb, kc, ap):
    """Buffer slot of second-stage bin kc of first-stage bin kb in the lanes
    ap + 4 b' (state B <-> C)."""
    return 4 * kb + 33 * kc + ap


def partner(kb: int, kc: int) -> tuple:
    """The group holding bins 256 - k of group (kb, kc)'s bins k (reversed in
    ka); (0, 0), holding DC and Nyquist, is paired with (0, 4), which is its
    own partner as (0, 0) is."""
    if (kb, kc) == (0, 0):
        return 0, 4
    if kb == 0:
        return 0, 8 - kc
    if kb == 4:
        return 4, 7 - kc
    return 8 - kb, 7 - kc


def groups() -> np.ndarray:
    """(32 lanes, 2, 2): the (kb, kc) of each lane's two groups in state C.
    Group 0 of lane L is ((L >> 2) & 3, (L & 3) + 4 (L >> 4)), kb 0 read as 4
    in the second half-warp; group 1 is its partner."""
    out = np.zeros((LANES, 2, 2), np.int64)
    for lane in range(LANES):
        kb, kc = (lane >> 2) & 3, (lane & 3) + 4 * (lane >> 4)
        if lane >= 16 and kb == 0:
            kb = 4
        out[lane] = (kb, kc), partner(kb, kc)
    return out


def bins() -> np.ndarray:
    """(32 lanes, 2, 4): the bin k = kb + 8 kc + 64 ka of each value a lane
    holds in state C, group-major."""
    g = groups()
    return (g[:, :, 0] + 8 * g[:, :, 1])[:, :, None] + 64 * np.arange(4)


# State C positions (4 g + ka) of slot j's bin k < 128 ("lo", the same in
# every lane) and of its partner 256 - k ("hi"; lane 0 holds DC, Nyquist
# and the bins 64, 96 and 32 in its own places: its slot 0 is DC, its hi
# the DC value itself, and Nyquist sits at position 2)
LO = (0, 1, 5, 4)
HI = (7, 6, 2, 3)
HI_LANE0 = (0, 3, 6, 7)
NYQUIST = 2  # position of bin 128 in lane 0


def slots() -> tuple:
    """(lo, hi, k): (32, 4) state C positions of each lane's 4 bins, of their
    partners, and the bins (k < 128; lane 0's slot 0 is DC)."""
    lo = np.tile(np.array(LO), (LANES, 1))
    hi = np.tile(np.array(HI), (LANES, 1))
    hi[0] = HI_LANE0
    k = bins().reshape(LANES, 8)
    return lo, hi, np.take_along_axis(k, lo, 1)


def bank_ways() -> int:
    """The most 8-byte words of one exchange that a half-warp's 16 lanes put
    on one bank pair (1: no conflict), over every access of both exchanges."""
    lane = np.arange(LANES)
    kb, ap = lane >> 2, lane & 3
    g = groups()
    accesses = [slot_a_to_b(lane, k) for k in range(8)]                 # A writes, reads back
    accesses += [slot_a_to_b(ap + 4 * b, kb) for b in range(8)]          # B reads, writes back
    accesses += [slot_b_to_c(kb, kc, ap) for kc in range(8)]             # B writes, reads back
    accesses += [slot_b_to_c(g[:, h, 0], g[:, h, 1], a) for h in range(2) for a in range(4)]
    ways = 1
    for slot in accesses:
        for half in (slot[:16], slot[16:]):
            ways = max(ways, np.bincount(half % 16).max())
    return int(ways)


def _dft4(y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """4-point DFTs over the last axis, in the kernel's butterflies."""
    rot = 1j if inverse else -1j
    e0, e1 = y[..., 0] + y[..., 2], y[..., 0] - y[..., 2]
    e2, e3 = y[..., 1] + y[..., 3], (y[..., 1] - y[..., 3]) * rot
    return torch.stack([e0 + e2, e1 + e3, e0 - e2, e1 - e3], -1)


def _dft8(v: torch.Tensor, inverse: bool, c: float) -> torch.Tensor:
    """8-point DFTs over the last axis: a radix-2 step (the odd half times
    e^(-+i pi n / 4), c = cos(pi / 4) in the data's precision), then two
    4-point DFTs giving the even and the odd bins."""
    s = 1.0 if inverse else -1.0
    a = v[..., :4] + v[..., 4:]
    d = v[..., :4] - v[..., 4:]
    rot = torch.tensor([1, complex(c, s * c), s * 1j, complex(-c, s * c)], dtype=v.dtype,
                       device=v.device)
    even, odd = _dft4(a, inverse), _dft4(d * rot, inverse)
    return torch.stack([even, odd], -1).reshape(v.shape)


def _twiddles(tw: torch.Tensor, dtype: torch.dtype) -> tuple:
    """The per-lane twiddles W256^(a kb) of state A and W32^(ap kc) of state B,
    (32, 8) complex, from the table."""
    w = torch.complex(tw[:, 0], -tw[:, 1]).to(dtype)  # the float32 parts: columns 0, 1
    lane, j = torch.arange(LANES), torch.arange(8)
    return w[(lane[:, None] * j) % FFT_SIZE], w[(8 * (lane[:, None] & 3) * j) % FFT_SIZE]


def forward(z: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """z (..., 32, 8) complex in state A -> its FFT (..., 32, 8) in state C
    (position 4 g + ka of lane L holds bin ``bins()[L, g, ka]``)."""
    w1, w2 = _twiddles(tw, z.dtype)
    c = tw[FFT_SIZE // 8, 0].item()
    lane = torch.arange(LANES)
    kb, ap = lane >> 2, lane & 3
    x = _dft8(z, False, c) * w1                                          # A
    buf = z.new_zeros(z.shape[:-2] + (SLOTS,))
    buf[..., slot_a_to_b(lane[:, None], torch.arange(8))] = x
    x = buf[..., slot_a_to_b((ap + 4 * torch.arange(8)[:, None]).T, kb[:, None])]
    x = _dft8(x, False, c) * w2                                          # B
    buf[..., slot_b_to_c(kb[:, None], torch.arange(8), ap[:, None])] = x
    g = torch.as_tensor(groups())
    x = buf[..., slot_b_to_c(g[:, :, 0, None], g[:, :, 1, None], torch.arange(4))]
    return _dft4(x, False).reshape(z.shape)                              # C


def inverse(t: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``forward``: (..., 32, 8) in state C -> sum_k W[k]
    e^(2 pi i n k / 256) (..., 32, 8) in state A, not divided by 256."""
    w1, w2 = _twiddles(tw, t.dtype)
    c = tw[FFT_SIZE // 8, 0].item()
    lane = torch.arange(LANES)
    kb, ap = lane >> 2, lane & 3
    x = _dft4(t.reshape(t.shape[:-1] + (2, 4)), True)                     # C
    buf = t.new_zeros(t.shape[:-2] + (SLOTS,))
    g = torch.as_tensor(groups())
    buf[..., slot_b_to_c(g[:, :, 0, None], g[:, :, 1, None], torch.arange(4))] = x
    x = buf[..., slot_b_to_c(kb[:, None], torch.arange(8), ap[:, None])] * w2.conj()
    x = _dft8(x, True, c)                                                # B
    buf[..., slot_a_to_b((ap + 4 * torch.arange(8)[:, None]).T, kb[:, None])] = x
    x = buf[..., slot_a_to_b(lane[:, None], torch.arange(8))] * w1.conj()
    return _dft8(x, True, c)                                             # A


def natural(t: torch.Tensor) -> torch.Tensor:
    """(..., 32, 8) in state C -> (..., 256) in bin order."""
    out = t.new_zeros(t.shape[:-2] + (FFT_SIZE,))
    out[..., torch.as_tensor(bins().reshape(LANES, 8))] = t
    return out


def to_lanes(x: torch.Tensor) -> torch.Tensor:
    """(..., 256) in sample order -> (..., 32, 8) in state A."""
    return x.reshape(x.shape[:-1] + (8, LANES)).transpose(-1, -2)


def from_lanes(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_lanes``."""
    return x.transpose(-1, -2).reshape(x.shape[:-2] + (FFT_SIZE,))


def _real_angle(x: torch.Tensor) -> torch.Tensor:
    """The angle of an exactly real bin x: pi where x < 0, else 0."""
    return torch.where(x < 0, torch.tensor(np.pi, dtype=x.dtype), torch.zeros_like(x))


def _phase(x: torch.Tensor, sp: torch.Tensor, exact_real: torch.Tensor,
           phase_bug: bool) -> torch.Tensor:
    """The phase step of streaming_gl_blocks on bins x (complex): exp(angle)
    with the exactly real bins at angle 0 or pi, or the unit phasor."""
    xr, xi = x.real, x.imag
    if phase_bug:
        ang = torch.where(exact_real, _real_angle(xr), torch.atan2(xi, xr))
        return torch.complex(sp * torch.exp(ang), torch.zeros_like(sp))
    r = torch.sqrt(xr * xr + xi * xi)
    safe = r > 0
    inv = torch.where(safe, 1.0 / torch.where(safe, r, torch.ones_like(r)), torch.zeros_like(r))
    return torch.complex(sp * torch.where(safe, xr * inv, torch.ones_like(r)), sp * (xi * inv))


def exact_bins(f: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """Frames (..., 256) -> their bins 0..128, summed in float64 and rounded
    to ``dtype`` (the kernel's ``exact_bin``)."""
    n = torch.arange(FFT_SIZE, dtype=torch.float64)
    ang = 2.0 * np.pi * torch.outer(n, n[: FFT_SIZE // 2 + 1]) / FFT_SIZE
    x = f.to(torch.float64)
    return torch.complex(x @ torch.cos(ang), -(x @ torch.sin(ang))).to(dtype)


def phase_inputs(z: torch.Tensor, tw: torch.Tensor, phase_bug: bool,
                 frames: torch.Tensor) -> tuple:
    """From the frames z = f0 + i f1 (B, 32, 8) in state A: their FFT Z in
    state C, the bins the phase step takes, each frame's 4 slots (B, 32, 4)
    at twice their value (``slots``; the phase step is blind to a scale of
    2), and the Nyquist bins (B,) of both frames; the ill-conditioned ones
    summed again (``TQ1``, ``TQ2``: lane 0's DC only by the first) from
    ``frames`` (B, 2, 256), the frames as the kernel's ``exact_bin`` sees
    them: each frame before its window times the window, exact."""
    lo, hi, k = (torch.as_tensor(a) for a in slots())
    rows = torch.arange(LANES)[:, None]
    dc = torch.zeros(LANES, 4, dtype=torch.bool)
    dc[0, 0] = True
    en = (z.real * z.real + z.imag * z.imag).sum((-2, -1))[:, None, None]
    Z = forward(z, tw)
    zl, zh = Z[:, rows, lo], Z[:, rows, hi]
    x0 = zl + zh.conj()
    x1 = torch.complex(zl.imag + zh.imag, zh.real - zl.real)
    ex = [exact_bins(frames[:, h], z.dtype) for h in (0, 1)]             # (B, 129) each
    x0, x1 = (torch.where((x.abs() ** 2 < TQ1 * en) | (phase_bug & ~dc & (x.real < 0)
                                                       & (x.imag ** 2 < TQ2 * en)),
                          2 * xe[:, k], x) for x, xe in ((x0, ex[0]), (x1, ex[1])))
    nyq = [torch.where(4 * x ** 2 < TQ1 * en[:, 0, 0], xe[:, FFT_SIZE // 2].real, x)
           for x, xe in ((Z[:, 0, NYQUIST].real, ex[0]), (Z[:, 0, NYQUIST].imag, ex[1]))]
    return Z, x0, x1, nyq[0], nyq[1]


def gl_blocks(log_mels: torch.Tensor, rand_init: torch.Tensor, minv: torch.Tensor,
              window: torch.Tensor, tw: torch.Tensor, iterations: int,
              phase_bug: bool) -> torch.Tensor:
    """Griffin-Lim blocks (B, 480) as the kernel computes them, in the dtype
    of ``window``: per block and iteration, the two frames' FFT in state C,
    each lane's 4 bins unpacked from their partners (``slots``; the factor
    1/2 is left out, the phase step being blind to a scale of 2), the
    ill-conditioned ones summed again (``TQ1``, ``TQ2``), the phase step on
    both frames, W packed back in place, the inverse FFT, the window and the
    in-block overlap-add in state A."""
    dt = window.dtype
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    tw = tw.to(dt)
    e = torch.exp(log_mels.to(dt))
    spec = e @ minv.to(dt)
    spec = torch.where(torch.isfinite(spec), spec, torch.zeros_like(spec))
    lo, hi, k = (torch.as_tensor(a) for a in slots())
    rows = torch.arange(LANES)[:, None]
    sp = [spec[h : h + rand_init.shape[0]] for h in (0, 1)]               # (B, 129) of frames 0, 1
    sp_k = [s[:, k] for s in sp]                                          # (B, 32, 4)
    dc = torch.zeros(LANES, 4, dtype=torch.bool)
    dc[0, 0] = True
    w = to_lanes(window.to(dt))
    wav = rand_init.to(dt)
    pad = torch.nn.functional.pad
    u0, u1 = to_lanes(wav[:, :FFT_SIZE]), to_lanes(wav[:, HOP : HOP + FFT_SIZE])
    for it in range(iterations):
        frames = torch.stack([from_lanes(u) for u in (u0, u1)], 1).double() * window.double()
        Z, x0, x1, *nyq = phase_inputs(torch.complex(u0 * w, u1 * w).to(cdt), tw, phase_bug,
                                       frames)
        y0, y1 = (_phase(x, s, dc, phase_bug) for x, s in ((x0, sp_k[0]), (x1, sp_k[1])))
        W = Z.clone()
        W[:, rows, hi] = y0.conj() + 1j * y1.conj()
        W[:, rows, lo] = y0 + 1j * y1                   # lane 0's DC: its lo is its hi
        W[:, 0, NYQUIST] = torch.complex(*(
            s[:, FFT_SIZE // 2] * (torch.exp(_real_angle(x)) if phase_bug
                                   else torch.where(x < 0, -1.0, 1.0).to(dt))
            for x, s in ((nyq[0], sp[0]), (nyq[1], sp[1]))))
        y = inverse(W, tw)
        t0, t1 = y.real / FFT_SIZE * w, y.imag / FFT_SIZE * w
        if it + 1 < iterations:                         # sample n of frame 1 is n + 160 of frame 0
            z = torch.zeros_like(t0[..., :1])
            u0 = t0 + torch.cat([z, z, z, z, z, t1[..., :3]], -1)
            u1 = torch.cat([t0[..., 5:], z, z, z, z, z], -1) + t1
        else:
            return (pad(from_lanes(t0), (0, BLOCK_SAMPLES - FFT_SIZE))
                    + pad(from_lanes(t1), (HOP, BLOCK_SAMPLES - HOP - FFT_SIZE)))
    return wav
