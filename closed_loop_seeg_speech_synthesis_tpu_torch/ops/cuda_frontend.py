"""Kernels K1 and K3: raw sEEG -> logMel frames, and raw sEEG -> log-power
features.

Port of ``closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py``
(``FrontendOps``, ``make_frontend_ops``, ``epilogue_constants``, the fused
``frontend_decode_mels`` and the split ``frontend_logpower``).  The CUDA
source of both is ``csrc/frontend_decode.cu``; its header note says how the
TPU kernels' sequential grid was split for a GPU.  ``frontend_decode_mels_plain``
and ``frontend_logpower_plain`` are the same functions in plain torch.

The kernels run their products on the tensor cores in 3xTF32 and walk the
block-boundary states as a two-level scan over chunks of up to
``SCAN_CHUNK`` periods (``scan_chunk``).  Their operands are packed here:
the impulse response's hi/lo split and the power table A_L^0 .. A_L^R once
in ``make_frontend_ops`` (``FrontendOps.h_tf32``, ``FrontendOps.apow``),
the LDA weights' hi/lo split in mma fragment order once per call
(``pack_lda_weights``) unless the caller passes it built.

Per schedule period (the frame grid repeats every P frames spanning exactly
Ls samples; Ls is the filter's block length) the computation is: the
48-state filter chain y = Tmat u + Cpow s, s <- A_L s + Pmat u; log-power
log(S_win [y_prev; y]^2 + 0.01) (where K3 stops); the 5-tap context stack
folded into 5 LDA products; first-max over the 9 class slots; median select;
sigma-0.5 smoothing as a matrix.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import _build, framing, smoothing
from .tf32 import pack_b_fragments, tf32_split
from .iir import BlockedIIR, _boundary_states

SCAN_CHUNK = 64     # periods per chunk of the kernels' two-level boundary scan
LDA_WARPS, LDA_NT = 16, 3                   # csrc/frontend_decode.cu EWARPS, ENT
LDA_PASS = LDA_WARPS * LDA_NT * 8           # score columns per pass (EPASS)
LDA_SLAB = 128                              # channels of F staged at a time (ECK)
MAX_LS = 2048                               # longest period the kernels take (JAX pipeline.py:215)


@dataclasses.dataclass
class FrontendOps:
    """Kernel constants, float32 (built host-side in float64)."""

    Tmat: torch.Tensor    # (Ls, Ls) causal Toeplitz of the combined chain
    Cpow: torch.Tensor    # (Ls, S)
    Pmat: torch.Tensor    # (S, Ls)
    A_L: torch.Tensor     # (S, S)
    S_win: torch.Tensor   # (P, 2*Ls) window selection in span coordinates
    prefix: torch.Tensor  # (Ls,) period 0's previous chunk: [zeros, zf_prefix]
    starts: torch.Tensor  # (P,) int32 first span column of each window
    win: int              # window length (samples)
    tail: int             # samples at the end of the previous chunk that windows reach
    h_tf32: torch.Tensor  # (2, Ls) TF32 hi and lo of h = Tmat[:, 0] (tf32_split)
    apow: torch.Tensor    # (SCAN_CHUNK + 1, S, S) A_L^0 .. A_L^R (power_table)

    @property
    def Ls(self) -> int:
        return self.Tmat.shape[0]

    @property
    def P(self) -> int:
        return self.S_win.shape[0]


def _to_f32_ftz(a: torch.Tensor) -> torch.Tensor:
    """Cast to float32 with subnormal results flushed to (signed) zero, as
    the JAX package's XLA cast does: the kernel constants are then the same
    bytes, and the kernel never meets a subnormal operand."""
    x = a.to(torch.float32)
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)


def power_table(A_L: torch.Tensor, R: int) -> torch.Tensor:
    """(R + 1, S, S) float64 table A_L^0 .. A_L^R, by repeated products."""
    A = A_L.detach().to("cpu", torch.float64)
    pows = [torch.eye(A.shape[0], dtype=torch.float64)]
    for _ in range(R):
        pows.append(pows[-1] @ A)
    return torch.stack(pows)


def scan_chunk(ops: FrontendOps, Kp: int) -> int:
    """Periods per chunk of the kernels' boundary scan over Kp periods:
    ceil(sqrt(Kp)), which makes the chunk-local and the carry steps about
    equal, up to the power table's SCAN_CHUNK.  Inputs of more than 3,969
    periods (16.5 min at 1024 Hz) take SCAN_CHUNK; shorter ones more,
    shorter chunks, so that a short decode (exp1's 120-period folds) does
    not walk 64 periods on a few CTAs."""
    return min(ops.apow.shape[0] - 1, math.isqrt(max(Kp, 1) - 1) + 1)


def serial_scan_steps(ops: FrontendOps, Kp: int) -> int:
    """Dependent steps of the kernels' boundary scan over Kp periods: the
    chunk-local scans (R = scan_chunk steps, every chunk at once), then the
    carry over the chunks (one step fewer than there are chunks)."""
    R = scan_chunk(ops, Kp)
    return min(R, Kp) + -(-Kp // R) - 1


def make_frontend_ops(op: BlockedIIR, zf_prefix: np.ndarray, frame_ms: float,
                      shift_ms: float, sr: float, device=None) -> FrontendOps | None:
    """Kernel constants; None if the schedule does not fit (the filter's block
    length must be one schedule period and every window must lie in the
    previous-plus-current chunk span)."""
    win = framing.frame_size(frame_ms, sr)
    prefill = len(zf_prefix)
    table = framing.shift_table(frame_ms, shift_ms, sr)
    P = len(table)
    Ls = int(table.sum())
    if op.block != Ls or win + prefill > 2 * Ls:
        return None
    ends = framing.streaming_frame_ends(frame_ms, shift_ms, sr, 10 * Ls)[:P]
    S_win = np.zeros((P, 2 * Ls), np.float64)
    starts = np.zeros(P, np.int32)
    for i, e in enumerate(ends):
        p = int(e) - win - prefill + Ls
        if p < 0 or p + win > 2 * Ls:
            return None
        S_win[i, p : p + win] = 1.0
        starts[i] = p
    prefix = np.zeros(Ls, np.float64)
    prefix[Ls - prefill :] = np.asarray(zf_prefix)
    f32 = lambda a: _to_f32_ftz(torch.as_tensor(a, device=device))
    Tmat = f32(op.Tmat)
    return FrontendOps(Tmat=Tmat, Cpow=f32(op.Cpow), Pmat=f32(op.Pmat),
                       A_L=f32(op.A_L), S_win=f32(S_win), prefix=f32(prefix),
                       starts=torch.as_tensor(starts, device=device), win=win,
                       tail=max(0, Ls - int(starts.min())),
                       h_tf32=torch.stack(tf32_split(Tmat[:, 0])),
                       apow=f32(power_table(op.A_L, SCAN_CHUNK)))


def epilogue_constants(lda_coef_full, intercept, valid, classes, medians, gauss_kernel,
                       n_channels: int, model_order: int = 4):
    """Rearrange the decode epilogue's parameters for the fused kernel:

    * ``W5`` (M*C, K*B): LDA weights, rows tap-major (row m*C+c = channel c,
      tap m oldest-first), columns k-major (col k*B+b);
    * ``bm`` (1, K*B): intercept, with -1e30 on invalid slots;
    * ``med_slot`` (K, B): medians pre-indexed by each slot's class label;
    * ``smoothM`` (B, B): the sigma-0.5 'reflect' smoothing as a matrix.
    All float32."""
    B, K, D = lda_coef_full.shape
    M = model_order + 1
    C = n_channels
    W = lda_coef_full.reshape(B, K, C, M)            # stacked index d = c*M + m
    W5 = W.permute(3, 2, 1, 0).reshape(M * C, K * B)
    bm = torch.where(valid, intercept, torch.full_like(intercept, -1e30))
    bm = bm.T.reshape(1, K * B)
    med_slot = torch.take_along_dim(medians, classes.long(), dim=1).T  # (K, B)
    eye = torch.eye(B, dtype=medians.dtype, device=medians.device)
    smoothM = smoothing.gaussian_smooth(eye, gauss_kernel.to(medians.dtype))
    f32 = lambda a: a.to(torch.float32).contiguous()
    return f32(W5), f32(bm), f32(med_slot), f32(smoothM)


def _logpower_plain(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor,
                    n_frames: int) -> torch.Tensor:
    """Log-power rows of whole periods (ceil(n_frames / P) * P, C), in the
    dtype of ``eeg``."""
    T, C = eeg.shape
    dt = eeg.dtype
    Ls, P = ops.Ls, ops.P
    Kp = -(-n_frames // P)
    need = Kp * Ls
    u = torch.nn.functional.pad(eeg, (0, 0, 0, max(0, need - T)))[:need].reshape(Kp, Ls, C)
    Tmat, Cpow, Pmat, A_L = (a.to(dt) for a in (ops.Tmat, ops.Cpow, ops.Pmat, ops.A_L))
    q = torch.einsum("sl,klc->ksc", Pmat, u)
    s_before, _ = _boundary_states(A_L, q, s0.to(dt))
    y = torch.einsum("ls,ksc->klc", Cpow, s_before) + torch.einsum("tj,kjc->ktc", Tmat, u)
    y_prev = torch.cat([ops.prefix.to(dt)[None, :, None].expand(1, Ls, C), y[:-1]], dim=0)
    span = torch.cat([y_prev, y], dim=1)                      # (Kp, 2Ls, C)
    F = torch.log(torch.einsum("pt,ktc->kpc", ops.S_win.to(dt), span * span) + 0.01)
    return F.reshape(Kp * P, C)


def frontend_logpower_plain(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor,
                            n_frames: int) -> torch.Tensor:
    """Plain torch version of kernel K3, in the dtype of ``eeg``."""
    return _logpower_plain(ops, eeg, s0, n_frames)[:n_frames]


def frontend_decode_mels_plain(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor,
                               W5: torch.Tensor, bm: torch.Tensor, med_slot: torch.Tensor,
                               smoothM: torch.Tensor, n_frames: int, model_order: int = 4,
                               step_size: int = 5) -> torch.Tensor:
    """Plain torch version of kernel K1, in the dtype of ``eeg``."""
    C = eeg.shape[1]
    dt = eeg.dtype
    K_slots, B = med_slot.shape
    depth = model_order * step_size
    F = _logpower_plain(ops, eeg, s0, n_frames)
    rows = F.shape[0]
    Fp = torch.cat([F.new_zeros((depth, C)), F], dim=0)
    W5 = W5.to(dt)
    scores = bm.to(dt).expand(rows, -1)
    for m in range(model_order + 1):
        scores = scores + Fp[m * step_size : m * step_size + rows] @ W5[m * C : (m + 1) * C]
    slot = torch.argmax(scores.reshape(rows, K_slots, B), dim=1)  # first max
    deq = torch.gather(med_slot.to(dt), 0, slot)                  # (rows, B)
    return (deq @ smoothM.to(dt))[:n_frames]


def _check_inputs(what: str, dev: torch.device, ops: FrontendOps, tensors: dict) -> None:
    """Raise unless every tensor is contiguous float32 of its shape on ``dev``
    and the kernel's limits hold."""
    if ops.A_L.shape[0] > 64:
        raise ValueError(f"{what} kernel takes <= 64 filter states; got {ops.A_L.shape[0]}")
    if ops.Ls > MAX_LS:
        raise ValueError(f"{what} kernel takes periods of <= {MAX_LS} samples; got {ops.Ls}")
    for name, (t, shape) in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous float32 tensor of shape "
                             f"{shape} on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if ops.Tmat.device != dev:
        raise ValueError(f"{what}: constants on {ops.Tmat.device}, data on {dev}")


def _launch_args(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor, Kp: int):
    """Pointers and sizes shared by both entry points, through the features
    F (Kp*P, C), and F itself."""
    T, C = eeg.shape
    Ls, P, S = ops.Ls, ops.P, ops.A_L.shape[0]
    dev = eeg.device
    need = Kp * Ls
    u = eeg[:need] if T >= need else torch.nn.functional.pad(eeg, (0, 0, 0, need - T))
    u = u.contiguous()
    R = scan_chunk(ops, Kp)
    local = torch.empty((Kp, S, C), dtype=torch.float32, device=dev)  # chunk-local states
    ends = torch.empty((-(-Kp // R), S, C), dtype=torch.float32, device=dev)
    carries = torch.empty_like(ends)                                  # states before each chunk
    F = torch.empty((Kp * P, C), dtype=torch.float32, device=dev)
    ptrs = (u, s0, ops.Pmat, ops.apow, ops.h_tf32, ops.Cpow, ops.prefix, ops.starts)
    return ptrs, (local, ends, carries, F), (Kp, Ls, S, C, P, ops.win, ops.tail, R), F


def pack_lda_weights(W5: torch.Tensor, C: int, M: int) -> torch.Tensor:
    """W5 (M*C, K*B) float32 -> its 3xTF32 B fragments for the epilogue
    launch, (passes, LDA_WARPS, k-steps, LDA_NT, 32 lanes, 4) on W5's device
    (``tf32.pack_b_fragments``).  The rows go in the order the launch walks
    its k-steps: by slab of LDA_SLAB channels (the last one ragged), then
    tap, then channel; each tap padded to C8 = 8 ceil(C / 8) channels and the
    columns to whole passes of LDA_PASS, with zeros.  Warp w of pass p owns
    the n-tiles at columns LDA_PASS p + 8 (LDA_NT w + t), t < LDA_NT."""
    KB = W5.shape[1]
    C8 = -(-C // 8) * 8
    passes = -(-KB // LDA_PASS)
    Wp = W5.new_zeros((M, C8, passes * LDA_PASS))
    Wp[:, :C, :KB] = W5.reshape(M, C, KB)
    rows = torch.cat([Wp[:, c : c + LDA_SLAB].reshape(-1, Wp.shape[2])
                      for c in range(0, C8, LDA_SLAB)])
    cols = (LDA_PASS * np.arange(passes)[:, None, None]
            + 8 * (LDA_NT * np.arange(LDA_WARPS)[:, None] + np.arange(LDA_NT)))
    return pack_b_fragments(rows, cols)


def frontend_logpower(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor,
                      n_frames: int) -> torch.Tensor:
    """Kernel K3: raw eeg (T, C) + initial filter state s0 (S, C) -> log-power
    feature rows (n_frames, C).  A CPU tensor runs the plain version; a CUDA
    tensor launches ``csrc/frontend_decode.cu`` (float32) or raises."""
    if eeg.device.type == "cpu":
        return frontend_logpower_plain(ops, eeg, s0, n_frames)
    dev = eeg.device
    if dev.type != "cuda":
        raise ValueError(f"frontend_logpower: unsupported device {dev}")
    T, C = eeg.shape
    S = ops.A_L.shape[0]
    _check_inputs("frontend_logpower", dev, ops, {"eeg": (eeg, (T, C)), "s0": (s0, (S, C))})
    Kp = -(-n_frames // ops.P)
    if Kp == 0:
        return eeg.new_empty((0, C))
    ptrs, scratch, sizes, F = _launch_args(ops, eeg, s0, Kp)
    fn = _build.bind(_build.load("frontend_decode"), "frontend_logpower", 12, 8)
    err = fn(*(a.data_ptr() for a in ptrs + scratch), *sizes,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "frontend_logpower")
    frontend_logpower.launches += 1
    return F[:n_frames]


frontend_logpower.launches = 0


def frontend_decode_mels(ops: FrontendOps, eeg: torch.Tensor, s0: torch.Tensor,
                         W5: torch.Tensor, bm: torch.Tensor, med_slot: torch.Tensor,
                         smoothM: torch.Tensor, n_frames: int, model_order: int = 4,
                         step_size: int = 5, packed: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel K1: raw eeg (T, C) + initial filter state s0 (S, C) -> logMel
    frames (n_frames, B).  A CPU tensor runs the plain version; a CUDA tensor
    launches ``csrc/frontend_decode.cu`` (float32) or raises.  ``packed``:
    ``pack_lda_weights(W5, C, model_order + 1)`` built once by a caller that
    decodes many inputs with one model (else packed here, per call)."""
    if eeg.device.type == "cpu":
        return frontend_decode_mels_plain(ops, eeg, s0, W5, bm, med_slot, smoothM,
                                          n_frames, model_order, step_size)
    dev = eeg.device
    if dev.type != "cuda":
        raise ValueError(f"frontend_decode_mels: unsupported device {dev}")
    T, C = eeg.shape
    S = ops.A_L.shape[0]
    K_slots, B = med_slot.shape
    M = model_order + 1
    if K_slots != 9 or not 1 <= B <= 128:
        raise ValueError(f"frontend_decode_mels kernel takes 9 class slots and <= 128 mel "
                         f"bins; got {K_slots}, {B}")
    _check_inputs("frontend_decode_mels", dev, ops,
                  {"eeg": (eeg, (T, C)), "s0": (s0, (S, C)), "W5": (W5, (M * C, K_slots * B)),
                   "bm": (bm, (1, K_slots * B)), "med_slot": (med_slot, (K_slots, B)),
                   "smoothM": (smoothM, (B, B))})
    Kp = -(-n_frames // ops.P)
    if Kp == 0:
        return eeg.new_empty((0, B))
    ptrs, scratch, sizes, _ = _launch_args(ops, eeg, s0, Kp)
    mel = torch.empty((Kp * ops.P, B), dtype=torch.float32, device=dev)
    wpk = pack_lda_weights(W5, C, M) if packed is None else packed
    if wpk.device != dev or wpk.dtype != torch.float32 or not wpk.is_contiguous():
        raise ValueError("frontend_decode_mels: packed must be the contiguous float32 "
                         f"pack_lda_weights of W5 on {dev}")
    fn = _build.bind(_build.load("frontend_decode"), "frontend_decode_mels", 17, 11)
    err = fn(*(a.data_ptr() for a in ptrs + (wpk, bm, med_slot, smoothM) + scratch + (mel,)),
             *sizes, B, M, step_size, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "frontend_decode_mels")
    frontend_decode_mels.launches += 1
    return mel[:n_frames]


frontend_decode_mels.launches = 0
