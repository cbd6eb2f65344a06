"""The decoder's offline replay path (torch).

Port of the offline half of ``closed_loop_seeg_speech_synthesis_tpu/runtime/pipeline.py``:
``DecoderConfig``, ``DecoderParams``, ``build_decoder_params``,
``_exact_smooth_fields``, ``_streaming_filter_chain``, ``_frames_to_mel`` and
``offline_decode``.  The reference's streaming output is chunk-size
invariant (filters carry state, frames sit on an absolute-time grid), so a
recorded session decodes as one batch: warm-started filter chain ->
windowed log-power -> context stack -> LDA -> dequantization + smoothing ->
Griffin-Lim -> overlap-add -> low-pass -> int16.

Kernel selection follows the JAX package (pipeline.py:325-374), with "the
tensors lie on a CUDA device" in place of "the backend is a TPU": in
float32 on CUDA the front end runs kernel K1 (``ops.cuda_frontend``) and the
vocoder kernel K2 (``ops.cuda_gl``); otherwise the plain torch stages run.
The split variants of the JAX package (``use_pallas_epilogue=False``,
``use_pallas_gl_tail=False``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..models import lda as lda_mod
from ..ops import filter_design as fd
from ..ops import framing, iir, smoothing
from ..ops import griffinlim as gl
from ..ops.cuda_frontend import (FrontendOps, epilogue_constants, frontend_decode_mels,
                                 make_frontend_ops)
from ..ops.cuda_gl import GLAudioOps, gl_audio, make_gl_audio_ops


def default_compute_dtype(device) -> torch.dtype:
    """float64 on the CPU (the golden numerics), float32 on CUDA (the kernels)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decode-time configuration (reference decode.py:152-164)."""

    sr: float                       # sEEG sampling rate (1024 / 2048)
    n_channels: int                 # channels after bad-channel exclusion
    line_noise: int = 50
    frame_len_ms: float = 50.0
    frame_shift_ms: float = 10.0
    model_order: int = 4
    step_size: int = 5
    n_mel: int = 40
    gl_iterations: int = 8
    gl_norm: float = 10.0
    phase_bug: bool = True          # GriffinLim.py:93 exp(angle) quirk
    audio_sr: int = 16000
    iir_block: int = 256
    dtype: Any = torch.float32
    use_cuda_frontend: bool = True  # kernel K1 for float32 CUDA decodes
    use_cuda_gl: bool = True        # kernel K2 for float32 CUDA decodes

    @property
    def win(self) -> int:
        return framing.frame_size(self.frame_len_ms, self.sr)

    @property
    def prefill(self) -> int:
        return framing.warm_start_prefill(self.frame_len_ms, self.frame_shift_ms, self.sr)

    @property
    def n_stacked(self) -> int:
        return (self.model_order + 1) * self.n_channels


@dataclasses.dataclass
class DecoderParams:
    """Device-resident decoder parameters (everything trained or designed)."""

    filt_op: iir.BlockedIIR           # combined high-gamma chain (one pass)
    filt_zi_scale: torch.Tensor       # (S,) x0-proportional init part
    filt_s_const: torch.Tensor        # (S,) warm-start constant init part
    zf_prefix: torch.Tensor           # (prefill,) zero-fill output prefix
    select: torch.Tensor              # (n_feats,) feature indices
    lda: lda_mod.LDAParams
    lda_coef_full: torch.Tensor       # (n_bins, k, n_stacked): coef scattered to the
                                      # full stacked width (select folded in)
    medians: torch.Tensor             # (n_mel, n_intervals)
    gauss_kernel: torch.Tensor        # (5,)
    gl_ops: gl.StreamingGLOps
    gl_audio_ops: GLAudioOps          # K2 constants (low-pass at block 160)
    lowpass_op_batch: iir.BlockedIIR  # output low-pass at block 4096 (plain path)
    shift_table: torch.Tensor         # (period,) int32 frame shifts
    frontend_ops: Optional[FrontendOps]
    device: torch.device
    smooth_pos: Optional[torch.Tensor] = None    # (n_mel, 5) reflect positions
    smooth_table: Optional[torch.Tensor] = None  # (n_mel, K^5) exact lattice (f64)


def build_decoder_params(cfg: DecoderConfig, lda_params: lda_mod.LDAParams,
                         medians: np.ndarray, select: np.ndarray, device="cpu",
                         exact_smooth: bool = True) -> DecoderParams:
    """Design-time construction (host, float64) of all device operators."""
    dt = cfg.dtype
    device = torch.device(device)
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    chain = fd.high_gamma_bank(cfg.sr, cfg.line_noise)
    combined, warm = iir.make_warmstart_chain(chain, cfg.prefill)
    # block length = one schedule period (256 samples @1024 Hz, 512 @2048 Hz),
    # which the fused front-end kernel requires
    table = framing.shift_table(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr)
    Ls = int(table.sum()) if len(table) else 0
    block = Ls if 64 <= Ls <= 2048 else cfg.iir_block
    filt_op = iir.make_blocked_iir(combined, block, dt, device)
    frontend_ops = (make_frontend_ops(filt_op, warm.zf_prefix, cfg.frame_len_ms,
                                      cfg.frame_shift_ms, cfg.sr, device)
                    if len(table) else None)
    lowpass_ss = iir.sos_to_statespace(fd.gl_output_lowpass_sos(cfg.audio_sr, cfg.frame_shift_ms))
    gl_ops = gl.make_streaming_gl_ops(cfg.n_mel, float(cfg.audio_sr), dt, device)
    sel = np.asarray(select, int)
    coef = lda_params.coef.detach().cpu().numpy().astype(np.float64)
    coef_full = np.zeros(coef.shape[:2] + (cfg.n_stacked,), np.float64)
    coef_full[:, :, sel] = coef
    return DecoderParams(
        filt_op=filt_op,
        filt_zi_scale=to(warm.zi_scale),
        filt_s_const=to(warm.s_const),
        zf_prefix=to(warm.zf_prefix),
        select=torch.as_tensor(sel, dtype=torch.int64, device=device),
        lda=lda_params.to(dt, device),
        lda_coef_full=to(coef_full),
        medians=to(medians),
        gauss_kernel=to(smoothing.gaussian_kernel1d(0.5)),
        gl_ops=gl_ops,
        gl_audio_ops=make_gl_audio_ops(gl_ops, lowpass_ss, dt, device),
        lowpass_op_batch=iir.make_blocked_iir(lowpass_ss, 4096, dt, device),
        shift_table=torch.as_tensor(table, dtype=torch.int32, device=device),
        frontend_ops=frontend_ops,
        device=device,
        **(_exact_smooth_fields(medians, dt, device) if exact_smooth else {}),
    )


def _exact_smooth_fields(medians, dt, device) -> dict:
    """Bit-exact smoothing lattice for the float64 path (ops/smoothing), built
    only in float64 and when small (default 40 x 9^5 = 18.9 MB)."""
    med = np.asarray(medians)
    if dt != torch.float64 or med.shape[1] ** 5 > 100_000:
        return {}
    pos, tbl = smoothing.exact_smooth_table(med)
    return {"smooth_pos": torch.as_tensor(pos, device=device),
            "smooth_table": torch.as_tensor(tbl, device=device)}


def _initial_state(params: DecoderParams, x: torch.Tensor) -> torch.Tensor:
    """Closed-form warm start of the chain: zi_scale * x[0] + s_const, (S, C)."""
    return params.filt_zi_scale[:, None] * x[0][None, :] + params.filt_s_const[:, None]


def _streaming_filter_chain(params: DecoderParams, cfg: DecoderConfig, eeg: torch.Tensor):
    """Raw eeg (T, C) -> the framed signal (zero-fill prefix + filtered,
    (T+prefill, C)) and the final combined filter state."""
    x = eeg.to(cfg.dtype)
    y, sT = iir.iir_blocked(params.filt_op, x, _initial_state(params, x))
    zf = params.zf_prefix[:, None].expand(cfg.prefill, eeg.shape[1])
    return torch.cat([zf, y], dim=0), sT


def _frames_to_mel(params: DecoderParams, stacked: torch.Tensor) -> torch.Tensor:
    """Stacked features (N, 5C) -> dequantized+smoothed logMel frames (N, n_mel).
    LDASynthesis.py:19-28 and Dequantization.py:15-17."""
    scores = torch.einsum("td,bkd->tbk", stacked, params.lda_coef_full) + params.lda.intercept[None]
    scores = torch.where(params.lda.valid[None], scores, torch.full_like(scores, -torch.inf))
    slot = torch.argmax(scores, dim=-1)                       # (N, n_mel), first max
    classes = params.lda.classes.long()
    label = torch.gather(classes.expand(slot.shape[0], -1, -1), 2, slot[:, :, None])[:, :, 0]
    if params.smooth_table is not None:
        # bit-exact float64 path: integer labels -> exactly-rounded lattice
        return smoothing.smooth_by_table(label, params.smooth_pos, params.smooth_table,
                                         params.medians.shape[1])
    # medians are indexed by original label
    deq = torch.gather(params.medians.expand(slot.shape[0], -1, -1), 2, label[:, :, None])[:, :, 0]
    return smoothing.gaussian_smooth(deq, params.gauss_kernel)


def offline_decode(params: DecoderParams, cfg: DecoderConfig, eeg,
                   rand_init=None, generator: Optional[torch.Generator] = None):
    """Decode a full recorded session.

    eeg: (T, n_channels) raw sEEG (bad channels already excluded), array or
    tensor.  rand_init: (N-1, 480) Griffin-Lim inits, drawn from ``generator``
    when None.  Returns (spectrogram (N, n_mel), audio int16 ((N-1)*160,)) as
    tensors on the params' device.  The reference's file-replay decode
    (decode.py:71-96).
    """
    dev, dt = params.device, cfg.dtype
    x = torch.as_tensor(eeg).to(device=dev, dtype=dt)
    T = x.shape[0]
    ends = framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr, T + cfg.prefill)
    n_frames = len(ends)
    if rand_init is None:
        rand_init = gl.default_rand_init(n_frames - 1, generator, dt, dev)
    rand_init = torch.as_tensor(rand_init).to(device=dev, dtype=dt)
    pw = framing.periodic_window_matrix(ends, cfg.win)
    on_cuda_f32 = dev.type == "cuda" and dt == torch.float32

    if (cfg.use_cuda_frontend and on_cuda_f32 and params.frontend_ops is not None
            and pw is not None):
        # K1: eeg -> mel frames (filter chain, log-power, context stack, LDA,
        # dequantization, smoothing)
        consts = epilogue_constants(params.lda_coef_full, params.lda.intercept,
                                    params.lda.valid, params.lda.classes, params.medians,
                                    params.gauss_kernel, cfg.n_channels, cfg.model_order)
        mel_frames = frontend_decode_mels(params.frontend_ops, x.contiguous(),
                                          _initial_state(params, x).contiguous(), *consts,
                                          n_frames, cfg.model_order, cfg.step_size)
    else:
        s_cat, _ = _streaming_filter_chain(params, cfg, x)
        if pw is not None:
            S, Ls, P, origin = pw
            F = framing.windowed_logpower_periodic(s_cat, torch.as_tensor(S, dtype=dt, device=dev),
                                                   Ls, n_frames, origin)
        else:
            F = framing.windowed_logpower(s_cat, torch.as_tensor(ends, device=dev), cfg.win)
        stacked = framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=True)
        mel_frames = _frames_to_mel(params, stacked)

    if cfg.use_cuda_gl and on_cuda_f32:
        # K2: GL iterations + overlap-add + low-pass + int16
        audio = gl_audio(mel_frames.contiguous(), rand_init.contiguous(), params.gl_audio_ops,
                         float(cfg.gl_norm), cfg.gl_iterations, cfg.phase_bug)
        return mel_frames, audio
    re = gl.streaming_gl_blocks(mel_frames, rand_init, params.gl_ops,
                                cfg.gl_iterations, cfg.phase_bug)
    raw = gl.overlap_add_stream(re, params.gl_ops)
    lp, _ = iir.iir_blocked(params.lowpass_op_batch, raw[:, None],
                            raw.new_zeros((params.lowpass_op_batch.dim, 1)))
    return mel_frames, gl.to_int16(lp[:, 0], cfg.gl_norm)
