"""The decoder: offline replay and the online closed-loop step (torch).

Port of ``closed_loop_seeg_speech_synthesis_tpu/runtime/pipeline.py``:
``DecoderConfig``, ``DecoderParams``, ``build_decoder_params``,
``_exact_smooth_fields``, ``_streaming_filter_chain``, ``_frames_to_mel``,
``offline_decode`` (what its front half builds per input length can be
built once: ``MelPlan``), ``OnlineCarry``, ``init_online_carry``,
``make_online_step`` and ``make_online_multi_step``; and, for the online
decoders, ``commit_carry``, ``static_online_step`` (the step, or K of
them, over static buffers: the CPU path) and ``capture_online_step`` (the
same recorded as a CUDA graph: the card's path, replayed once a packet or
a K-packet chunk, or run inside the persistent loop).

* ``offline_decode`` decodes a recorded session as one batch.  The
  reference's streaming output is chunk-size invariant (filters carry state,
  frames sit on an absolute-time grid): warm-started filter chain ->
  windowed log-power -> context stack -> LDA -> dequantization + smoothing ->
  Griffin-Lim -> overlap-add -> low-pass -> int16.
* ``make_online_step`` returns ``step(carry, packet)``, one amplifier packet
  (32 samples at 1024 Hz, 64 at 2048 Hz) of the closed loop; the carry holds
  every piece of streaming state.  Given the same Griffin-Lim inits it
  decodes a session to the offline decode's output.

Kernel selection follows the JAX package (pipeline.py:325-388), with "the
tensors lie on a CUDA device" in place of "the backend is a TPU": in float32
on CUDA the offline front end runs kernel K1 (``cuda_frontend.frontend_decode_mels``)
or, with ``use_cuda_epilogue=False``, kernel K3 (``cuda_frontend.frontend_logpower``)
followed by the plain context stack and LDA; the offline vocoder runs K2
(``cuda_gl.gl_audio``) or, with ``use_cuda_gl_tail=False``, K4
(``cuda_gl.gl_blocks``) followed by the plain overlap-add, low-pass and int16.
The online step's Griffin-Lim phase runs K4 the same way.  Everything else,
and every stage on the CPU, is plain torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..models import lda as lda_mod
from ..ops import filter_design as fd
from ..ops import cuda_prng, framing, iir, smoothing
from ..ops import griffinlim as gl
from ..ops.cuda_frontend import (FrontendOps, epilogue_constants, frontend_decode_mels,
                                 frontend_logpower, make_frontend_ops, pack_lda_weights)
from ..ops.cuda_gl import GLAudioOps, gl_audio, gl_blocks, gl_blocks_plain, make_gl_audio_ops
from ..ops.prng import is_key
from .tracing import span


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    card.  Raises where a CUDA device is asked for and none is visible;
    nothing falls back to the CPU, which runs only when asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is visible; pass "
                           "device='cpu' to run on the CPU")
    return device


def default_compute_dtype(device) -> torch.dtype:
    """float64 on the CPU (the golden numerics), float32 on CUDA (the kernels)."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32


def max_frames_per_packet(packet_size: int, shift_table: np.ndarray) -> int:
    """Worst-case frames emitted per packet: floor((P-1)/min_shift) + 1
    (4 for 32 @ 1024 Hz and 64 @ 2048 Hz)."""
    return int((packet_size - 1) // int(np.min(shift_table))) + 1


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decode-time configuration (reference decode.py:152-164)."""

    sr: float                       # sEEG sampling rate (1024 / 2048)
    n_channels: int                 # channels after bad-channel exclusion
    packet_size: int = 32           # amplifier chunk (decode.py:115-116)
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
    use_cuda_frontend: bool = True  # kernels K1/K3 for float32 CUDA decodes
    use_cuda_epilogue: bool = True  # K1 (fused epilogue) rather than K3 + plain LDA
    use_cuda_gl: bool = True        # kernels K2/K4 for float32 CUDA decodes
    use_cuda_gl_tail: bool = True   # K2 (fused tail) rather than K4 + plain tail
    # The Griffin-Lim DFT products of K2/K4 with bf16 operands (f32
    # accumulation; the JAX field of the same name): the kernels' bf16
    # variants.  Honoured where K2/K4 run (float32 CUDA offline decodes), as
    # the JAX package honours it on its Pallas route only; the plain route
    # and the online step ignore it.  Griffin-Lim under any precision change
    # picks another waveform: quality-gated, not LSB parity
    # (docs/NUMERICS.md, "bf16 Griffin-Lim matmuls").
    gl_bf16: bool = False

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
    filt_op_pkt: iir.BlockedIIR       # same system at packet block length (online)
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
    gl_audio_ops: GLAudioOps          # K2/K4 constants; its low-pass at block 160
                                      # is also the online step's
    lowpass_op_batch: iir.BlockedIIR  # output low-pass at block 4096 (plain path)
    shift_table: torch.Tensor         # (period,) int32 frame shifts
    shift_table_host: np.ndarray      # the same on the host (``mel_plan``'s period)
    frontend_ops: Optional[FrontendOps]
    device: torch.device
    smooth_pos: Optional[torch.Tensor] = None    # (n_mel, 5) reflect positions
    smooth_table: Optional[torch.Tensor] = None  # (n_mel, K^5) exact lattice (f64)
    # K1's epilogue constants and packed LDA fragments, built with the params
    # where K1 runs: ((n_channels, model_order), MelPlan.k1).  Not an
    # argument, so ``dataclasses.replace`` (exp1's retrained folds) drops it
    # and ``mel_plan`` builds the new LDA's per call.
    k1: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False)


def build_decoder_params(cfg: DecoderConfig, lda_params: lda_mod.LDAParams,
                         medians: np.ndarray, select: np.ndarray, device=None,
                         exact_smooth: bool = True) -> DecoderParams:
    """Design-time construction (host, float64) of all device operators, on
    ``device`` (default the card; see ``resolve_device``)."""
    dt = cfg.dtype
    device = resolve_device(device)
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
    params = DecoderParams(
        filt_op=filt_op,
        filt_op_pkt=iir.make_blocked_iir(combined, cfg.packet_size, dt, device),
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
        shift_table_host=table,
        frontend_ops=frontend_ops,
        device=device,
        **(_exact_smooth_fields(medians, dt, device) if exact_smooth else {}),
    )
    if cfg.use_cuda_epilogue and _runs_k1(params, cfg):
        params.k1 = ((cfg.n_channels, cfg.model_order), _k1_constants(params, cfg))
    return params


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
    return _products_to_mel(params, torch.einsum("td,bkd->tbk", stacked, params.lda_coef_full))


def _products_to_mel(params: DecoderParams, products: torch.Tensor) -> torch.Tensor:
    """``_frames_to_mel`` from the LDA products (N, n_bins, k) on: intercept,
    first max over the present class slots, dequantization, smoothing.  The
    channel-sharded decode (``parallel.sharded``) sums its ranks' partial
    products and enters here."""
    scores = products + params.lda.intercept[None]
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


def offline_decode(params: DecoderParams, cfg: DecoderConfig, eeg, rand_init=None, seed=0):
    """Decode a full recorded session.

    eeg: (T, n_channels) raw sEEG (bad channels already excluded), array or
    tensor.  rand_init: (N-1, 480) Griffin-Lim inits; when None,
    ``gl.default_rand_init`` of ``seed`` (an int seed, meaning
    ``PRNGKey(seed)``, or a key pair), the JAX package's draws of the key it
    defaults to, ``PRNGKey(0)``.  Returns (spectrogram (N, n_mel), audio int16
    ((N-1)*160,)) as tensors on the params' device.  The reference's
    file-replay decode (decode.py:71-96).
    """
    mel_frames = _mel_frames(params, cfg, eeg)
    if rand_init is None:
        rand_init = gl.default_rand_init(mel_frames.shape[0] - 1, 0, seed, cfg.dtype,
                                         params.device)
    return mel_frames, _vocode(params, cfg, mel_frames, rand_init)


def _vocode(params: DecoderParams, cfg: DecoderConfig, mel_frames: torch.Tensor,
            rand_init) -> torch.Tensor:
    """``offline_decode``'s back half: mel frames (N, n_mel) and inits
    (N-1, 480) -> int16 audio ((N-1)*160,), through K2 (or K4) in float32
    on CUDA, their bf16 variants with ``cfg.gl_bf16``.  Traced as
    ``seeg.vocode``."""
    with span("seeg.vocode"):
        dev, dt = params.device, cfg.dtype
        rand_init = torch.as_tensor(rand_init).to(device=dev, dtype=dt)
        on_cuda_f32 = dev.type == "cuda" and dt == torch.float32

        use_k2 = cfg.use_cuda_gl and on_cuda_f32
        if use_k2 and cfg.use_cuda_gl_tail:
            # K2: GL iterations + overlap-add + low-pass + int16
            return gl_audio(mel_frames.contiguous(), rand_init.contiguous(), params.gl_audio_ops,
                            float(cfg.gl_norm), cfg.gl_iterations, cfg.phase_bug, cfg.gl_bf16)
        if use_k2:
            # K4: GL iterations only; the tail below is plain
            re = gl_blocks(mel_frames.contiguous(), rand_init.contiguous(), params.gl_audio_ops,
                           cfg.gl_iterations, cfg.phase_bug, cfg.gl_bf16)
        else:
            re = gl.streaming_gl_blocks(mel_frames, rand_init, params.gl_ops,
                                        cfg.gl_iterations, cfg.phase_bug)
        raw = gl.overlap_add_stream(re, params.gl_ops)
        lp, _ = iir.iir_blocked(params.lowpass_op_batch, raw[:, None],
                                raw.new_zeros((params.lowpass_op_batch.dim, 1)))
        return gl.to_int16(lp[:, 0], cfg.gl_norm)


def _runs_k1(params: DecoderParams, cfg: DecoderConfig) -> bool:
    """K1 (or K3) can run for cfg: the front-end kernels on, float32 on CUDA,
    and a frame schedule that the kernel takes.  ``mel_plan`` also asks for
    a periodic grid."""
    return (cfg.use_cuda_frontend and params.device.type == "cuda"
            and cfg.dtype == torch.float32 and params.frontend_ops is not None)


def _k1_constants(params: DecoderParams, cfg: DecoderConfig) -> tuple:
    """``MelPlan.k1`` for cfg's channels and model order: the ones built with
    the params where they are for those, else built here (small launches on
    the params' device)."""
    if params.k1 is not None and params.k1[0] == (cfg.n_channels, cfg.model_order):
        return params.k1[1]
    consts = epilogue_constants(params.lda_coef_full, params.lda.intercept, params.lda.valid,
                                params.lda.classes, params.medians, params.gauss_kernel,
                                cfg.n_channels, cfg.model_order)
    return consts + (pack_lda_weights(consts[0], cfg.n_channels, cfg.model_order + 1),)


@dataclasses.dataclass
class MelPlan:
    """What ``_mel_frames`` needs besides the sEEG that depends only on the
    model and the input length: the frame count, the periodic window plan,
    and for K1 the epilogue's constants and its packed 3xTF32 LDA
    fragments.  A caller that decodes many inputs of one length with one
    model (exp2's chance segments) builds it once (``mel_plan``), as the JAX
    package's batched chance level builds ``ends_d`` / ``window_S`` once."""

    n_samples: int                  # T, the input length it was built for
    n_frames: int
    ends: Optional[np.ndarray]      # (n_frames,) frame ends, only where read: the plain
                                    # path on a grid with no periodic window plan
    window: Optional[tuple]         # plain path on a periodic grid: (S (P, 2 Ls), Ls, P, origin)
    k1: Optional[tuple] = None      # (W5, bm, med_slot, smoothM, packed W5) where K1 runs
    k3: bool = False                # K3 runs (K1 without its epilogue)


def mel_plan(params: DecoderParams, cfg: DecoderConfig, n_samples: int) -> MelPlan:
    """The ``MelPlan`` of ``n_samples``-sample inputs decoded with ``params``
    (traced as ``seeg.frontend.plan``), in time proportional to the grid's
    period: the frame count from the few frames around the input's end
    (``framing.frame_count``), the window plan from the params' shift table
    (``framing.periodic_window``).  Below two table periods of frames the
    frame ends' own period may look shorter, so there the plan searches
    them (``framing.periodic_window_matrix``, as before) and counts it in
    ``mel_plan.searched``.  Equal, field for field, to the plan built from
    the whole array of frame ends, which it builds only for ``ends``."""
    with span("seeg.frontend.plan"):
        dev, dt = params.device, cfg.dtype
        grid = (cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr)
        total = n_samples + cfg.prefill
        n_frames = framing.frame_count(*grid, total)
        table = params.shift_table_host
        ends = S = None
        if 0 < len(table) and 2 * len(table) <= n_frames:
            pw = framing.periodic_window(cfg.frame_len_ms, cfg.sr, cfg.win, table)
        else:
            mel_plan.searched += 1
            ends = framing.streaming_frame_ends(*grid, total)
            pw = framing.periodic_window_matrix(ends, cfg.win)
            if pw is not None:
                S, *pw = pw
        use_k1 = _runs_k1(params, cfg) and pw is not None
        plan = MelPlan(n_samples=n_samples, n_frames=n_frames, ends=None, window=None)
        if use_k1 and cfg.use_cuda_epilogue:
            plan.k1 = _k1_constants(params, cfg)
        elif use_k1:
            plan.k3 = True
        elif pw is not None:
            Ls, P, origin = pw
            if S is None:
                S = framing.window_matrix(framing.exact_frame_ends(*grid, P), cfg.win, Ls, origin)
            plan.window = (torch.as_tensor(S, dtype=dt, device=dev), Ls, P, origin)
        else:
            plan.ends = framing.streaming_frame_ends(*grid, total) if ends is None else ends
        return plan


mel_plan.searched = 0


def _mel_frames(params: DecoderParams, cfg: DecoderConfig, eeg,
                plan: Optional[MelPlan] = None) -> torch.Tensor:
    """``offline_decode``'s front half: raw eeg (T, n_channels) -> the
    dequantized, smoothed logMel frames (N, n_mel), through K1 (or K3) in
    float32 on CUDA.  exp1's chance runs and exp2's chance segments stop
    here.  ``plan``: ``mel_plan(params, cfg, T)``, built here when None.
    Traced as ``seeg.frontend``."""
    with span("seeg.frontend"):
        dev, dt = params.device, cfg.dtype
        x = torch.as_tensor(eeg).to(device=dev, dtype=dt)
        T = x.shape[0]
        if plan is None:
            plan = mel_plan(params, cfg, T)
        elif plan.n_samples != T:
            raise ValueError(f"mel plan built for {plan.n_samples} samples, input has {T}")
        n_frames = plan.n_frames

        if plan.k1 is not None:
            # K1: eeg -> mel frames (filter chain, log-power, context stack, LDA,
            # dequantization, smoothing)
            *consts, packed = plan.k1
            return frontend_decode_mels(params.frontend_ops, x.contiguous(),
                                        _initial_state(params, x).contiguous(), *consts,
                                        n_frames, cfg.model_order, cfg.step_size, packed=packed)
        stacked = framing.stack_context(_logpower(params, cfg, x, plan), cfg.model_order,
                                        cfg.step_size, zero_pad=True)
        return _frames_to_mel(params, stacked)


def _logpower(params: DecoderParams, cfg: DecoderConfig, x: torch.Tensor,
              plan: MelPlan) -> torch.Tensor:
    """The log-power feature rows (n_frames, C) of x (T, C) on the params'
    device in cfg's dtype, through K3 where the plan says so.  C may be a
    block of the decoder's channels: the filter chain and the log-power are
    channel-local."""
    if plan.k3:
        # K3: eeg -> log-power features (filter chain, log-power)
        return frontend_logpower(params.frontend_ops, x.contiguous(),
                                 _initial_state(params, x).contiguous(), plan.n_frames)
    s_cat, _ = _streaming_filter_chain(params, cfg, x)
    if plan.window is not None:
        S, Ls, P, origin = plan.window
        return framing.windowed_logpower_periodic(s_cat, S, Ls, plan.n_frames, origin)
    return framing.windowed_logpower(s_cat, torch.as_tensor(plan.ends, device=params.device),
                                     cfg.win)


# ---------------------------------------------------------------------------
# Online step: the closed-loop path
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OnlineCarry:
    """All streaming state of the decoder.  A step returns a new carry and
    never writes into the tensors of the one it was given."""

    filt_state: torch.Tensor      # (S, C) combined chain state
    started: torch.Tensor         # bool: the first packet applies the closed-form init
    hist: torch.Tensor            # (win, C) last framed-signal samples
    sample_count: torch.Tensor    # int64, includes the prefill
    frame_k: torch.Tensor         # int64 frames emitted so far
    next_e: torch.Tensor          # int64 next frame end position
    stack_ring: torch.Tensor      # (stack_len, C) feature history, chronological
    prev_mel: torch.Tensor        # (n_mel,) last emitted mel frame
    ola_acc: torch.Tensor         # (2, 160) pending overlap-add contributions
    ola_wacc: torch.Tensor        # (2, 160) their window sums
    lowpass_state: torch.Tensor   # (S_lp, 1)


def init_online_carry(params: DecoderParams, cfg: DecoderConfig) -> OnlineCarry:
    """The carry before the first packet (pipeline.py:453-475)."""
    dt, dev = cfg.dtype, params.device
    C, win = cfg.n_channels, cfg.win
    stack_len = cfg.model_order * cfg.step_size + 1
    # the last filter's prefill zero-response is the initial history (the
    # frame buffer's zero-fill, FrameBuffer.py:94-98); the x0-dependent part
    # of the chain state is applied on the first packet
    hist = torch.zeros((win, C), dtype=dt, device=dev)
    hist[win - cfg.prefill :] = params.zf_prefix[:, None]
    long = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return OnlineCarry(
        filt_state=torch.zeros((params.filt_op_pkt.dim, C), dtype=dt, device=dev),
        started=torch.tensor(False, device=dev),
        hist=hist,
        sample_count=long(cfg.prefill),
        frame_k=long(0),
        next_e=long(win),
        stack_ring=torch.zeros((stack_len, C), dtype=dt, device=dev),
        prev_mel=torch.zeros((cfg.n_mel,), dtype=dt, device=dev),
        ola_acc=torch.zeros((2, gl.HOP), dtype=dt, device=dev),
        ola_wacc=torch.zeros((2, gl.HOP), dtype=dt, device=dev),
        lowpass_state=torch.zeros((params.gl_audio_ops.lp.dim, 1), dtype=dt, device=dev),
    )


def make_online_step(params: DecoderParams, cfg: DecoderConfig, rand_source=0):
    """Returns ``step(carry, packet) -> (carry, outputs)`` (pipeline.py:478-583).

    packet: (packet_size, n_channels) raw sEEG chunk, a tensor on the params'
    device.  outputs: 'spec' (n_slots, n_mel), 'spec_valid' (n_slots,),
    'audio' (n_slots, 160) int16, 'audio_valid' (n_slots,), n_slots =
    ``max_frames_per_packet``; rows whose valid flag is False are filler.

    rand_source: an int seed (``PRNGKey(seed)``) or a key pair, whose block
    inits are ``gl.block_rand`` of the global block index, the JAX step's
    ``uniform(fold_in(key, max(i, 0)))`` rows (so the default online and
    offline decodes agree), or an (n_blocks, 480) table indexed by global
    block index.  The step reads
    no device value to check the table's length: blocks past its end reuse
    its last row (``online.OnlineDecoder`` raises before it emits one).

    Shapes are static, valid masks select with ``torch.where``, and nothing
    in the step reads a device value on the host.
    """
    dt, dev = cfg.dtype, params.device
    win, P = cfg.win, cfg.packet_size
    table = params.shift_table.to(torch.int64)
    period = int(table.shape[0])
    if period == 0:
        raise ValueError("decoder params carry an empty shift table; rebuild them with "
                         "build_decoder_params (the exact grid is periodic at every rate)")
    n_slots = max_frames_per_packet(P, params.shift_table_host)
    stack_len = cfg.model_order * cfg.step_size + 1
    slots = torch.arange(n_slots, device=dev)
    taps = torch.arange(0, stack_len, cfg.step_size, device=dev)
    offs = torch.arange(win, device=dev)
    w_ola = params.gl_ops.ola_window
    w_ola0, w_ola1, w_ola2 = w_ola[: gl.HOP], w_ola[gl.HOP : 2 * gl.HOP], w_ola[2 * gl.HOP :]
    lp = params.gl_audio_ops.lp
    if is_key(rand_source):
        rand_rows = lambda ids: gl.block_rand(ids, rand_source, dt)
    else:
        if not torch.is_tensor(rand_source):
            rand_source = torch.from_numpy(np.array(rand_source))
        rand_table = rand_source.to(device=dev, dtype=dt)
        rand_rows = lambda ids: rand_table.index_select(0, ids.clamp(max=rand_table.shape[0] - 1))
    on_cuda_f32 = dev.type == "cuda" and dt == torch.float32
    gl_fn = gl_blocks if cfg.use_cuda_gl and on_cuda_f32 else gl_blocks_plain

    def step(carry: OnlineCarry, packet: torch.Tensor):
        x = packet.to(dt)
        # --- combined filter chain (closed-form init on the first packet) ---
        s0 = torch.where(carry.started, carry.filt_state, _initial_state(params, x))
        y, s_new = iir.iir_blocked(params.filt_op_pkt, x, s0)
        buf = torch.cat([carry.hist, y], dim=0)          # (win + P, C); buf[p] is
        cnt = carry.sample_count                         # sample cnt - win + p

        # --- phase 1: the frames this packet completes.  Frames are emitted
        # in order, so slot s's frame ends where slot s-1's did plus the next
        # shift, and the valid slots are a prefix ---
        shifts = table[(carry.frame_k + slots) % period]
        ends = carry.next_e + torch.cumsum(shifts, 0) - shifts
        valid = ends <= cnt + P
        n_valid = valid.sum()
        start = torch.clamp(ends - cnt, 0, P)
        window = buf[start[:, None] + offs[None, :]]     # (n_slots, win, C)
        f_rows = torch.log((window * window).sum(1) + 0.01)
        # the ring after slot s is rows [m_s, m_s + stack_len) of the history
        # followed by the new rows, m_s = valid slots up to s
        ext = torch.cat([carry.stack_ring, f_rows], dim=0)
        m = torch.cumsum(valid.long(), 0)
        stacked = ext[m[:, None] + taps[None, :]]        # (n_slots, taps, C)
        stacked = stacked.transpose(1, 2).reshape(n_slots, -1)  # channel-major

        # --- phase 2: LDA + dequantization for all slots at once ---
        mels = _frames_to_mel(params, stacked)           # (n_slots, n_mel)

        # --- phase 3: Griffin-Lim on the blocks of consecutive mel pairs ---
        mel_seq = torch.cat([carry.prev_mel[None], mels], dim=0)
        block_ids = carry.frame_k + slots - 1
        has_block = valid & (block_ids >= 0)
        rand = rand_rows(block_ids.clamp(min=0))
        re_all = gl_fn(mel_seq.contiguous(), rand.contiguous(), params.gl_audio_ops,
                       cfg.gl_iterations, cfg.phase_bug)  # (n_slots, 480)

        # --- phase 4: overlap-add + low-pass per emitted chunk ---
        ola_acc, ola_wacc, lp_state = carry.ola_acc, carry.ola_wacc, carry.lowpass_state
        audio = []
        for s in range(n_slots):
            re, hb = re_all[s], has_block[s]
            acc = ola_acc[0] + re[: gl.HOP]
            wsum = ola_wacc[0] + w_ola0
            chunk = torch.where(wsum != 0, acc / torch.where(wsum != 0, wsum, 1.0), acc)
            y_lp = lp.Cpow @ lp_state[:, 0] + lp.Tmat @ chunk
            audio.append(gl.to_int16(y_lp, cfg.gl_norm))
            new_acc = torch.stack([ola_acc[1] + re[gl.HOP : 2 * gl.HOP], re[2 * gl.HOP :]])
            new_wacc = torch.stack([ola_wacc[1] + w_ola1, w_ola2])
            ola_acc = torch.where(hb, new_acc, ola_acc)
            ola_wacc = torch.where(hb, new_wacc, ola_wacc)
            lp_state = torch.where(hb, lp.A_L @ lp_state + lp.Pmat @ chunk[:, None], lp_state)

        new_carry = OnlineCarry(
            filt_state=s_new,
            started=torch.ones_like(carry.started),
            hist=buf[-win:],
            sample_count=cnt + P,
            frame_k=carry.frame_k + n_valid,
            next_e=carry.next_e + (shifts * valid).sum(),
            stack_ring=ext[n_valid + torch.arange(stack_len, device=dev)],
            # index_select: indexing by a 0-d tensor would read it on the host
            prev_mel=torch.where(n_valid > 0, mel_seq.index_select(0, n_valid.reshape(1))[0],
                                 carry.prev_mel),
            ola_acc=ola_acc,
            ola_wacc=ola_wacc,
            lowpass_state=lp_state,
        )
        outputs = {"spec": mels, "spec_valid": valid,
                   "audio": torch.stack(audio), "audio_valid": has_block}
        return new_carry, outputs

    return step


def make_online_multi_step(params: DecoderParams, cfg: DecoderConfig, rand_source=0,
                           step=None):
    """``multi(carry, packets (K, packet_size, n_channels)) -> (carry, outputs)``
    with the per-step outputs stacked on a leading K axis: K calls of the
    same step function in order, so the decoded stream is bit-identical to K
    single steps (pipeline.py:586-611).  ``step`` reuses the caller's step."""
    step = step or make_online_step(params, cfg, rand_source)

    def multi(carry: OnlineCarry, packets: torch.Tensor):
        outs = []
        for packet in packets:
            carry, out = step(carry, packet)
            outs.append(out)
        return carry, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return multi


# ---------------------------------------------------------------------------
# The online step over static buffers, and recorded as a CUDA graph
# ---------------------------------------------------------------------------


def commit_carry(carry: OnlineCarry, new: OnlineCarry, is_data: torch.Tensor) -> None:
    """Write ``new`` into ``carry``'s own tensors where the 0-d bool
    ``is_data`` is true and keep them where it is false: the persistent
    loop's masked commit (the JAX loop body's ``where(is_data, new_carry,
    carry)``, runtime/online.py:365-367), in place, so that a captured graph
    keeps reading and writing the same addresses."""
    for field in dataclasses.fields(OnlineCarry):
        old = getattr(carry, field.name)
        old.copy_(torch.where(is_data, getattr(new, field.name), old))


def _byte_layout(like: dict):
    """For ``name: (dtype, shape)`` in order: each one's (offset, bytes) in
    one byte buffer, every offset on a 16-byte boundary, and the buffer's
    size."""
    layout, size = {}, 0
    for name, (dtype, shape) in like.items():
        n = int(np.prod(shape)) * dtype.itemsize
        layout[name] = (size, n)
        size += -(-n // 16) * 16
    return layout, size


def _byte_views(flat: torch.Tensor, like: dict) -> dict:
    """Views of the uint8 buffer ``flat``, one for each ``name: (dtype,
    shape)`` of ``like``, at ``_byte_layout``'s offsets."""
    layout, _ = _byte_layout(like)
    return {name: flat[off : off + n].view(like[name][0]).view(like[name][1])
            for name, (off, n) in layout.items()}


@dataclasses.dataclass
class StaticStep:
    """``chunk_steps`` = K online steps over static buffers.  ``run()``
    decodes ``packet`` ((packet_size, n_channels), or (K, packet_size,
    n_channels) for K > 1) from ``carry`` through K calls of the step in
    order, commits the last new carry into ``carry``'s own tensors where
    ``is_data`` (int32) is nonzero (``commit_carry``) and copies the outputs
    into ``outputs``, stacked on a leading K axis for K > 1 as
    ``make_online_multi_step`` stacks them.  The outputs are views of the
    one byte buffer ``flat``, so a host slot of the same layout
    (``host_slot``) reads them all back with one copy.  Here ``run()`` calls
    ``body`` eagerly (the CPU path); ``CapturedStep`` replays the same body
    recorded as a CUDA graph."""

    body: Any
    packet: torch.Tensor
    is_data: torch.Tensor
    carry: OnlineCarry
    flat: torch.Tensor
    outputs: dict           # 'spec', 'spec_valid', 'audio', 'audio_valid'
    chunk_steps: int

    def run(self):
        self.body()

    def host_slot(self, pin: bool):
        """A host byte buffer the size of ``flat`` (pinned with ``pin``) and
        its views of the outputs."""
        slot = torch.empty(self.flat.shape, dtype=torch.uint8, pin_memory=pin)
        return slot, _byte_views(slot, {k: (v.dtype, tuple(v.shape))
                                        for k, v in self.outputs.items()})


def static_online_step(params: DecoderParams, cfg: DecoderConfig, step,
                       chunk_steps: int = 1, carry: Optional[OnlineCarry] = None) -> StaticStep:
    """The step function (``make_online_step``'s ``step``) over static
    buffers, ``chunk_steps`` calls a run.  ``carry`` is the static carry to
    commit into (a new ``init_online_carry`` by default); two of these built
    over one carry decode one stream.  The outputs' shapes come from one
    step on a fresh carry; is_data starts at 0."""
    K = int(chunk_steps)
    if K < 1:
        raise ValueError("chunk_steps must be >= 1")
    dev = params.device
    lead = (K,) if K > 1 else ()
    carry = carry if carry is not None else init_online_carry(params, cfg)
    packet = torch.zeros(lead + (cfg.packet_size, cfg.n_channels), dtype=cfg.dtype, device=dev)
    is_data = torch.zeros((), dtype=torch.int32, device=dev)
    _, probe = step(init_online_carry(params, cfg), packet[0] if K > 1 else packet)
    like = {k: (v.dtype, lead + tuple(v.shape)) for k, v in probe.items()}
    flat = torch.zeros(_byte_layout(like)[1], dtype=torch.uint8, device=dev)
    outputs = _byte_views(flat, like)

    def body():
        new = carry
        for i in range(K):
            new, out = step(new, packet[i] if K > 1 else packet)
            for name, v in out.items():
                (outputs[name][i] if K > 1 else outputs[name]).copy_(v)
        commit_carry(carry, new, is_data != 0)

    return StaticStep(body=body, packet=packet, is_data=is_data, carry=carry, flat=flat,
                      outputs=outputs, chunk_steps=K)


@dataclasses.dataclass
class CapturedStep(StaticStep):
    """A ``StaticStep`` recorded once: ``run()`` replays ``graph``, the
    ``torch.cuda.CUDAGraph`` (``keep_graph=True``) of its body.  Its
    ``raw_cuda_graph()`` is what the persistent loop runs, and it holds the
    private memory pool of every tensor made inside the recording, so it
    must live as long as anything that replays it."""

    graph: Any
    k4_nodes: int           # K4 launches recorded (gl_blocks wrapper calls in the recording)
    init_nodes: int         # block-init kernels recorded (cuda_prng.block_inits calls)

    def run(self):
        self.graph.replay()


def capture_online_step(params: DecoderParams, cfg: DecoderConfig, rand_source=0,
                        step=None, chunk_steps: int = 1, carry: Optional[OnlineCarry] = None,
                        pool=None) -> CapturedStep:
    """Record ``static_online_step``'s body (``chunk_steps`` calls of
    ``step``, the masked commit of the new carry into the static carry and
    the copies of the outputs into static buffers) as one CUDA graph, after
    two warm-up runs on a side stream with is_data 0 (they load every kernel
    and cuBLAS's workspace before the recording and leave the carry as it
    was).  ``step`` reuses the caller's ``make_online_step``; its arithmetic
    is not touched.  ``carry`` and ``pool`` (another graph's
    ``graph.pool()``) let two recordings, the single step and the K-step,
    share one static carry and one memory pool."""
    dev = params.device
    if dev.type != "cuda":
        raise ValueError(f"capture_online_step records a CUDA graph; the params lie on {dev}")
    step = step or make_online_step(params, cfg, rand_source)
    static = static_online_step(params, cfg, step, chunk_steps, carry)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            static.body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    k4, inits = gl_blocks.launches, cuda_prng.block_inits.launches
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        static.body()
    return CapturedStep(graph=graph, k4_nodes=gl_blocks.launches - k4,
                        init_nodes=cuda_prng.block_inits.launches - inits,
                        **{f.name: getattr(static, f.name) for f in dataclasses.fields(StaticStep)})
