"""Training and replay over the (data, model) mesh.

Port of ``closed_loop_seeg_speech_synthesis_tpu/parallel/sharded.py``.

``make_sharded_train_step`` fits one model from a batch of recording
sessions, each rank holding its own sessions (data) and featurizing its own
block of their channels (model):

    filter chain -> log-power -> context stack     (channel-local)
    -> all-gather of the features over model, then of the features and the
       target spectrograms over data               (the one cross-rank edge)
    -> quantization, Spearman selection, the 40 LDAs   (the same on every rank)

``make_sharded_decode`` decodes one session with its channels split over
``model``: each rank filters and frames its block (K3 on the card), stacks
its context and contracts it with its block of the LDA weights; the partial
products are summed across the ranks, and the rest of the decode (first
max, dequantization, smoothing, then K2) runs on every rank, whose outputs
are therefore the same.

``make_batched_replay`` decodes each rank's sessions: through K1 + K2, one
launch each per session, where the model axis has one rank (the JAX
package's ``pallas_util.sequential_vmap`` also launches one kernel per
session), through the channel-sharded decode where it has more.

The JAX signatures' ``decode_jit`` argument (the jitted decode to vmap) and
its ``ends`` (the frame ends) are not taken: the decode is the pipeline's,
and the frame ends follow from the input length.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models import lda as lda_mod
from ..models.selection import spearman_vs_target, top_k
from ..ops import filter_design as fd
from ..ops import framing, griffinlim as gl, iir, quantization
from ..ops.spectrogram import compute_spectrogram
from ..runtime import pipeline
from . import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class ShardedTrainConfig:
    sr: float = 1024.0
    audio_sr: int = 16000
    line_noise: int = 50
    n_mel: int = 40
    nb_intervals: int = 9
    nb_feats: int = 150
    model_order: int = 4
    step_size: int = 5
    iir_block: int = 128
    dtype: Any = torch.float32


def make_sharded_train_step(mesh, cfg: ShardedTrainConfig, session_len: int, audio_len: int,
                            n_channels: int, device=None):
    """Returns ``step(eeg (B_local, T, C), audio (B_local, Ta))`` -> (LDAParams,
    select (nb_feats,), medians (n_mel, nb_intervals)), the same on every
    rank: a complete decodable model (tensors on ``device``, default the
    card).  eeg holds this rank's sessions with all C channels (the ranks of
    one model group pass the same sessions; each featurizes its
    ``session_sharding`` channel block); audio is at ``cfg.audio_sr``.  The
    global batch is the data ranks' sessions in rank order.  ``step`` takes
    ``timings``, a dict that receives the collectives' milliseconds."""
    device = pipeline.resolve_device(device)
    dt = cfg.dtype
    chain = fd.high_gamma_bank(cfg.sr, cfg.line_noise)
    prefill = int(0.05 * cfg.sr) - int(0.01 * cfg.sr)
    combined, warm = iir.make_warmstart_chain(chain, prefill)
    op = iir.make_blocked_iir(combined, cfg.iir_block, dt, device)
    zi_scale, s_const = (torch.as_tensor(a, dtype=dt, device=device)
                         for a in (warm.zi_scale, warm.s_const))
    starts = framing.offline_window_starts(0.05, 0.01, cfg.sr, session_len)
    wlen = framing.offline_window_len(0.05, cfg.sr, starts)
    ends = torch.as_tensor(starts + wlen, device=device)
    channels = mesh_lib.axis_block(mesh, "model", n_channels, "channels")

    def session_features(eeg):
        """One session's training-grid stacked features of this rank's channels."""
        x = torch.as_tensor(eeg)[:, channels].to(device=device, dtype=dt)
        y, _ = iir.iir_blocked(op, x, zi_scale[:, None] * x[0][None, :] + s_const[:, None])
        F = framing.windowed_logpower(y, ends, wlen)
        return framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=False)

    def step(eeg, audio, timings: dict | None = None):
        if tuple(eeg.shape[1:]) != (session_len, n_channels) or audio.shape[1:] != (audio_len,):
            raise ValueError(f"sharded train step built for sessions of ({session_len}, "
                             f"{n_channels}) and audio of {audio_len}; got "
                             f"{tuple(eeg.shape)} and {tuple(audio.shape)}")
        feats = torch.stack([session_features(e) for e in eeg])          # (B_local, N, F_local)
        specs = torch.stack([compute_spectrogram(
            torch.as_tensor(a).to(device=device, dtype=dt), cfg.audio_sr, 0.016, 0.01,
            cfg.n_mel) for a in audio])[:, 20:-4]  # alignment crop (train.py:144-147)
        # channel-major blocks side by side, then the sessions in data order
        feats = mesh_lib.all_gather(feats, mesh, "model", dim=2, timings=timings)
        feats = mesh_lib.all_gather(feats, mesh, "data", timings=timings)
        specs = mesh_lib.all_gather(specs, mesh, "data", timings=timings)
        B, N, F = feats.shape
        n = min(N, specs.shape[1])
        X = feats[:, :n].reshape(B * n, F)
        Yspec = specs[:, :n].reshape(B * n, cfg.n_mel)

        medians, borders = quantization.compute_borders_logistic(Yspec, cfg.nb_intervals)
        q = quantization.quantize(Yspec, borders).long()
        rhos = spearman_vs_target(X, torch.mean(Yspec, dim=1))
        select = top_k(torch.abs(rhos), cfg.nb_feats).flip(0)  # ascending |rho|, as the reference
        coef, intercept, present = lda_mod.fit_batched(X[:, select], q.T, cfg.nb_intervals)
        classes = torch.arange(cfg.nb_intervals, dtype=torch.int32, device=device)
        params = lda_mod.LDAParams(coef=coef, intercept=intercept,
                                   classes=classes.expand(cfg.n_mel, -1).contiguous(),
                                   valid=present)
        return params, select, medians

    return step


def make_sharded_decode(mesh, dec_params: pipeline.DecoderParams, cfg: pipeline.DecoderConfig,
                        n_frames: int):
    """Returns ``decode(eeg (T, C), rand_init=None, seed=0, timings=None)`` ->
    (spec (n_frames, n_mel), audio int16), the same on every rank: the
    session's channels split over the model axis (each rank takes its
    ``session_sharding`` block of eeg), the LDA products summed across it.
    With one model rank it is the split offline decode (K3 and the plain
    LDA, then K2 on the card).  rand_init: (n_frames - 1, 480), the
    ``gl.default_rand_init`` of ``seed`` (an int seed, meaning
    ``PRNGKey(seed)``, or a key pair) when None."""
    C = cfg.n_channels
    channels = mesh_lib.axis_block(mesh, "model", C, "channels")
    features = mesh_lib.feature_sharding(mesh, cfg.n_stacked)
    cfg_block = dataclasses.replace(cfg, n_channels=channels.stop - channels.start,
                                    use_cuda_epilogue=False)
    coef_block = dec_params.lda_coef_full[:, :, features]
    dev, dt = dec_params.device, cfg.dtype

    def decode(eeg, rand_init=None, seed=0, timings: dict | None = None):
        x = torch.as_tensor(eeg)
        if x.ndim != 2 or x.shape[1] != C:
            raise ValueError(f"sharded decode built for {C} channels; got eeg of shape "
                             f"{tuple(x.shape)}")
        x = x[:, channels].to(device=dev, dtype=dt)
        plan = pipeline.mel_plan(dec_params, cfg_block, x.shape[0])
        if plan.n_frames != n_frames:
            raise ValueError(f"sharded decode built for {n_frames} frames; {x.shape[0]} "
                             f"samples give {plan.n_frames}")
        stacked = framing.stack_context(pipeline._logpower(dec_params, cfg_block, x, plan),
                                        cfg.model_order, cfg.step_size, zero_pad=True)
        products = torch.einsum("td,bkd->tbk", stacked, coef_block)
        products = mesh_lib.all_reduce_sum(products, mesh, "model", timings=timings)
        mel = pipeline._products_to_mel(dec_params, products)
        if rand_init is None:
            rand_init = gl.default_rand_init(n_frames - 1, 0, seed, dt, dev)
        return mel, pipeline._vocode(dec_params, cfg, mel, rand_init)

    return decode


def make_batched_replay(mesh, cfg: pipeline.DecoderConfig, n_frames: int):
    """Returns ``replay(params, eeg (B_local, T, C), rand (B_local, n_frames - 1,
    480), timings=None)`` -> (specs (B_local, n_frames, n_mel), audios
    (B_local, (n_frames - 1) * 160)): this rank's sessions decoded, on the
    params' device.  The global batch is the data ranks' sessions in rank
    order (``session_sharding``); the ranks of one model group pass the
    same sessions and decode each through ``make_sharded_decode``."""

    def replay(params: pipeline.DecoderParams, eeg, rand, timings: dict | None = None):
        if mesh_lib.axis_size(mesh, "model") > 1:
            decode = make_sharded_decode(mesh, params, cfg, n_frames)
            outs = [decode(e, r, timings=timings) for e, r in zip(eeg, rand)]
        else:
            plan = pipeline.mel_plan(params, cfg, eeg.shape[1])
            if plan.n_frames != n_frames:
                raise ValueError(f"batched replay built for {n_frames} frames; "
                                 f"{eeg.shape[1]} samples give {plan.n_frames}")
            outs = []
            for e, r in zip(eeg, rand):
                mel = pipeline._mel_frames(params, cfg, e, plan)
                outs.append((mel, pipeline._vocode(params, cfg, mel, r)))
        return torch.stack([s for s, _ in outs]), torch.stack([a for _, a in outs])

    return replay
