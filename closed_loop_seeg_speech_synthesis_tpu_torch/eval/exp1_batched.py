"""Retrain+decode runners for exp1's proposed method and chance level (torch).

Port of ``closed_loop_seeg_speech_synthesis_tpu/eval/exp1_batched.py``.  One
run circularly shifts the training sEEG (chance runs only), re-extracts the
offline features, re-selects the top-|rho| features, refits all 40 LDAs in
one batch and decodes the held-out sEEG, all on the runner's device: in
float32 on the card the decode's front end is kernel K1 and the proposed
method's vocoder kernel K2.  The audio side of a fold (quantized labels,
medians, target mean; ``fold_targets``) never shifts, so it is staged once
per fold on the host.

A runner is built per fold shape and holds what all its runs share: the
decoder parameters with zero LDA weights (``exact_smooth=False``, as the
JAX runner builds them), into which each run swaps its LDA and medians, and
the training and decode frame grids.  The JAX runners map their runs one
after another (``lax.map``); so do these, in a Python loop.

Griffin-Lim inits: a proposed-method run takes an explicit ``rand_init``
table, or an int seed or key pair whose inits are
``griffinlim.default_rand_init``'s, the JAX package's threefry draws of that
key (``exp1.Experiment1`` passes ``prng.fold_in(key, k)`` as the JAX package
does).  Chance runs stop at the mel frames and draw no inits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.signal as _sig
import torch

from ..models import lda as lda_mod
from ..models.selection import spearman_vs_target, top_k
from ..ops import framing, iir, quantization
from ..ops import griffinlim as gl
from ..ops.spectrogram import compute_spectrogram
from ..runtime import pipeline, trainer

def fold_targets(y_train_audio, n_mel=40, nb_intervals=9):
    """Fold-constant training targets (audio never shifts, exp1.py:94-99):
    quantized labels (n, n_mel) int32, medians (n_mel, nb_intervals) and the
    target's frame mean (n,), staged on the host in float64 as the JAX
    package stages them on its CPU backend (scipy decimate, then the
    spectrogram and the quantizer)."""
    audio16 = np.ascontiguousarray(_sig.decimate(np.asarray(y_train_audio, np.float64), 3))
    y_spec = compute_spectrogram(torch.as_tensor(audio16), 16000, 0.016, 0.01, n_mel)[20:-4]
    medians, borders = quantization.compute_borders_logistic(y_spec, nb_intervals)
    q = quantization.quantize(y_spec, borders).numpy().astype(np.int32)
    y_spec = y_spec.numpy()
    return q, medians.numpy(), y_spec.mean(axis=1)


class FoldRunner:
    """Retrain+decode of one fold shape (``_make_one_run`` of the JAX
    package): training sEEG of ``train_len`` samples, held-out sEEG of
    ``test_len``, ``n_channels`` channels after the bad ones are dropped.
    ``device`` defaults to the card, ``dtype`` to its compute dtype."""

    def __init__(self, train_len, test_len, n_channels, eeg_sr, norm_factor, nb_feats=150,
                 nb_intervals=9, n_mel=40, line_noise=50, dtype=None, device=None):
        device = pipeline.resolve_device(device)
        dtype = dtype or pipeline.default_compute_dtype(device)
        self.device, self.dtype = device, dtype
        self.nb_feats, self.nb_intervals = nb_feats, nb_intervals
        self.cfg = cfg = pipeline.DecoderConfig(sr=float(eeg_sr), n_channels=n_channels,
                                                gl_norm=float(norm_factor),
                                                line_noise=line_noise, dtype=dtype)
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
        self.template = pipeline.build_decoder_params(
            cfg,
            lda_mod.LDAParams(
                coef=zeros(n_mel, nb_intervals, nb_feats),
                intercept=zeros(n_mel, nb_intervals),
                classes=torch.arange(nb_intervals, dtype=torch.int32,
                                     device=device).expand(n_mel, nb_intervals),
                valid=torch.ones((n_mel, nb_intervals), dtype=torch.bool, device=device),
            ),
            np.zeros((n_mel, nb_intervals)), np.arange(nb_feats), device=device,
            # each run swaps in its medians: the exact smoothing lattice
            # would be stale, so the arithmetic smoothing runs (as in JAX)
            exact_smooth=False)
        # training-grid framing (offline.py:99-116)
        starts = framing.offline_window_starts(0.05, 0.01, eeg_sr, train_len)
        self.wlen = framing.offline_window_len(0.05, eeg_sr, starts)
        self.tr_ends = torch.as_tensor(starts + self.wlen, device=device)
        # decode-grid framing of the held-out sEEG
        self.n_frames = framing.frame_count(cfg.frame_len_ms, cfg.frame_shift_ms, eeg_sr,
                                            test_len + cfg.prefill)
        self.n_stacked = (cfg.model_order + 1) * n_channels

    def _train_features(self, eeg):
        """Offline herff2016_b features of one (shifted) training signal, the
        decoder's combined chain warm-started in closed form
        (offline.py:31-97)."""
        t, cfg = self.template, self.cfg
        s0 = t.filt_zi_scale[:, None] * eeg[0][None, :] + t.filt_s_const[:, None]
        y, _ = iir.iir_blocked(t.filt_op, eeg, s0)
        F = framing.windowed_logpower(y, self.tr_ends, self.wlen)
        return framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=False)

    def fit(self, xt, q, y_mean, medians, shift=0, clock=None) -> pipeline.DecoderParams:
        """Retrain on the training sEEG shifted by ``shift`` samples: the
        template's decoder parameters with this run's LDA and medians."""
        clock = clock or trainer.StageClock(None, self.device)
        with clock("features"):
            feats = self._train_features(torch.roll(xt, -int(shift), 0))
        n = min(feats.shape[0], q.shape[0])
        X = feats[:n]
        with clock("selection"):
            rhos = spearman_vs_target(X, y_mean[:n])
            select = top_k(rhos.abs(), self.nb_feats).flip(0)  # select[::-1]
        with clock("lda_fit"):
            coef, intercept, present = lda_mod.fit_batched(X[:, select], q[:n].T,
                                                           self.nb_intervals)
        coef_full = coef.new_zeros(coef.shape[:2] + (self.n_stacked,))
        coef_full[:, :, select] = coef
        return dataclasses.replace(
            self.template, lda_coef_full=coef_full, medians=medians.to(self.dtype),
            lda=dataclasses.replace(self.template.lda, intercept=intercept, valid=present))

    def run(self, xt, xe, q, y_mean, medians, shift=0, rand_init=None, seed=0, audio=True,
            timings=None):
        """One retrain+decode.  xt (Tt, C) training and xe (T2, C) held-out
        sEEG, q (n, n_mel) labels, y_mean (n,), medians (n_mel, k): tensors
        on the runner's device (``put``).  Returns (spectrogram (n_frames,
        n_mel), int16 audio ((n_frames - 1) * 160,) or None without
        ``audio``); the inits are ``rand_init`` or the draws of ``seed`` (an
        int seed or a key pair).  ``timings`` sums milliseconds by stage
        into a dict (``trainer.StageClock``): features, selection, lda_fit,
        decode (the mel frames), vocoder."""
        clock = trainer.StageClock(timings, self.device)
        params = self.fit(xt, q, y_mean, medians, shift, clock)
        # offline_decode's two halves, timed apart; chance runs stop after the first
        with clock("decode"):
            spec = pipeline._mel_frames(params, self.cfg, xe)
        if not audio:
            return spec, None
        if rand_init is None:
            rand_init = gl.default_rand_init(self.n_frames - 1, 0, seed, self.dtype, self.device)
        with clock("vocoder"):
            wav = pipeline._vocode(params, self.cfg, spec, rand_init)
        return spec, wav

    def put(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype).to(self.device)


def make_chance_runner(train_len, test_len, n_channels, eeg_sr, norm_factor, nb_feats=150,
                       nb_intervals=9, n_mel=40, line_noise=50, dtype=None, device=None):
    """Chance runner for the given fold shapes.  Returns (runner, n_frames)
    with ``runner(xt (Tt, C), xe (T2, C), q (n, n_mel), y_mean (n,),
    medians (n_mel, k), shifts (R,), timings=None) -> reco (R, n_frames,
    n_mel)`` on the runner's device: one run per shift, in order."""
    one = FoldRunner(train_len, test_len, n_channels, eeg_sr, norm_factor, nb_feats,
                     nb_intervals, n_mel, line_noise, dtype=dtype, device=device)

    def runner(xt, xe, q, y_mean, medians, shifts, timings=None):
        return torch.stack([one.run(xt, xe, q, y_mean, medians, int(s), audio=False,
                                    timings=timings)[0] for s in shifts])

    runner.fold_runner = one
    return runner, one.n_frames


def make_proposed_runner(train_len, test_len, n_channels, eeg_sr, norm_factor, nb_feats=150,
                         nb_intervals=9, n_mel=40, line_noise=50, dtype=None, device=None):
    """Proposed-method runner for the given fold shapes: each fold differs
    from a chance run by an unshifted training sEEG and its own targets.
    Returns (runner, n_frames) with ``runner(xts, xes, qs, y_means,
    medians, rand_inits=None, seeds=None, timings=None) -> (reco (K,
    n_frames, n_mel), audio (K, (n_frames - 1) * 160))`` over K folds in
    order; fold j takes ``rand_inits[j]`` or the inits of ``seeds[j]``, an
    int seed or a key pair (default 0, ``PRNGKey(0)``)."""
    one = FoldRunner(train_len, test_len, n_channels, eeg_sr, norm_factor, nb_feats,
                     nb_intervals, n_mel, line_noise, dtype=dtype, device=device)

    def runner(xts, xes, qs, y_means, medians, rand_inits=None, seeds=None, timings=None):
        out = [one.run(xt, xe, q, ym, med, 0,
                       rand_init=None if rand_inits is None else rand_inits[j],
                       seed=0 if seeds is None else seeds[j], timings=timings)
               for j, (xt, xe, q, ym, med) in enumerate(zip(xts, xes, qs, y_means, medians))]
        return torch.stack([s for s, _ in out]), torch.stack([a for _, a in out])

    runner.fold_runner = one
    return runner, one.n_frames


def make_fold_chance_runner(x_train, y_train_audio, x_test, eeg_sr, audio_sr, bad_channels,
                            norm_factor, nb_feats=150, nb_intervals=9, n_mel=40, line_noise=50,
                            dtype=None, device=None):
    """``make_chance_runner`` bound to one fold's data.  Returns (runner,
    n_frames) with ``runner(shifts) -> reco (R, n_frames, n_mel)``."""
    mask = np.ones(x_train.shape[1], bool)
    if len(bad_channels):
        mask[np.asarray(bad_channels, int)] = False
    q, medians, y_mean = fold_targets(y_train_audio, n_mel, nb_intervals)
    runner, n_frames = make_chance_runner(
        x_train.shape[0], x_test.shape[0], int(mask.sum()), float(eeg_sr), float(norm_factor),
        nb_feats, nb_intervals, n_mel, line_noise, dtype=dtype, device=device)
    put = runner.fold_runner.put
    xt = put(np.asarray(x_train, np.float64)[:, mask])
    xe = put(np.asarray(x_test, np.float64)[:, mask])
    args = (xt, xe, put(q, torch.int64), put(y_mean), put(medians))

    def bound(shifts):
        return runner(*args, shifts)

    return bound, n_frames
