"""Experiment 1: 10-fold cross-validated spectrogram reconstruction vs a
randomized chance level (twin of reference ``eval_steps/exp1.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/eval/exp1.py``.  Per fold:
cut the test words' contiguous 3 s spans out of the raw recording, retrain
on the rest, decode the held-out sEEG, compare the reconstructed logMels
with the audio spectrogram of the held-out audio.  Chance level repeats this
with the training sEEG circularly split at a random index to break
neural/audio alignment (exp1.py:94-99).

Runs on ``device`` (default the card, float32: every fold's decode launches
kernel K1, every proposed fold's vocoder K2); ``device="cpu"`` runs the
float64 path the tests hold to the JAX package.  The session comes from
``session_dir`` (``speech1.hdf`` and ``params.h5``, read through ``io.hdf5``)
or as a ``Session`` and the bad channels given as arrays.
Griffin-Lim inits are the JAX package's: ``PRNGKey(k)`` for fold k through
``train_decode_fold``, ``fold_in(key, k)`` in the batched folds.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.io.wavfile import write as wavwrite
from scipy.signal import decimate

from ..io import hdf5
from ..io.session import Session
from ..ops import prng
from ..ops.spectrogram import compute_spectrogram
from ..runtime import pipeline, trainer
from . import exp1_batched
from .metrics import extract_corrs_for_distribution, kfold_indices, pearson_correlation

logger = logging.getLogger("eval.exp1")

# Stacked-feature multiplier of the runners' decoder config: the nb_feats
# clamp below tracks DecoderConfig's default model_order
_N_TAPS = pipeline.DecoderConfig.__dataclass_fields__["model_order"].default + 1


def train_decode_fold(k, eeg_train, audio_train, eeg_test, spec_test, eeg_sr, audio_sr,
                      bad_channels, norm_factor, dtype=None, rand_init=None, seed=None,
                      nb_feats=150, device=None):
    """One fold: full retrain + offline decode of the held-out sEEG on
    ``device`` (default the card).  The Griffin-Lim inits are ``rand_init``
    or those of ``seed``, an int seed or a key pair (default: the fold id
    ``k``, as the JAX package keys fold k with PRNGKey(k)).  Returns (k,
    spectrogram, spec_test, audio) as numpy arrays."""
    device = pipeline.resolve_device(device)
    dtype = dtype or pipeline.default_compute_dtype(device)
    logger.info("Processing Fold k=%d", k)
    res = trainer.train(eeg_train, audio_train, eeg_sr, audio_sr, bad_channels,
                        nb_feats=nb_feats, dtype=dtype, device=device)

    mask = np.ones(eeg_test.shape[1], bool)
    mask[np.asarray(bad_channels, int)] = False
    eeg_test_sel = eeg_test[:, mask]

    cfg = pipeline.DecoderConfig(sr=float(eeg_sr), n_channels=eeg_test_sel.shape[1],
                                 gl_norm=float(norm_factor), dtype=dtype)
    dec = pipeline.build_decoder_params(cfg, res.lda, res.medians, res.select, device=device)
    spec, audio = pipeline.offline_decode(dec, cfg, eeg_test_sel, rand_init=rand_init,
                                          seed=k if seed is None else seed)
    return k, spec.cpu().numpy(), spec_test, audio.cpu().numpy()


class Experiment1:
    """exp1 on one session.  ``session`` (a ``Session``) and
    ``bad_channels`` stand in for ``session_dir``'s recording and
    ``params.h5``; ``rng`` draws the session's audio dither (when the
    session is read here) and every chance shift, in the JAX package's
    order.  ``device`` defaults to the card, ``dtype`` to its compute dtype."""

    def __init__(self, config, session_dir, dest_dir, rng=None, device=None, session=None,
                 bad_channels=None, dtype=None):
        self.session_dir = session_dir
        self.dest_dir = dest_dir
        self.config = config
        self.device = pipeline.resolve_device(device)
        self.dtype = dtype or pipeline.default_compute_dtype(self.device)
        self.rng = rng or np.random.RandomState()
        self.sess = session or Session(session_dir, downsample_audio=False, rng=self.rng)
        self.bad_channels = None if bad_channels is None else np.asarray(bad_channels, int)

    def _bad_channels(self):
        if self.bad_channels is None:
            with hdf5.File(os.path.join(self.session_dir, "params.h5"), "r") as hf:
                self.bad_channels = hf["bad_channels"][:]
        return self.bad_channels

    def _construct_datasets_for_run(self, nb_folds=10, randomize=False):
        """Per fold (k, x_train, y_train, x_test, y_test, eeg_sr, audio_sr,
        bad_channels, norm_factor), staged in threads; with ``randomize`` the
        training sEEG is circularly shifted afterwards, in fold order, so the
        shifts are the JAX package's (and the reference's serial loop's)."""
        bad_channels = self._bad_channels()
        norm_factor = self.config.getint("Experiment1", "griffin_lim_norm")
        sess = self.sess
        folds = list(enumerate(kfold_indices(len(sess.words), nb_folds), start=1))

        def stage(fold):
            k, (train_idx, test_idx) = fold
            eeg_mask = np.ones(len(sess.eeg), bool)
            audio_mask = np.ones(len(sess.audio), bool)
            es = sess.word_starts_indices_eeg[test_idx[0]]
            ee = sess.word_starts_indices_eeg[test_idx[-1]] + 3 * sess.eeg_sr
            eeg_mask[es:ee] = False
            as_ = sess.word_starts_indices_audio[test_idx[0]]
            ae = sess.word_starts_indices_audio[test_idx[-1]] + 3 * sess.audio_sr
            audio_mask[as_:ae] = False

            x_train = np.asarray(sess.eeg[eeg_mask], dtype=np.float64)
            y_train = sess.audio[audio_mask]
            x_test = sess.eeg[~eeg_mask]
            y_test = compute_spectrogram(
                torch.as_tensor(np.ascontiguousarray(decimate(sess.audio[~audio_mask], 3))),
                16000, 0.016, 0.01).numpy()

            minimum = min(len(x_train) / sess.eeg_sr, len(y_train) / sess.audio_sr)
            x_train = x_train[: int(minimum * sess.eeg_sr)]
            y_train = y_train[: int(minimum * sess.audio_sr)]
            return [k, x_train, y_train, x_test, y_test, sess.eeg_sr, sess.audio_sr,
                    bad_channels, norm_factor]

        # numpy masking, scipy decimate and the spectrogram release the GIL
        with ThreadPoolExecutor(max_workers=min(len(folds), os.cpu_count() or 4)) as ex:
            args = list(ex.map(stage, folds))

        if randomize:
            for a in args:
                r = self.rng.randint(0, len(a[1]))
                a[1] = np.vstack([a[1][r:], a[1][:r]])
        return [tuple(a) for a in args]

    def _run_folds(self, args, rand_inits=None):
        """Fold by fold through ``train_decode_fold`` (the parity twin of
        ``_run_folds_batched``); fold k's inits are ``rand_inits[i]`` (i its
        place in ``args``) or those of seed k."""
        results = [train_decode_fold(*a, dtype=self.dtype, device=self.device,
                                     rand_init=None if rand_inits is None else rand_inits[i])
                   for i, a in enumerate(args)]
        _, reco, orig, wavs = zip(*sorted(results, key=lambda r: r[0]))
        return np.vstack(reco), np.vstack(orig), np.hstack(wavs)

    def _run_folds_batched(self, args, nb_feats=150, fold_batch=10, rand_inits=None, seed=0,
                           timings=None):
        """The folds through one proposed runner per fold shape (uniform
        KFold: one), ``fold_batch`` folds staged at a time.  Fold k's inits
        are ``rand_inits[i]`` (i its place in ``args``) or those of
        ``fold_in(seed, k)``, ``seed`` an int seed (``PRNGKey(seed)``) or a
        key pair, as the JAX package keys them."""
        groups = {}  # shape key -> [(place in args, fold args)]
        for i, a in enumerate(args):
            groups.setdefault((a[1].shape, a[3].shape, float(a[8])), []).append((i, a))

        recos, origs, wavs = [None] * len(args), [None] * len(args), [None] * len(args)
        for members in groups.values():
            (_, xt0, _, xe0, _, eeg_sr, _, bad, norm) = members[0][1]
            mask = np.ones(xt0.shape[1], bool)
            if len(bad):
                mask[np.asarray(bad, int)] = False
            # small sessions can have fewer stacked features than nb_feats
            nf = min(nb_feats, _N_TAPS * int(mask.sum()))
            runner, _ = exp1_batched.make_proposed_runner(
                xt0.shape[0], xe0.shape[0], int(mask.sum()), float(eeg_sr), float(norm),
                nb_feats=nf, dtype=self.dtype, device=self.device)
            put = runner.fold_runner.put

            for c0 in range(0, len(members), fold_batch):
                chunk = members[c0 : c0 + fold_batch]

                def stage_member(member):
                    _, (k, x_train, y_train, x_test, *_rest) = member
                    q, medians, y_mean = exp1_batched.fold_targets(y_train)
                    return (np.asarray(x_train, np.float64)[:, mask],
                            np.asarray(x_test, np.float64)[:, mask], q, y_mean, medians)

                with ThreadPoolExecutor(max_workers=min(len(chunk), os.cpu_count() or 4)) as ex:
                    staged = list(ex.map(stage_member, chunk))
                xts, xes, qs, yms, meds = (
                    [put(s[j], torch.int64 if j == 2 else None) for s in staged] for j in range(5))
                reco_b, audio_b = runner(
                    xts, xes, qs, yms, meds,
                    rand_inits=None if rand_inits is None else [rand_inits[i] for i, _ in chunk],
                    seeds=[prng.fold_in(seed, a[0]) for _, a in chunk], timings=timings)
                reco_b, audio_b = reco_b.cpu().numpy(), audio_b.cpu().numpy()
                for j, (i, a) in enumerate(chunk):
                    recos[i], origs[i], wavs[i] = reco_b[j], a[4], audio_b[j]
        return np.vstack(recos), np.vstack(origs), np.hstack(wavs)

    def proposed_method(self, nb_folds=10, batched=True, args=None, fold_batch=10,
                        rand_inits=None, seed=0, timings=None):
        """Reconstruct every word from a model trained without its fold;
        writes ``reco_wavs/``, ``pm_reco.npy`` and ``orig.npy`` to the
        destination and returns the per-bin correlations' mean and std over
        5 contiguous blocks.  ``args``: pre-staged folds."""
        if args is None:
            args = self._construct_datasets_for_run(nb_folds)
        elif len(args) != nb_folds:
            raise ValueError(f"pre-staged args carry {len(args)} folds but nb_folds={nb_folds}")
        if batched:
            reco, orig, decoded_audio = self._run_folds_batched(
                args, fold_batch=fold_batch, rand_inits=rand_inits, seed=seed, timings=timings)
        else:
            reco, orig, decoded_audio = self._run_folds(args, rand_inits=rand_inits)
        sr = 16000
        wav_dir = os.path.join(self.dest_dir, "reco_wavs")
        os.makedirs(wav_dir, exist_ok=True)
        for i, w in enumerate(self.sess.words):
            word_wav = decoded_audio[i * 3 * sr : (i * 3 + 2) * sr]
            wavwrite(os.path.join(wav_dir, "{:03}-{}.wav".format(i + 1, w)), sr, word_wav)
        np.save(os.path.join(self.dest_dir, "pm_reco.npy"), reco)
        np.save(os.path.join(self.dest_dir, "orig.npy"), orig)
        return extract_corrs_for_distribution(orig, reco, n_folds=5)

    def chance_level(self, nb_runs=100, nb_folds=10):
        """Sequential chance level: each run restages the folds with fresh
        shifts and retrains fold by fold."""
        corrs = []
        for i in range(nb_runs):
            reco, orig, _ = self._run_folds(self._construct_datasets_for_run(nb_folds, randomize=True))
            np.save(os.path.join(self.dest_dir, "rc_reco_i={:03}.npy".format(i + 1)), reco)
            _, _, rs = pearson_correlation(orig, reco, return_means=True)
            corrs.append(rs)
        corrs = np.vstack(corrs)
        return np.mean(corrs, axis=0), np.std(corrs, axis=0)

    def chance_level_batched(self, nb_runs=100, nb_folds=10, batch_size=10, save=True,
                             nb_feats=150, base_args=None, checkpoint_dir=None, timings=None):
        """The chance level with the folds staged once: a run only shifts
        the training sEEG (exp1.py:94-99), so each fold's targets are staged
        once and its runs go through one chance runner, ``batch_size`` runs
        a chunk.  Every (run, fold) shift is drawn from ``rng`` before any
        run, so a resume with the same seeded rng repeats them;
        ``checkpoint_dir`` keeps each finished chunk and then each finished
        fold.  The selected features are the top |rho| (the reference's
        argsort selects the same set; the LDA's predictions do not depend
        on the features' order).  ``timings`` sums milliseconds by stage
        into a dict: fold_targets (once a fold a call) and the runs' stages
        (``exp1_batched.FoldRunner.run``).  Returns the per-bin mean and std
        over runs."""
        if base_args is None:
            base_args = self._construct_datasets_for_run(nb_folds, randomize=False)
        elif len(base_args) != nb_folds:
            raise ValueError(
                f"pre-staged base_args carry {len(base_args)} folds but nb_folds={nb_folds}")

        shifts = np.zeros((nb_runs, len(base_args)), np.int64)
        for i in range(nb_runs):
            for f, a in enumerate(base_args):
                shifts[i, f] = self.rng.randint(0, len(a[1]))
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)

        runners = {}  # fold shape -> chance runner
        fold_recos, origs = [], []  # per fold: (nb_runs, n_frames, n_mel)
        for f, (k, x_train, y_train, x_test, y_test, eeg_sr, audio_sr, bad, norm) in enumerate(base_args):
            ck = (os.path.join(checkpoint_dir, f"chance_fold_{f:02}_r{nb_runs}.npy")
                  if checkpoint_dir else None)
            if ck and os.path.exists(ck):
                done = np.load(ck)
                if done.shape[0] == nb_runs:  # a complete fold from a prior attempt
                    logger.info("chance fold %d restored from checkpoint", f)
                    fold_recos.append(done)
                    origs.append(y_test)
                    continue
            chunk_cks = {}
            if checkpoint_dir:
                for start in range(0, nb_runs, batch_size):
                    chunk_cks[start] = os.path.join(
                        checkpoint_dir, f"chance_fold_{f:02}_c{start:03}_b{batch_size}_r{nb_runs}.npy")
            mask = np.ones(x_train.shape[1], bool)
            if len(bad):
                mask[np.asarray(bad, int)] = False
            shape_key = (x_train.shape, x_test.shape, float(norm))
            if shape_key not in runners:
                nf = min(nb_feats, _N_TAPS * int(mask.sum()))
                runners[shape_key] = exp1_batched.make_chance_runner(
                    x_train.shape[0], x_test.shape[0], int(mask.sum()), float(eeg_sr),
                    float(norm), nb_feats=nf, dtype=self.dtype, device=self.device)[0]
            runner = runners[shape_key]
            put = runner.fold_runner.put
            t0 = time.perf_counter()
            q, medians, y_mean = exp1_batched.fold_targets(y_train)
            if timings is not None:
                timings["fold_targets"] = (timings.get("fold_targets", 0.0)
                                           + (time.perf_counter() - t0) * 1e3)
            fold_args = (put(np.asarray(x_train, np.float64)[:, mask]),
                         put(np.asarray(x_test, np.float64)[:, mask]),
                         put(q, torch.int64), put(y_mean), put(medians))
            outs = []
            for start in range(0, nb_runs, batch_size):
                cck = chunk_cks.get(start)
                if cck and os.path.exists(cck):
                    outs.append(np.load(cck))
                    continue
                out = runner(*fold_args, shifts[start : start + batch_size, f],
                             timings=timings).cpu().numpy()
                if cck:
                    np.save(cck, out)
                outs.append(out)
            fold_recos.append(np.concatenate(outs, axis=0))
            origs.append(y_test)
            if ck:
                np.save(ck, fold_recos[-1])
                for cck in chunk_cks.values():
                    if os.path.exists(cck):
                        os.remove(cck)
        orig = np.vstack(origs)

        corrs = []
        for i in range(nb_runs):
            reco = np.vstack([fr[i] for fr in fold_recos])
            n = min(len(reco), len(orig))
            if save:
                np.save(os.path.join(self.dest_dir, "rc_reco_i={:03}.npy".format(i + 1)), reco[:n])
            _, _, rs = pearson_correlation(orig[:n], reco[:n], return_means=True)
            corrs.append(rs)
        corrs = np.vstack(corrs)
        return np.mean(corrs, axis=0), np.std(corrs, axis=0)

    def synthesize_specs(self, reco, norm_factor=10.0, rand_init=None, seed=0):
        """Re-vocode a saved spectrogram (exp1.py:162-180) in float64 on the
        plain path: 8 Griffin-Lim iterations under the reference's phase
        quirk, overlap-add, the output low-pass at blocks of 160; writes the
        words' 2 s trials to ``resynth/`` and returns the int16 audio."""
        from ..ops import filter_design as fd
        from ..ops import griffinlim as gl
        from ..ops import iir

        dt, dev = torch.float64, self.device
        reco = torch.as_tensor(np.asarray(reco), dtype=dt, device=dev)
        ops = gl.make_streaming_gl_ops(reco.shape[1], 16000.0, dt, dev)
        rand = (gl.default_rand_init(reco.shape[0] - 1, 0, seed, dt, dev) if rand_init is None
                else torch.as_tensor(rand_init, dtype=dt, device=dev))
        re = gl.streaming_gl_blocks(reco, rand, ops, 8, True)
        raw = gl.overlap_add_stream(re, ops)
        ss = iir.sos_to_statespace(fd.gl_output_lowpass_sos())
        lp, _ = iir.iir_blocked(iir.make_blocked_iir(ss, 160, dt, dev), raw[:, None],
                                raw.new_zeros((ss.dim, 1)))
        wav = gl.to_int16(lp[:, 0], norm_factor).cpu().numpy()
        out_dir = os.path.join(self.dest_dir, "resynth")
        os.makedirs(out_dir, exist_ok=True)
        for i in range(len(self.sess.words)):
            trial = wav[i * 3 * 16000 : (i * 3 + 2) * 16000]
            wavwrite(os.path.join(out_dir, "{:03}-{}.wav".format(i + 1, self.sess.words[i])), 16000, trial)
        return wav

    def run(self, randomization_runs=100, batched=True):
        pm = self.proposed_method(batched=batched)
        if batched:
            rc = self.chance_level_batched(nb_runs=randomization_runs)
        else:
            rc = self.chance_level(nb_runs=randomization_runs)
        return pm, rc
