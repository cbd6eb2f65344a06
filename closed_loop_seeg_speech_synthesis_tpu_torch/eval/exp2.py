"""Experiment 2: DTW correlations of whisper/imagine decodes vs chance
(twin of reference ``eval_steps/exp2.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/eval/exp2.py``.  Matched
pairs: for every word present in both the training session and a decoding
run, DTW-warp the training trial's logMels onto the decoded trial's logMels
and take the mean per-bin Pearson r.  Chance: decode random 2 s segments of
*other-task* sEEG through the trained model and DTW-score them against
training words.

Runs on ``device`` (default the card, float32): every chance segment's
decode launches kernel K1 once (``chance_level_batched``, what ``run`` uses,
stops at the mel frames; ``chance_level``, its sequential parity twin, runs
the whole ``offline_decode``, so K2 launches too).  ``device="cpu"`` runs
the float64 path the tests hold to the JAX package.  The spectrograms of
the original audio run on the experiment's device and dtype; DTW and the
correlations run in numpy on the host.  The cuts are drawn from ``rng`` in
the JAX package's order, so they are the same indices.  The session, the
decoding run, the other-task sEEG and the model come from files
(``session_dir``, ``run_dir``, ``other_tasks``, ``params.h5``) or as
objects and arrays.  Griffin-Lim inits of the
sequential twin are the JAX package's draws of ``PRNGKey(i)`` for segment
i; the score depends only on the spectrogram.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..io.loaders import load_only_eeg
from ..io.session import DecodingRun, Session
from ..ops.spectrogram import compute_spectrogram
from ..runtime import params as params_io
from ..runtime import pipeline
from ..runtime.trainer import StageClock
from .dtw import dtw_warping
from .metrics import pearson_correlation

logger = logging.getLogger("eval.exp2")


class Experiment2:
    """exp2 of one decoding run.  ``session`` (a ``Session``), ``dec_run``
    (a ``DecodingRun``), ``other_tasks_eeg`` (T, C) and ``model`` (the
    ``params.load_params`` dict: lda, medians, select, bad_channels) stand
    in for the files; ``rng`` draws the session's audio dither (when the
    session is read here) and then the chance cuts, as in the JAX package.
    ``device`` defaults to the card, ``dtype`` to its compute dtype."""

    def __init__(self, config, session_dir, run_dir, other_tasks, dest_dir, rng=None,
                 device=None, dtype=None, session=None, dec_run=None, other_tasks_eeg=None,
                 model=None):
        self.config = config
        self.session_dir = session_dir
        self.run_dir = run_dir
        self.dest_dir = dest_dir
        self.device = pipeline.resolve_device(device)
        self.dtype = dtype or pipeline.default_compute_dtype(self.device)
        self.rng = rng or np.random.RandomState()
        self.audio_sr = 16000
        self.dec_run = dec_run or DecodingRun(run_dir)
        self.sess = session or Session(session_dir, rng=self.rng)
        self.model = model
        if other_tasks_eeg is not None:
            self.other_tasks_eeg = np.asarray(other_tasks_eeg)
        elif other_tasks:
            self.other_tasks_eeg = np.vstack([
                load_only_eeg(os.path.join(session_dir, ot))[0] for ot in other_tasks
            ])
        else:
            self.other_tasks_eeg = None

    def _model(self):
        if self.model is None:
            self.model = params_io.load_params(os.path.join(self.session_dir, "params.h5"),
                                               dtype=self.dtype, device=self.device)
        return self.model

    def _decoder(self):
        """(channel mask of the other-task sEEG, DecoderConfig, DecoderParams)
        of the trained model at the decoding run's rate."""
        model = self._model()
        norm = self.config.getint("Experiment2", "griffin_lim_norm")
        mask = np.ones(self.other_tasks_eeg.shape[1], bool)
        mask[np.asarray(model["bad_channels"], int)] = False
        cfg = pipeline.DecoderConfig(sr=float(self.dec_run.eeg_sr), n_channels=int(mask.sum()),
                                     gl_norm=float(norm), dtype=self.dtype)
        dec = pipeline.build_decoder_params(cfg, model["lda"], model["medians"], model["select"],
                                            device=self.device)
        return mask, cfg, dec

    def _spectrogram(self, audio, sr):
        """logMels (0.016 s windows every 0.01 s) of host audio, computed on
        the experiment's device and dtype, back on the host."""
        x = torch.as_tensor(np.ascontiguousarray(audio), dtype=self.dtype, device=self.device)
        return compute_spectrogram(x, sr, 0.016, 0.01).cpu().numpy()

    def _scorer(self, clock):
        """score(i, reco): the DTW correlation of chance segment i's decoded
        logMels against training word i mod the words' count; each word's
        spectrogram is computed once."""
        training_words = list(zip(self.sess.word_starts_indices_audio, self.sess.words))
        origs = {}

        def score(i, reco):
            w = i % len(training_words)
            if w not in origs:
                wa, _ = training_words[w]
                with clock("spectrogram"):
                    origs[w] = self._spectrogram(
                        self.sess.audio[wa : wa + 2 * self.sess.audio_sr], self.sess.audio_sr)
            with clock("dtw", host=True):
                warped = dtw_warping(reco, origs[w])
            with clock("correlation", host=True):
                return pearson_correlation(warped, reco)[0]

        return score

    def chance_level(self, runs=100, timings=None):
        """Sequential chance level: each segment through the whole
        ``offline_decode`` (K1 and K2 on the card), its spectrogram scored."""
        mask, cfg, dec = self._decoder()
        T = 2 * self.dec_run.eeg_sr
        clock = StageClock(timings, self.device)
        score = self._scorer(clock)
        corrs = []
        for i in range(runs):
            cutoff = self.rng.randint(0, len(self.other_tasks_eeg) - T)
            seeg = self.other_tasks_eeg[cutoff : cutoff + T][:, mask]
            with clock("decode"):
                reco_spec, _ = pipeline.offline_decode(dec, cfg, seeg, seed=i)
                reco = reco_spec.cpu().numpy()
            corrs.append(score(i, reco))
        return np.asarray(corrs)

    def chance_level_batched(self, runs=100, batch_size=25, timings=None):
        """All random other-task segments decoded with the model and the
        segment length fixed: the frame grid, K1's epilogue constants and
        its packed LDA fragments are built once (``pipeline.mel_plan``),
        the segments are staged on the device ``batch_size`` at a time, and
        each one pays one K1 launch (no Griffin-Lim: only the spectrogram is
        scored), the launch pattern of the JAX package's ``sequential_vmap``.
        DTW scored on the host.  Sampling identical to ``chance_level``.
        ``timings`` sums milliseconds by stage into a dict: stage (the
        segments to the device), decode, spectrogram, dtw, correlation."""
        mask, cfg, dec = self._decoder()
        T = 2 * self.dec_run.eeg_sr
        cuts = [self.rng.randint(0, len(self.other_tasks_eeg) - T) for _ in range(runs)]
        plan = pipeline.mel_plan(dec, cfg, T)
        clock = StageClock(timings, self.device)
        score = self._scorer(clock)

        corrs = []
        for start in range(0, runs, batch_size):
            chunk = cuts[start : start + batch_size]
            with clock("stage"):
                segs = torch.as_tensor(np.stack([self.other_tasks_eeg[c : c + T][:, mask]
                                                 for c in chunk])).to(self.device, self.dtype)
            with clock("decode"):
                specs = torch.stack([pipeline._mel_frames(dec, cfg, seg, plan)
                                     for seg in segs]).cpu().numpy()
            for j, reco in enumerate(specs):
                corrs.append(score(start + j, reco))
        return np.asarray(corrs)

    def matching_trials(self, timings=None):
        clock = StageClock(timings, self.device)
        inter = set(self.sess.words) & set(self.dec_run.words)
        corrs = []
        for word in sorted(inter):
            train_audio = self.sess.get_trial_by_word(word)[2]
            dec_audio = self.dec_run.get_trial_by_word(word)[2]
            with clock("spectrogram"):
                train_lm = self._spectrogram(train_audio, self.sess.audio_sr)
                dec_lm = self._spectrogram((dec_audio / (2**15)).astype(float),
                                           self.dec_run.audio_sr)
            with clock("dtw", host=True):
                warped = dtw_warping(dec_lm, train_lm)
            with clock("correlation", host=True):
                corrs.append(pearson_correlation(warped, dec_lm)[0])
        return corrs

    def run(self, runs=100, which="both"):
        run = os.path.basename(self.run_dir)
        os.makedirs(self.dest_dir, exist_ok=True)
        if which in ("both", "chance_only"):
            # one K1 launch per segment (identical sampling to the
            # sequential twin chance_level, which the tests hold to it)
            chance = self.chance_level_batched(runs=runs)
            chance = chance[~np.isnan(chance)]
            np.save(os.path.join(self.dest_dir, "exp2_{}_chance.npy".format(run)), chance)
        if which in ("both", "pm_only"):
            pm = self.matching_trials()
            np.save(os.path.join(self.dest_dir, "exp2_{}_pm.npy".format(run)), pm)
