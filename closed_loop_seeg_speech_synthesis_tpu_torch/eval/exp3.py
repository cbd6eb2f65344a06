"""Experiment 3: voiced-speech proportion inside vs outside trial windows
(twin of reference ``eval_steps/exp3.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/eval/exp3.py`` (numpy on the
host, with the port's ``EnergyBasedVad``).  The decoding run comes from its
directory or as a ``DecodingRun`` built from arrays.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..io.session import DecodingRun
from .vad import EnergyBasedVad

logger = logging.getLogger("eval.exp3")


class Experiment3:
    def __init__(self, config, run_dir, rng=None, dec_run=None):
        self.run_dir = run_dir
        self.config = config
        self.rng = rng or np.random.RandomState()
        self.vad_frame_context = config.getint("Experiment3", "vad_frames_context")
        self.frame_shift = 0.01
        self.dec_run = dec_run or DecodingRun(run_dir)
        self.vad = None
        self.vad_mask = None

    def _trial_mask(self):
        shift = int(np.floor(self.frame_shift * self.dec_run.audio_sr))
        n_windows = len(self.dec_run.audio) // shift - self.vad_frame_context
        mask = np.zeros(n_windows, bool)
        starts = np.ceil(np.asarray(self.dec_run.word_starts_indices_audio) / shift).astype(int)
        ends = starts + 2 * self.dec_run.audio_sr // shift
        for s, e in zip(starts, ends):
            mask[s:e] = True
        return mask, starts[0], ends[-1]

    def run(self):
        self.vad = EnergyBasedVad(
            vad_energy_threshold=self.config.getfloat("Experiment3", "vad_energy_threshold"),
            vad_energy_mean_scale=self.config.getint("Experiment3", "vad_energy_mean_scale"),
            vad_frames_context=self.vad_frame_context,
            vad_proportion_threshold=self.config.getfloat("Experiment3", "vad_proportion_threshold"),
        )
        audio = self.dec_run.audio + self.rng.normal(0, 0.0001, len(self.dec_run.audio))
        self.vad_mask = self.vad.from_wav(audio, sampling_rate=self.dec_run.audio_sr)

        trial_mask, start, end = self._trial_mask()
        n = min(len(self.vad_mask), len(trial_mask))
        vad_mask = self.vad_mask[:n].copy()
        trial_mask = trial_mask[:n]
        vad_mask[:start] = False
        vad_mask[end:] = False
        self.vad_mask = vad_mask

        speech_in_trials = np.count_nonzero(trial_mask & vad_mask) * self.frame_shift
        speech_in_rest = np.count_nonzero(~trial_mask & vad_mask) * self.frame_shift
        return speech_in_trials, speech_in_rest

    def export_lab(self, filename):
        self.vad.convert_vad_to_lab(filename, self.vad_mask)


def run_experiment3(config, session_dir, dest_dir, dec_runs=None, rng=None):
    """exp3 of every run in Experiment3 -> decoding_runs, each read from
    ``session_dir/<run>`` or given in ``dec_runs`` (run name ->
    ``DecodingRun``); ``rng`` (default a fresh stream per run, as the JAX
    package draws) draws the audio dither."""
    os.makedirs(dest_dir, exist_ok=True)
    results = {}
    for run in config["Experiment3"]["decoding_runs"].split(","):
        run = run.strip()
        run_dir = run if session_dir is None else os.path.join(session_dir, run)
        exp = Experiment3(config, run_dir, rng=rng, dec_run=(dec_runs or {}).get(run))
        in_trials, in_rest = exp.run()
        np.save(os.path.join(dest_dir, f"{run}_speech_amount.npy"), np.array([in_trials, in_rest]))
        exp.export_lab(os.path.join(dest_dir, f"{run}_run.lab"))
        results[run] = (in_trials, in_rest)
    return results
