"""Trial accessors over recorded sessions and decoding runs
(twin of reference ``local/data_loader.py:196-325``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/io/session.py``.
``Session``: the training recording, words on a fixed 3 s grid (2 s word +
1 s cross), audio decimated to 16 kHz with dither; built from a session
directory's ``speech1.hdf`` or from arrays (``Session.from_arrays``).  ``DecodingRun``: the artifacts a decode run
stores (audio.wav, sEEG.hdf, markers.csv, first_timestamp.npy), trial starts
recovered from marker wall-clock minus the stream's first timestamp; or the
same given as arrays (``DecodingRun.from_arrays``).  HDF5 files are read
through the port's ``io.hdf5``.  ``make_synthetic_session`` is the numpy
half of ``examples/demo.py``'s session maker.
"""

from __future__ import annotations

import logging
import os

import numpy as np
from scipy.signal import decimate

from . import hdf5

logger = logging.getLogger("io.session")


class _TrialMixin:
    def get_trial_by_index(self, index, include_rest=False):
        dur = 3 if include_rest else 2
        es, as_ = self.word_starts_indices_eeg[index], self.word_starts_indices_audio[index]
        return (
            self.words[index],
            self.eeg[es : es + dur * self.eeg_sr],
            self.audio[as_ : as_ + dur * self.audio_sr],
        )

    def get_trial_by_word(self, word, include_rest=False):
        return self.get_trial_by_index(self.words.index(word), include_rest)

    def get_trial_generator(self, duration=2):
        for i in range(len(self.words)):
            es, as_ = self.word_starts_indices_eeg[i], self.word_starts_indices_audio[i]
            yield (
                self.words[i],
                self.eeg[es : es + duration * self.eeg_sr],
                self.audio[as_ : as_ + duration * self.audio_sr],
            )


class Session(_TrialMixin):
    """Training-session trials on the fixed per-word grid
    (data_loader.py:196-251).  The dither is drawn from ``rng`` (default the
    global numpy stream) after the optional decimation, as the reference
    draws it."""

    def __init__(self, session_dir, complete_trial_duration=3, downsample_audio=True,
                 recording="speech1.hdf", rng=None):
        from .loaders import load_hdf5

        self.session_dir = session_dir
        path = os.path.join(session_dir, recording)
        eeg, eeg_sr, audio, audio_sr, self.ch_names, self.markers = load_hdf5(path, return_markers=True)
        words = [m[0][6:].strip() for m in self.markers if m[0].startswith("start;")]
        self._setup(eeg, eeg_sr, audio, audio_sr, words, complete_trial_duration,
                    downsample_audio, rng)

    @classmethod
    def from_arrays(cls, eeg, eeg_sr, audio, audio_sr, words, complete_trial_duration=3,
                    downsample_audio=True, rng=None) -> "Session":
        """The session of a recording given as arrays: sEEG (T, C) at
        ``eeg_sr``, audio (T_a,) at ``audio_sr`` and the words in trial
        order (the ``start;<word>`` markers' words)."""
        self = cls.__new__(cls)
        self.session_dir, self.ch_names, self.markers = None, None, None
        self._setup(np.asarray(eeg), eeg_sr, np.asarray(audio), audio_sr, words,
                    complete_trial_duration, downsample_audio, rng)
        return self

    def _setup(self, eeg, eeg_sr, audio, audio_sr, words, complete_trial_duration,
               downsample_audio, rng):
        self.eeg, self.eeg_sr, self.audio_sr = eeg, eeg_sr, audio_sr
        if downsample_audio:
            audio = decimate(audio, 3)
            self.audio_sr = 16000
        rng = rng or np.random
        self.audio = audio + rng.normal(0, 0.0001, len(audio))
        self.words = list(words)
        if len(self.words) != 100:
            logger.warning("Number of words does not match 100 (got %d).", len(self.words))
        self.word_starts_indices_eeg = [t * complete_trial_duration * self.eeg_sr for t in range(len(self.words))]
        self.word_starts_indices_audio = [t * complete_trial_duration * self.audio_sr for t in range(len(self.words))]


class DecodingRun(_TrialMixin):
    """Artifacts of one decode run (data_loader.py:253-325), read from the
    run directory or given as arrays (``DecodingRun.from_arrays``)."""

    def __init__(self, run_dir):
        from scipy.io import wavfile

        audio_sr, audio = wavfile.read(os.path.join(run_dir, "audio.wav"))
        first_timestamp = np.load(os.path.join(run_dir, "first_timestamp.npy"))

        starts, words = [], []
        with open(os.path.join(run_dir, "markers.csv")) as f:
            for line in f:
                parts = line.rstrip("\n").split(",", 2)
                if len(parts) != 3:
                    continue
                _, mono, label = parts
                if label.startswith("start;"):
                    starts.append(round(float(mono) - float(first_timestamp), 2))
                    words.append(label[6:])

        with hdf5.File(os.path.join(run_dir, "sEEG.hdf"), "r") as f:
            eeg = f["sEEG"][...]
            eeg_sr = int(np.asarray(f["sEEG_sr"]).reshape(-1)[0])
        self._setup(run_dir, audio, audio_sr, eeg, eeg_sr, starts, words)

    @classmethod
    def from_arrays(cls, audio, audio_sr, eeg, eeg_sr, trial_starts_in_sec, words,
                    run_dir=None) -> "DecodingRun":
        """The run of a decode given as arrays: its int16 audio at
        ``audio_sr``, the sEEG it decoded (T, C) at ``eeg_sr``, the trials'
        starts in seconds from the stream's first sample and their words.
        ``run_dir`` names the run (exp2's output files take its base name)."""
        self = cls.__new__(cls)
        self._setup(run_dir, np.asarray(audio), int(audio_sr), np.asarray(eeg), int(eeg_sr),
                    trial_starts_in_sec, words)
        return self

    def _setup(self, run_dir, audio, audio_sr, eeg, eeg_sr, trial_starts_in_sec, words):
        self.run_dir = run_dir
        self.audio_sr, self.audio = audio_sr, audio
        self.eeg, self.eeg_sr = eeg, eeg_sr
        self.trial_starts_in_sec = np.asarray(trial_starts_in_sec, np.float64)
        self.words = list(words)
        self.word_starts_indices_audio = (self.trial_starts_in_sec * self.audio_sr).astype(int)
        self.word_starts_indices_eeg = (self.trial_starts_in_sec * self.eeg_sr).astype(int)


def make_synthetic_session(n_words=20, eeg_sr=1024, audio_sr=48000, n_channels=16, seed=0):
    """Word-locked data (``examples/demo.py`` make_synthetic_session, without
    the HDF5 file): each 3 s trial has 2 s of a 120 Hz burst on half the
    channels (gain 1.0-2.6 by word) and a voiced harmonic stack in the audio
    (f0 150-270 Hz by word), then 1 s of rest.  Returns (sEEG (T, C), audio
    (T_a,), words, markers) as the demo writes them."""
    rng = np.random.RandomState(seed)
    words = ["w{:02d}".format(i % 10) for i in range(n_words)]
    T = 3 * n_words * eeg_sr
    Ta = 3 * n_words * audio_sr
    eeg = rng.randn(T, n_channels)
    audio = np.zeros(Ta)
    t_a = np.arange(2 * audio_sr) / audio_sr
    for i, w in enumerate(words):
        wid = int(w[1:]) % 5
        f0 = 150 + 30 * wid
        burst = np.sin(2 * np.pi * 120 * np.arange(2 * eeg_sr) / eeg_sr)
        gain = 1.0 + wid * 0.4
        eeg[i * 3 * eeg_sr : i * 3 * eeg_sr + 2 * eeg_sr, : n_channels // 2] += gain * burst[:, None]
        voiced = sum((0.4 / h) * np.sin(2 * np.pi * h * f0 * t_a) for h in range(1, 26))
        voiced += 0.02 * rng.randn(len(t_a))
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] = 0.3 * voiced / np.abs(voiced).max()
    markers = [["experimentStarted"]]
    for w in words:
        markers += [[f"start;{w}"], [f"end;{w}"]]
    markers += [["experimentEnded"]]
    return eeg, audio, words, markers
