"""Kaldi-style energy VAD (twin of reference ``local/vad.py``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/eval/vad.py`` (numpy on the
host, with the port's ``ops/mel.mel_matrices`` and ``FUZZ``): wav -> 50 ms /
10 ms Hann spectrogram -> 40 logMels -> DCT-II MFCCs -> C0 log-energy
threshold (s*mean + offset) with a context-window proportion vote.
Vectorized (no per-frame Python loops) but numerically identical.
"""

from __future__ import annotations

import numpy as np
from scipy.fftpack import dct
import scipy.signal.windows as win

from ..ops import mel as mel_ops


class EnergyBasedVad:
    def __init__(self, vad_energy_threshold=4.0, vad_energy_mean_scale=1,
                 vad_frames_context=5, vad_proportion_threshold=0.6):
        assert vad_frames_context >= 0
        assert 0.0 < vad_proportion_threshold < 1
        self.vad_energy_threshold = vad_energy_threshold
        self.vad_energy_mean_scale = vad_energy_mean_scale
        self.vad_frames_context = vad_frames_context
        self.vad_proportion_threshold = vad_proportion_threshold
        self.mfcc_coeff = 13
        self.frame_shift = 0.01
        self.window_length = 0.05

    def from_wav(self, wav, sampling_rate=16000):
        wsize = int(sampling_rate * self.window_length)
        wshift = int(sampling_rate * self.frame_shift)
        starts = np.arange(0, len(wav) - wsize, wshift)
        frames = np.stack([np.asarray(wav[s : s + wsize], np.float64) / (2**15) for s in starts])
        w = win.hann(wsize, sym=True)
        spec = np.abs(np.fft.rfft(frames * w, axis=1))
        M, _ = mel_ops.mel_matrices(wsize // 2 + 1, 40, float(sampling_rate))
        log_mels = np.log(spec @ M + mel_ops.FUZZ)
        log_mels[~np.isfinite(log_mels)] = 0.0
        return self.from_log_mels(log_mels)

    def from_log_mels(self, log_mels):
        self.mfccs = dct(np.asarray(log_mels))[:, : self.mfcc_coeff + 2]
        return self.from_mfccs(self.mfccs)

    def from_mfccs(self, mfccs):
        self.mfccs = np.asarray(mfccs)
        return self._compute_vad()

    def _compute_vad(self):
        log_energy = self.mfccs[:, 0]
        n = len(log_energy)
        thr = self.vad_energy_threshold
        if self.vad_energy_mean_scale != 0:
            assert self.vad_energy_mean_scale > 0
            thr = thr + self.vad_energy_mean_scale * log_energy.sum() / n

        above = (log_energy > thr).astype(np.float64)
        # window [i - ctx, i + ctx) clipped to bounds (note: asymmetric, the
        # reference's range() excludes i + ctx itself)
        ctx = self.vad_frames_context
        cums = np.concatenate([[0.0], np.cumsum(above)])
        lo = np.clip(np.arange(n) - ctx, 0, n)
        hi = np.clip(np.arange(n) + ctx, 0, n)
        num = cums[hi] - cums[lo]
        den = (hi - lo).astype(np.float64)
        return num >= den * self.vad_proportion_threshold

    def convert_vad_to_lab(self, filename, vad):
        """Audacity .lab export (vad.py:103-123)."""
        out, s, last = [], 0.0, None
        for t, v in enumerate(vad):
            if last is None:
                last, s = v, 0.0
            if v != last:
                out.append("{:.2f}\t{:.2f}\t{}".format(s, t * self.frame_shift, int(last)))
                s, last = t * self.frame_shift, v
        out.append("{:.2f}\t{:.2f}\t{}".format(s, len(vad) * self.frame_shift, int(last)))
        with open(filename, "w+") as f:
            f.write("\n".join(out) + "\n")
