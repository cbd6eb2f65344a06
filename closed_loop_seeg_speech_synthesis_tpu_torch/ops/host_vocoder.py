"""Reference-exact host vocoder (byte-reproduces ``livenodes/GriffinLim.py``).

Numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/host_vocoder.py``
(``ReferenceExactVocoder``, ``decode_audio_exact``): given the same phase
inits, its int16 stream is byte-equal to the JAX package's.  The decode CLI's
``--vocoder exact-host`` takes the inits from ``rand_init`` (``--rand_init``)
or draws the float64 threefry rows of ``PRNGKey(0)`` that the JAX CLI draws
(its ``cli/decode.py:79-99``), so by default its bytes are the JAX CLI's.

The device Griffin-Lim (kernel K2 on the card) is the production vocoder;
this NumPy twin exists for acceptance testing and byte-level reproducibility
against recordings made with the reference system.  It reproduces the
reference node bit-for-bit, including two quirks a clean implementation
would not have:

* ``scipy.blackman`` windows (GriffinLim.py:50,160) — a 2018-era re-export
  of ``np.blackman``, which differs from ``scipy.signal.windows.blackman``
  by ~1 ulp: enough to decohere the chaotic phase iteration on long
  sessions.

* the FP-jittered emission grid (GriffinLim.py:115-120): output positions
  are ``int((outputBufferPosMs / 1000.0) * sampleRate)`` with
  ``outputBufferPosMs`` accumulated in 10 ms steps, so ``0.01*k*16000``
  occasionally rounds one sample low and a chunk is emitted with 159
  samples (then 161 later).  Block placement in the overlap-add buffer
  follows the same jittered positions, so between a short and its
  compensating long chunk the whole waveform is offset by one sample
  relative to the exact 160-per-frame grid the device pipeline uses.  This is
  why byte-parity with the reference requires replicating the schedule, not
  just the math.

The GL block math itself (stft/exp(angle) quirk/istft, GriffinLim.py:64-96)
is shared with tests/golden.py.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sig

from . import filter_design as fd
from . import mel as mel_ops


class ReferenceExactVocoder:
    """Streaming vocoder byte-equal to the reference GriffinLim node.

    Feed one logMel frame + one (480,) uniform phase-init row per call (the
    row is consumed from the second frame onward, matching the reference's
    one ``np.random.rand(480)`` draw per emitted block); returns the int16
    chunk the reference node would emit (length 159/160/161) or None for
    the first frame.
    """

    def __init__(self, n_mel: int = 40, num_iterations: int = 8,
                 norm_factor: float = 10.0, sample_rate: float = 16000.0,
                 frame_shift_ms: float = 10.0, phase_bug: bool = True):
        self.fft_size = int((16.0 / 1000.0) * sample_rate)        # 256
        self.hop = int((frame_shift_ms / 1000.0) * sample_rate)   # 160
        self.block = 3 * self.hop                                 # blockLen=3
        self.sr = float(sample_rate)
        self.shift_ms = float(frame_shift_ms)
        self.win = np.blackman(self.fft_size)
        self.ola_win = np.blackman(self.block)
        _, self.Minv = mel_ops.mel_matrices(self.fft_size // 2 + 1, n_mel,
                                            sample_rate)
        self.Minv = np.asarray(self.Minv)
        self.iters = int(num_iterations)
        self.norm = float(norm_factor)
        self.phase_bug = bool(phase_bug)
        self.b, self.a = fd.gl_output_lowpass_ba()
        self.lp_state = np.zeros(max(len(self.a), len(self.b)) - 1)
        # absolute-position OLA buffers (the reference's ring buffer with its
        # per-frame zeroing of the newly entered region is equivalent to an
        # ever-growing buffer: a region is never revisited after emission)
        self._buf = np.zeros(0)
        self._wbuf = np.zeros(0)
        self._origin = self.block      # index of absolute position 0
        self.pos_ms = 0.0
        self.frame = 0                 # framePos
        self.prev_mel = None

    def _ensure(self, end: int) -> int:
        need = end + self._origin
        if need > len(self._buf):
            grow = max(need - len(self._buf), 4096)
            self._buf = np.concatenate([self._buf, np.zeros(grow)])
            self._wbuf = np.concatenate([self._wbuf, np.zeros(grow)])
        return self._origin

    def _gl_block(self, mels2: np.ndarray, rand_init: np.ndarray) -> np.ndarray:
        spec = np.exp(mels2) @ self.Minv
        spec[np.isnan(spec)] = 0
        spec[np.isinf(spec)] = 0
        wav = rand_init.copy()
        for _ in range(self.iters):
            frames = np.stack([wav[0:256] * self.win, wav[160:416] * self.win])
            X = np.fft.rfft(frames, axis=1)
            if self.phase_bug:
                Z = spec * np.exp(np.angle(X))        # real (GriffinLim.py:93)
            else:
                Z = spec * np.exp(1j * np.angle(X))
            t = np.real(np.fft.irfft(Z, axis=1)) * self.win
            wav = np.zeros(self.block)
            wav[0:256] += t[0]
            wav[160:416] += t[1]
        return wav

    def process_frame(self, mel_frame: np.ndarray, rand_init: np.ndarray | None):
        """One reference ``add_data`` step.  Returns int16 chunk or None."""
        self.frame += 1
        prev_pos = int((self.pos_ms / 1000.0) * self.sr)      # the FP jitter
        self.pos_ms += self.shift_ms
        out_pos = int((self.pos_ms / 1000.0) * self.sr)
        shift = out_pos - prev_pos                            # 159/160/161
        if self.frame < 2:                                    # blockLen - contextWidth
            self.prev_mel = np.asarray(mel_frame, np.float64)
            return None
        mels2 = np.stack([self.prev_mel, np.asarray(mel_frame, np.float64)])
        self.prev_mel = mels2[1]
        re = self._gl_block(mels2, np.asarray(rand_init, np.float64))

        o = self._ensure(out_pos)
        self._buf[o + out_pos - self.block : o + out_pos] += re
        self._wbuf[o + out_pos - self.block : o + out_pos] += self.ola_win
        s = o + out_pos - self.block
        chunk = self._buf[s : s + shift].copy()
        wsum = self._wbuf[s : s + shift]
        nz = wsum != 0
        chunk[nz] = chunk[nz] / wsum[nz]
        chunk, self.lp_state = sig.lfilter(self.b, self.a, chunk,
                                           zi=self.lp_state)
        return np.int16(np.clip(chunk / (self.norm * 1.01), -0.99, 0.99)
                        * (2 ** 15 - 1))


def decode_audio_exact(spec: np.ndarray, rand_rows: np.ndarray,
                       norm_factor: float = 10.0, n_mel: int = 40,
                       num_iterations: int = 8,
                       phase_bug: bool = True) -> np.ndarray:
    """Batch helper: decoded logMel spectrogram (N, n_mel) + phase-init rows
    ((>=N-1, 480)) -> the exact int16 stream the reference system would
    produce (``decode.perform_offline_decoding``'s ``output_audio``)."""
    voc = ReferenceExactVocoder(n_mel=n_mel, num_iterations=num_iterations,
                                norm_factor=norm_factor, phase_bug=phase_bug)
    chunks = []
    k = 0
    for i in range(spec.shape[0]):
        c = voc.process_frame(spec[i], rand_rows[k] if i > 0 else None)
        if c is not None:
            chunks.append(c)
            k += 1
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int16)
