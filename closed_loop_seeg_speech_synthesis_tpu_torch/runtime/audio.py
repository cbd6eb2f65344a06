"""Audio output sinks with the reference's latency policy.

Copy of ``closed_loop_seeg_speech_synthesis_tpu/runtime/audio.py`` (numpy
only).  The reference plays decoded int16 audio through JACK on Linux or
PortAudio on Windows, handing blocks to the realtime callback through a
bounded pipe that DROPS blocks beyond 8 in flight (latency over
completeness, JackAudioSink.py:30-32,111-118) and counts xruns
(JackAudioSink.py:72-78).  The queueing/drop/xrun policy lives in
``BoundedBlockQueue``; ``jack`` and ``pyaudio`` are imported when a sink of
theirs is made, and ``make_sink("auto")`` falls back to ``NullSink`` where
neither imports (no audio hardware), as the JAX package does.
"""

from __future__ import annotations

import collections
import logging
import threading

import numpy as np

logger = logging.getLogger("runtime.audio")


class StreamingResampler:
    """Streaming windowed-sinc sample-rate converter with carried state.

    Host-side twin of the reference's libsamplerate ``sinc_fastest`` streaming
    resampler (JackAudioSink.py:58,125): arbitrary (including fractional)
    ratios, chunk-size invariant — feeding the same stream in different chunk
    splits yields the identical output sequence.  The kernel is a Hann-windowed
    sinc with ``half`` taps of one-sided support at the lower of the two
    Nyquist rates.
    """

    def __init__(self, ratio: float, half: int = 16):
        if ratio <= 0:
            raise ValueError(f"resample ratio must be positive, got {ratio}")
        self.ratio = float(ratio)
        self.half = int(half)
        # zero prehistory: the first output is centered on input sample 0
        self._hist = np.zeros(self.half, np.float32)
        self._pos = -self.half          # absolute input index of _hist[0]
        self._next_t = 0.0              # absolute input-time of next output
        # anti-alias cutoff at the lower Nyquist (only bites when ratio < 1)
        self._cut = min(1.0, self.ratio)

    def _kernel(self, frac):
        """(n_out, 2*half) windowed-sinc taps at fractional offsets ``frac``."""
        j = np.arange(-self.half + 1, self.half + 1, dtype=np.float64)  # tap offsets
        x = j[None, :] - frac[:, None]                                  # distance to center
        k = self._cut * np.sinc(self._cut * x)
        w = 0.5 + 0.5 * np.cos(np.pi * np.clip(x / self.half, -1.0, 1.0))
        k *= w
        return (k / k.sum(axis=1, keepdims=True)).astype(np.float32)

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32).ravel()
        if chunk.size:
            self._hist = np.concatenate([self._hist, chunk])
        # outputs at t need inputs up to floor(t)+half
        last_avail = self._pos + len(self._hist) - 1
        n_out = int(np.floor((last_avail - self.half - self._next_t) * self.ratio)) + 1
        if n_out <= 0:
            return np.zeros(0, np.float32)
        t = self._next_t + np.arange(n_out, dtype=np.float64) / self.ratio
        base = np.floor(t).astype(np.int64)
        frac = t - base
        rel = base - self._pos                                   # center index in _hist
        idx = rel[:, None] + np.arange(-self.half + 1, self.half + 1)
        y = np.einsum("ot,ot->o", self._hist[idx], self._kernel(frac)).astype(np.float32)
        self._next_t = self._next_t + n_out / self.ratio
        # trim history: future outputs never reach before floor(next_t)-half+1
        keep_from = int(np.floor(self._next_t)) - self.half + 1
        cut = max(0, keep_from - self._pos)
        if cut:
            self._hist = self._hist[cut:]
            self._pos += cut
        return y


class BoundedBlockQueue:
    """Reblocks a sample stream into fixed blocks; at most ``max_blocks``
    queued, overflow dropped and counted."""

    def __init__(self, block_size: int = 256, max_blocks: int = 8, dtype=np.int16):
        self.block_size = block_size
        self.max_blocks = max_blocks
        self.dtype = dtype
        self._accum = np.zeros(0, dtype)
        self._q = collections.deque()
        self._lock = threading.Lock()
        self.dropped_blocks = 0
        self.xruns = 0

    def push(self, samples: np.ndarray) -> None:
        self._accum = np.concatenate([self._accum, np.asarray(samples, self.dtype)])
        while len(self._accum) >= self.block_size:
            block, self._accum = self._accum[: self.block_size], self._accum[self.block_size :]
            with self._lock:
                if len(self._q) >= self.max_blocks:
                    self.dropped_blocks += 1
                else:
                    self._q.append(block)

    def pop(self):
        """Called from the audio callback; None on underrun (counted)."""
        with self._lock:
            if not self._q:
                self.xruns += 1
                return None
            return self._q.popleft()

    def __len__(self):
        with self._lock:
            return len(self._q)


class NullSink:
    def __init__(self, *a, **k):
        self.queue = BoundedBlockQueue()

    def write(self, samples):
        pass

    def close(self):
        pass


class BufferSink:
    """Collects everything (tests / headless runs)."""

    def __init__(self, *a, **k):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.int16))

    def audio(self):
        return np.concatenate(self.chunks) if self.chunks else np.zeros(0, np.int16)

    def close(self):
        pass


class WavFileSink:
    """Streams to a wav file incrementally."""

    def __init__(self, path, sample_rate=16000):
        import wave

        self._w = wave.open(path, "wb")
        self._w.setnchannels(1)
        self._w.setsampwidth(2)
        self._w.setframerate(sample_rate)

    def write(self, samples):
        self._w.writeframes(np.asarray(samples, np.int16).tobytes())

    def close(self):
        self._w.close()


class JackSink:
    """JACK playout (the reference's Linux lab path, JackAudioSink.py).

    Decoded 16 kHz int16 audio is sinc-resampled to the JACK server rate in
    a streaming fashion (JackAudioSink.py:58,125), re-blocked to the client
    block size into the bounded-drop queue, and the mono output port is
    connected to the first two physical playback ports — mono to both stereo
    speakers (JackAudioSink.py:97-100)."""

    def __init__(self, orig_sample_rate=16000, block_size=256, max_blocks=8,
                 allow_fractional_resample=True, client_name="seeg_synth"):
        import jack  # raises if unavailable, caller falls back

        self._client = jack.Client(client_name)
        try:
            self._client.blocksize = block_size
        except Exception:
            pass  # some servers fix the block size; use theirs
        bs = int(getattr(self._client, "blocksize", 0)) or block_size
        rate = float(self._client.samplerate)
        self._ratio = rate / float(orig_sample_rate)
        if not allow_fractional_resample and rate % orig_sample_rate != 0:
            raise ValueError(
                f"JACK rate {rate} not divisible by source rate {orig_sample_rate}"
            )
        self._resampler = StreamingResampler(self._ratio)
        self.queue = BoundedBlockQueue(bs, max_blocks, dtype=np.float32)
        self._out = self._client.outports.register("audio_out")

        @self._client.set_process_callback
        def process(frames):  # pragma: no cover — needs a JACK server
            self._on_process(frames)

        self._client.activate()
        # mono -> both physical playback ports (JackAudioSink.py:97-100)
        try:
            targets = self._client.get_ports(is_physical=True, is_input=True,
                                             is_audio=True)
            for t in targets[:2]:
                self._out.connect(t)
        except Exception as e:
            logger.warning("could not connect JACK playback ports: %s", e)

    def _on_process(self, frames):
        block = self.queue.pop()
        buf = self._out.get_array()
        if block is None:
            buf[:] = 0.0
        else:
            n = min(len(buf), len(block))
            buf[:n] = block[:n]
            if n < len(buf):
                buf[n:] = 0.0

    def write(self, samples):
        x = np.asarray(samples, np.float32) / 32768.0
        y = self._resampler.process(x)
        if len(y):
            self.queue.push(np.clip(y, -1.0, 1.0))

    def close(self):
        self._client.deactivate()
        self._client.close()


class PyAudioSink:
    """PortAudio playout (the reference's Windows path, PyAudioSink.py):
    same bounded-drop queue feeding the stream callback."""

    def __init__(self, orig_sample_rate=16000, block_size=256, max_blocks=8):
        import pyaudio  # raises if unavailable, caller falls back

        self.queue = BoundedBlockQueue(block_size, max_blocks)
        self._pa = pyaudio.PyAudio()

        def callback(in_data, frame_count, time_info, status):  # pragma: no cover
            block = self.queue.pop()
            if block is None:
                return (np.zeros(frame_count, np.int16).tobytes(), pyaudio.paContinue)
            return (block.tobytes(), pyaudio.paContinue)

        self._stream = self._pa.open(format=pyaudio.paInt16, channels=1,
                                     rate=orig_sample_rate, output=True,
                                     frames_per_buffer=block_size,
                                     stream_callback=callback)

    def write(self, samples):
        self.queue.push(samples)

    def close(self):
        self._stream.stop_stream()
        self._stream.close()
        self._pa.terminate()


def make_sink(kind: str = "auto", wav_path=None, sample_rate=16000):
    """Best available sink: jack -> pyaudio -> wav -> null
    (mirrors decode.py:170-181 platform dispatch, availability-gated)."""
    if kind in ("auto", "jack"):
        try:
            return JackSink(orig_sample_rate=sample_rate)
        except Exception as e:
            if kind == "jack":
                raise
            logger.info("JACK unavailable (%s)", e)
    if kind in ("auto", "pyaudio"):
        try:
            return PyAudioSink(orig_sample_rate=sample_rate)
        except Exception as e:
            if kind == "pyaudio":
                raise
            logger.info("PyAudio unavailable (%s)", e)
    if kind in ("auto", "wav") and wav_path:
        return WavFileSink(wav_path, sample_rate)
    if kind == "buffer":
        return BufferSink()
    return NullSink()
