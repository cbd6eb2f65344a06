"""Transport abstraction: LSL when pylsl/liblsl is installed, native NSX
otherwise.

Port of ``closed_loop_seeg_speech_synthesis_tpu/runtime/streams.py``.  The
reference talks to the lab over the Lab Streaming Layer exclusively
(lsl_socket.py, dev_lsl_streamer.py, marker.py, utils.extract_sr_from_lsl);
this module gives the rest of the port one API for both backends.  ``pylsl``
is imported at first use, not when this module is imported.
"""

from __future__ import annotations

import functools
import logging

import numpy as np

logger = logging.getLogger("runtime.streams")


@functools.cache
def _pylsl():
    """The pylsl module, or None where it (or liblsl) does not import."""
    try:
        import pylsl  # type: ignore
    except Exception:  # ImportError, or liblsl missing (RuntimeError)
        return None
    return pylsl


def backend_name(force: str | None = None) -> str:
    if force in ("lsl", "nsx"):
        return force
    return "lsl" if _pylsl() else "nsx"


class StreamOutlet:
    def __init__(self, name, stream_type, channels, srate, string_fmt=False,
                 source_id="", backend=None):
        self.backend = backend_name(backend)
        if self.backend == "lsl":
            pylsl = _pylsl()
            fmt = pylsl.cf_string if string_fmt else pylsl.cf_float32
            info = pylsl.StreamInfo(name, stream_type, channels, srate, fmt, source_id or name)
            self._o = pylsl.StreamOutlet(info)
        else:
            from . import nsx

            self._o = nsx.Outlet(name, stream_type, channels, srate, string_fmt)
        self.channels = channels

    def push_chunk(self, data, timestamp=0.0):
        if self.backend == "lsl":
            self._o.push_chunk(np.asarray(data, np.float32).tolist(), timestamp)
        else:
            self._o.push_chunk(data, timestamp)

    def push_sample(self, value, timestamp=0.0):
        if self.backend == "lsl":
            self._o.push_sample([value] if np.isscalar(value) or isinstance(value, str) else list(value), timestamp)
        else:
            self._o.push_sample(value, timestamp)

    def have_consumers(self) -> bool:
        if self.backend == "lsl":
            return self._o.have_consumers()
        return self._o.subscriber_count() > 0


class StreamInlet:
    def __init__(self, name, timeout=10.0, backend=None):
        self.backend = backend_name(backend)
        self.name = name
        if self.backend == "lsl":
            pylsl = _pylsl()
            streams = pylsl.resolve_byprop("name", name, timeout=timeout)
            if not streams:
                raise TimeoutError(f"LSL stream {name!r} not found")
            self._i = pylsl.StreamInlet(streams[0])
            info = self._i.info()
            self.channels = info.channel_count()
            self.nominal_srate = info.nominal_srate()
            self.stream_type = info.type()
        else:
            from . import nsx

            self._i = nsx.Inlet(name, timeout)
            self.channels = self._i.channels
            self.nominal_srate = self._i.nominal_srate
            self.stream_type = self._i.stream_type

    def pull_chunk(self, max_samples=1024, timeout=1.0):
        """Returns (chunk (n, C) float32, first timestamp)."""
        if self.backend == "lsl":
            samples, ts = self._i.pull_chunk(timeout=timeout, max_samples=max_samples)
            arr = np.asarray(samples, np.float32).reshape(-1, self.channels)
            return arr, (ts[0] if ts else 0.0)
        return self._i.pull_chunk(max_samples, timeout)

    def pull_string(self, timeout=1.0):
        if self.backend == "lsl":
            sample, ts = self._i.pull_sample(timeout=timeout)
            return (sample[0] if sample else None), (ts or 0.0)
        return self._i.pull_string(timeout)

    def time_correction(self):
        if self.backend == "lsl":
            return self._i.time_correction()
        try:
            return self._i.time_correction()
        except Exception:
            return 0.0  # loopback shares the monotonic clock anyway


def stream_info(name, timeout=10.0, backend=None):
    """(channels, nominal_srate) of a stream, resolved without subscribing
    to it: a decoder reads these, builds its parameters, then opens the
    ``StreamInlet``, so that a sender faster than real time does not fill a
    subscriber that is not reading yet (NSX drops such a subscriber after
    1 s; an LSL inlet buffers)."""
    if backend_name(backend) == "lsl":
        streams = _pylsl().resolve_byprop("name", name, timeout=timeout)
        if not streams:
            raise TimeoutError(f"LSL stream {name!r} not found")
        return streams[0].channel_count(), streams[0].nominal_srate()
    from . import nsx

    info = nsx.stream_info(name, timeout)
    return int(info["channels"]), float(info["srate"])


def local_clock() -> float:
    if _pylsl():
        return _pylsl().local_clock()
    from . import nsx

    return nsx.local_clock()


def extract_sr(stream_name: str, timeout: float = 10.0, backend=None) -> int:
    """Resolve a stream and return its nominal srate (utils.py:87-93)."""
    inlet = StreamInlet(stream_name, timeout=timeout, backend=backend)
    sr = inlet.nominal_srate
    if sr == 0.0:
        logger.warning("Detected an irregular sampling rate for %s.", stream_name)
    return int(sr)
