"""ctypes bindings for the native NSX transport (``native/nsx.cpp``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/runtime/nsx.py``, bound to
the same C++ source, so the wire protocol and the stream registry are the
same and the JAX package's streamer can feed the port's decoder.  The
library is built at first use with

    g++ -O2 -fPIC -std=c++17 -shared -o build/native/libnsx-<hash>.so native/nsx.cpp -lpthread

into ``build/native/`` at the repository root (git-ignored; ``native/``
itself is left as it is), named by a hash of the source and flags.  A
failed build raises.  Streams resolve through a registry directory,
``$NSX_REGISTRY_DIR`` (default ``/tmp/nsx``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC = _REPO / "native" / "nsx.cpp"
_BUILD_DIR = _REPO / "build" / "native"
_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
_lib = None
_lock = threading.Lock()


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libnsx-{digest}.so"
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if not cxx:
            raise RuntimeError("g++ not found: the NSX transport is built from native/nsx.cpp")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        lib.nsx_outlet_create.restype = ctypes.c_void_p
        lib.nsx_outlet_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_double, ctypes.c_int]
        lib.nsx_outlet_push.restype = ctypes.c_int
        lib.nsx_outlet_push.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_int, ctypes.c_double]
        lib.nsx_outlet_push_str.restype = ctypes.c_int
        lib.nsx_outlet_push_str.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double]
        lib.nsx_outlet_subscriber_count.restype = ctypes.c_int
        lib.nsx_outlet_subscriber_count.argtypes = [ctypes.c_void_p]
        lib.nsx_outlet_destroy.argtypes = [ctypes.c_void_p]
        lib.nsx_inlet_open.restype = ctypes.c_void_p
        lib.nsx_inlet_open.argtypes = [ctypes.c_char_p, ctypes.c_double]
        lib.nsx_inlet_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_double), ctypes.c_char_p, ctypes.c_int]
        lib.nsx_inlet_pull.restype = ctypes.c_int
        lib.nsx_inlet_pull.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int, ctypes.POINTER(ctypes.c_double), ctypes.c_double]
        lib.nsx_inlet_pull_str.restype = ctypes.c_int
        lib.nsx_inlet_pull_str.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_double), ctypes.c_double]
        lib.nsx_inlet_destroy.argtypes = [ctypes.c_void_p]
        lib.nsx_inlet_time_correction.restype = ctypes.c_double
        lib.nsx_inlet_time_correction.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_double]
        lib.nsx_local_clock.restype = ctypes.c_double
        _lib = lib
        return lib


def local_clock() -> float:
    return load_library().nsx_local_clock()


class Outlet:
    def __init__(self, name: str, stream_type: str, channels: int, srate: float, string_fmt=False):
        self._lib = load_library()
        self._h = self._lib.nsx_outlet_create(name.encode(), stream_type.encode(),
                                              channels, float(srate), int(string_fmt))
        if not self._h:
            raise RuntimeError(f"could not create outlet {name}")
        self.channels = channels

    def push_chunk(self, data: np.ndarray, timestamp: float = 0.0) -> None:
        arr = np.ascontiguousarray(data, np.float32).reshape(-1, self.channels)
        self._lib.nsx_outlet_push(self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  arr.shape[0], float(timestamp))

    def push_sample(self, value, timestamp: float = 0.0) -> None:
        if isinstance(value, str):
            self._lib.nsx_outlet_push_str(self._h, value.encode(), float(timestamp))
        else:
            self.push_chunk(np.asarray(value, np.float32)[None, :], timestamp)

    def subscriber_count(self) -> int:
        return self._lib.nsx_outlet_subscriber_count(self._h)

    def close(self):
        if self._h:
            self._lib.nsx_outlet_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def stream_info(name: str, timeout: float = 5.0) -> dict:
    """The registry entry of stream ``name`` (its name, type, port, channels,
    srate and fmt), read without connecting: unlike opening an ``Inlet``, it
    does not subscribe, so nothing is sent to the caller yet (an outlet drops
    a subscriber that has not read for 1 s, ``native/nsx.cpp`` broadcast).
    Waits up to ``timeout`` seconds for the stream to appear."""
    import json
    import time

    path = Path(os.environ.get("NSX_REGISTRY_DIR", "/tmp/nsx")) / f"{name}.json"
    deadline = time.monotonic() + timeout
    while True:
        try:
            return json.loads(path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            if time.monotonic() > deadline:
                raise TimeoutError(f"stream {name!r} not found within {timeout}s") from None
            time.sleep(0.05)


class Inlet:
    def __init__(self, name: str, timeout: float = 5.0):
        self._lib = load_library()
        self._h = self._lib.nsx_inlet_open(name.encode(), float(timeout))
        if not self._h:
            raise TimeoutError(f"stream {name!r} not found within {timeout}s")
        ch = ctypes.c_int()
        sr = ctypes.c_double()
        tbuf = ctypes.create_string_buffer(64)
        self._lib.nsx_inlet_info(self._h, ctypes.byref(ch), ctypes.byref(sr), tbuf, 64)
        self.channels = ch.value
        self.nominal_srate = sr.value
        self.stream_type = tbuf.value.decode()

    def pull_chunk(self, max_samples: int = 1024, timeout: float = 1.0):
        buf = np.empty((max_samples, self.channels), np.float32)
        ts = ctypes.c_double()
        n = self._lib.nsx_inlet_pull(self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     max_samples, ctypes.byref(ts), float(timeout))
        if n < 0:
            raise ConnectionError("stream closed")
        return buf[:n].copy(), ts.value

    def pull_string(self, timeout: float = 1.0):
        buf = ctypes.create_string_buffer(65536)
        ts = ctypes.c_double()
        n = self._lib.nsx_inlet_pull_str(self._h, buf, 65536, ctypes.byref(ts), float(timeout))
        if n < 0:
            raise ConnectionError("stream closed")
        if n == 0:
            return None, ts.value
        return buf.value.decode(), ts.value

    def time_correction(self, n_probes: int = 4, timeout: float = 2.0) -> float:
        """Clock offset to add to received timestamps (LSL time_correction
        equivalent); min-RTT ping/pong estimate over a control connection."""
        off = self._lib.nsx_inlet_time_correction(self._h, n_probes, float(timeout))
        if off != off:  # NaN
            raise TimeoutError("time correction probe failed")
        return off

    def close(self):
        if self._h:
            self._lib.nsx_inlet_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
