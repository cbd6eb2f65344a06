"""The persistent online loop: a whole closed-loop session as one graph launch.

Port of the device side of ``PersistentOnlineDecoder`` in
``closed_loop_seeg_speech_synthesis_tpu/runtime/online.py`` (a
``lax.while_loop`` around the online step, with an ordered ``io_callback``
at each of its two I/O edges).  The CUDA source is ``csrc/persistent_loop.cu``:
an outer graph with one conditional WHILE node whose body is
``wait_packet_kernel`` -> the captured online step (a child graph, the
``cudaGraph_t`` of ``pipeline.capture_online_step``) -> ``publish_kernel``.
Packets enter and outputs leave through rings in mapped pinned host memory;
the host writes packet n into slot (n-1) % R and reads output n from the
same slot of the output ring.

``PersistentLoop`` owns the loop: it binds the C entries, keeps the rings as
numpy views, checks the step's buffers, raises on every CUDA error and
counts sessions (graph launches, module-level ``sessions``) and iterations
(the device's own count, ``publish_kernel`` bumps it; added to the
module-level ``iterations`` at each session's end).  There is no plain
version here: on the CPU, ``runtime.online.PersistentOnlineDecoder`` runs
the same body as a host loop.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

STOP, DATA = 0, 1
HEADER = 16  # bytes before a slot's payload: u64 sequence, u32 flag, pad
RING = 64    # slots of each ring
DONE, TIMEOUT, ABORTED = 0, 1, 2  # what loop_wait_done / loop_wait_free return

sessions = 0    # graph launches (each runs one session)
iterations = 0  # loop iterations the device ran, summed at each session's end

_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.int16: np.int16,
       torch.bool: np.bool_, torch.int32: np.int32}

_u64, _ptr = ctypes.c_ulonglong, ctypes.c_void_p
_SIGNATURES = {
    "loop_create": ([ctypes.c_int, _ptr, _ptr, _u64, _ptr, ctypes.c_int, _ptr, _ptr, _ptr, _u64,
                     ctypes.c_int, ctypes.POINTER(_ptr), ctypes.POINTER(ctypes.c_char_p)],
                    ctypes.c_int),
    "loop_describe_graph": ([_ptr, ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    "loop_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "loop_host_views": ([_ptr, ctypes.POINTER(_ptr), ctypes.POINTER(_ptr)], ctypes.c_int),
    "loop_launch": ([_ptr, _ptr], ctypes.c_int),
    "loop_sync": ([_ptr], ctypes.c_int),
    "loop_publish": ([_ptr, _u64, ctypes.c_int, _ptr], ctypes.c_int),
    "loop_wait_done": ([_ptr, _u64, ctypes.c_double], ctypes.c_int),
    "loop_wait_free": ([_ptr, _u64, ctypes.c_double], ctypes.c_int),
    "loop_release": ([_ptr, _u64], ctypes.c_int),
    "loop_abort": ([_ptr], ctypes.c_int),
    "loop_recover": ([_ptr], _u64),
    "loop_destroy": ([_ptr], ctypes.c_int),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry of ``_SIGNATURES`` declared.  A
    ``CDLL`` call drops the GIL, so a thread that spins in ``loop_wait_*``
    leaves the others running."""
    lib = _build.load("persistent_loop")
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"persistent loop: {what} failed: cudaError {err} "
                           f"({_lib().loop_error_string(err).decode()})")


def _slot_view(base: int, stride: int, offset: int, dtype, shape) -> np.ndarray:
    """(RING, *shape) numpy view of one field of every slot of a ring."""
    dtype = np.dtype(dtype)
    buf = (ctypes.c_ubyte * (RING * stride)).from_address(base)
    inner = tuple(int(np.prod(shape[i + 1:], dtype=np.int64)) * dtype.itemsize
                  for i in range(len(shape)))
    return np.ndarray((RING, *shape), dtype, buffer=buf, offset=offset, strides=(stride, *inner))


class PersistentLoop:
    """The graph of one captured online step inside a device-side while loop.

    ``step_graph``: the ``cudaGraph_t`` (an int) of the captured step, which
    reads ``packet`` and ``is_data`` and leaves its results in ``outputs``
    (all contiguous static tensors on one CUDA device; the caller keeps them
    and the graph's memory pool alive as long as the loop)."""

    def __init__(self, step_graph: int, packet: torch.Tensor, is_data: torch.Tensor, outputs):
        dev = packet.device
        if dev.type != "cuda":
            raise ValueError(f"persistent loop: buffers must lie on a CUDA device; got {dev}")
        for name, t in [("packet", packet), ("is_data", is_data)] + [
                (f"outputs[{i}]", o) for i, o in enumerate(outputs)]:
            if t.device != dev or not t.is_contiguous() or t.dtype not in _NP:
                raise ValueError(f"persistent loop: {name} must be a contiguous tensor on {dev} "
                                 f"of a dtype in {sorted(map(str, _NP))}; got {t.dtype} on "
                                 f"{t.device}")
        if is_data.dtype != torch.int32 or is_data.numel() != 1:
            raise ValueError("persistent loop: is_data must be one int32")
        nbytes = packet.numel() * packet.element_size()
        if packet.data_ptr() % 16 or nbytes % 4:
            raise ValueError("persistent loop: the packet buffer must start on a 16-byte "
                             "boundary and hold a whole number of 4-byte words")
        if not 1 <= len(outputs) <= 4:
            raise ValueError("persistent loop: 1-4 output buffers")
        self.packet_shape = tuple(packet.shape)
        self.packet_dtype = _NP[packet.dtype]
        offs, o = [], HEADER
        for t in outputs:
            offs.append(o)
            o += -(-t.numel() * t.element_size() // 16) * 16
        self.out_stride = o
        lib = _lib()
        n = len(outputs)
        handle, where = _ptr(), ctypes.c_char_p()
        err = lib.loop_create(
            dev.index if dev.index is not None else torch.cuda.current_device(),
            step_graph, packet.data_ptr(), nbytes, is_data.data_ptr(), n,
            (_ptr * n)(*(t.data_ptr() for t in outputs)),
            (_u64 * n)(*(t.numel() * t.element_size() for t in outputs)), (_u64 * n)(*offs),
            self.out_stride, RING, ctypes.byref(handle), ctypes.byref(where))
        if err:
            buf = ctypes.create_string_buffer(512)
            lib.loop_describe_graph(step_graph, buf, len(buf))
            raise RuntimeError(
                f"persistent loop: {where.value.decode()} failed: cudaError {err} "
                f"({lib.loop_error_string(err).decode()}); the captured step holds "
                f"{buf.value.decode()}")
        self._h = handle
        out, ctl = _ptr(), _ptr()
        lib.loop_host_views(handle, ctypes.byref(out), ctypes.byref(ctl))
        # control block: abort, taken, iterations, consumed (read-only here)
        self._ctl = np.ndarray((4,), np.uint64, buffer=(ctypes.c_ubyte * 32).from_address(ctl.value))
        self.flags = _slot_view(out.value, self.out_stride, 8, np.uint32, ())
        self.outputs = [_slot_view(out.value, self.out_stride, off, _NP[t.dtype],
                                   tuple(t.shape)) for t, off in zip(outputs, offs)]
        self._device = dev
        self._running = False

    # -- state ---------------------------------------------------------------
    @property
    def taken(self) -> int:
        """Packets the device has taken, over every session."""
        return int(self._ctl[1])

    @property
    def iterations(self) -> int:
        """Iterations the device has published, over every session."""
        return int(self._ctl[2])

    @property
    def consumed(self) -> int:
        """Outputs the host has read (``release``), over every session."""
        return int(self._ctl[3])

    def slot(self, seq: int) -> int:
        return (seq - 1) % RING

    # -- a session -------------------------------------------------------------
    def launch(self) -> None:
        """Start a session: one graph launch, ordered after the work queued so
        far on torch's current stream (which wrote the static buffers)."""
        global sessions
        if self._running:
            raise RuntimeError("persistent loop: a session is already running")
        self._start_iterations = self.iterations
        _check(_lib().loop_launch(self._h, torch.cuda.current_stream(self._device).cuda_stream),
               "cudaGraphLaunch of the loop")
        self._running = True
        sessions += 1

    def publish(self, seq: int, packet: np.ndarray, flag: int) -> None:
        """Write packet ``seq`` (its slot must be free: ``wait_free``)."""
        data = np.ascontiguousarray(packet, dtype=self.packet_dtype)
        if data.shape != self.packet_shape:
            raise ValueError(f"persistent loop: packet of shape {data.shape}, the step takes "
                             f"{self.packet_shape}")
        _lib().loop_publish(self._h, seq, int(flag), data.ctypes.data)

    def wait_done(self, seq: int, timeout: float) -> int:
        """DONE when output ``seq`` is in its slot, TIMEOUT, or ABORTED."""
        return _lib().loop_wait_done(self._h, seq, timeout)

    def wait_free(self, seq: int, timeout: float) -> int:
        """DONE when packet ``seq``'s slot is free, TIMEOUT, or ABORTED."""
        return _lib().loop_wait_free(self._h, seq, timeout)

    def release(self, seq: int) -> None:
        """Output ``seq`` has been read; its slots may be reused."""
        _lib().loop_release(self._h, seq)

    def abort(self) -> None:
        """End the running session at its next wait (or after the iteration in
        flight)."""
        _lib().loop_abort(self._h)

    def finish(self, aborted: bool) -> int:
        """Wait, on the loop's stream only, until the session's graph has
        ended (if it was launched).  After an abort, clear the rings and the
        abort word so that the next session starts at the packet after the
        last one taken, and return how many data packets the device decoded
        whose outputs were never read (``release``): the carry holds them,
        the host's outputs do not.  0 otherwise."""
        global iterations
        if self._running:
            self._running = False
            _check(_lib().loop_sync(self._h), "the loop's session")
            iterations += self.iterations - self._start_iterations
        if not aborted:
            return 0
        unread = sum(int(self.flags[self.slot(s)]) == DATA
                     for s in range(self.consumed + 1, self.taken + 1))
        _lib().loop_recover(self._h)
        return unread

    def close(self) -> None:
        if getattr(self, "_h", None):
            h, self._h = self._h, None
            _lib().loop_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
