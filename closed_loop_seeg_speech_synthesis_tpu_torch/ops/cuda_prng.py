"""The Griffin-Lim block inits' kernel: JAX's threefry uniform rows.

Row r is ``jax.random.uniform(jax.random.fold_in(key, max(ids[r], 0)),
(n,), dtype)``, the draw of ``default_rand_init`` in
``closed_loop_seeg_speech_synthesis_tpu/ops/griffinlim.py:158`` and of the
online step (``runtime/pipeline.py:541-544``).  Not a TPU kernel: it
replaces XLA's ``jax.random`` work.  The CUDA source is ``csrc/prng.cu``;
``block_inits_plain`` is the same function in plain torch
(``ops/prng.py``), bit for bit.  An id is taken mod 2^32 after the clamp,
as JAX's conversion of a traced integer to uint32 takes it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build, prng

PER_THREAD = 8  # samples a thread of the kernel draws (csrc/prng.cu): n must be a multiple


def block_inits_plain(ids: torch.Tensor, key, n: int, dtype) -> torch.Tensor:
    """Plain version of the kernel: (len(ids), n) on ids' device, drawn on
    the CPU in numpy uint32 slabs of ``_CPU_ROWS`` rows, which stay in cache
    (about 8x faster than int64 tensor ops over the whole table), so a
    comparison with the kernel also holds the card's draws to the CPU's."""
    k0, k1 = prng.as_key(key)
    b = (ids.to("cpu", torch.int64).clamp(min=0) & prng.M32).numpy().astype(np.uint32)
    j = np.arange(n, dtype=np.uint32)
    out = torch.empty((len(b), n), dtype=dtype)
    for r in range(0, len(b), _CPU_ROWS):
        out[r : r + _CPU_ROWS] = _rows(k0, k1, b[r : r + _CPU_ROWS], j, dtype)
    return out.to(ids.device)


_CPU_ROWS = 64


def _rows(k0, k1, b, j, dtype) -> torch.Tensor:
    """Rows of the blocks b (uint32 words), samples j: one threefry for each
    row's key, ``fold_in(key, b)``, and one for each sample."""
    kb0, kb1 = prng.threefry2x32_plain(k0, k1, 0, b)
    w0, w1 = prng.threefry2x32_plain(kb0[:, None], kb1[:, None], 0, j[None, :])
    return prng.uniform_from_bits(w0, w1, dtype)


@functools.cache
def _entry():
    fn = _build.load("prng").block_inits
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def block_inits(ids: torch.Tensor, key, n: int, dtype) -> torch.Tensor:
    """ids (B,) int64 block indices, ``key`` an int seed or a key pair
    (``prng.as_key``) -> (B, n) uniform rows in ``dtype`` (float32 or
    float64).  A CPU tensor runs the plain version; a CUDA tensor launches
    ``csrc/prng.cu`` on the current stream or raises.  The launch reads
    nothing back to the host, so a CUDA graph can record it."""
    if ids.device.type == "cpu":
        return block_inits_plain(ids, key, n, dtype)
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"block_inits: unsupported device {dev}")
    if ids.dtype != torch.int64 or ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError(f"block_inits: ids must be a contiguous 1-D int64 tensor; got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"block_inits: the kernel draws float32 or float64; got {dtype}")
    if n <= 0 or n % PER_THREAD:
        raise ValueError(f"block_inits: the row length must be a positive multiple of "
                         f"{PER_THREAD}; got {n}")
    k0, k1 = prng.as_key(key)
    out = torch.empty((ids.shape[0], n), dtype=dtype, device=dev)
    if ids.shape[0] == 0:
        return out
    err = _entry()(ids.data_ptr(), out.data_ptr(), ids.shape[0], n, k0, k1,
                   int(dtype == torch.float64), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "block_inits")
    block_inits.launches += 1
    return out


block_inits.launches = 0
