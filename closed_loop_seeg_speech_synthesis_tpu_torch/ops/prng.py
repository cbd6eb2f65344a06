"""JAX's threefry keys and uniform draws, bit for bit, without JAX.

Reproduces what ``jax.random`` computes with its default implementation
(threefry2x32, ``jax_threefry_partitionable`` on, JAX's default since 0.5),
as written in ``jax._src.prng`` and ``jax._src.random``:

- ``threefry2x32_plain``: ``threefry_2x32``, the 20-round Threefry-2x32
  block cipher (Salmon et al. 2011, Random123) on 32-bit words;
- ``PRNGKey``: ``threefry_seed`` of a 64-bit seed, the key (seed >> 32,
  seed & 0xFFFFFFFF) as ``jax.random.PRNGKey`` builds it with x64 on (and,
  for any seed that fits in 32 bits, without it);
- ``fold_in``: ``_threefry_fold_in``, the key threefry2x32(key, (0, data));
- ``uniform_from_bits``: ``jax.random.uniform``'s mantissa fill of the bits
  that ``_threefry_random_bits_partitionable`` draws for element j of a
  1-D shape, threefry2x32(key, (0, j)): float32 takes word0 ^ word1 >> 9,
  float64 the 64-bit (word0 << 32 | word1) >> 12, each as the mantissa of a
  number in [1, 2) less 1.

A key is a pair of Python ints in [0, 2^32) (``jax.random.key_data`` of
the same key holds the same two words).  ``threefry2x32_plain`` takes
Python ints or numpy uint32 arrays, with explicit masks, so the same code
derives keys on the host and draws the plain version's table.  The
Griffin-Lim inits built on these are ``ops/griffinlim.block_rand``; their
kernel is ``ops/cuda_prng.py``.
"""

from __future__ import annotations

import operator

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # Threefry's key-schedule constant


def threefry2x32_plain(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    (k0, k1): ``jax._src.prng.threefry_2x32``.  Arguments are Python ints
    or numpy uint32 arrays (broadcast together); returns the two output
    words of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ((ks[(i + 2) % 3] + (i + 1)) & M32)) & M32
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (x64 on): the key of a 64-bit seed,
    negative seeds in two's complement.  Raises OverflowError outside the
    int64 range, as ``np.int64(seed)`` does in JAX."""
    seed = operator.index(seed)
    if not -(2**63) <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in int64")
    return (seed >> 32) & M32, seed & M32


def as_key(key) -> tuple[int, int]:
    """An int seed means ``PRNGKey(seed)``; a pair of 32-bit words (a
    ``PRNGKey`` or ``fold_in`` result, or ``jax.random.key_data``) is the
    key itself."""
    try:
        return PRNGKey(operator.index(key))
    except TypeError:
        pass
    words = tuple(int(w) for w in key)
    if len(words) != 2 or not all(0 <= w <= M32 for w in words):
        raise ValueError(f"a key is two 32-bit words; got {key!r}")
    return words


def is_key(x) -> bool:
    """Whether ``x`` is a seed or a key as the entry points take them (an
    int, or a tuple of two ints), as opposed to a table of inits."""
    if isinstance(x, tuple):
        return len(x) == 2 and all(isinstance(w, (int, np.integer)) for w in x)
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: a new key from ``key`` (a key pair
    or an int seed) and ``data`` in [0, 2^32).  Other data raise
    OverflowError, as ``jnp.uint32(data)`` raises in JAX."""
    data = operator.index(data)
    if not 0 <= data <= M32:
        raise OverflowError(f"fold_in data {data} does not fit in uint32")
    return threefry2x32_plain(*as_key(key), 0, data)


def uniform_from_bits(w0: np.ndarray, w1: np.ndarray, dtype) -> torch.Tensor:
    """``jax.random.uniform``'s values in [0, 1) from the two threefry output
    words of each element (numpy uint32 arrays), as a CPU tensor."""
    if dtype == torch.float32:
        bits = ((w0 ^ w1) >> 9) | np.uint32(0x3F800000)
        return torch.from_numpy(bits.view(np.float32) - np.float32(1.0))
    if dtype == torch.float64:
        w0, w1 = w0.astype(np.uint64), w1.astype(np.uint64)
        bits = (w0 << np.uint64(20)) | (w1 >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return torch.from_numpy(bits.view(np.float64) - 1.0)
    raise ValueError(f"uniform draws are float32 or float64; got {dtype}")
