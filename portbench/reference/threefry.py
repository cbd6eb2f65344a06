"""The Griffin-Lim inits: JAX's threefry draws, in plain torch.

Block b of a decode starts Griffin-Lim from
``jax.random.uniform(jax.random.fold_in(PRNGKey(seed), b), (480,), dtype)``
(threefry2x32 with JAX's partitionable layout): element j of a draw is
threefry2x32(key, (0, j)); float32 takes the mantissa from
``(word0 ^ word1) >> 9``, float64 from ``(word0 << 32 | word1) >> 12``.
Words are held in int64 tensors and masked to 32 bits.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors (or ints) holding 32-bit words."""
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


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` of a 64-bit seed."""
    seed = int(seed)
    return (seed >> 32) & M32, seed & M32


def block_inits(seed: int, first: int, count: int, width: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """The (count, width) inits of blocks first .. first + count - 1."""
    k0, k1 = prng_key(seed)
    ids = torch.arange(first, first + count, device=device, dtype=torch.int64)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(ids), ids)
    j = torch.arange(width, device=device, dtype=torch.int64)[None, :]
    w0, w1 = threefry2x32(b0[:, None], b1[:, None], torch.zeros_like(j), j)
    if dtype == torch.float32:
        bits = ((w0 ^ w1) >> 9) | 0x3F800000
        return bits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        bits = (w0 << 20) | (w1 >> 12) | 0x3FF0000000000000
        return bits.view(torch.float64) - 1.0
    raise ValueError(f"inits are float32 or float64, not {dtype}")
