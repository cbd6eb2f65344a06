"""Host side of ``csrc/wgmma.cuh``: a bf16 operand laid out as the
shared-memory image that ``wgmma`` descriptors in the 128-byte swizzle read,
and the inverse map, which the CPU tests use to unpack an image.

A (K, N) operand with K a multiple of 64 is stored as K / 64 blocks; block
``kb`` holds, for each of the N columns, the 64 values k = 64 kb .. 64 kb + 63
as one 128-byte row.  Rows are grouped by 8 into 1,024-byte atoms, and in row
r of an atom the 16-byte chunk c (8 values) sits at chunk position c ^ (r % 8)
(PTX ISA, "Shared memory matrix layout", 128B swizzle; the image must start
on a 1,024-byte boundary).  Read with K-major descriptors the image is the B
operand (K, N): one row per column, the K values contiguous.  Read with
MN-major descriptors the same bytes are the (N, K) operand B^T: its K is the
row (column n of B), its N the 64 contiguous values of a row, the next 64 of
them a block (K / 64 rows x 128 B) further on.  ``gl_audio.cu``'s bf16
Griffin-Lim kernel reads the forward DFT operand both ways: as itself for the
forward product, and transposed for the inverse (``cuda_gl``).

Torch on any device; the index is built once per shape.
"""

from __future__ import annotations

import functools

import torch

ROW = 64   # bf16 values in one 128-byte swizzle row
ATOM = 8   # rows of a 1,024-byte swizzle atom


@functools.lru_cache(maxsize=8)
def _image_index(K: int, N: int) -> torch.Tensor:
    """(K * N,) flat indices into a row-major (K, N) operand in the order of
    its image: element ``p`` of the image is operand element ``index[p]``."""
    if K % ROW or N % ATOM:
        raise ValueError(f"a 128-byte swizzled image needs K % {ROW} == 0 and N % {ATOM} == 0; "
                         f"got ({K}, {N})")
    p = torch.arange(K * N)
    kb, rem = p // (N * ROW), p % (N * ROW)
    col, slot = rem // ROW, rem % ROW
    chunk = (slot // 8) ^ (col % ATOM)            # the swizzle is its own inverse
    k = kb * ROW + chunk * 8 + slot % 8
    return k * N + col


def sw128_image(m: torch.Tensor) -> torch.Tensor:
    """(K, N) operand -> its image, a flat bfloat16 tensor of K * N values on
    m's device (``m`` rounded to bf16, nearest even)."""
    K, N = m.shape
    index = _image_index(K, N).to(m.device)
    return m.to(torch.bfloat16).reshape(-1)[index]


def unpack_image(image: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """Inverse of ``sw128_image``: the (K, N) operand, in the image's dtype."""
    out = torch.empty(K * N, dtype=image.dtype, device=image.device)
    out[_image_index(K, N).to(image.device)] = image.reshape(-1)
    return out.reshape(K, N)
