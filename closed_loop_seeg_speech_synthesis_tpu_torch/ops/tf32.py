"""Host side of ``csrc/tf32_mma.cuh``: the TF32 hi/lo split of a float32
operand and its packing into ``mma.sync.m16n8k8`` B fragments, which
``frontend_decode.cu``'s LDA epilogue streams in 3xTF32; and the bf16
rounding of an operand
(``gl_audio.cu``'s bf16 variants).  Torch on any device; the TF32 rounding
is integer arithmetic and the bf16 one torch's round to nearest even, so the
CPU and the card give the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds on the card."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi): x - hi is exact in
    float32, and hi + lo is x within 2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def pack_b_fragments(m: torch.Tensor, cols: np.ndarray) -> torch.Tensor:
    """(K, N) float32 operand -> its 3xTF32 B fragments, (*cols.shape[:-1],
    K / 8 k-steps, cols.shape[-1] n-tiles, 32 lanes, 4) on m's device.
    ``cols`` holds the first column of each 8-column n-tile.  Lane l of
    k-step s and n-tile t holds (hi[k][n], hi[k+4][n], lo[k][n], lo[k+4][n])
    with k = 8 s + l % 4 and n = cols[..., t] + l // 4.  One gather on the
    device; the index is built once per shape (the LDA weights are packed
    at every K1 call that is not given them prebuilt)."""
    cols = np.ascontiguousarray(cols, np.int64)
    K, N = m.shape
    index = _fragment_index(K, N, cols.tobytes(), cols.shape, m.device)
    return torch.stack(tf32_split(m)).view(-1)[index]


@functools.lru_cache(maxsize=16)
def _fragment_index(K: int, N: int, cols: bytes, shape: tuple, device) -> torch.Tensor:
    """Flat indices into stack([hi, lo]) (2, K, N) in pack_b_fragments' order."""
    lane = torch.arange(32)
    k = 8 * torch.arange(K // 8)[:, None, None] + lane % 4
    n = torch.tensor(np.frombuffer(cols, np.int64).reshape(shape))[..., None, :, None] + lane // 4
    return torch.stack([k * N + n, (k + 4) * N + n, (K + k) * N + n, (K + k + 4) * N + n],
                       dim=-1).to(device)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bf16 value (ties to even), as float32: JAX's
    ``astype(bfloat16)`` and ``__float2bfloat16_rn`` on the card."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)
