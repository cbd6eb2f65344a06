"""The precision the reference computes in.

The reference runs in float64 (``Arith(torch.float64)``).  The control of
the correctness check is the same reference one precision below the one the
configurations state (float32 with TF32 off): float32 whose products take
TF32 operands (``Arith(torch.float32, tf32=True)``).  TF32 is emulated,
on the card and on the CPU alike: both operands of every product are
rounded to TF32's 10 mantissa bits (to nearest, ties to even) and
multiplied in float32 with TF32 off, which is exact for the products and
accumulates in float32, as the tensor cores do.
"""

from __future__ import annotations

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0xFFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


class Arith:
    """The dtype of every tensor the reference makes, and its products."""

    def __init__(self, dtype: torch.dtype = torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 tensors")
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` (torch.matmul broadcasting) in this precision."""
        if not self.tf32:
            return torch.matmul(a, b)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(to_tf32(a), to_tf32(b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def tensor(self, a, device) -> torch.Tensor:
        return torch.as_tensor(a).to(device=device, dtype=self.dtype)
