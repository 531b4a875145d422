"""u32 word helpers on int64 tensors (port of the u32 part of
``primus_fhe_tpu/numeric/limb.py``).

A u32 word lives in an int64 tensor in ``[0, 2^32)``.  Products of two
words can reach 2^64 and wrap in int64; their low 32 bits stay exact, so
``(a * b) & MASK32`` is the wrapping u32 product.  The high word needs a
split: :func:`mulhi_u32` cuts ``b`` into 16-bit halves so that every
partial product stays below 2^49.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mulhi_u32(a, b):
    """``floor(a * b / 2^32)`` for u32 words ``a``, ``b`` (exact).

    ``a*b = a*b1*2^16 + a*b0`` with ``b = b1*2^16 + b0``; nesting the two
    floors keeps every term below 2^49.
    """
    b0 = b & 0xFFFF
    b1 = b >> 16
    return (a * b1 + ((a * b0) >> 16)) >> 16


def mul_wide_u32(a, b):
    """``a * b`` as ``(lo, hi)`` u32 words (exact)."""
    return (a * b) & MASK32, mulhi_u32(a, b)


def narrow_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> int32 storage holding the same 32-bit pattern."""
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage (or int64 words) -> int64 words in ``[0, 2^32)``."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & MASK32
