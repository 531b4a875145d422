"""Barrett modulus record for u32 words (port of the 32-bit part of
``primus_fhe_tpu/modular/modulus.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BarrettModulus32(NamedTuple):
    """Barrett modulus for u32 words, ``1 < q < 2^31`` (int64 tensors)."""

    value: torch.Tensor  # q
    ratio_lo: torch.Tensor  # floor(2^64 / q) & 0xFFFFFFFF
    ratio_hi: torch.Tensor  # floor(2^64 / q) >> 32

    def map(self, fn) -> "BarrettModulus32":
        """Applies ``fn`` to every field (reshape, device moves)."""
        return BarrettModulus32(*(fn(x) for x in self))


def barrett32(q, device=None) -> BarrettModulus32:
    """Builds a :class:`BarrettModulus32` from host ints (scalar or array)."""
    qs = np.asarray(q, dtype=np.uint64)
    if np.any(qs <= 1) or np.any(qs >= 1 << 31):
        raise ValueError("BarrettModulus32 requires 1 < q < 2^31")
    ratios = [(1 << 64) // int(v) for v in qs.reshape(-1)]
    shape = qs.shape

    def t(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device).reshape(shape)

    return BarrettModulus32(
        t([int(v) for v in qs.reshape(-1)]),
        t([r & 0xFFFFFFFF for r in ratios]),
        t([r >> 32 for r in ratios]),
    )


def barrett32_int(q: int) -> BarrettModulus32:
    """A :class:`BarrettModulus32` of Python ints for one modulus: every
    modular op accepts it on any device without a copy."""
    q = int(q)
    if not 1 < q < 1 << 31:
        raise ValueError("BarrettModulus32 requires 1 < q < 2^31")
    ratio = (1 << 64) // q
    return BarrettModulus32(q, ratio & 0xFFFFFFFF, ratio >> 32)
