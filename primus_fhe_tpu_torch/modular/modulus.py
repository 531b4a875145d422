"""Barrett modulus records for u32 and u64 words (port of ``BarrettModulus32``,
``BarrettModulus64``, ``barrett32`` and ``barrett64`` in
``primus_fhe_tpu/modular/modulus.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..numeric.limb import u64_tensor


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


class BarrettModulus64(NamedTuple):
    """Barrett modulus for u64 words, ``1 < q < 2^62`` (int64 tensors of u64
    patterns, shaped like ``q``, or Python ints for a single modulus).

    ``value``, ``ratio0``, ``ratio1`` are the reference's fields (``q`` and
    ``floor(2^128 / q)`` split in 64-bit halves).  :func:`..modops.mul64`
    reduces with the classical Barrett step at the modulus's own width
    ``s = bit_length(q)`` instead, which needs ``shift = s`` and
    ``mu = floor(2^(2s) / q) < 2^(s+1)``; ``shift`` is a Python int when
    every modulus of the record has the same width.
    """

    value: torch.Tensor  # q
    ratio0: torch.Tensor  # floor(2^128 / q) & (2^64 - 1)
    ratio1: torch.Tensor  # floor(2^128 / q) >> 64
    shift: object  # bit_length(q): int, or a tensor shaped like q
    mu: torch.Tensor  # floor(2^(2 shift) / q)

    def map(self, fn) -> "BarrettModulus64":
        """Applies ``fn`` to every tensor field (reshape, device moves)."""
        return BarrettModulus64(*(fn(x) if isinstance(x, torch.Tensor) else x for x in self))


def _barrett64_ints(q: int):
    if not 1 < q < 1 << 62:
        raise ValueError("BarrettModulus64 requires 1 < q < 2^62")
    ratio = (1 << 128) // q
    s = q.bit_length()
    return q, ratio & ((1 << 64) - 1), ratio >> 64, s, (1 << (2 * s)) // q


def barrett64(q, device=None) -> BarrettModulus64:
    """Builds a :class:`BarrettModulus64` from host ints (scalar or array)."""
    arr = np.asarray(q, dtype=object)
    rows = [_barrett64_ints(int(v)) for v in arr.reshape(-1)]
    cols = list(zip(*rows)) if rows else [()] * 5

    def t(vals):
        return u64_tensor(np.asarray(list(vals), dtype=object), device).reshape(arr.shape)

    shifts = set(cols[3])
    shift = shifts.pop() if len(shifts) == 1 else t(cols[3])
    return BarrettModulus64(t(cols[0]), t(cols[1]), t(cols[2]), shift, t(cols[4]))


def barrett64_int(q: int) -> BarrettModulus64:
    """A :class:`BarrettModulus64` of Python ints for one modulus: every
    modular op accepts it on any device without a copy."""
    return BarrettModulus64(*_barrett64_ints(int(q)))
