"""Modulus records for u32 and u64 words (port of
``primus_fhe_tpu/modular/modulus.py``).

=======================  =====================================================
record                   reference analogue
=======================  =====================================================
``BarrettModulus32``     ``BarrettModulus<u32>``, ``q < 2^31``
``BarrettModulus64``     ``BarrettModulus<u64>``, ``q < 2^62``
``NativeModulus32/64``   wrapping mod ``2^BITS`` (no fields)
``PowOf2Modulus32/64``   mask modulus ``2^k``, stores ``2^k - 1``
``CompactModulus32/64``  add/sub-only modulus, ``q < 2^30`` / ``q < 2^62``
``UintModulus32/64``     compare-subtract fallback, ``q < 2^31`` / ``2^63``
=======================  =====================================================

u64 fields are int64 tensors of u64 bit patterns (``numeric/limb.py``).
"""

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


class NativeModulus32(NamedTuple):
    """Implicit modulus 2^32 (wrapping u32 arithmetic)."""


class NativeModulus64(NamedTuple):
    """Implicit modulus 2^64 (wrapping u64 arithmetic)."""


class PowOf2Modulus32(NamedTuple):
    """Modulus ``2^k`` with ``k <= 32``; stores the mask ``2^k - 1``."""

    mask: torch.Tensor


class PowOf2Modulus64(NamedTuple):
    """Modulus ``2^k`` with ``k <= 64``; stores the mask as a u64 pattern."""

    mask: torch.Tensor


class CompactModulus32(NamedTuple):
    """Add/sub-only modulus ``q < 2^30`` (``src/compact/mod.rs:11-49``): no
    Barrett ratio, for the compare-subtract ops of :mod:`.modops` and the
    kernels of :mod:`.compact`."""

    value: torch.Tensor


class CompactModulus64(NamedTuple):
    """Add/sub-only modulus ``q < 2^62`` (u64 pattern)."""

    value: torch.Tensor


class UintModulus32(NamedTuple):
    """Compare-subtract fallback modulus, any ``q < 2^31``
    (``src/uint/mod.rs:11-43``); multiplication callers should prefer
    :class:`BarrettModulus32`."""

    value: torch.Tensor


class UintModulus64(NamedTuple):
    """Compare-subtract fallback modulus, any ``q < 2^63`` (u64 pattern)."""

    value: torch.Tensor


def compact32(q, device=None) -> CompactModulus32:
    """A :class:`CompactModulus32` from host ints (scalar or array)."""
    qs = np.asarray(q, dtype=np.uint64)
    if np.any(qs >= 1 << 30):
        raise ValueError("CompactModulus32 requires q < 2^30")
    return CompactModulus32(torch.from_numpy(qs.astype(np.int64)).to(device))


def uint32_modulus(q, device=None) -> UintModulus32:
    """A :class:`UintModulus32` from host ints (scalar or array)."""
    qs = np.asarray(q, dtype=np.uint64)
    if np.any(qs >= 1 << 31):
        raise ValueError("UintModulus32 requires q < 2^31")
    return UintModulus32(torch.from_numpy(qs.astype(np.int64)).to(device))
