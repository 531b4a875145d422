"""Shoup precomputed-multiplier factors for u32 and u64 words (port of
``primus_fhe_tpu/modular/factor.py``).

    q_hat = hi(w_precon * y)
    r     = w * y - q * q_hat        (wrapping, r in [0, 2q))

The 64-bit quotient estimate holds for any u64 ``y`` (the operand need not
be reduced), so ``factor_mul64`` with ``w = 1`` reduces any u64 word.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..numeric.limb import MASK32, ge_u64, mul_hi_u64, mulhi_u32, u64_tensor


class ShoupFactor32(NamedTuple):
    """``(w, floor(w * 2^32 / q))`` for moduli ``q < 2^31`` (int64 tensors)."""

    value: torch.Tensor
    quotient: torch.Tensor

    def map(self, fn) -> "ShoupFactor32":
        return ShoupFactor32(*(fn(x) for x in self))


def shoup32(w, q, device=None) -> ShoupFactor32:
    """Builds a :class:`ShoupFactor32` from host ints (scalar or array)."""
    wb, qb = np.broadcast_arrays(
        np.asarray(w, dtype=np.uint64), np.asarray(q, dtype=np.uint64)
    )
    quot = [((int(a) << 32) // int(b)) & MASK32 for a, b in zip(wb.reshape(-1), qb.reshape(-1))]

    def t(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device).reshape(wb.shape)

    return ShoupFactor32(t([int(a) for a in wb.reshape(-1)]), t(quot))


def factor_mul_lazy32(y, factor: ShoupFactor32, q):
    """``y * w mod q`` in ``[0, 2q)``."""
    q_hat = mulhi_u32(y, factor.quotient)
    return (factor.value * y - q * q_hat) & MASK32


def factor_mul32(y, factor: ShoupFactor32, q):
    """``y * w mod q`` in ``[0, q)`` via the min-trick reduce_once."""
    r = factor_mul_lazy32(y, factor, q)
    return torch.minimum(r, (r - q) & MASK32)


class ShoupFactor64(NamedTuple):
    """``(w, floor(w * 2^64 / q))`` for moduli ``q < 2^63`` (int64 tensors of
    u64 patterns, or Python ints)."""

    value: torch.Tensor
    quotient: torch.Tensor

    def map(self, fn) -> "ShoupFactor64":
        return ShoupFactor64(*(fn(x) for x in self))


def shoup64_int(w: int, q: int) -> ShoupFactor64:
    """A :class:`ShoupFactor64` of Python ints (``w < q``)."""
    return ShoupFactor64(int(w), ((int(w) << 64) // int(q)) & ((1 << 64) - 1))


def shoup64(w, q, device=None) -> ShoupFactor64:
    """Builds a :class:`ShoupFactor64` from host ints (scalar or array)."""
    wb, qb = np.broadcast_arrays(np.asarray(w, dtype=object), np.asarray(q, dtype=object))
    quot = [shoup64_int(a, b).quotient for a, b in zip(wb.reshape(-1), qb.reshape(-1))]

    def t(vals):
        return u64_tensor(np.asarray(vals, dtype=object), device).reshape(wb.shape)

    return ShoupFactor64(t([int(a) for a in wb.reshape(-1)]), t(quot))


def factor_mul_lazy64(y, factor: ShoupFactor64, q):
    """``y * w mod q`` in ``[0, 2q)`` for any u64 ``y`` (wrapping int64)."""
    return factor.value * y - q * mul_hi_u64(y, factor.quotient)


def factor_mul64(y, factor: ShoupFactor64, q):
    """``y * w mod q`` in ``[0, q)`` (unsigned compare: ``2q`` may pass 2^63)."""
    r = factor_mul_lazy64(y, factor, q)
    return torch.where(ge_u64(r, q), r - q, r)


class MultiplyFactor32(NamedTuple):
    """Generic precomputed multiplier (``primus_factor::MultiplyFactor``):
    the storage of :class:`ShoupFactor32` without the canonical-result
    contract; callers manage the output range through
    :func:`factor_mul_lazy32`."""

    value: torch.Tensor
    quotient: torch.Tensor

    def map(self, fn) -> "MultiplyFactor32":
        return MultiplyFactor32(*(fn(x) for x in self))


def multiply_factor32(w, q, device=None) -> MultiplyFactor32:
    """A :class:`MultiplyFactor32` from host ints (scalar or array)."""
    return MultiplyFactor32(*shoup32(w, q, device))
