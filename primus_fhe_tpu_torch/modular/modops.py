"""Modular operations on int64-carried u32 and u64 words (port of the uint32
part and of the U64 add/sub/mul/dot part of ``primus_fhe_tpu/modular/modops.py``).

Lazy-range contracts as in the reference:

- ``lazy_*``     results in ``[0, 2q)``
- canonical ops  results in ``[0, q)``
- ``reduce_once(x) = min(x, x - q)`` assumes ``x < 2q`` (Harvey min-trick)

Every function broadcasts: a scalar modulus record serves a polynomial, a
``(n_mod, 1)``-shaped record serves a CRT polynomial.
"""

from __future__ import annotations

import torch

from ..numeric.limb import MASK32, ge_u64, mul_hi_u64, mul_wide_u32, mulhi_u32
from .modulus import BarrettModulus32, BarrettModulus64


def reduce_once32(x, q):
    """``x mod q`` for ``x < 2q`` (wrapping sub then unsigned min)."""
    return torch.minimum(x, (x - q) & MASK32)


def reduce_twice32(x, q):
    """``x mod q`` for ``x < 4q``."""
    return reduce_once32(reduce_once32(x, q * 2), q)


def add32(a, b, q):
    """``(a + b) mod q`` for canonical inputs (q < 2^31: no overflow)."""
    return reduce_once32(a + b, q)


def sub32(a, b, q):
    """``(a - b) mod q`` for canonical inputs."""
    d = a - b
    return torch.where(a < b, d + q, d)


def neg32(a, q):
    """``-a mod q`` (0 maps to 0)."""
    return torch.where(a == 0, a, q - a)


def barrett_lazy_reduce32(v, m: BarrettModulus32):
    """Barrett lazy reduce of one u32 word to ``[0, 2q)``.

    ``q_hat = floor(v * ratio / 2^64)`` (barrett/ops.rs:13-33), exact.
    """
    tmp = mulhi_u32(v, m.ratio_lo)
    lo, hi = mul_wide_u32(v, m.ratio_hi)
    q_hat = (hi + ((lo + tmp) >> 32)) & MASK32
    return (v - q_hat * m.value) & MASK32


def barrett_lazy_reduce_wide32(lo, hi, m: BarrettModulus32):
    """Barrett lazy reduce of ``hi*2^32 + lo`` to ``[0, 2q)``.

    The four-product diagram of ``lazy_reduce_wide`` (barrett/mod.rs:99-132):
    ``q_hat = floor(value * ratio / 2^64) mod 2^32``, then one wrapping
    low-word subtraction.  The int64 sum of the three low words cannot
    overflow, so its carry is read with one shift.
    """
    ah = mulhi_u32(lo, m.ratio_lo)
    b_lo, b_hi = mul_wide_u32(lo, m.ratio_hi)
    c_lo, c_hi = mul_wide_u32(hi, m.ratio_lo)
    d = (hi * m.ratio_hi) & MASK32
    carry = (b_lo + ah + c_lo) >> 32
    q_hat = (d + b_hi + c_hi + carry) & MASK32
    return (lo - q_hat * m.value) & MASK32


def mul32(a, b, m: BarrettModulus32):
    """``a * b mod q`` canonical."""
    lo, hi = mul_wide_u32(a, b)
    return reduce_once32(barrett_lazy_reduce_wide32(lo, hi, m), m.value)


def lazy_mul32(a, b, m: BarrettModulus32):
    """``a * b mod q`` in ``[0, 2q)``."""
    lo, hi = mul_wide_u32(a, b)
    return barrett_lazy_reduce_wide32(lo, hi, m)


def sum_mod32(t, m: BarrettModulus32, dim=-1):
    """Exact modular sum of canonical terms over ``dim``.

    int64 holds the exact sum of up to 2^33 terms below 2^30; one wide
    Barrett reduce of its two words finishes.  ``m`` broadcasts against
    the output shape.
    """
    s = t.sum(dim=dim)
    return reduce_once32(barrett_lazy_reduce_wide32(s & MASK32, s >> 32, m), m.value)


def dot32(a, b, m: BarrettModulus32, dim: int = -1):
    """Modular dot product ``sum_i a_i b_i mod q`` over ``dim``, canonical.

    Each product is lazily reduced to ``[0, 2q)``; int64 sums up to 2^31 of
    them exactly and one wide Barrett reduce finishes.  ``m`` broadcasts
    against the output shape (a record of Python ints serves any shape).
    """
    m_l = m.map(lambda x: x.unsqueeze(dim) if isinstance(x, torch.Tensor) and x.dim() else x)
    s = lazy_mul32(a, b, m_l).sum(dim=dim)
    return reduce_once32(barrett_lazy_reduce_wide32(s & MASK32, s >> 32, m), m.value)


# ===========================================================================
# u64 words (int64 bit patterns, q < 2^62)
# ===========================================================================

_POS63 = (1 << 63) - 1  # masks an arithmetic shift by one into a logical one


def reduce_once64(x, q):
    """``x mod q`` for ``x < 2q`` (unsigned compare: ``x`` may pass 2^63)."""
    return torch.where(ge_u64(x, q), x - q, x)


def reduce_twice64(x, q, two_q):
    """``x mod q`` for ``x < 4q``."""
    return reduce_once64(reduce_once64(x, two_q), q)


def add64(a, b, q):
    """``(a + b) mod q`` for canonical inputs."""
    return reduce_once64(a + b, q)


def neg64(a, q):
    """``-a mod q`` for canonical u64 words (0 maps to 0)."""
    return torch.where(a == 0, a, q - a)


def sub64(a, b, q):
    """``(a - b) mod q`` for canonical inputs (below 2^62: signed compare)."""
    d = a - b
    return torch.where(a < b, d + q, d)


def _shr_pos(x, k):
    """Logical ``x >> k`` of a u64 pattern for ``k >= 1`` (int or tensor)."""
    return ((x >> 1) & _POS63) >> (k - 1)


def mul64(a, b, m: BarrettModulus64):
    """``a * b mod q`` canonical, for ``a * b < 2^(2s)``, ``s = bit_length(q)``
    (so for every pair of canonical inputs).

    Classical Barrett at width ``s`` (HAC 14.42, base 2): with the exact
    128-bit product ``P``, ``q1 = floor(P / 2^(s-1))`` and ``q3 =
    floor(q1 * mu / 2^(s+1))`` (both below 2^63), ``P - q3*q`` lies in
    ``[0, 3q)``; two conditional subtractions finish.  The reference's
    ratio-``2^128`` reduction gives the same canonical word.
    """
    s = m.shift
    lo = a * b
    q1 = (mul_hi_u64(a, b) << (65 - s)) | _shr_pos(lo, s - 1)
    q3 = (mul_hi_u64(q1, m.mu) << (63 - s)) | _shr_pos(q1 * m.mu, s + 1)
    r = lo - q3 * m.value
    r = torch.where(ge_u64(r, 2 * m.value), r - 2 * m.value, r)
    return reduce_once64(r, m.value)


def sum_mod64(t, m: BarrettModulus64, dim: int):
    """Modular sum of canonical terms over ``dim`` (``m`` broadcasts against
    the output).  When every modulus has the same width ``s`` and ``terms *
    2^s <= 2^63``, one int64 sum and one exact remainder; otherwise a chain
    of :func:`add64`."""
    count = t.shape[dim]
    if isinstance(m.shift, int) and count << m.shift <= 1 << 63:
        return torch.remainder(t.sum(dim=dim), m.value)
    terms = t.unbind(dim)
    acc = terms[0]
    for x in terms[1:]:
        acc = add64(acc, x, m.value)
    return acc


def dot64(a, b, m: BarrettModulus64, dim: int = -1):
    """Modular dot product ``sum_i a_i b_i mod q`` of canonical u64 words over
    ``dim``, canonical (``m`` broadcasts against the output shape).  Each
    product is reduced to ``[0, q)`` and :func:`sum_mod64` sums them: the
    canonical word of the reference's lazy products and 128-bit sum."""
    m_l = m.map(lambda x: x.unsqueeze(dim) if isinstance(x, torch.Tensor) and x.dim() else x)
    return sum_mod64(mul64(a, b, m_l), m, dim)
