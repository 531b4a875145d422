"""Modular operations on int64-carried u32 and u64 words (port of
``primus_fhe_tpu/modular/modops.py``).

Lazy-range contracts as in the reference:

- ``lazy_*``     results in ``[0, 2q)``
- canonical ops  results in ``[0, q)``
- ``reduce_once(x) = min(x, x - q)`` assumes ``x < 2q`` (Harvey min-trick)

Every function broadcasts: a scalar modulus record serves a polynomial, a
``(n_mod, 1)``-shaped record serves a CRT polynomial.
"""

from __future__ import annotations

import torch

from ..numeric.limb import (MASK32, as_i64, ge_u64, lt_u64, mul_hi_u64, mul_wide_u32,
                           mul_wide_u64, mulhi_u32)
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


def lazy_add32(a, b, two_q):
    """``(a + b) mod 2q`` for inputs in ``[0, 2q)``."""
    return reduce_once32(a + b, two_q)


def double32(a, q):
    return reduce_once32(a + a, q)


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


def sqr32(a, m: BarrettModulus32):
    return mul32(a, a, m)


def mul_add32(a, b, c, m: BarrettModulus32):
    """``a * b + c mod q``: the exact wide sum, then one Barrett reduce."""
    lo, hi = mul_wide_u32(a, b)
    t = lo + c
    return reduce_once32(barrett_lazy_reduce_wide32(t & MASK32, hi + (t >> 32), m), m.value)


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


def double64(a, q):
    return reduce_once64(a + a, q)


def _i64(x):
    """A record field as an int64 operand (a Python int past 2^63 becomes its
    bit pattern)."""
    return as_i64(x) if isinstance(x, int) else x


def barrett_lazy_reduce_wide64(lo, hi, m: BarrettModulus64):
    """Barrett lazy reduce of the 128-bit ``hi*2^64 + lo`` to ``[0, 2q)``:
    the reference's four-product estimate of ``floor(value * ratio /
    2^128)`` on the ratio ``floor(2^128 / q)``, then one wrapping low-word
    subtraction (the reference's words, lazy ones included)."""
    r0, r1 = _i64(m.ratio0), _i64(m.ratio1)
    ah = mul_hi_u64(lo, r0)
    b_lo, b_hi = mul_wide_u64(lo, r1)
    b_lo2 = b_lo + ah
    b_hi = b_hi + lt_u64(b_lo2, b_lo).to(torch.int64)
    c_lo, c_hi = mul_wide_u64(hi, r0)
    s = b_lo2 + c_lo
    q_hat = hi * r1 + b_hi + c_hi + lt_u64(s, b_lo2).to(torch.int64)
    return lo - q_hat * _i64(m.value)


def lazy_mul64(a, b, m: BarrettModulus64):
    """``a * b mod q`` in ``[0, 2q)`` (the reference's lazy word)."""
    lo, hi = mul_wide_u64(a, b)
    return barrett_lazy_reduce_wide64(lo, hi, m)


def sqr64(a, m: BarrettModulus64):
    return mul64(a, a, m)


def mul_add64(a, b, c, m: BarrettModulus64):
    """``a * b + c mod q``: the exact 128-bit sum, then one Barrett reduce."""
    lo, hi = mul_wide_u64(a, b)
    lo2 = lo + c
    hi = hi + lt_u64(lo2, lo).to(torch.int64)
    return reduce_once64(barrett_lazy_reduce_wide64(lo2, hi, m), m.value)


# ===========================================================================
# exponentiation / inversion / division (ReduceExp, ReduceExpPowOf2,
# ReduceInv, ReduceDiv: crates/primus_reduce/src/ops.rs:210-343)
# ===========================================================================


def _exp_static(a, e: int, mul):
    """Square-and-multiply for a host exponent ``e >= 0``."""
    if e < 0:
        raise ValueError("the exponent must be non-negative")
    result = None
    acc = a
    while e:
        if e & 1:
            result = acc if result is None else mul(result, acc)
        e >>= 1
        if e:
            acc = mul(acc, acc)
    return torch.ones_like(a) if result is None else result


def exp32(a, e, m: BarrettModulus32):
    """``a^e mod q`` canonical.  A host int ``e`` runs the square-and-multiply
    ladder over its bits; a tensor ``e`` of u32 exponents (broadcasting
    against ``a``) the fixed 32-step ladder with selects."""
    if not isinstance(e, torch.Tensor):
        return _exp_static(a, int(e), lambda x, y: mul32(x, y, m))
    a, e = torch.broadcast_tensors(a, e)
    result = torch.ones_like(a)
    acc = a
    for i in range(32):
        result = torch.where(((e >> i) & 1) == 1, mul32(result, acc, m), result)
        acc = sqr32(acc, m)
    return result


def exp_pow_of_2_32(a, log_e: int, m: BarrettModulus32):
    """``a^(2^log_e) mod q``: ``log_e`` squarings."""
    for _ in range(log_e):
        a = sqr32(a, m)
    return a


def inv32(a, m: BarrettModulus32, q: int):
    """Fermat inverse ``a^(q-2) mod q`` for a **prime** q; ``inv32(0) = 0``."""
    return exp32(a, q - 2, m)


def div32(a, b, m: BarrettModulus32, q: int):
    """``a / b mod q`` for a prime q (``ReduceDiv``)."""
    return mul32(a, inv32(b, m, q), m)


def exp64(a, e: int, m: BarrettModulus64):
    """``a^e mod q`` over u64 words, host int ``e`` (plan-time powers and
    Fermat inverses)."""
    return _exp_static(a, int(e), lambda x, y: mul64(x, y, m))


def exp_pow_of_2_64(a, log_e: int, m: BarrettModulus64):
    for _ in range(log_e):
        a = sqr64(a, m)
    return a


def inv64(a, m: BarrettModulus64, q: int):
    """Fermat inverse over u64 words for a prime q; ``inv64(0) = 0``."""
    return exp64(a, q - 2, m)


def div64(a, b, m: BarrettModulus64, q: int):
    return mul64(a, inv64(b, m, q), m)


# ===========================================================================
# UintModulus fallback multiply: any q, no Barrett ratio
# (crates/primus_modulus/src/uint/mod.rs:11-43)
# ===========================================================================


def uint_mul32(a, b, q):
    """``a * b mod q`` for any u32 words and any ``q < 2^31`` (prime or not;
    ``q`` broadcasts).  Both factors reduce first, so their product stays
    below 2^62 and one exact int64 remainder gives the canonical word."""
    return torch.remainder(torch.remainder(a, q) * torch.remainder(b, q), q)


def uint_mul64(a, b, q):
    """``a * b mod q`` for any u64 words and any ``q < 2^63`` by
    shift-subtract over the exact 128-bit product: 128 steps of ``r = 2r +
    bit``, less ``q`` when it reaches ``q`` (the reference's generic tier;
    ``r < q`` keeps ``2r + 1`` below 2^64)."""
    lo, hi = mul_wide_u64(a, b)
    r = torch.zeros_like(lo)
    for i in range(127, -1, -1):
        word = hi if i >= 64 else lo
        r = (r << 1) | ((word >> (i % 64)) & 1)
        r = torch.where(ge_u64(r, q), r - q, r)
    return r
