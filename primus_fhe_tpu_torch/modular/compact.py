"""Compact-modulus kernels (port of ``primus_fhe_tpu/modular/compact.py``;
reference ``crates/primus_modulus/src/common/compact/``).

- The add/sub tier (``q < 2^30`` for u32 words, ``q < 2^62`` for u64 words)
  is one unsigned min of the wrapped value: ``min(v, v - q)``.
- The widening multiply needs no Barrett ratio: canonical inputs bound the
  product by ``q * 2^30`` (u32) or ``q * 2^62`` (u64), so a fold of ``q <<
  k`` for ``k = kmax .. 0`` (one conditional subtract each) reduces it for
  any modulus of the tier.
- ``compact_dot32`` sums chunks of 16 products exactly in 64 bits
  (``16 (2^30 - 1)^2 < 2^64``), ``compact_dot64`` chunks of 8 in 128 bits,
  and folds each chunk once (``DOT_PRODUCT_INNER_CHUNK``).

u32 words are int64 tensors in ``[0, 2^32)``; u64 words are int64 tensors of
u64 bit patterns (``numeric/limb.py``), and a 128-bit value is a ``(hi,
lo)`` pair of them, ordered by unsigned compares.  Inputs to the multiply
and dot tiers must be canonical (``< q``); ``q`` broadcasts and need not be
prime.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..numeric.limb import MASK32, ge_u64, lt_u64, mul_wide_u64


def _umin(x, y):
    """Unsigned minimum of two u64 patterns."""
    return torch.where(lt_u64(y, x), y, x)


def _q_like(q, like: torch.Tensor) -> torch.Tensor:
    """``q`` (int or tensor) as an int64 tensor broadcast to ``like``."""
    return torch.as_tensor(q, dtype=torch.int64, device=like.device).expand(like.shape)


def _chunks(a: torch.Tensor, dim: int, chunk: int) -> torch.Tensor:
    """``a`` with ``dim`` moved last, zero-padded to whole chunks and split
    into ``(..., chunks, chunk)``."""
    a = a.movedim(dim, -1)
    a = F.pad(a, (0, (-a.shape[-1]) % chunk))
    return a.reshape(*a.shape[:-1], -1, chunk)


# ---------------------------------------------------------------------------
# u32 words, q < 2^30
# ---------------------------------------------------------------------------


def compact_reduce_once32(v, q):
    """``[0, 2q) -> [0, q)``: ``min(v, v - q)`` on wrapped u32 words."""
    return torch.minimum(v, (v - q) & MASK32)


def compact_add32(a, b, q):
    """Canonical ``(a + b) mod q`` (compact/primitive.rs ``reduce_add``)."""
    return compact_reduce_once32(a + b, q)


def compact_sub32(a, b, q):
    """Canonical ``(a - b) mod q``: wrapped difference, then the min."""
    d = (a - b) & MASK32
    return torch.minimum(d, (d + q) & MASK32)


def compact_double32(a, q):
    return compact_reduce_once32((a << 1) & MASK32, q)


def compact_neg32(a, q):
    return torch.where(a == 0, torch.zeros_like(a), (q - a) & MASK32)


def compact_lazy_sub32(a, b, q):
    """The lazy difference ``a + (q - b)`` in ``[0, 2q)``, unreduced
    (compact/primitive.rs ``lazy_reduce_sub``)."""
    return (a + q - b) & MASK32


def compact_reduce_wide32(lo, hi, q, kmax: int):
    """Reduces the 64-bit ``hi*2^32 + lo < q * 2^(kmax+1)`` mod ``q < 2^30``
    by folding ``q << k`` for ``k = kmax .. 0``."""
    v = (hi << 32) | lo
    for k in range(kmax, -1, -1):
        d = v - (q << k)
        v = torch.where(lt_u64(d, v), d, v)
    return v & MASK32


def _wide32(p):
    """A u64 pattern as the ``(lo, hi)`` u32 words :func:`compact_reduce_wide32`
    takes."""
    return p & MASK32, (p >> 32) & MASK32


def compact_mul32(a, b, q):
    """Canonical ``a * b mod q`` for canonical inputs, any ``q < 2^30``: 31
    folds (``a * b < q^2 <= q * 2^30``).  The int64 product is the exact
    u64 pattern."""
    return compact_reduce_wide32(*_wide32(a * b), q, 30)


def compact_mul_add32(a, b, c, q):
    """``(a * b + c) mod q`` with the addend folded into the wide value."""
    return compact_reduce_wide32(*_wide32(a * b + c), q, 30)


def compact_dot32(a, b, q, dim: int = -1):
    """``sum(a * b) mod q`` over ``dim``: chunks of 16 products summed
    exactly in 64 bits, each chunk folded once (35 folds: ``< 16 q^2 <= q
    2^34``), the chunks' residues added mod q.  ``q`` broadcasts against
    the inputs with ``dim`` last (a ``(k, 1)`` column serves ``(k, n)``
    rows), as in the reference."""
    prod = _chunks(a, dim, 16) * _chunks(b, dim, 16)  # u64 patterns, exact
    acc = prod.sum(dim=-1)  # < 16 q^2 < 2^64: the wrapped int64 sum is exact
    qb = _q_like(q, acc)
    part = compact_reduce_wide32(*_wide32(acc), qb, 34)
    out = part[..., 0]
    for j in range(1, part.shape[-1]):
        out = compact_add32(out, part[..., j], qb[..., 0])
    return out


# ---------------------------------------------------------------------------
# u64 words, q < 2^62
# ---------------------------------------------------------------------------


def compact_reduce_once64(v, q):
    return _umin(v, v - q)


def compact_add64(a, b, q):
    s = a + b
    return _umin(s, s - q)


def compact_sub64(a, b, q):
    d = a - b
    return _umin(d, d + q)


def compact_double64(a, q):
    return compact_add64(a, a, q)


def compact_lazy_sub64(a, b, q):
    return a + (q - b)


def _u128_ge(ah, al, bh, bl):
    return lt_u64(bh, ah) | ((ah == bh) & ge_u64(al, bl))


def _u128_sub(ah, al, bh, bl):
    return ah - bh - lt_u64(al, bl).to(torch.int64), al - bl


def compact_reduce_wide64(lo, hi, q, kmax: int):
    """Reduces the 128-bit ``hi*2^64 + lo < q * 2^(kmax+1)`` mod ``q < 2^62``
    by folding ``q << k`` for ``k = kmax .. 0``; ``q`` is a tensor shaped
    like ``lo`` (non-negative, so ``>>`` is the logical shift)."""
    zero = torch.zeros_like(q)
    vh, vl = hi, lo
    for k in range(kmax, -1, -1):
        if k == 0:
            th, tl = zero, q
        elif k < 64:
            th, tl = q >> (64 - k), q << k
        else:
            th, tl = q << (k - 64), zero
        ge = _u128_ge(vh, vl, th, tl)
        sh, sl = _u128_sub(vh, vl, th, tl)
        vh = torch.where(ge, sh, vh)
        vl = torch.where(ge, sl, vl)
    return vl


def compact_mul64(a, b, q):
    """Canonical ``a * b mod q`` for canonical inputs, any ``q < 2^62``: 63
    folds (``a * b < q^2 <= q * 2^62``)."""
    lo, hi = mul_wide_u64(a, b)
    return compact_reduce_wide64(lo, hi, _q_like(q, lo), 62)


def compact_dot64(a, b, q, dim: int = -1):
    """``sum(a * b) mod q`` over ``dim``: chunks of 8 products (each below
    2^124) summed exactly in 128 bits, each chunk folded once (66 folds:
    ``< 8 q^2 <= q 2^65``), the chunks' residues added mod q.  ``q``
    broadcasts as in :func:`compact_dot32`."""
    plo, phi = mul_wide_u64(_chunks(a, dim, 8), _chunks(b, dim, 8))
    acc_l = torch.zeros_like(plo[..., 0])
    acc_h = torch.zeros_like(acc_l)
    for j in range(8):
        nl = acc_l + plo[..., j]
        acc_h = acc_h + phi[..., j] + lt_u64(nl, plo[..., j]).to(torch.int64)
        acc_l = nl
    qb = _q_like(q, acc_l)
    part = compact_reduce_wide64(acc_l, acc_h, qb, 65)
    out = part[..., 0]
    for j in range(1, part.shape[-1]):
        out = compact_add64(out, part[..., j], qb[..., 0])
    return out
