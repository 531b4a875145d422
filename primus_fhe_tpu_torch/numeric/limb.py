"""u32 and u64 word helpers on int64 tensors (port of
``primus_fhe_tpu/numeric/limb.py``).

u32 words
---------
A u32 word lives in an int64 tensor in ``[0, 2^32)``.  Products of two
words can reach 2^64 and wrap in int64; their low 32 bits stay exact, so
``(a * b) & MASK32`` is the wrapping u32 product.  The high word needs a
split: :func:`mulhi_u32` cuts ``b`` into 16-bit halves so that every
partial product stays below 2^49.

u64 words
---------
The reference carries a u64 as a ``U64(lo, hi)`` pair of u32 arrays (a TPU
workaround).  Here a u64 is an int64 tensor holding its bit pattern, the
storage the CUDA code reads as ``uint64_t``:

- ``+``, ``-``, ``*`` and ``<<`` wrap mod 2^64 in int64, so the low 64 bits
  of sums and products are exact (:func:`mul_lo_u64` is ``a * b``);
- the high 64 bits of a product come from 22-bit limbs
  (:func:`mul_hi_u64`), every partial product below 2^46;
- words at or above 2^63 are negative as int64, so order needs the unsigned
  compare :func:`lt_u64` (``(x ^ 2^63) < (y ^ 2^63)``).  Values below 2^63
  (every lazy residue of a modulus below 2^61) may use signed compares.

:func:`to_u64_pair` / :func:`from_u64_pair` convert to and from the
reference's ``U64`` pairs (host numpy u32 arrays).
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SIGN64 = -(1 << 63)  # the int64 with only bit 63 set
_M22 = (1 << 22) - 1
_M20 = (1 << 20) - 1


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


def mul_lo_u32(a, b):
    """``a * b mod 2^32`` for u32 words, every partial product below 2^48
    (``b`` cut into 16-bit halves): no int64 product wraps."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def narrow_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 words -> int32 storage holding the same 32-bit pattern."""
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 storage (or int64 words) -> int64 words in ``[0, 2^32)``."""
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & MASK32


# ---------------------------------------------------------------------------
# u64 words (int64 bit patterns)
# ---------------------------------------------------------------------------


def as_i64(value: int) -> int:
    """A Python int in ``[0, 2^64)`` as the int64 with the same bit pattern."""
    value = int(value)
    return value - (1 << 64) if value >= 1 << 63 else value


def _limbs22(a):
    """22-bit limbs of a u64 pattern: bits 0-21, 22-43, 44-63."""
    if isinstance(a, int):
        a &= (1 << 64) - 1
        return a & _M22, (a >> 22) & _M22, a >> 44
    return a & _M22, (a >> 22) & _M22, (a >> 44) & _M20


def mul_hi_u64(a, b):
    """``floor(a * b / 2^64)`` of two u64 patterns (exact).

    Columns ``c_k`` of 22-bit limb products (each below 2^46) at weights
    ``2^(22k)``; the carries of the three low columns settle the high word::

        u = c1 + (c0 >> 22);  v = c2 + (u >> 22)
        hi = (v >> 20) + 4 c3 + 2^24 c4          (mod 2^64)

    ``b`` may be a Python int (its limbs are then constants).
    """
    a0, a1, a2 = _limbs22(a)
    b0, b1, b2 = _limbs22(b)
    u = a1 * b0 + a0 * b1 + ((a0 * b0) >> 22)
    v = a2 * b0 + a1 * b1 + a0 * b2 + (u >> 22)
    return (v >> 20) + ((a2 * b1 + a1 * b2) << 2) + ((a2 * b2) << 24)


def mul_lo_u64(a, b):
    """Low 64 bits of ``a * b`` (the wrapping int64 product)."""
    return a * b


def mul_wide_u64(a, b):
    """``a * b`` as ``(low64, high64)`` u64 patterns (exact)."""
    return a * b, mul_hi_u64(a, b)


def lt_u64(a, b):
    """Unsigned ``a < b`` of u64 patterns."""
    return (a ^ SIGN64) < (b ^ SIGN64)


def ge_u64(a, b):
    """Unsigned ``a >= b`` of u64 patterns."""
    return (a ^ SIGN64) >= (b ^ SIGN64)


def u64_tensor(values, device=None) -> torch.Tensor:
    """Host ints in ``[0, 2^64)`` (array-like or numpy uint64) -> int64 tensor."""
    arr = np.asarray(values)
    if arr.dtype == np.uint64:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int64)).to(device)
    if arr.dtype.kind in "iu":
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    arr = np.asarray(values, dtype=object)  # Python ints past 2^63
    flat = [as_i64(v) for v in arr.reshape(-1)]
    return torch.tensor(flat, dtype=torch.int64, device=device).reshape(arr.shape)


def u64_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 patterns -> host numpy uint64."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64)


def to_u64_pair(x: torch.Tensor):
    """int64 tensor of u64 patterns -> the reference's ``(lo, hi)`` pair of
    host numpy u32 arrays (what ``U64`` wraps)."""
    u = u64_numpy(x)
    return (u & np.uint64(MASK32)).astype(np.uint32), (u >> np.uint64(32)).astype(np.uint32)


def from_u64_pair(pair, device=None) -> torch.Tensor:
    """A reference ``U64(lo, hi)`` (or any ``(lo, hi)`` pair of u32 arrays)
    -> int64 tensor of the u64 patterns on ``device``."""
    lo, hi = pair
    u = (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)
    return u64_tensor(u, device)
