"""Little-endian multi-limb big integers (port of
``primus_fhe_tpu/numeric/bigint.py``).

A big integer is a ``(..., L)`` int64 tensor of u32 limbs (each in
``[0, 2^32)``), least significant first; leading axes batch coefficients.
int64 holds a limb sum with its carry, so a carry is one ``>> 32`` and a
borrow one arithmetic ``>> 32`` of a negative difference.  Carry chains run
as Python loops over the (small, static) limb count.
"""

from __future__ import annotations

import numpy as np
import torch

from .limb import MASK32, mul_wide_u32


def big_from_int(value: int, limbs: int) -> np.ndarray:
    """Host: a Python int as a little-endian u32 limb vector (int64)."""
    if value < 0:
        raise ValueError("big_from_int expects non-negative values")
    if value >> (32 * limbs):
        raise ValueError(f"value does not fit in {limbs} limbs")
    return np.array([(value >> (32 * i)) & MASK32 for i in range(limbs)], dtype=np.int64)


def big_to_int(limbs_arr) -> int:
    """Host: a little-endian u32 limb vector -> a Python int."""
    arr = np.asarray(limbs_arr.cpu() if isinstance(limbs_arr, torch.Tensor) else limbs_arr)
    return sum(int(v) << (32 * i) for i, v in enumerate(arr.reshape(-1)))


def big_to_ints(arr) -> np.ndarray:
    """Host: a batch ``(..., L)`` of limbs -> an object array of ints."""
    a = np.asarray(arr.cpu() if isinstance(arr, torch.Tensor) else arr).astype(object)
    out = np.zeros(a.shape[:-1], dtype=object)
    for i in range(a.shape[-1]):
        out = out + (a[..., i] << (32 * i))
    return out


def big_add(a, b):
    """``(a + b) mod 2^(32L)``; second output is the final carry (0/1)."""
    outs = []
    carry = 0
    for i in range(a.shape[-1]):
        s = a[..., i] + b[..., i] + carry
        outs.append(s & MASK32)
        carry = s >> 32
    return torch.stack(outs, dim=-1), carry


def big_sub(a, b):
    """``(a - b) mod 2^(32L)``; second output is the final borrow (0/1)."""
    outs = []
    borrow = 0
    for i in range(a.shape[-1]):
        d = a[..., i] - b[..., i] - borrow
        outs.append(d & MASK32)
        borrow = (d >> 32) & 1
    return torch.stack(outs, dim=-1), borrow


def big_ge(a, b):
    """``a >= b``: no borrow out of ``a - b``."""
    return big_sub(a, b)[1] == 0


def big_cond_sub(a, b):
    """``a - b`` where ``a >= b``, else ``a``."""
    diff, borrow = big_sub(a, b)
    return torch.where((borrow == 0).unsqueeze(-1), diff, a)


def big_mul_u32_add(a, scalar, acc):
    """``acc + a * scalar`` for a u32 ``scalar``; returns ``(limbs, carry)``.

    ``a``'s limbs broadcast against ``scalar[..., None]`` and ``acc``."""
    lo, hi = mul_wide_u32(a, scalar.unsqueeze(-1) if isinstance(scalar, torch.Tensor) else scalar)
    outs = []
    carry = 0
    for i in range(acc.shape[-1]):
        s = lo[..., i] + acc[..., i] + carry
        outs.append(s & MASK32)
        carry = hi[..., i] + (s >> 32)
    return torch.stack(outs, dim=-1), carry


def big_mod_u32_dot(a, pow_table, m):
    """``a mod q`` canonical for a 32-bit Barrett modulus via the power table
    ``pow_table[..., i] = 2^(32 i) mod q``: each limb times its power
    lazily, the (at most 2^31) terms summed exactly in int64, one wide
    Barrett reduce.  ``m`` broadcasts against the output shape (the input
    minus the limb axis)."""
    from ..modular.modops import barrett_lazy_reduce_wide32, lazy_mul32, reduce_once32

    m_l = m.map(lambda x: x.unsqueeze(-1) if isinstance(x, torch.Tensor) and x.dim() else x)
    s = lazy_mul32(a, pow_table, m_l).sum(dim=-1)
    return reduce_once32(barrett_lazy_reduce_wide32(s & MASK32, s >> 32, m), m.value)


def big_mod_u64_dot(a, pow_table, m):
    """``a mod q`` canonical via the power table ``pow_table[..., i] =
    2^(32 i) mod q``: each limb (reduced mod q first) times its power,
    summed mod q.  ``m`` (a ``BarrettModulus64``) broadcasts against the
    output shape (the input minus the limb axis)."""
    from ..modular.modops import add64, mul64

    m_l = m.map(lambda x: x.unsqueeze(-1) if x.dim() else x)
    t = mul64(a % m_l.value, pow_table, m_l)
    acc = t[..., 0]
    for i in range(1, t.shape[-1]):
        acc = add64(acc, t[..., i], m.value)
    return acc


def big_shr_window(a, shift_bits: int, width_bits: int):
    """The ``width_bits``-wide window starting at bit ``shift_bits`` (static
    offsets, at most two adjacent limbs)."""
    if width_bits > 32:
        raise ValueError("window wider than one limb is not supported")
    L = a.shape[-1]
    index, shr = divmod(shift_bits, 32)
    if index >= L:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    low = a[..., index] >> shr
    if shr + width_bits > 32 and index + 1 < L:
        low = low | (a[..., index + 1] << (32 - shr))
    return low & ((1 << width_bits) - 1)
