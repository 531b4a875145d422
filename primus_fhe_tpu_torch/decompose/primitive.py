"""Single-limb approximate signed decomposition of u32 and u64 words (port of
``ApproxSignedBasis32`` and ``ApproxSignedBasis64`` in
``primus_fhe_tpu/decompose/primitive.py``).

Each level extracts a window, adds the incoming carry, and branches into a
signed digit plus the next carry:

    temp       = ((value >> shr) & (B-1)) + carry
    next_carry = (temp & carry_mask) != 0          # digit >= B/2 (rounding)
    digit      = 0                        if next_carry and temp > B-1
               = temp + (modulus - B)     if next_carry  (i.e. temp - B mod q)
               = temp                     otherwise

Two modes, as in the reference (basis.rs:39-178):

- **torus** (``modulus=None``): values and digits are words mod 2^32 (or
  2^64);
- **mod q** (NTRU path): ``value_bits`` is the bit length of ``q``, digits
  are canonical mod ``q``, and a value at or above ``wrap_threshold`` is
  first shifted by ``adjust_add`` so that its top digit rounds into the
  next (dropped) level instead of wrapping.
"""

from __future__ import annotations

import torch

from ..modular.modops import _shr_pos
from ..numeric.limb import MASK32, as_i64, ge_u64


def _derive(modulus: int | None, bits: int, log_basis: int, reverse_length):
    """Decomposition parameters (``_derive`` of the reference port)."""
    if log_basis <= 0:
        raise ValueError("log_basis must be positive")
    basis = 1 << log_basis
    basis_minus_one = basis - 1
    limit = 1 << bits
    if modulus is not None:
        modulus = int(modulus)
        modulus_is_pow2 = modulus & (modulus - 1) == 0
        value_bits = modulus.bit_length() - 1 if modulus_is_pow2 else modulus.bit_length()
        if value_bits < log_basis:
            raise ValueError("the basis exceeds the modulus")
        modulus_minus_basis = modulus - basis
    else:
        modulus_is_pow2 = True
        value_bits = bits
        modulus_minus_basis = (limit - basis) % limit

    length = value_bits // log_basis
    if reverse_length is not None:
        if reverse_length > length:
            raise ValueError("reverse_length exceeds the decompose length")
        length = reverse_length
    drop_bits = value_bits - length * log_basis

    wrap_threshold = None
    adjust_add = 0
    if not modulus_is_pow2:
        if log_basis == 1:
            if drop_bits != 0:
                value = ((1 << (length + 1)) - 1) << (drop_bits - 1)
                wrap_threshold = value if value < modulus else None
        else:
            value = 0
            for _ in range(length):
                value = (value << log_basis) | (basis_minus_one >> 1)
            if drop_bits > 0:
                value = ((value << 1) | 1) << (drop_bits - 1)
            else:
                value += 1
            wrap_threshold = value if value < modulus else None
        adjust_add = ((1 << value_bits) - 1) - (modulus - 1)

    return dict(
        modulus=modulus,
        modulus_is_pow2=modulus_is_pow2,
        log_basis=log_basis,
        basis=basis,
        basis_minus_one=basis_minus_one,
        modulus_minus_basis=modulus_minus_basis,
        value_bits=value_bits,
        decompose_length=length,
        drop_bits=drop_bits,
        carry_mask=2 if log_basis == 1 else (basis | (basis >> 1)),
        init_carry_mask=(1 << (drop_bits - 1)) if drop_bits > 0 else None,
        wrap_threshold=wrap_threshold,
        adjust_add=adjust_add,
        scalars=[1 << (drop_bits + j * log_basis) for j in range(length)],
        shr_bits=[drop_bits + j * log_basis for j in range(length)],
    )


class ApproxSignedBasis32:
    """u32 approximate signed basis (values mod ``modulus`` or ``2^32``)."""

    def __init__(self, modulus: int | None, log_basis: int, reverse_length: int | None = None):
        self.__dict__.update(_derive(modulus, 32, log_basis, reverse_length))

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    def init_value_carry(self, values):
        """Pre-adjusted values and initial carries (basis.rs:254-300)."""
        v = values
        if self.wrap_threshold is not None:
            v = torch.where(v >= self.wrap_threshold, (v + self.adjust_add) & MASK32, v)
        if self.init_carry_mask is None:
            return v, torch.zeros_like(v)
        return v, ((v & self.init_carry_mask) != 0).to(v.dtype)

    def decompose_level(self, values, carries, level: int):
        """One signed-digit extraction; returns ``(digit, next_carries)``."""
        temp = ((values >> self.shr_bits[level]) & self.basis_minus_one) + carries
        next_carry = (temp & self.carry_mask) != 0
        signed = torch.where(
            temp > self.basis_minus_one,
            torch.zeros_like(temp),
            (temp + self.modulus_minus_basis) & MASK32,
        )
        digit = torch.where(next_carry, signed, temp)
        return digit, next_carry.to(values.dtype)

    def decompose(self, values):
        """All levels: digits ``(L, ...)`` stacked on a new leading axis."""
        v, carries = self.init_value_carry(values)
        digits = []
        for lvl in range(self.decompose_length):
            d, carries = self.decompose_level(v, carries, lvl)
            digits.append(d)
        return torch.stack(digits, dim=0)


class ApproxSignedBasis64:
    """u64 approximate signed basis (values mod ``modulus`` or ``2^64``) on
    int64 tensors of u64 words: shifts are logical, the wrap threshold an
    unsigned compare, and constants past 2^63 their int64 patterns."""

    def __init__(self, modulus: int | None, log_basis: int, reverse_length: int | None = None):
        self.__dict__.update(_derive(modulus, 64, log_basis, reverse_length))

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    def init_value_carry(self, values):
        """Pre-adjusted values and initial carries."""
        v = values
        if self.wrap_threshold is not None:
            v = torch.where(ge_u64(v, as_i64(self.wrap_threshold)), v + as_i64(self.adjust_add), v)
        if self.init_carry_mask is None:
            return v, torch.zeros_like(v)
        return v, ((v & as_i64(self.init_carry_mask)) != 0).to(v.dtype)

    def decompose_level(self, values, carries, level: int):
        """One signed-digit extraction; returns ``(digit, next_carries)``."""
        shr = self.shr_bits[level]
        if shr >= 64:
            window = torch.zeros_like(values)
        else:
            window = _shr_pos(values, shr) if shr else values
        temp = (window & as_i64(self.basis_minus_one)) + carries  # at most 2^log_basis
        next_carry = (temp & self.carry_mask) != 0
        signed = torch.where(temp > self.basis_minus_one, torch.zeros_like(temp),
                             temp + as_i64(self.modulus_minus_basis))
        return torch.where(next_carry, signed, temp), next_carry.to(values.dtype)

    def decompose(self, values):
        """All levels: digits ``(L, ...)`` stacked on a new leading axis."""
        v, carries = self.init_value_carry(values)
        digits = []
        for lvl in range(self.decompose_length):
            d, carries = self.decompose_level(v, carries, lvl)
            digits.append(d)
        return torch.stack(digits, dim=0)
