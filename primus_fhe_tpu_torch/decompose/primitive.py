"""Single-limb approximate signed decomposition over the 2^32 torus (port of
``ApproxSignedBasis32`` in ``primus_fhe_tpu/decompose/primitive.py``).

Each level extracts a window, adds the incoming carry, and branches into a
signed digit plus the next carry:

    temp       = ((value >> shr) & (B-1)) + carry
    next_carry = (temp & carry_mask) != 0          # digit >= B/2 (rounding)
    digit      = 0                        if next_carry and temp > B-1
               = temp + (2^32 - B)        if next_carry  (i.e. temp - B)
               = temp                     otherwise

Only the torus mode (``modulus=None``) the boolean gates use is ported; the
mod-q mode belongs to the NTRU path.
"""

from __future__ import annotations

import torch

from ..numeric.limb import MASK32


class ApproxSignedBasis32:
    """u32 approximate signed basis over the 2^32 torus."""

    def __init__(self, modulus: int | None, log_basis: int, reverse_length: int | None = None):
        if modulus is not None:
            raise NotImplementedError("only the torus mode (modulus=None) is ported")
        if log_basis <= 0:
            raise ValueError("log_basis must be positive")
        bits = 32
        basis = 1 << log_basis
        length = bits // log_basis
        if reverse_length is not None:
            if reverse_length > length:
                raise ValueError("reverse_length exceeds the decompose length")
            length = reverse_length
        drop_bits = bits - length * log_basis
        self.modulus = None
        self.log_basis = log_basis
        self.basis = basis
        self.basis_minus_one = basis - 1
        self.modulus_minus_basis = ((1 << bits) - basis) % (1 << bits)
        self.decompose_length = length
        self.drop_bits = drop_bits
        self.init_carry_mask = (1 << (drop_bits - 1)) if drop_bits > 0 else None
        self.carry_mask = 2 if log_basis == 1 else (basis | (basis >> 1))
        self.scalars = [1 << (drop_bits + j * log_basis) for j in range(length)]
        self.shr_bits = [drop_bits + j * log_basis for j in range(length)]

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    def init_value_carry(self, values):
        """Initial carries from the dropped bits (basis.rs:254-300)."""
        if self.init_carry_mask is None:
            return values, torch.zeros_like(values)
        return values, ((values & self.init_carry_mask) != 0).to(values.dtype)

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
