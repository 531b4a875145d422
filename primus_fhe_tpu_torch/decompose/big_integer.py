"""Multi-limb approximate signed decomposition over an RNS product modulus
(port of ``BigUintApproxSignedBasis`` in
``primus_fhe_tpu/decompose/big_integer.py``).

Values modulo ``Q`` are ``(..., L)`` u32 limb tensors; the basis cuts them
into *unsigned* digits in ``[0, B)`` plus a carry chain, and the signed
correction happens downstream in the centred RNS lift
(:meth:`..rns.base.RNSBase64.wrapping_decompose_small`), as in the DCRT
gadget product.  Digits are int64 tensors (``log_basis <= 31``).
"""

from __future__ import annotations

import torch

from ..numeric.bigint import big_add, big_from_int, big_ge, big_shr_window


class BigUintApproxSignedBasis:
    """Signed basis of ``2^log_basis`` over an RNS product modulus ``Q``."""

    def __init__(self, rns_base, log_basis: int, reverse_length: int | None = None):
        if not 0 < log_basis <= 31:
            raise ValueError("log_basis must be in 1..=31")
        self.rns_base = rns_base
        modulus = rns_base.q_product
        self.log_basis = log_basis
        self.basis = 1 << log_basis
        self.basis_minus_one = self.basis - 1

        modulus_bits = modulus.bit_length()
        decompose_length = modulus_bits // log_basis
        drop_bits = modulus_bits - decompose_length * log_basis
        if reverse_length is not None:
            if decompose_length < reverse_length:
                raise ValueError("reverse_length exceeds the decomposition length")
            decompose_length = reverse_length
            drop_bits = modulus_bits - reverse_length * log_basis
        if decompose_length <= 0:
            raise ValueError("empty decomposition")
        self.decompose_length = decompose_length
        self.drop_bits = drop_bits
        self.init_carry_mask_bit = drop_bits - 1 if drop_bits > 0 else None
        self.carry_mask = 2 if log_basis == 1 else (self.basis | (self.basis >> 1))

        # split threshold (basis.rs:88-135)
        if log_basis == 1:
            if drop_bits == 0:
                threshold = None
            else:
                value = ((1 << (decompose_length + 1)) - 1) << (drop_bits - 1)
                threshold = value if value < modulus else None
        else:
            value = 0
            for _ in range(decompose_length):
                value = (value << log_basis) | (self.basis_minus_one >> 1)
            if drop_bits > 0:
                value = ((value << 1) | 1) << (drop_bits - 1)
            else:
                value += 1
            threshold = value if value < modulus else None
        self.threshold_int = threshold
        self.adjust_add_int = (1 << modulus_bits) - modulus if threshold is not None else 0
        self.L = rns_base.big_len
        self.shr_bits = [drop_bits + j * log_basis for j in range(decompose_length)]
        # the gadget scalars B^j * 2^drop, and their residues (level, k)
        self.scalar_ints = [1 << s for s in self.shr_bits]
        self.scalars_residue_ints = [[s % q for q in rns_base.moduli_ints] for s in self.scalar_ints]
        self._on: dict = {}

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    def _limbs(self, device):
        """``(threshold, adjust_add)`` limb tensors on ``device``."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.from_numpy(big_from_int(v, self.L)).to(device)
                for v in (self.threshold_int, self.adjust_add_int))
        return self._on[device]

    def init_value_carry(self, values: torch.Tensor):
        """``(..., L)`` limbs -> adjusted limbs and boolean carries."""
        v = values
        if self.threshold_int is not None:
            threshold, adjust = self._limbs(v.device)
            adj, _ = big_add(v, adjust.expand(v.shape))
            v = torch.where(big_ge(v, threshold.expand(v.shape)).unsqueeze(-1), adj, v)
        if self.init_carry_mask_bit is not None:
            bit = self.init_carry_mask_bit
            carries = ((v[..., bit // 32] >> (bit % 32)) & 1) != 0
        else:
            carries = torch.zeros(v.shape[:-1], dtype=torch.bool, device=v.device)
        return v, carries

    def unsigned_decompose_level(self, values, carries, level: int):
        """One unsigned digit ``((v >> shr) & (B-1) + carry) & (B-1)`` and the
        next carries (common.rs:168-180)."""
        window = big_shr_window(values, self.shr_bits[level], self.log_basis)
        temp = window + carries.to(torch.int64)
        return temp & self.basis_minus_one, (temp & self.carry_mask) != 0

    def unsigned_decompose(self, values: torch.Tensor) -> torch.Tensor:
        """All levels, stacked on a new leading axis: ``(level, ...)``."""
        v, carries = self.init_value_carry(values)
        digits = []
        for lvl in range(self.decompose_length):
            d, carries = self.unsigned_decompose_level(v, carries, lvl)
            digits.append(d)
        return torch.stack(digits, dim=0)
