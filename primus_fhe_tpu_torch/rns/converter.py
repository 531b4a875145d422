"""Fast and exact RNS base conversion, HPS-style (port of
``primus_fhe_tpu/rns/converter.py``).

A converter holds the output-by-input matrix ``(Q/q_i) mod p_j``; a
conversion Shoup-adjusts each input residue by ``(Q/q_i)^-1 mod q_i`` and
takes one modular dot product per output modulus over the input-residue
axis, for every coefficient at once: ``(in_k, ...)`` -> ``(out_k, ...)``.
The exact conversion removes the fast one's ``alpha * Q`` slack with
``alpha = round(sum_i y_i / q_i)`` in integer fixed point, no float.

Torch ops on the tensors' device; no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..modular.factor import factor_mul32, factor_mul64
from ..modular.modops import dot32, dot64, mul32, mul64, sub32, sub64
from ..numeric.limb import MASK32, lt_u64, mul_wide_u64, u64_tensor
from .base import RNSBase32, RNSBase64


def _alpha_fixed32(y: torch.Tensor, fix: torch.Tensor) -> torch.Tensor:
    """``round(sum_i y_i / q_i)`` in 2^64 fixed point: ``y (in_k, ...)``
    canonical residues below 2^31, ``fix (in_k,)`` the u64 words
    ``floor(2^64 / q_i)`` (int64 patterns).

    Each ``y_i * fix_i < 2^64`` is exact as a wrapping int64 product; its
    32-bit halves sum exactly in int64, and ``S = H 2^32 + L`` with ``L <
    2^32`` rounds at 2^64 as ``(H + 2^31) >> 32`` (the reference's overflow
    count plus bit 63 of its 64-bit sum)."""
    prod = y * fix.reshape((-1,) + (1,) * (y.dim() - 1))
    low = (prod & MASK32).sum(dim=0)
    high = ((prod >> 32) & MASK32).sum(dim=0) + (low >> 32)
    return (high + (1 << 31)) >> 32


def _matrix(input_base, output_base) -> list:
    return [[p % pj for p in input_base.punctured_ints] for pj in output_base.moduli_ints]


class BaseConverter32:
    """Converter between two u32 RNS bases."""

    def __init__(self, input_base: RNSBase32, output_base: RNSBase32):
        self.input_base, self.output_base = input_base, output_base
        self.matrix = torch.tensor(_matrix(input_base, output_base), dtype=torch.int64)
        self.alpha_fix = u64_tensor(np.array([(1 << 64) // q for q in input_base.moduli_ints],
                                             dtype=object))
        self.q_mod_out = torch.tensor([input_base.q_product % pj
                                       for pj in output_base.moduli_ints], dtype=torch.int64)

    def _adjusted(self, residues):
        """``y_i = |x (Q/q_i)^-1|_{q_i}``, canonical ``(in_k, ...)``."""
        ib = self.input_base
        shape = (ib.count,) + (1,) * (residues.dim() - 1)
        t = ib.tables(residues.device)
        return factor_mul32(residues, t["inv_punctured"].map(lambda x: x.reshape(shape)),
                            t["modulus"].value.reshape(shape))

    def _dot(self, y):
        """``sum_i y_i (Q/q_i) mod p_j`` ``(out_k, ...)``, and the output
        base's Barrett record shaped like it."""
        ob, nd = self.output_base, y.dim() - 1
        mat = self.matrix.to(y.device).reshape((ob.count,) + (1,) * nd + (self.input_base.count,))
        m = ob.modulus_bc(nd, y.device)
        return dot32(y.movedim(0, -1)[None], mat, m), m

    def fast_convert(self, residues_in: torch.Tensor) -> torch.Tensor:
        """``(in_k, ...)`` residues -> ``(out_k, ...)``: the representative
        ``sum_i y_i (Q/q_i)``, which may exceed the value by a small multiple
        of Q (the reference's fast-conversion slack)."""
        return self._dot(self._adjusted(residues_in))[0]

    def exact_convert(self, residues_in: torch.Tensor) -> torch.Tensor:
        """Exact conversion: the fast one minus ``alpha * Q``, ``alpha =
        round(sum y_i / q_i)``.  Values in the upper half of ``[0, Q)``
        convert with centred semantics, ``(V - Q) mod p``, as the reference's
        do; valid away from ``~k Q 2^-34`` of a multiple of ``Q/2``."""
        y = self._adjusted(residues_in)
        raw, m = self._dot(y)
        alpha = _alpha_fixed32(y, self.alpha_fix.to(y.device))
        qm = self.q_mod_out.to(y.device).reshape(m.value.shape)
        return sub32(raw, mul32(alpha[None].expand(raw.shape), qm, m), m.value)


class BaseConverter64:
    """Converter between two u64 RNS bases (moduli below 2^62)."""

    def __init__(self, input_base: RNSBase64, output_base: RNSBase64):
        self.input_base, self.output_base = input_base, output_base
        self.matrix = u64_tensor(np.array(_matrix(input_base, output_base), dtype=object))
        # alpha in 2^96 fixed point: floor(2^96 / q_i) fits a u64 iff q_i >= 2^32
        self._exact_ok = all(q >= 1 << 32 for q in input_base.moduli_ints)
        if self._exact_ok:
            self.alpha_fix96 = u64_tensor(np.array([(1 << 96) // q for q in input_base.moduli_ints],
                                                   dtype=object))
        self.q_mod_out = u64_tensor(np.array([input_base.q_product % pj
                                              for pj in output_base.moduli_ints], dtype=object))

    def _adjusted(self, residues):
        ib = self.input_base
        shape = (ib.count,) + (1,) * (residues.dim() - 1)
        t = ib.tables(residues.device)
        return factor_mul64(residues, t["inv_punctured"].map(lambda x: x.reshape(shape)),
                            t["modulus"].value.reshape(shape))

    def _dot(self, y):
        ob, nd = self.output_base, y.dim() - 1
        mat = self.matrix.to(y.device).reshape((ob.count,) + (1,) * nd + (self.input_base.count,))
        m = ob.modulus_bc(nd, y.device)
        return dot64(y.movedim(0, -1)[None], mat, m), m

    def fast_convert(self, residues_in: torch.Tensor) -> torch.Tensor:
        """``(in_k, ...)`` u64 residues -> ``(out_k, ...)`` (fast-conversion
        slack as in :meth:`BaseConverter32.fast_convert`)."""
        return self._dot(self._adjusted(residues_in))[0]

    def exact_convert(self, residues_in: torch.Tensor) -> torch.Tensor:
        """Exact conversion, ``alpha = round(sum y_i / q_i)`` from the 128-bit
        sum of ``y_i * floor(2^96 / q_i)`` rounded at 2^96 (centred semantics
        near Q as in :meth:`BaseConverter32.exact_convert`)."""
        if not self._exact_ok:
            raise ValueError("exact_convert requires all input moduli >= 2^32")
        y = self._adjusted(residues_in)
        fix = self.alpha_fix96.to(y.device)
        acc_lo = torch.zeros(y.shape[1:], dtype=torch.int64, device=y.device)
        acc_hi = torch.zeros_like(acc_lo)
        for i in range(y.shape[0]):
            plo, phi = mul_wide_u64(y[i], fix[i])
            new_lo = acc_lo + plo
            acc_hi = acc_hi + phi + lt_u64(new_lo, acc_lo).to(torch.int64)
            acc_lo = new_lo
        alpha = ((acc_hi >> 32) & MASK32) + ((acc_hi & MASK32) >> 31)
        raw, m = self._dot(y)
        qm = self.q_mod_out.to(y.device).reshape(m.value.shape)
        return sub64(raw, mul64(alpha[None].expand(raw.shape), qm, m), m.value)
