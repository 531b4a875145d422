"""RNS bases over u32 and u64 moduli with CRT precomputations (port of
``_RNSBaseCommon``, ``RNSBase32`` and ``RNSBase64`` in
``primus_fhe_tpu/rns/base.py``).

Residues live modulus-major: a CRT polynomial is a ``(count, ..., N)`` int64
tensor of u64 words.  Big integers are ``(..., L)`` u32 limb tensors
(:mod:`..numeric.bigint`).  ``compose`` recombines ``sum_i |x_i *
(Q/q_i)^-1|_{q_i} * (Q/q_i) mod Q``; ``wrapping_decompose_small`` lifts small
values into every modulus with the centred convention of the reference
(``base.rs:279-311``).  The host tables are built once and copied to a
device at first use there.
"""

from __future__ import annotations

from functools import reduce
from math import gcd

import numpy as np
import torch

from ..modular.factor import factor_mul32, factor_mul64, shoup32, shoup64
from ..modular.modops import dot32
from ..modular.modulus import barrett32, barrett64
from ..numeric.bigint import big_cond_sub, big_from_int, big_mod_u64_dot, big_mul_u32_add
from ..numeric.limb import MASK32, u64_tensor


def _check_coprime(moduli):
    if not moduli:
        raise ValueError("empty RNS base")
    for i in range(len(moduli)):
        for j in range(i + 1, len(moduli)):
            if gcd(moduli[i], moduli[j]) != 1:
                raise ValueError(f"moduli {moduli[i]} and {moduli[j]} not coprime")


class _RNSBaseCommon:
    """Host precompute shared by every width: ``Q``, the punctured products
    ``Q/q_i`` and their inverses, and their limb vectors (int64 numpy)."""

    def __init__(self, moduli):
        moduli = [int(q) for q in moduli]
        _check_coprime(moduli)
        self.moduli_ints = moduli
        self.count = len(moduli)
        self.q_product = reduce(lambda a, b: a * b, moduli)
        self.big_len = max(1, (self.q_product.bit_length() + 31) // 32)
        self.punctured_ints = [self.q_product // q for q in moduli]
        self.inv_punctured_ints = [pow(p, -1, q) for p, q in zip(self.punctured_ints, moduli)]
        L = self.big_len
        # (k, L+1): punctured products in the extended accumulator width,
        # and shifted one limb (for the high word of a u64 scalar)
        self.punctured_limbs = np.stack([big_from_int(p, L + 1) for p in self.punctured_ints])
        self.punctured_limbs_shift = np.stack(
            [big_from_int((p << 32) % (1 << (32 * (L + 1))), L + 1) for p in self.punctured_ints])
        self.q_limbs = big_from_int(self.q_product, L)
        self.q_limbs_ext = big_from_int(self.q_product, L + 1)

    def _pow_table_ints(self):
        """``2^(32 i) mod q_k``, shape ``(k, L)``."""
        return [[pow(2, 32 * i, q) for i in range(self.big_len)] for q in self.moduli_ints]


class RNSBase32(_RNSBaseCommon):
    """RNS basis over moduli ``q < 2^31`` (u32 residues in int64 tensors)."""

    def __init__(self, moduli):
        super().__init__(moduli)
        if any(q >= 1 << 31 for q in self.moduli_ints):
            raise ValueError("RNSBase32 requires q < 2^31")
        self.modulus = barrett32(self.moduli_ints)  # (k,)
        self.inv_punctured = shoup32(self.inv_punctured_ints, self.moduli_ints)  # (k,)
        self.pow_table = torch.tensor(self._pow_table_ints(), dtype=torch.int64)  # (k, L)
        self._on: dict = {}

    def tables(self, device) -> dict:
        """The device copies: ``modulus``, ``inv_punctured``, ``pow_table``
        and the limb tables as int64 tensors."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = dict(
                modulus=self.modulus.map(lambda x: x.to(device)),
                inv_punctured=self.inv_punctured.map(lambda x: x.to(device)),
                pow_table=self.pow_table.to(device),
                punctured_limbs=torch.from_numpy(self.punctured_limbs).to(device),
                q_limbs_ext=torch.from_numpy(self.q_limbs_ext).to(device),
            )
        return self._on[device]

    def modulus_bc(self, extra: int, device):
        """The Barrett record broadcast to ``(count, 1, ..., 1)``."""
        shape = (self.count,) + (1,) * extra
        return self.tables(device)["modulus"].map(lambda x: x.reshape(shape))

    def decompose(self, values: torch.Tensor) -> torch.Tensor:
        """Big integers ``(..., L)`` -> residues ``(count, ...)``: the dot of
        the limbs with ``2^(32 i) mod q``."""
        extra = values.dim() - 1
        pow_t = self.tables(values.device)["pow_table"].reshape(
            (self.count,) + (1,) * extra + (self.big_len,))
        return dot32(values[None], pow_t, self.modulus_bc(extra, values.device))

    def wrapping_decompose_small(self, values: torch.Tensor, small_mod: int) -> torch.Tensor:
        """Centred lift of small values ``(...)`` into ``(count, ...)`` (see
        :meth:`RNSBase64.wrapping_decompose_small`)."""
        small_mod = int(small_mod)
        vb = values[None].expand((self.count,) + tuple(values.shape))
        if small_mod == 2:
            return vb
        q = self.modulus_bc(values.dim(), values.device).value
        return torch.where(vb < (small_mod + 1) // 2, vb, q - small_mod + vb)

    def compose(self, residues: torch.Tensor) -> torch.Tensor:
        """Residues ``(count, ...)`` -> canonical big integers ``(..., L)``."""
        t = self.tables(residues.device)
        value = torch.zeros(residues.shape[1:] + (self.big_len + 1,), dtype=torch.int64,
                            device=residues.device)
        shape = (self.count,) + (1,) * (residues.dim() - 1)
        prods = factor_mul32(residues, t["inv_punctured"].map(lambda x: x.reshape(shape)),
                             t["modulus"].value.reshape(shape))
        for i in range(self.count):
            value, _ = big_mul_u32_add(t["punctured_limbs"][i], prods[i], value)
            value = big_cond_sub(value, t["q_limbs_ext"])
        return value[..., : self.big_len]


class RNSBase64(_RNSBaseCommon):
    """RNS basis over moduli ``q < 2^62`` (u64 residues)."""

    def __init__(self, moduli):
        super().__init__(moduli)
        if any(q >= 1 << 62 for q in self.moduli_ints):
            raise ValueError("RNSBase64 requires q < 2^62")
        self.modulus = barrett64(self.moduli_ints)  # (k,)
        self.inv_punctured = shoup64(self.inv_punctured_ints, self.moduli_ints)  # (k,)
        self.pow_table = u64_tensor(np.array(self._pow_table_ints(), dtype=object))  # (k, L)
        self._on: dict = {}

    def tables(self, device) -> dict:
        """The device copies: ``modulus``, ``inv_punctured``, ``pow_table``
        and the limb tables as int64 tensors."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = dict(
                modulus=self.modulus.map(lambda x: x.to(device)),
                inv_punctured=self.inv_punctured.map(lambda x: x.to(device)),
                pow_table=self.pow_table.to(device),
                punctured_limbs=torch.from_numpy(self.punctured_limbs).to(device),
                punctured_limbs_shift=torch.from_numpy(self.punctured_limbs_shift).to(device),
                q_limbs_ext=torch.from_numpy(self.q_limbs_ext).to(device),
            )
        return self._on[device]

    def modulus_bc(self, extra: int, device):
        """The Barrett record broadcast to ``(count, 1, ..., 1)`` (``extra``
        trailing ones)."""
        shape = (self.count,) + (1,) * extra
        return self.tables(device)["modulus"].map(lambda x: x.reshape(shape))

    def decompose(self, values: torch.Tensor) -> torch.Tensor:
        """Big integers ``(..., L)`` -> residues ``(count, ...)``."""
        extra = values.dim() - 1
        t = self.tables(values.device)
        pow_t = t["pow_table"].reshape((self.count,) + (1,) * extra + (self.big_len,))
        return big_mod_u64_dot(values[None], pow_t, self.modulus_bc(extra, values.device))

    def wrapping_decompose_small(self, values: torch.Tensor, small_mod: int) -> torch.Tensor:
        """Centred lift of small values ``(...)`` (below ``small_mod``) into
        ``(count, ...)``: values below ``ceil(small_mod/2)`` stay, the others
        become ``q_i - small_mod + value``."""
        small_mod = int(small_mod)
        vb = values[None].expand((self.count,) + tuple(values.shape))
        if small_mod == 2:
            return vb
        q = self.modulus_bc(values.dim(), values.device).value
        return torch.where(vb < (small_mod + 1) // 2, vb, q - small_mod + vb)

    def compose_partial(self, residues: torch.Tensor, start: int = 0) -> torch.Tensor:
        """The CRT terms of the moduli ``start, start+1, ...`` summed mod Q:
        residues ``(m, ...)`` of those ``m`` moduli -> canonical big integers
        ``(..., L+1)`` below Q.  Over all moduli it is the composition; a
        residue shard composes its own moduli and the shards' values add up
        to it mod Q."""
        t = self.tables(residues.device)
        m, extra = residues.shape[0], residues.dim() - 1
        shape = (m,) + (1,) * extra
        f, q = t["inv_punctured"], t["modulus"].value
        if (start, m) != (0, self.count):  # a shard's moduli; all of them need no slice
            f, q = f.map(lambda x: x[start:start + m]), q[start:start + m]
        prods = factor_mul64(residues, f.map(lambda x: x.reshape(shape)), q.reshape(shape))
        value = torch.zeros(residues.shape[1:] + (self.big_len + 1,), dtype=torch.int64,
                            device=residues.device)
        for i in range(m):
            value, _ = big_mul_u32_add(t["punctured_limbs"][start + i], prods[i] & MASK32, value)
            value, _ = big_mul_u32_add(t["punctured_limbs_shift"][start + i], prods[i] >> 32,
                                       value)
            value = big_cond_sub(value, t["q_limbs_ext"])
        return value

    def compose(self, residues: torch.Tensor) -> torch.Tensor:
        """Residues ``(count, ...)`` -> canonical big integers ``(..., L)``."""
        return self.compose_partial(residues)[..., : self.big_len]
