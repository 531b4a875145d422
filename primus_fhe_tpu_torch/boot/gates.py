"""Homomorphic boolean gates (port of ``primus_fhe_tpu/boot/gates.py``).

Encoding: TRUE = +1/8 (2^29 on the 2^32 torus), FALSE = -1/8.  A gate is
one affine combination of input LWEs followed by a sign bootstrap and a key
switch back to the input key, so gate outputs feed gates indefinitely.

    NAND(c1, c2) = sign_bootstrap(c1 + c2 - (0, 5/8))
    AND(c1, c2)  = sign_bootstrap(c1 + c2 - (0, 1/8))
    OR(c1, c2)   = sign_bootstrap(c1 + c2 + (0, 1/8))
    NOT(c)       = (-a, -b)

and the leveled select with an encrypted control,
``MUX(sel, x, y) = y + (x - y) ⊡ GGSW(sel)``.
"""

from __future__ import annotations

import torch

from ..lattice.keyswitch import key_switch
from ..lattice.tfhe import external_product
from ..numeric.limb import MASK32
from .blind_rotate import bootstrap

TRUE_MU = 1 << 29  # +1/8
FALSE_MU = (1 << 32) - (1 << 29)  # -1/8


def _affine(c1, c2, b: int):
    """``c1 + c2 + (0, b)`` on the torus."""
    lin = c1 + c2
    lin[..., -1] += b
    return lin & MASK32


def _gate(conv, basis, bsk, ksk, ks_basis, lin, log_n):
    test_poly = torch.full((1 << log_n,), TRUE_MU, dtype=torch.int64, device=lin.device)
    big = bootstrap(conv, basis, bsk, lin, test_poly, log_n)
    return key_switch(big, ksk, ks_basis)


def nand_gate(conv, basis, bsk, ksk, ks_basis, c1, c2, log_n: int):
    """NAND: affine ``c1 + c2 - 5/8`` then sign bootstrap + key switch."""
    return _gate(conv, basis, bsk, ksk, ks_basis, _affine(c1, c2, -(5 << 29)), log_n)


def and_gate(conv, basis, bsk, ksk, ks_basis, c1, c2, log_n: int):
    return _gate(conv, basis, bsk, ksk, ks_basis, _affine(c1, c2, -(1 << 29)), log_n)


def or_gate(conv, basis, bsk, ksk, ks_basis, c1, c2, log_n: int):
    return _gate(conv, basis, bsk, ksk, ks_basis, _affine(c1, c2, 1 << 29), log_n)


def not_gate(c):
    """NOT is free: negate the whole sample."""
    return (-c) & MASK32


def leveled_mux(conv, basis, ggsw_ntt, cx, cy):
    """Leveled select ``y + (x - y) ⊡ GGSW(sel)`` of GLWE ciphertexts
    ``cx``, ``cy`` ``(B..., k+1, N)`` under one key; ``ggsw_ntt (kp, k+1,
    L, k+1, N)`` typically from :func:`.circuit_bootstrap.circuit_bootstrap`
    and :func:`..lattice.tfhe.ggsw_to_ntt` (an encrypted bit)."""
    return (cy + external_product(conv, basis, (cx - cy) & MASK32, ggsw_ntt)) & MASK32
