"""TFHE external product on the 2^64 torus, exact (port of
``primus_fhe_tpu/lattice/tfhe64.py``).

The external product of :mod:`.tfhe` through a
:class:`..transforms.torus.TorusConvolver64`: full 64-bit torus words (int64
tensors of u64 bit patterns), no transform error.

Shapes:
- ``glwe``: ``(B..., k+1, N)`` u64 words
- ``key``:  NTT residues ``(kp, k+1, L, k+1, N)`` (30-bit primes)
"""

from __future__ import annotations

import math

from ..decompose.primitive import ApproxSignedBasis64
from ..transforms.torus import TorusConvolver64
from .tfhe import _external_product_tail


def external_product_bound_bits64(n: int, level: int, k: int, log_basis: int) -> int:
    """``|acc| <= n * level * (k+1) * (B/2) * 2^63``."""
    return 63 + (log_basis - 1) + math.ceil(math.log2(n * level * (k + 1))) + 1


def make_convolver64(n_log: int, level: int, k: int, log_basis: int) -> TorusConvolver64:
    return TorusConvolver64(n_log, external_product_bound_bits64(1 << n_log, level, k, log_basis))


def ggsw_to_ntt64(conv: TorusConvolver64, ggsw_coeff):
    """Coefficient-domain u64 GGSW ``(k+1, L, k+1, N)`` -> NTT residues."""
    return conv.forward(ggsw_coeff)


def external_product64(conv: TorusConvolver64, basis: ApproxSignedBasis64, glwe, key_ntt):
    """``glwe ⊡ key`` on the 2^64 torus, exact."""
    batch = glwe.shape[:-2]
    digits = basis.decompose(glwe).movedim(0, -2)  # (B..., k+1, L, N)
    return _external_product_tail(conv, conv.forward(digits), key_ntt, len(batch))
