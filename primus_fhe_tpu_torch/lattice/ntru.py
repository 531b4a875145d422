"""NTRU samples: one polynomial ``(..., N)`` mod q (port of
``primus_fhe_tpu/lattice/ntru.py``).

An NTRU ciphertext of ``m`` under a secret ``f`` is ``c = g/f + m`` (so
``c * f = g + m * f``); this layer holds the polynomial mechanics.  The
transforms take the prime's :class:`~..ops.ntt32.NttTables32`, so a CUDA
tensor runs kernels 1-2.
"""

from __future__ import annotations

from ..modular import modops
from ..modular.factor import factor_mul32
from ..ops import ntt32


def to_ntt(ntru, tables):
    """Coefficient -> NTT form (bit-reversed, canonical)."""
    return ntt32.forward32(tables, ntru.unsqueeze(0))[0]


def from_ntt(ntt_ntru, tables):
    """NTT form (canonical or lazy ``[0, 2q)``) -> canonical coefficients."""
    return ntt32.inverse32(tables, ntt_ntru.unsqueeze(0))[0]


def mul_ntt_poly(ntru, ntt_poly, tables, m):
    """``NTT(self) * ntt_poly``, canonical."""
    return modops.mul32(to_ntt(ntru, tables), ntt_poly, m)


def mul_scalar(ntru, scalar, m):
    return modops.mul32(ntru, scalar, m)


def mul_factor(ntru, factor, q):
    """Shoup-factor multiply."""
    return factor_mul32(ntru, factor, q)


def ntru_phase(ntru, secret_ntt, tables, m):
    """``c * f``: the NTRU decryption product."""
    return from_ntt(modops.mul32(to_ntt(ntru, tables), secret_ntt, m), tables)
