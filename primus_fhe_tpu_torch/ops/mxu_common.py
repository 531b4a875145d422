"""Host-side four-step (Bailey) factorization of the negacyclic NTT (port of
``four_step_matrices`` in ``primus_fhe_tpu/ops/mxu_common.py``).

Numpy object-int code, no device work.  The rest of the JAX module (u32-pair
shifts, Solinas folds, the ``pallas_call`` scaffolding) emulates 64-bit
arithmetic on the TPU; CUDA has it natively, so nothing else is ported.
"""

from __future__ import annotations

import numpy as np

from ..golden.model import GoldenNtt
from ..utils.bits import reverse_lsbs
from ..utils.gcd import mod_inv


def _pow_table(base: int, q: int, count: int) -> list[int]:
    """``[base^0, ..., base^(count-1)] mod q``."""
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * base % q
    return out


def _vandermonde(col_pows, row_pows, q: int) -> np.ndarray:
    """``m[r, c] = col_pows[c] * row_pows[r]^c mod q`` (object ints)."""
    m = np.empty((len(row_pows), len(col_pows)), dtype=object)
    for r, base in enumerate(row_pows):
        acc = 1
        for c, cp in enumerate(col_pows):
            m[r, c] = acc * cp % q
            acc = acc * base % q
    return m


def four_step_matrices(log_n: int, q: int, h1: int, h1_inv: int, root: int | None = None):
    """Four-step matrices of the forward NTT and its mirrored inverse.

    For input ``a[B k1 + k0]`` and bit-reversed output ``j = B r0 + r1``
    (``A = 2^h1``, ``B = n / A``)::

        out[j] = sum_{k0} [ sum_{k1} a[B k1 + k0] m1[r0, k1] ] tw[r0, k0] m2[r1, k0]

    The inverse takes bit-reversed input ``[Ai r0 ... ]`` through
    ``m2i[k0, r1]``, ``twi[r0, k0]`` and ``m1i[k1, r0]`` with ``inv_n``
    folded into ``m1i``.  Returns a dict of object-int arrays plus the
    split sizes ``A, B, Ai, Bi``.
    """
    n = 1 << log_n
    A, B = 1 << h1, 1 << (log_n - h1)
    Ai, Bi = 1 << h1_inv, 1 << (log_n - h1_inv)
    if root is None:
        g = GoldenNtt(log_n, q)
        psi, inv_n = g.root, g.inv_n
    else:
        psi, inv_n = int(root), mod_inv(n, q)

    omega = psi * psi % q
    om_a, om_b = pow(omega, B, q), pow(omega, A, q)
    rev1 = [reverse_lsbs(i, h1) for i in range(A)]
    rev2 = [reverse_lsbs(i, log_n - h1) for i in range(B)]
    m1 = _vandermonde(_pow_table(pow(psi, B, q), q, A), [pow(om_a, e, q) for e in rev1], q)
    m2 = _vandermonde([1] * B, [pow(om_b, e, q) for e in rev2], q)
    tw = _vandermonde(_pow_table(psi, q, B), [pow(omega, e, q) for e in rev1], q)

    ipsi = pow(psi, 2 * n - 1, q)
    iom = ipsi * ipsi % q
    iom_a, iom_b = pow(iom, Bi, q), pow(iom, Ai, q)
    rev1i = [reverse_lsbs(i, h1_inv) for i in range(Ai)]
    rev2i = [reverse_lsbs(i, log_n - h1_inv) for i in range(Bi)]
    m2i = _vandermonde([1] * Bi, [pow(iom_b, e, q) for e in rev2i], q).T.copy()
    twi = _vandermonde(_pow_table(ipsi, q, Bi), [pow(iom, e, q) for e in rev1i], q)
    ipsi_b = _pow_table(pow(ipsi, Bi, q), q, Ai)
    m1i = _vandermonde([p * inv_n % q for p in ipsi_b], [pow(iom_a, e, q) for e in rev1i], q)
    return {
        "A": A, "B": B, "Ai": Ai, "Bi": Bi,
        "m1": m1, "m2": m2, "tw": tw,
        "m2i": m2i, "twi": twi, "m1i": m1i.T.copy(),
    }
