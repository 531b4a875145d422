"""Coefficient-domain polynomial operations over ``Z_q[X]/(X^n + 1)`` (port of
``primus_fhe_tpu/poly/poly.py``; reference ``poly/mul.rs:17-148``).

A polynomial is a ``(..., n)`` tensor of canonical words: u32 residues, or
u64 residues as int64 bit patterns (``q < 2^62``, so every canonical word
is a non-negative int64).  The central special is the negacyclic monomial
multiply of blind rotation:

    X^d * sum_j a_j X^j  ->  out[k] = ±a[(k - d) mod n],
    negated when ``(k - d) mod 2n >= n``  (X^n = -1).

The degree is data, so the rotation is one gather plus a negation: the
index math (:func:`rot_index`) serves the mod-q rotations here and the
torus rotation of :func:`..ops.rotate.rotate_plain`.  The reference keeps a
gather (``poly_mul_monomial*``) and a bit chain of static rolls
(``poly_rotate*``, the TPU's form) that give the same words; here both
names run the gather and one sign, as kernel F does.
"""

from __future__ import annotations

import torch

from ..modular import modops
from ..modular.modulus import BarrettModulus32


def rot_index(n: int, degrees: torch.Tensor):
    """Gather index and negation mask of ``X^d`` for every degree:
    ``degrees (...)`` (any sign, taken mod 2n) -> ``(..., n)`` each."""
    d = degrees.to(torch.int64).remainder(2 * n)
    kd = (torch.arange(n, device=degrees.device) - d.unsqueeze(-1)).remainder(2 * n)
    return kd.remainder(n), kd >= n


def _rotate(a: torch.Tensor, degree, q, neg):
    n = a.shape[-1]
    deg = torch.as_tensor(degree, device=a.device).expand(a.shape[:-1])
    idx, flip = rot_index(n, deg)
    g = torch.gather(a, -1, idx)
    return torch.where(flip, neg(g, q), g)


# -- u32 words ----------------------------------------------------------------


def poly_add32(a, b, q):
    return modops.add32(a, b, q)


def poly_sub32(a, b, q):
    return modops.sub32(a, b, q)


def poly_neg32(a, q):
    return modops.neg32(a, q)


def poly_mul_scalar32(a, scalar, m: BarrettModulus32):
    """Scalar multiply via Barrett (``mul_scalar`` of poly/mul.rs)."""
    return modops.mul32(a, torch.as_tensor(scalar, device=a.device).expand(a.shape), m)


def poly_rotate32(a: torch.Tensor, degree, q) -> torch.Tensor:
    """``a * X^degree`` in ``Z_q[X]/(X^n + 1)``, canonical in and out.

    ``degree`` (int or tensor) broadcasts against ``a.shape[:-1]``; the
    negation is mod ``q`` (0 stays 0).
    """
    return _rotate(a, degree, q, modops.neg32)


def poly_mul_monomial32(a: torch.Tensor, degree, q) -> torch.Tensor:
    """``a * X^degree`` (the reference's gather form): the words of
    :func:`poly_rotate32`."""
    return _rotate(a, degree, q, modops.neg32)


def poly_evaluate32(a: torch.Tensor, x, m: BarrettModulus32) -> torch.Tensor:
    """Horner evaluation at ``x`` (poly/mul.rs:125-148), canonical; ``x``
    broadcasts against ``a.shape[:-1]``."""
    x = torch.as_tensor(x, device=a.device)
    acc = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for i in range(a.shape[-1] - 1, -1, -1):
        acc = modops.add32(modops.mul32(acc, x, m), a[..., i], m.value)
    return acc


def poly_naive_mul32(a: torch.Tensor, b: torch.Tensor, m: BarrettModulus32) -> torch.Tensor:
    """O(n^2) negacyclic product (``naive_mul``, poly/mul.rs): ``sum_d a_d
    (b X^d)`` with every product canonical and one exact modular sum.  The
    oracle for transform tests."""
    n = a.shape[-1]
    a, b = torch.broadcast_tensors(a, b)
    shifted = poly_rotate32(b.unsqueeze(-2).expand(*b.shape[:-1], n, n),
                            torch.arange(n, device=b.device), m.value)  # (..., d, n)
    return modops.sum_mod32(modops.mul32(a.unsqueeze(-1), shifted, m), m, dim=-2)


# -- u64 words ----------------------------------------------------------------


def poly_add64(a, b, q):
    return modops.add64(a, b, q)


def poly_sub64(a, b, q):
    return modops.sub64(a, b, q)


def poly_neg64(a, q):
    return modops.neg64(a, q)


def poly_mul_monomial64(a: torch.Tensor, degree, q) -> torch.Tensor:
    """``a * X^degree`` over u64 words, ``degree`` as in :func:`poly_rotate32`."""
    return _rotate(a, degree, q, modops.neg64)


def poly_rotate64(a: torch.Tensor, degree, q) -> torch.Tensor:
    """``a * X^degree`` over u64 words (the reference's roll-chain name):
    the words of :func:`poly_mul_monomial64`, ``degree`` broadcasting
    against ``a.shape[:-1]``."""
    return _rotate(a, degree, q, modops.neg64)
