"""Negacyclic rotation of polynomials (port of ``poly_rotate32`` in
``primus_fhe_tpu/poly/poly.py``).

``X^d * sum_j a_j X^j`` has coefficient ``out[k] = ±a[(k - d) mod n]``,
negated when ``(k - d) mod 2n >= n`` (``X^n = -1``).  The degree is data,
so the rotation is one gather plus a negation: the index math
(:func:`rot_index`) serves the mod-q rotation here and the torus rotation
of :func:`..ops.rotate.rotate_plain`.
"""

from __future__ import annotations

import torch


def rot_index(n: int, degrees: torch.Tensor):
    """Gather index and negation mask of ``X^d`` for every degree:
    ``degrees (...)`` (any sign, taken mod 2n) -> ``(..., n)`` each."""
    d = degrees.to(torch.int64).remainder(2 * n)
    kd = (torch.arange(n, device=degrees.device) - d.unsqueeze(-1)).remainder(2 * n)
    return kd.remainder(n), kd >= n


def poly_rotate32(a: torch.Tensor, degree, q: int) -> torch.Tensor:
    """``a * X^degree`` in ``Z_q[X]/(X^n + 1)``, canonical in and out.

    ``degree`` (int or tensor) broadcasts against ``a.shape[:-1]``; the
    negation is mod ``q`` (0 stays 0).
    """
    n = a.shape[-1]
    deg = torch.as_tensor(degree, device=a.device).expand(a.shape[:-1])
    idx, neg = rot_index(n, deg)
    g = torch.gather(a, -1, idx)
    return torch.where(neg & (g != 0), q - g, g)
