"""Root tables of the negacyclic NTT over Python integers (copy of
``minimal_primitive_root`` and ``GoldenNtt``'s tables in
``primus_fhe_tpu/golden/model.py``).

The port's plans (:mod:`..transforms.plan`, :mod:`..ops.mxu_common`) read
these tables; the transforms themselves are the port's own.
"""

from __future__ import annotations

from ..utils.bits import reverse_lsbs
from ..utils.gcd import mod_inv

__all__ = ["GoldenNtt", "minimal_primitive_root", "mod_inv"]


def minimal_primitive_root(log_degree: int, q: int) -> int:
    """The minimal primitive ``2^log_degree``-th root of unity mod prime ``q``
    (the minimum over all primitive roots is unique, so a deterministic
    search gives the reference's value)."""
    degree = 1 << log_degree
    if (q - 1) % degree != 0:
        raise ValueError(f"no primitive 2^{log_degree}-th root modulo {q}")
    quotient = (q - 1) // degree
    g = None
    for r in range(2, q):
        w = pow(r, quotient, q)
        if pow(w, degree // 2, q) == q - 1:
            g = w
            break
    if g is None:  # pragma: no cover - q prime guarantees existence
        raise ValueError("no primitive root found")
    g_sq = g * g % q
    root = cur = g
    for _ in range(degree):
        if cur < root:
            root = cur
        cur = cur * g_sq % q
    return root


class GoldenNtt:
    """Root tables with the bit-reversed layout of ``U64NttTable``.

    ``roots[brev(i)] = psi^i`` (forward), ``inv_roots[brev(i) + 1] =
    psi^-(i+1)`` with ``inv_roots[0] = 1`` (inverse), ``ordinal_roots =
    [psi^0 .. psi^(2n-1)]``, ``inv_n`` and ``inv_n_w = inv_n *
    inv_roots[n-1]`` for the fused final inverse stage.  ``root`` defaults
    to the minimal primitive ``2n``-th root; an explicit one serves the
    four-step sub-transforms, whose roots are powers of the top-level one.
    """

    def __init__(self, log_n: int, q: int, root: int | None = None):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.q = q
        if root is None:
            root = minimal_primitive_root(log_n + 1, q)
        elif pow(root, n, q) != q - 1:
            raise ValueError("root is not a primitive 2n-th root of unity")
        self.root = psi = root
        self.inv_root = mod_inv(psi, q)
        self.inv_n = mod_inv(n, q)
        ordinal = [1] * (2 * n)
        for i in range(1, 2 * n):
            ordinal[i] = ordinal[i - 1] * psi % q
        self.ordinal_roots = ordinal
        rev = [reverse_lsbs(i, log_n) for i in range(n)]
        self.reverse_lsbs = rev
        roots = [0] * n
        for i in range(n):
            roots[rev[i]] = ordinal[i]
        self.roots = roots
        inv_roots = [0] * n
        inv_roots[0] = 1
        for i in range(n - 1):
            inv_roots[rev[i] + 1] = ordinal[2 * n - 1 - i]
        self.inv_roots = inv_roots
        self.inv_n_w = self.inv_n * inv_roots[n - 1] % q
