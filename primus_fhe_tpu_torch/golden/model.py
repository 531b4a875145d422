"""Exact scalar and NTT golden models over Python integers (copy of
``primus_fhe_tpu/golden/model.py``): the port's plans (:mod:`..transforms.plan`,
:mod:`..ops.mxu_common`) read ``GoldenNtt``'s tables, and tests use the
models as oracles.

Semantics mirror the reference implementations cited below:

- Barrett lazy reduce:      crates/primus_modulus/src/barrett/ops.rs:13-33
- Barrett wide reduce:      crates/primus_modulus/src/barrett/mod.rs:99-132
- Shoup factor multiply:    crates/primus_factor/src/shoup_factor/mod.rs:104-143
- minimal primitive root:   crates/primus_ntt/src/root.rs:103-126
- root table layout:        crates/primus_ntt/src/ntt/prime64/table.rs:330-360
- Harvey butterflies:       crates/primus_ntt/src/ntt/prime64/scalar/arithmetic.rs:43-79
- fwd/inv transforms:       crates/primus_ntt/src/ntt/prime64/scalar/transform.rs
- monomial transforms:      crates/primus_ntt/src/ntt/prime64/table.rs:565-650
"""

from __future__ import annotations

from ..utils.bits import reverse_lsbs
from ..utils.gcd import mod_inv

__all__ = [
    "GoldenNtt", "barrett_lazy_reduce", "barrett_lazy_reduce_wide", "barrett_ratio",
    "minimal_primitive_root", "mod_inv", "naive_negacyclic_mul", "reduce_once",
    "shoup_mul_lazy", "shoup_quotient",
]

# ---------------------------------------------------------------------------
# Scalar Barrett / Shoup golden ops (bit-width-parameterized)
# ---------------------------------------------------------------------------


def barrett_ratio(q: int, bits: int) -> tuple[int, int]:
    """``floor(B^2 / q)`` split into two ``bits``-wide limbs, ``B = 2^bits``."""
    b = 1 << bits
    ratio = (b * b) // q
    return ratio & (b - 1), ratio >> bits


def barrett_lazy_reduce(value: int, q: int, bits: int) -> int:
    """Single-word Barrett lazy reduce: result in ``[0, 2q)``.

    ``q_hat = hi_word(value * ratio / B)`` then ``value - q_hat * q`` with
    wrapping ``bits``-wide arithmetic.
    """
    b = 1 << bits
    mask = b - 1
    r0, r1 = barrett_ratio(q, bits)
    tmp = (value * r0) >> bits
    q_hat = (value * r1 + tmp) >> bits
    return (value - q_hat * q) & mask


def barrett_lazy_reduce_wide(lo: int, hi: int, q: int, bits: int) -> int:
    """Two-word Barrett lazy reduce of ``hi*B + lo``: result in ``[0, 2q)``."""
    b = 1 << bits
    mask = b - 1
    r0, r1 = barrett_ratio(q, bits)
    value = hi * b + lo
    q_hat = ((value * (r1 * b + r0)) >> (2 * bits)) & mask
    return (lo - q_hat * q) & mask


def shoup_quotient(w: int, q: int, bits: int) -> int:
    """Shoup preconditioner ``floor(w * B / q)``."""
    return ((w << bits) // q) & ((1 << bits) - 1)


def shoup_mul_lazy(y: int, w: int, w_precon: int, q: int, bits: int) -> int:
    """Shoup/Barrett lazy multiply ``y * w mod q`` in ``[0, 2q)``.

    Exactly ``mul_mod_lazy`` — hi word of ``y * w_precon`` as the quotient
    estimate, then a wrapping low-word subtraction.
    """
    mask = (1 << bits) - 1
    q_hat = (y * w_precon) >> bits
    return (w * y - q * q_hat) & mask


def reduce_once(x: int, q: int) -> int:
    """``x mod q`` assuming ``x < 2q``."""
    return x - q if x >= q else x


# ---------------------------------------------------------------------------
# Primitive roots
# ---------------------------------------------------------------------------


def minimal_primitive_root(log_degree: int, q: int) -> int:
    """The minimal primitive ``2^log_degree``-th root of unity mod prime ``q``.

    The reference samples a random primitive root then scans its odd-power
    orbit for the minimum (root.rs:103-126); the minimum over all primitive
    roots is unique, so a deterministic search gives the identical value.
    """
    degree = 1 << log_degree
    if (q - 1) % degree != 0:
        raise ValueError(f"no primitive 2^{log_degree}-th root modulo {q}")
    quotient = (q - 1) // degree
    # Find any generator of the order-2^log_degree subgroup.
    g = None
    for r in range(2, q):
        w = pow(r, quotient, q)
        if pow(w, degree // 2, q) == q - 1:
            g = w
            break
    if g is None:  # pragma: no cover - q prime guarantees existence
        raise ValueError("no primitive root found")
    # Minimum over the odd-power orbit (= all primitive roots).
    g_sq = g * g % q
    root = g
    cur = g
    for _ in range(degree):
        if cur < root:
            root = cur
        cur = cur * g_sq % q
    return root


# ---------------------------------------------------------------------------
# Golden negacyclic NTT
# ---------------------------------------------------------------------------


class GoldenNtt:
    """Exact reference NTT with the bit-reversed layout of ``U64NttTable``.

    Forward: normal-order input, bit-reversed output (Cooley-Tukey).
    Inverse: bit-reversed input, normal-order output (Gentleman-Sande with a
    fused ``inv_n`` final stage).  All arithmetic is exact mod ``q``.
    """

    def __init__(self, log_n: int, q: int, root: int | None = None):
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.q = q
        if root is None:
            root = minimal_primitive_root(log_n + 1, q)
        elif pow(root, n, q) != q - 1:
            # explicit roots serve four-step sub-transforms, where the
            # minimal-root convention must NOT be re-derived per factor
            raise ValueError("root is not a primitive 2n-th root of unity")
        self.root = psi = root
        self.inv_root = mod_inv(psi, q)
        self.inv_n = mod_inv(n, q)

        # ordinal_roots = [1, psi, psi^2, ..., psi^(2n-1)]
        ordinal = [1] * (2 * n)
        for i in range(1, 2 * n):
            ordinal[i] = ordinal[i - 1] * psi % q
        self.ordinal_roots = ordinal

        rev = [reverse_lsbs(i, log_n) for i in range(n)]
        self.reverse_lsbs = rev

        # Forward roots, bit-reversed: roots[brev(i)] = psi^i.
        roots = [0] * n
        for i in range(n):
            roots[rev[i]] = ordinal[i]
        self.roots = roots

        # Inverse roots: inv_roots[brev(i) + 1] = psi^(2n-1-i) = psi^-(i+1),
        # for i in 0..n-1; inv_roots[0] = 1.
        inv_roots = [0] * n
        inv_roots[0] = 1
        for i in range(n - 1):
            inv_roots[rev[i] + 1] = ordinal[2 * n - 1 - i]
        self.inv_roots = inv_roots

        # inv_n * inv_roots[n-1] for the fused final stage.
        self.inv_n_w = self.inv_n * inv_roots[n - 1] % q

    # -- transforms ---------------------------------------------------------

    def forward(self, values: list[int]) -> list[int]:
        """Forward NTT: normal order -> bit-reversed order, exact mod q."""
        n, q = self.n, self.q
        v = [x % q for x in values]
        t = n >> 1
        m = 1
        ri = 1
        while m < n:
            for j in range(m):
                w = self.roots[ri]
                ri += 1
                base = 2 * j * t
                for k in range(base, base + t):
                    x, y = v[k], v[k + t]
                    wy = y * w % q
                    v[k] = (x + wy) % q
                    v[k + t] = (x - wy) % q
            t >>= 1
            m <<= 1
        return v

    def inverse(self, values: list[int]) -> list[int]:
        """Inverse NTT: bit-reversed order -> normal order, exact mod q."""
        n, q = self.n, self.q
        v = [x % q for x in values]
        t = 1
        m = n >> 1
        ri = 1
        while m > 1:
            for j in range(m):
                w = self.inv_roots[ri]
                ri += 1
                base = 2 * j * t
                for k in range(base, base + t):
                    x, y = v[k], v[k + t]
                    v[k] = (x + y) % q
                    v[k + t] = (x - y) * w % q
            t <<= 1
            m >>= 1
        half = n >> 1
        for k in range(half):
            x, y = v[k], v[k + half]
            v[k] = (x + y) * self.inv_n % q
            v[k + half] = (x - y) * self.inv_n_w % q
        return v

    # -- monomial fast paths ------------------------------------------------

    def monomial(self, coeff: int, degree: int) -> list[int]:
        """NTT of ``coeff * X^degree`` (bit-reversed output).

        Output position j carries ``coeff * psi^((2*i+1)*degree mod 2n)``
        where ``i = reverse_lsbs[j]`` (table.rs:565-609).
        """
        n, q = self.n, self.q
        coeff %= q
        if coeff == 0:
            return [0] * n
        if degree % (2 * n) == 0:
            return [coeff] * n
        mask = 2 * n - 1
        out = [0] * n
        for j in range(n):
            i = self.reverse_lsbs[j]
            w = self.ordinal_roots[((2 * i + 1) * degree) & mask]
            out[j] = coeff * w % q
        return out

    # -- helpers ------------------------------------------------------------

    def pointwise_mul(self, a: list[int], b: list[int]) -> list[int]:
        q = self.q
        return [x * y % q for x, y in zip(a, b)]

    def negacyclic_mul(self, a: list[int], b: list[int]) -> list[int]:
        """Polynomial product in Z_q[X]/(X^n + 1) via the golden NTT."""
        fa = self.forward(a)
        fb = self.forward(b)
        return self.inverse(self.pointwise_mul(fa, fb))


def naive_negacyclic_mul(a: list[int], b: list[int], q: int) -> list[int]:
    """O(n^2) schoolbook negacyclic product — the model-based oracle
    (reference test: crates/primus_fft/tests/negacyclic.rs:15-51)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + ai * bj) % q
            else:
                out[k - n] = (out[k - n] - ai * bj) % q
    return out
