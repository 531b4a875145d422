"""NTT plan construction (port of ``build_plan32`` and ``build_plan64`` in
``primus_fhe_tpu/transforms/plan.py``).

Root tables are the golden model's (``GoldenNtt``): bit-reversed forward
and inverse roots with Shoup quotients, and the fused ``inv_n`` final-stage
constants.  :func:`_golden_tables` computes the same words on whole arrays
(numpy), so a plan of ``2^20`` words builds in a fraction of a second.
Tables are int64 tensors (u64 tables hold bit patterns); the scalars stay
Python ints, since every kernel and plain version reads them as constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.bits import bit_reverse_indices
from ..utils.gcd import mod_inv


_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _mul_hi(a: np.ndarray, b: int) -> np.ndarray:
    """High 64 bits of each ``a * b`` (uint64 words, ``b < 2^64``), on
    32-bit halves."""
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = np.uint64(b & 0xFFFFFFFF), np.uint64(b >> 32)
    mid = a1 * b0 + ((a0 * b0) >> _S32)
    mid2 = a0 * b1 + (mid & _M32)
    return a1 * b1 + (mid >> _S32) + (mid2 >> _S32)


def _mul_mod(a: np.ndarray, c: int, q: int) -> np.ndarray:
    """``a * c mod q`` for uint64 words ``a < q`` and ``c < q < 2^62``: a
    Shoup multiply (the wrapped difference is below 2q), then one
    subtraction."""
    with np.errstate(over="ignore"):
        r = a * np.uint64(c) - _mul_hi(a, ((c << 64) // q)) * np.uint64(q)
    return np.where(r >= np.uint64(q), r - np.uint64(q), r)


def _shoup_quotients(w: np.ndarray, q: int) -> np.ndarray:
    """``(w << 64) // q`` for uint64 words ``w < q < 2^62``: ``w 2^64 = w (c
    q + r)`` with ``c, r`` the quotient and remainder of ``2^64 / q``, so
    the quotient is ``w c + floor(w r / q)``, the latter a Shoup estimate
    corrected once."""
    c, r = divmod(1 << 64, q)
    with np.errstate(over="ignore"):
        est = _mul_hi(w, (r << 64) // q)
        rem = w * np.uint64(r) - est * np.uint64(q)
        return w * np.uint64(c) + est + (rem >= np.uint64(q)).astype(np.uint64)


def _powers(psi: int, q: int, count: int) -> np.ndarray:
    """``psi^0 .. psi^(count - 1) mod q`` (``count`` a power of two, ``q <
    2^62``) as uint64 words, by doubling."""
    p = np.ones(1, dtype=np.uint64)
    while len(p) < count:
        p = np.concatenate([p, _mul_mod(p, pow(psi, len(p), q), q)])
    return p


def _minimal_root(log_degree: int, q: int) -> int:
    """``golden.model.minimal_primitive_root``: the least primitive
    ``2^log_degree``-th root of unity mod prime ``q``, the minimum over a
    generator's odd powers taken on one array."""
    degree = 1 << log_degree
    if (q - 1) % degree != 0:
        raise ValueError(f"no primitive 2^{log_degree}-th root modulo {q}")
    quotient = (q - 1) // degree
    for r in range(2, q):
        g = pow(r, quotient, q)
        if pow(g, degree // 2, q) == q - 1:
            return int(_powers(g, q, 2 * degree)[1::2].min())
    raise ValueError("no primitive root found")  # pragma: no cover - q prime


@dataclasses.dataclass(frozen=True)
class _Tables:
    """``GoldenNtt(log_n, q, root)``'s tables as uint64 arrays."""

    ordinal_roots: np.ndarray  # (2n,) psi^i
    roots: np.ndarray  # roots[brev(i)] = psi^i
    inv_roots: np.ndarray  # inv_roots[brev(i) + 1] = psi^-(i+1); inv_roots[0] = 1
    reverse_lsbs: np.ndarray  # (n,) int64
    inv_n: int
    inv_n_w: int  # inv_n * inv_roots[n-1] mod q


def _golden_tables(log_n: int, q: int, root: int | None = None) -> _Tables:
    n = 1 << log_n
    if root is None:
        root = _minimal_root(log_n + 1, q)
    elif pow(root, n, q) != q - 1:
        # explicit roots serve four-step sub-transforms, where the
        # minimal-root convention must NOT be re-derived per factor
        raise ValueError("root is not a primitive 2n-th root of unity")
    ordinal = _powers(root, q, 2 * n)
    rev = bit_reverse_indices(log_n)
    roots = np.empty_like(ordinal[:n])
    roots[rev] = ordinal[:n]
    inv_roots = np.empty_like(roots)
    inv_roots[0] = 1
    inv_roots[rev[:-1] + 1] = ordinal[2 * n - 1:n:-1]  # i = 0 .. n-2: psi^(2n-1-i)
    inv_n = mod_inv(n, q)
    return _Tables(ordinal, roots, inv_roots, rev, inv_n, inv_n * int(inv_roots[n - 1]) % q)


def _quot32(w: int, q: int) -> int:
    return ((w << 32) // q) & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class NttPlan32:
    """Root tables for the u32 NTT path (``q < 2^30``, lazy ``[0, 4q)``)."""

    log_n: int
    q: int
    roots: torch.Tensor  # (n,) bit-reversed psi powers
    roots_precon: torch.Tensor  # (n,) Shoup 32-bit quotients
    inv_roots: torch.Tensor
    inv_roots_precon: torch.Tensor
    inv_n: int
    inv_n_precon: int
    inv_n_w: int  # inv_n * inv_roots[n-1] mod q
    inv_n_w_precon: int
    ordinal_roots: torch.Tensor  # (2n,) psi^i, for monomials
    monomial_base: torch.Tensor  # (n,) 2 * reverse_lsbs(j) + 1

    @property
    def n(self) -> int:
        return 1 << self.log_n

    def to(self, device) -> "NttPlan32":
        fields = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **fields)


def build_plan32(log_n: int, q: int, device=None) -> NttPlan32:
    """Builds a u32 NTT plan.  Requires prime ``q < 2^30``, ``q = 1 mod 2n``."""
    if q >= 1 << 30:
        raise ValueError("NttPlan32 requires q < 2^30 for the [0,4q) lazy range")
    g = _golden_tables(log_n, q)

    def arr(vals):
        return torch.as_tensor(vals.astype(np.int64), device=device)

    def quot(w):  # _quot32 on every word: w << 32 < 2^62
        return (w << np.uint64(32)) // np.uint64(q)

    return NttPlan32(
        log_n=log_n,
        q=q,
        roots=arr(g.roots),
        roots_precon=arr(quot(g.roots)),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr(quot(g.inv_roots)),
        inv_n=g.inv_n,
        inv_n_precon=_quot32(g.inv_n, q),
        inv_n_w=g.inv_n_w,
        inv_n_w_precon=_quot32(g.inv_n_w, q),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=arr(2 * g.reverse_lsbs + 1),
    )


def _quot64(w: int, q: int) -> int:
    return ((w << 64) // q) & ((1 << 64) - 1)


@dataclasses.dataclass(frozen=True)
class NttPlan64:
    """Root tables for the u64 NTT path (``q < 2^62``, lazy ``[0, 4q)``)."""

    log_n: int
    q: int
    roots: torch.Tensor  # (n,) bit-reversed psi powers
    roots_precon: torch.Tensor  # (n,) Shoup 64-bit quotients (u64 patterns)
    inv_roots: torch.Tensor
    inv_roots_precon: torch.Tensor
    inv_n: int
    inv_n_precon: int
    inv_n_w: int  # inv_n * inv_roots[n-1] mod q
    inv_n_w_precon: int
    ordinal_roots: torch.Tensor  # (2n,) psi^i, for monomials
    monomial_base: torch.Tensor  # (n,) 2 * reverse_lsbs(j) + 1

    @property
    def n(self) -> int:
        return 1 << self.log_n

    def to(self, device) -> "NttPlan64":
        fields = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **fields)


def build_plan64(log_n: int, q: int, device=None, root: int | None = None) -> NttPlan64:
    """Builds a u64 NTT plan.  Requires prime ``q < 2^62``, ``q = 1 mod 2n``.
    ``root``: an explicit primitive ``2n``-th root (the four-step
    sub-plans of :mod:`.ntt_large`); the minimal one by default."""
    if q >= 1 << 62:
        raise ValueError("NttPlan64 requires q < 2^62 for the [0,4q) lazy range")
    g = _golden_tables(log_n, q, root)

    def arr(vals):  # u64 bit patterns
        return torch.as_tensor(vals.view(np.int64), device=device)

    def quot(w):  # _quot64 on every word
        return _shoup_quotients(w, q)

    return NttPlan64(
        log_n=log_n,
        q=q,
        roots=arr(g.roots),
        roots_precon=arr(quot(g.roots)),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr(quot(g.inv_roots)),
        inv_n=g.inv_n,
        inv_n_precon=_quot64(g.inv_n, q),
        inv_n_w=g.inv_n_w,
        inv_n_w_precon=_quot64(g.inv_n_w, q),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=torch.as_tensor(2 * g.reverse_lsbs + 1, device=device),
    )
