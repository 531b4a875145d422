"""NTT plan construction (port of ``build_plan32`` and ``build_plan64`` in
``primus_fhe_tpu/transforms/plan.py``).

Root tables come from the golden model (``GoldenNtt``): bit-reversed
forward and inverse roots with Shoup quotients, and the fused ``inv_n``
final-stage constants.  Tables are int64 tensors (u64 tables hold bit
patterns); the scalars stay Python ints, since every kernel and plain
version reads them as constants.
"""

from __future__ import annotations

import dataclasses

import torch

from ..golden.model import GoldenNtt

from ..numeric.limb import u64_tensor


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
    g = GoldenNtt(log_n, q)

    def arr(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device)

    return NttPlan32(
        log_n=log_n,
        q=q,
        roots=arr(g.roots),
        roots_precon=arr([_quot32(w, q) for w in g.roots]),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr([_quot32(w, q) for w in g.inv_roots]),
        inv_n=g.inv_n,
        inv_n_precon=_quot32(g.inv_n, q),
        inv_n_w=g.inv_n_w,
        inv_n_w_precon=_quot32(g.inv_n_w, q),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=arr([2 * i + 1 for i in g.reverse_lsbs]),
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
    g = GoldenNtt(log_n, q, root)

    def arr(vals):
        return u64_tensor([int(v) for v in vals], device)

    return NttPlan64(
        log_n=log_n,
        q=q,
        roots=arr(g.roots),
        roots_precon=arr([_quot64(w, q) for w in g.roots]),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr([_quot64(w, q) for w in g.inv_roots]),
        inv_n=g.inv_n,
        inv_n_precon=_quot64(g.inv_n, q),
        inv_n_w=g.inv_n_w,
        inv_n_w_precon=_quot64(g.inv_n_w, q),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=torch.tensor([2 * i + 1 for i in g.reverse_lsbs], dtype=torch.int64,
                                   device=device),
    )
