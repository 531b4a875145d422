"""Negacyclic NTT forward/inverse over u32 and u64 words (port of
``forward32``, ``inverse32``, ``forward64``, ``inverse64``, ``monomial32``,
``monomial64``, ``pointwise_mul32``, ``pointwise_mul64``,
``negacyclic_mul32``, ``negacyclic_mul64``, ``bit_reverse_permute`` and the
four ``*_normal_order`` variants in ``primus_fhe_tpu/transforms/ntt.py``).

Radix-2 Harvey butterflies with Shoup lazy multiplies and the
``[0,4q)`` / ``[0,2q)`` lazy-range discipline; each stage is a reshape to
``(..., m, 2, t)`` plus elementwise ops.  These are the plain versions of
the NTT kernels in :mod:`..ops.ntt32` and :mod:`..ops.ntt64`.

- forward: normal-order input (``[0,4q)`` ok), bit-reversed output;
  ``out_factor=1`` gives canonical ``[0,q)``, ``out_factor=4`` stays lazy.
- inverse: bit-reversed input in ``[0,2q)``, normal-order output;
  ``out_factor=1`` canonical, ``out_factor=2`` lazy.

Values below 4q < 2^32 and roots below q < 2^30 keep every product below
2^62, so int64 holds them exactly.  The u64 path carries bit patterns
(:mod:`..numeric.limb`): lazy values below ``4q`` may pass 2^63 when
``q >= 2^61``, so its range reductions compare unsigned.
"""

from __future__ import annotations

import torch

from ..modular.modops import mul32, mul64, reduce_once32, reduce_once64, reduce_twice32, reduce_twice64
from ..numeric.limb import MASK32, mul_hi_u64, mulhi_u32
from ..utils.bits import reverse_lsbs
from ..utils.contracts import check_range_u32, check_range_u64
from .plan import NttPlan32, NttPlan64


def _shoup_lazy32(y, w, w_precon, q):
    """``y*w mod q`` in ``[0,2q)`` — mul_mod_lazy32 (scalar/arithmetic.rs:23-28)."""
    return (w * y - q * mulhi_u32(y, w_precon)) & MASK32


def forward32(plan: NttPlan32, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT; input normal order, output bit-reversed."""
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    check_range_u32(values, plan.q, 4, "forward32 input")
    n, q = plan.n, plan.q
    two_q = 2 * q
    batch = values.shape[:-1]
    v = values
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        w = plan.roots[m : 2 * m].reshape(m, 1)
        wp = plan.roots_precon[m : 2 * m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        tx = reduce_once32(v[..., 0, :], two_q)
        ty = _shoup_lazy32(v[..., 1, :], w, wp, q)
        v = torch.stack([tx + ty, tx + two_q - ty], dim=-2)
    v = v.reshape(*batch, n)
    if out_factor == 1:
        v = reduce_twice32(v, q)
    return v


def inverse32(plan: NttPlan32, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT; input bit-reversed in ``[0,2q)``, normal-order output."""
    if out_factor not in (1, 2):
        raise ValueError("out_factor must be 1 or 2")
    check_range_u32(values, plan.q, 2, "inverse32 input")
    n, q = plan.n, plan.q
    two_q = 2 * q
    batch = values.shape[:-1]
    v = values
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        # inv_roots are consumed sequentially: stage s starts after the
        # n/2 + n/4 + ... roots of earlier stages (transform.rs:186).
        start = 1 + n - (n >> s)
        w = plan.inv_roots[start : start + m].reshape(m, 1)
        wp = plan.inv_roots_precon[start : start + m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        x = v[..., 0, :]
        y = v[..., 1, :]
        tx = reduce_once32(x + y, two_q)
        ty = _shoup_lazy32(x + two_q - y, w, wp, q)
        v = torch.stack([tx, ty], dim=-2)
    v = v.reshape(*batch, n)
    half = n >> 1
    x = v[..., :half]
    y = v[..., half:]
    tx = reduce_once32(x + y, two_q)
    ty = x + two_q - y
    ox = _shoup_lazy32(tx, plan.inv_n, plan.inv_n_precon, q)
    oy = _shoup_lazy32(ty, plan.inv_n_w, plan.inv_n_w_precon, q)
    out = torch.cat([ox, oy], dim=-1)
    if out_factor == 1:
        out = reduce_once32(out, q)
    return out


def pointwise_mul32(m, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical ``a * b mod q`` of two NTT polynomials (``m``: a
    ``BarrettModulus32``)."""
    return mul32(a, b, m)


def monomial32(plan: NttPlan32, degree, negate=False) -> torch.Tensor:
    """NTT of ``±X^degree`` on a u32 plan: the table lookup of
    :func:`monomial64`, which reads only the plan's ``ordinal_roots`` and
    ``monomial_base``."""
    return monomial64(plan, degree, negate)


def negacyclic_mul32(plan: NttPlan32, m, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` in ``Z_q[X]/(X^n + 1)`` for canonical coefficient vectors:
    two forward transforms, a pointwise product, one inverse (canonical)."""
    return inverse32(plan, mul32(forward32(plan, a), forward32(plan, b), m))


# ---------------------------------------------------------------------------
# u64 path
# ---------------------------------------------------------------------------


def _shoup_lazy64(y, w, w_precon, q):
    """``y*w mod q`` in ``[0,2q)`` for any u64 ``y`` (wrapping int64)."""
    return w * y - q * mul_hi_u64(y, w_precon)


def forward64(plan: NttPlan64, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT over u64 patterns; input normal order in ``[0,4q)``,
    output bit-reversed."""
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    check_range_u64(values, plan.q, 4, "forward64 input")
    n, q = plan.n, plan.q
    two_q = 2 * q
    batch = values.shape[:-1]
    v = values
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        w = plan.roots[m : 2 * m].reshape(m, 1)
        wp = plan.roots_precon[m : 2 * m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        tx = reduce_once64(v[..., 0, :], two_q)
        ty = _shoup_lazy64(v[..., 1, :], w, wp, q)
        v = torch.stack([tx + ty, tx + two_q - ty], dim=-2)
    v = v.reshape(*batch, n)
    if out_factor == 1:
        v = reduce_twice64(v, q, two_q)
    return v


def inverse64(plan: NttPlan64, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT over u64 patterns; input bit-reversed in ``[0,2q)``,
    normal-order output."""
    if out_factor not in (1, 2):
        raise ValueError("out_factor must be 1 or 2")
    check_range_u64(values, plan.q, 2, "inverse64 input")
    n, q = plan.n, plan.q
    two_q = 2 * q
    batch = values.shape[:-1]
    v = values
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        start = 1 + n - (n >> s)
        w = plan.inv_roots[start : start + m].reshape(m, 1)
        wp = plan.inv_roots_precon[start : start + m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        x = v[..., 0, :]
        y = v[..., 1, :]
        tx = reduce_once64(x + y, two_q)
        ty = _shoup_lazy64(x + two_q - y, w, wp, q)
        v = torch.stack([tx, ty], dim=-2)
    v = v.reshape(*batch, n)
    half = n >> 1
    x = v[..., :half]
    y = v[..., half:]
    tx = reduce_once64(x + y, two_q)
    ty = x + two_q - y
    ox = _shoup_lazy64(tx, plan.inv_n, plan.inv_n_precon, q)
    oy = _shoup_lazy64(ty, plan.inv_n_w, plan.inv_n_w_precon, q)
    out = torch.cat([ox, oy], dim=-1)
    if out_factor == 1:
        out = reduce_once64(out, q)
    return out


def monomial64(plan: NttPlan64 | NttPlan32, degree, negate=False) -> torch.Tensor:
    """NTT of ``±X^degree`` (bit-reversed output): ``out[j] =
    psi^((2 rev(j) + 1) degree mod 2n)``, ``negate`` flips the exponent by
    ``n`` (``psi^n = -1``).  ``degree`` may be a tensor of shape ``(..., 1)``
    (any sign: it wraps mod 2n)."""
    n = plan.n
    degree = torch.as_tensor(degree, dtype=torch.int64, device=plan.ordinal_roots.device)
    idx = (plan.monomial_base * degree) & (2 * n - 1)
    if negate is not False:
        idx = idx ^ (torch.as_tensor(negate, device=idx.device).to(torch.int64) * n)
    return plan.ordinal_roots[idx]


def pointwise_mul64(m, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical ``a * b mod q`` (``m``: a ``BarrettModulus64``)."""
    return mul64(a, b, m)


def negacyclic_mul64(plan: NttPlan64, m, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b`` in ``Z_q[X]/(X^n + 1)`` for canonical coefficient vectors:
    two forward transforms, a pointwise product, one inverse (canonical)."""
    return inverse64(plan, mul64(forward64(plan, a), forward64(plan, b), m))


def bit_reverse_permute(values: torch.Tensor, log_n: int) -> torch.Tensor:
    """Reorders the last axis by bit-reversed index (its own inverse)."""
    rev = [reverse_lsbs(i, log_n) for i in range(1 << log_n)]
    return values[..., torch.tensor(rev, device=values.device)]


def forward32_normal_order(plan: NttPlan32, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT with normal-order output."""
    return bit_reverse_permute(forward32(plan, values, out_factor), plan.log_n)


def inverse32_normal_order(plan: NttPlan32, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT of normal-order NTT-domain input."""
    return inverse32(plan, bit_reverse_permute(values, plan.log_n), out_factor)


def forward64_normal_order(plan: NttPlan64, values: torch.Tensor, out_factor: int = 1):
    """64-bit forward NTT with normal-order output."""
    return bit_reverse_permute(forward64(plan, values, out_factor), plan.log_n)


def inverse64_normal_order(plan: NttPlan64, values: torch.Tensor, out_factor: int = 1):
    """64-bit inverse NTT of normal-order NTT-domain input."""
    return inverse64(plan, bit_reverse_permute(values, plan.log_n), out_factor)
