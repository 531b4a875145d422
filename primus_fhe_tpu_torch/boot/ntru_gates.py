"""Boolean gates over the NTRU (FINAL-style) bootstrap (port of
``primus_fhe_tpu/boot/ntru_gates.py``).

Encoding: TRUE = +(q-1)/8, FALSE = -(q-1)/8 mod q, LWE ``(..., n+1)`` under
the binary key ``s``; the context must use ``t_scale=8``.  A gate is an
affine combination mod q, the modulus switch q -> 2N, the NTRU blind
rotation (sign test), extraction under ``f`` and the key switch back to
``s``, so outputs feed gates indefinitely.
"""

from __future__ import annotations

import torch

from ..modular.modops import add32, neg32, sub32
from .ntru_blind_rotate import (
    NtruContext,
    extract_lwe_ntru,
    modulus_switch_q,
    ntru_blind_rotate,
    ntru_key_switch,
    ntru_test_polynomial,
)


def true_mu(ctx: NtruContext) -> int:
    if ctx.t_scale != 8:
        raise ValueError("gates need t_scale=8 (±q/8 encodings)")
    return (ctx.q_int - 1) // 8


def false_mu(ctx: NtruContext) -> int:
    return ctx.q_int - true_mu(ctx)


def _trivial(ctx, b: int, n_in: int, device):
    out = torch.zeros(n_in + 1, dtype=torch.int64, device=device)
    out[n_in] = b % ctx.q_int
    return out


def _gate(ctx, evk, ksk, ks_basis, lin):
    q = ctx.q_int
    switched = modulus_switch_q(lin, ctx, ctx.log_n + 1)
    tp = ntru_test_polynomial(ctx.n, q, true_mu(ctx), lin.device)
    a_vec = extract_lwe_ntru(ntru_blind_rotate(ctx, evk, switched, tp), q)
    # the extraction's phase is +sum a_j f_j; the key switch reads
    # b - sum a_i f_i, so the mask is negated (b = 0)
    lwe_f = torch.cat([neg32(a_vec, q), torch.zeros_like(a_vec[..., :1])], dim=-1)
    return ntru_key_switch(ctx, lwe_f, ksk, ks_basis)


def ntru_nand(ctx, evk, ksk, ks_basis, c1, c2):
    """NAND: ``c1 + c2 - 5q/8``, then sign bootstrap and key switch."""
    t = _trivial(ctx, 5 * true_mu(ctx), c1.shape[-1] - 1, c1.device)
    return _gate(ctx, evk, ksk, ks_basis, sub32(add32(c1, c2, ctx.q_int), t, ctx.q_int))


def ntru_and(ctx, evk, ksk, ks_basis, c1, c2):
    t = _trivial(ctx, true_mu(ctx), c1.shape[-1] - 1, c1.device)
    return _gate(ctx, evk, ksk, ks_basis, sub32(add32(c1, c2, ctx.q_int), t, ctx.q_int))


def ntru_or(ctx, evk, ksk, ks_basis, c1, c2):
    t = _trivial(ctx, true_mu(ctx), c1.shape[-1] - 1, c1.device)
    return _gate(ctx, evk, ksk, ks_basis, add32(add32(c1, c2, ctx.q_int), t, ctx.q_int))


def ntru_not(ctx, c):
    """NOT is free: negate the sample mod q."""
    return neg32(c, ctx.q_int)
