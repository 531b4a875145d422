"""NTRU (NGS / FINAL-style) blind rotation, the FHEW variant (port of
``primus_fhe_tpu/boot/ntru_blind_rotate.py``).

- scalar NTRU ciphertext ``c = g/f + mu`` over ``Z_q[X]/(X^N+1)`` with
  secret ``f = 1 + t*f'`` (ternary ``f'``);
- vector NGS ciphertext of a bit ``s``: rows ``g_j/f + B^j*2^drop*s``;
- CMux chain ``acc <- acc + rot(delta, a_i) - delta`` with
  ``delta = INTT(acc ⊠ EVK_i)``, i.e. ``acc * X^{a_i s_i}``;
- extraction under ``f`` and a mod-q LWE key switch back to ``s``.

Everything is mod one NTT prime ``q < 2^30``.  The blind rotation takes
either evaluation key: an NTT-domain ``(n_lwe, L, N)`` tensor runs the
composed step (kernels 1-2 on a CUDA tensor, the route the reference takes
on its accelerator for this key), an MXU pack ``(vals, precons)`` runs
kernel B once per key slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian, sample_uniform, uniform_ternary
from ..lattice.ntru import from_ntt, to_ntt
from ..modular.modops import add32, dot32, lazy_mul32, neg32, sub32
from ..modular.modulus import barrett32_int
from ..numeric.limb import narrow_u32, widen_u32
from ..ops import ntt32
from ..ops.ntru_cmux_mxu import get_ntru_plan, ntru_cmux_step, ntru_ntt_step, prepare_mxu_evk
from ..poly.poly import poly_rotate32

# Budget of the int64 (batch, chunk, L, n_out+1) key-switch product per chunk.
_CHUNK_BYTES = 256 << 20


class NtruContext:
    """Ring tables, modulus record and NGS gadget of one NTRU setting."""

    def __init__(self, log_n: int, q: int, log_basis: int, level: int, t_scale: int = 4):
        if (q - 1) % t_scale != 0:
            raise ValueError("t_scale must divide q - 1 (q = 1 mod 2N covers 4/8/...)")
        self.ntt = ntt32.NttTables32(log_n, (q,))
        self.log_n = log_n
        self.m = barrett32_int(q)
        self.q_int = q
        self.log_basis = log_basis
        self.level = level
        self.t_scale = t_scale  # f = 1 + t*f'; messages live in ((q-1)/t)*Z_t
        self.delta = (q - 1) // t_scale
        self.basis = ApproxSignedBasis32(q, log_basis, level)

    @property
    def n(self) -> int:
        return 1 << self.log_n


@dataclasses.dataclass
class NtruSecret:
    """``f = 1 + t f'`` with its NTT form and pointwise NTT-domain inverse
    (all ``(N,)`` canonical int64)."""

    f: torch.Tensor
    f_ntt: torch.Tensor
    f_inv_ntt: torch.Tensor


def make_ntru_context(log_n: int, q: int, log_basis: int, level: int) -> NtruContext:
    return NtruContext(log_n, q, log_basis, level)


def ntru_phase(ctx: NtruContext, sk: "NtruSecret", c: torch.Tensor) -> torch.Tensor:
    """``c * f`` mod q, canonical: the decryption phase of NTRU samples ``c
    (..., N)`` (ntru/ntt.rs:36-108), kernels 1-2 on a CUDA tensor."""
    fc = ntt32.forward32(ctx.ntt, c.unsqueeze(0))[0]
    return ntt32.inverse32(ctx.ntt, lazy_mul32(fc, sk.f_ntt, ctx.m).unsqueeze(0))[0]


def rotate_poly_q(poly: torch.Tensor, degree, n: int, q) -> torch.Tensor:
    """``poly * X^degree`` mod ``(X^N + 1, q)`` (:func:`..poly.poly.poly_rotate32`)."""
    return poly_rotate32(poly, degree, q)


def _pow_mod(x: torch.Tensor, e: int, q: int) -> torch.Tensor:
    """``x^e mod q`` elementwise (int64; ``q < 2^31`` keeps products exact)."""
    out = torch.ones_like(x)
    base = x.clone()
    while e:
        if e & 1:
            out = out * base % q
        base = base * base % q
        e >>= 1
    return out


def ntru_secret(ctx: NtruContext, f: torch.Tensor) -> NtruSecret | None:
    """The secret record of coefficients ``f``, or ``None`` when ``f`` is not
    invertible (an NTT coordinate is 0).  The pointwise Fermat inverse runs
    on the host."""
    f_ntt = to_ntt(f, ctx.ntt)
    host = f_ntt.cpu()
    if bool((host == 0).any()):
        return None
    inv = _pow_mod(host, ctx.q_int - 2, ctx.q_int).to(f.device)
    return NtruSecret(f=f, f_ntt=f_ntt, f_inv_ntt=inv)


def ntru_keygen(generator: torch.Generator, ctx: NtruContext) -> NtruSecret:
    """Samples ternary ``f'`` until ``f = 1 + t f'`` is invertible in R_q."""
    q = ctx.q_int
    for _ in range(64):
        f = (ctx.t_scale * uniform_ternary(generator, (ctx.n,))).remainder(q)
        f[0] = (f[0] + 1) % q
        sk = ntru_secret(ctx, f)
        if sk is not None:
            return sk
    raise RuntimeError("no invertible NTRU secret found (q too small?)")


def ntru_encrypt_poly(generator, ctx: NtruContext, sk: NtruSecret, mu, gaussian: DiscreteGaussian):
    """``c = g/f + mu`` with Gaussian ``g`` (``mu``: ``(..., N)`` mod q)."""
    g = gaussian.sample_mod(generator, mu.shape, ctx.q_int)
    gf = from_ntt(lazy_mul32(to_ntt(g, ctx.ntt), sk.f_inv_ntt, ctx.m), ctx.ntt)
    return add32(gf, mu, ctx.q_int)


def ngs_encrypt_bit(generator, ctx: NtruContext, sk: NtruSecret, bit, gaussian):
    """NGS ciphertexts of bits ``bit (...)``: ``(..., L, N)`` coefficient
    rows ``g_j/f + B^j 2^drop bit``, aligned with the gadget scalars of
    ``ctx.basis``."""
    q = ctx.q_int
    bit = torch.as_tensor(bit, dtype=torch.int64, device=sk.f.device)
    scal = torch.tensor([s % q for s in ctx.basis.scalars], dtype=torch.int64, device=bit.device)
    mu = torch.zeros(tuple(bit.shape) + (scal.shape[0], ctx.n), dtype=torch.int64,
                     device=bit.device)
    mu[..., 0] = (bit.unsqueeze(-1) * scal) % q
    return ntru_encrypt_poly(generator, ctx, sk, mu, gaussian)


def make_ntru_bootstrap_key(generator, ctx, sk, lwe_secret, gaussian):
    """EVK_i = NGS(s_i) in NTT form, ``(n_lwe, L, N)``; ``gaussian`` at the
    NTRU-side sigma."""
    return to_ntt(ngs_encrypt_bit(generator, ctx, sk, lwe_secret, gaussian), ctx.ntt)


def make_ntru_bootstrap_key_mxu(generator, ctx, sk, lwe_secret, gaussian):
    """The same NGS material as :func:`make_ntru_bootstrap_key` (same
    generator draws) as the MXU pack ``(vals, precons)``."""
    return prepare_mxu_evk(ctx, ngs_encrypt_bit(generator, ctx, sk, lwe_secret, gaussian))


def ntru_blind_rotate(ctx: NtruContext, evk, lwe_switched, test_poly):
    """The rotated accumulator ``(..., N)`` mod q.

    ``evk``: NTT-domain ``(n_lwe, L, N)`` or the MXU pack ``(vals,
    precons)``; ``lwe_switched``: ``(..., n_lwe+1)`` int32 mod 2N;
    ``test_poly``: ``(N,)`` mod q.  ``acc = v X^{-b}``, then one CMux per
    mask element (a Python loop over the key slices).
    """
    use_mxu = isinstance(evk, (tuple, list))
    n_lwe = evk[0].shape[0] if use_mxu else evk.shape[0]
    n, q = ctx.n, ctx.q_int
    batch = lwe_switched.shape[:-1]
    sw = lwe_switched.reshape(-1, n_lwe + 1)
    acc = poly_rotate32(test_poly.to(sw.device).expand(sw.shape[0], n), -sw[:, n_lwe], q)
    a_t = sw[:, :n_lwe].t().to(torch.int32).contiguous()  # (n_lwe, B)
    if use_mxu:
        plan = get_ntru_plan(ctx.log_n, q)
        kv = narrow_u32(evk[0]).contiguous()
        kpre = narrow_u32(evk[1]).contiguous()
        acc = narrow_u32(acc)
        for i in range(n_lwe):
            acc = ntru_cmux_step(plan, ctx.basis, acc, a_t[i], kv[i], kpre[i])
        acc = widen_u32(acc)
    else:
        for i in range(n_lwe):
            acc = ntru_ntt_step(ctx.ntt, q, ctx.basis, acc, a_t[i], evk[i],
                                ntt32.forward32, ntt32.inverse32)
    return acc.reshape(*batch, n)


def extract_lwe_ntru(acc, q: int):
    """NTRU accumulator -> LWE mask under ``f`` (``b = 0``): ``(acc_0,
    -acc_{N-1}, ..., -acc_1)``."""
    return torch.cat([acc[..., :1], neg32(acc[..., 1:].flip(-1), q)], dim=-1)


def lwe_phase_q(a, f, m):
    """``sum a_j f_j mod q``."""
    return dot32(a, f.expand(a.shape), m)


def ntru_test_polynomial(n: int, q: int, delta: int, device=None) -> torch.Tensor:
    """Constant sign-test vector ``delta * sum X^i``."""
    return torch.full((n,), delta % q, dtype=torch.int64, device=device)


def modulus_switch_q(lwe_q, ctx: NtruContext, log_2n: int):
    """``round(x 2N / q) mod 2N``, exact: the int64 product ``x << log_2n``
    cannot overflow for ``q < 2^31``."""
    q = ctx.q_int
    return ((((lwe_q << log_2n) + q // 2) // q) & ((1 << log_2n) - 1)).to(torch.int32)


def make_ntru_keyswitch_key(generator, ctx, sk, secret_out, ks_basis, gaussian):
    """KSK ``(N, level, n_out+1)`` mod q: ``KSK[i, l] = LWE_s(f_i B^l 2^drop)``;
    ``gaussian`` at the LWE-side sigma."""
    q = ctx.q_int
    n_in, n_out, level = ctx.n, secret_out.shape[0], ks_basis.decompose_length
    a = sample_uniform(generator, (n_in, level, n_out), q)
    e = gaussian.sample_mod(generator, (n_in, level), q)
    scal = torch.tensor([s % q for s in ks_basis.scalars], dtype=torch.int64,
                        device=secret_out.device)
    msg = (sk.f[:, None] * scal[None, :]) % q
    b = ((a * secret_out).sum(dim=-1) + msg + e) % q
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)


def ntru_key_switch(ctx: NtruContext, lwe, ksk, ks_basis):
    """``(..., N+1)`` LWE under ``f`` -> ``(..., n_out+1)`` under ``s``:
    ``(0, b) - sum_{i,l} digit_l(a_i) KSK[i, l]`` mod q.

    The digits are centered (``|d| <= B/2``) and the contraction runs as an
    int64 multiply-sum, chunked over ``n_in`` so that the product of one
    chunk stays within a fixed budget (the whole product is about 92 MB
    per ciphertext at NTRU_128)."""
    q = ctx.q_int
    n_in, level, n_out1 = ksk.shape
    batch = lwe.shape[:-1]
    lw = lwe.reshape(-1, n_in + 1)
    digits = ks_basis.decompose(lw[:, :n_in]).permute(1, 2, 0)  # (B, n_in, level)
    digits = torch.where(digits > q // 2, digits - q, digits)
    bsz = lw.shape[0]
    chunk = max(1, min(n_in, _CHUNK_BYTES // max(1, bsz * level * n_out1 * 8)))
    acc = torch.zeros((bsz, n_out1), dtype=torch.int64, device=lwe.device)
    for i in range(0, n_in, chunk):
        acc += (digits[:, i : i + chunk, :, None] * ksk[None, i : i + chunk]).sum(dim=(1, 2))
    out = torch.zeros((bsz, n_out1), dtype=torch.int64, device=lwe.device)
    out[:, -1] = lw[:, n_in]
    return sub32(out, acc.remainder(q), q).reshape(*batch, n_out1)
