"""NTRU (NGS / FINAL-style) blind rotation, the FHEW variant (port of
``primus_fhe_tpu/boot/ntru_blind_rotate.py``).

- scalar NTRU ciphertext ``c = g/f + mu`` over ``Z_q[X]/(X^N+1)`` with
  secret ``f = 1 + t*f'`` (ternary ``f'``);
- vector NGS ciphertext of a bit ``s``: rows ``g_j/f + B^j*2^drop*s``;
- CMux chain ``acc <- acc + rot(delta, a_i) - delta`` with
  ``delta = INTT(acc ⊠ EVK_i)``, i.e. ``acc * X^{a_i s_i}``;
- extraction under ``f`` and a mod-q LWE key switch back to ``s``.

Everything is mod one NTT prime ``q < 2^30``.  The blind rotation takes
either evaluation key, the NTT-domain ``(n_lwe, L, N)`` tensor or the MXU
pack ``(vals, precons)``: the pack's values are the NTT tensor's words
(canonical, bit-reversed), so both run one loop on
:class:`~..ops.ntru_cmux_mxu.NtruStepPlan` (its route decided once a
rotation): kernel B once per key slice where it takes the shape (on the NTT
tensor with the Shoup quotients made once a rotation), else the staged step
(kernel I for the first slice, then kernels 1 and J a slice).
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
from ..ops.cmux_mxu import shoup_precons
from ..ops.ntru_cmux_mxu import NtruStepPlan, prepare_mxu_evk
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
    return ntru_encrypt_from(ctx, sk, mu, gaussian.sample_mod(generator, mu.shape, ctx.q_int))


def ntru_encrypt_from(ctx: NtruContext, sk: NtruSecret, mu, g):
    """``c = g/f + mu`` from the Gaussian draws ``g`` (``mu``, ``g``: ``(...,
    N)`` mod q).  Each row depends on its own draws alone."""
    gf = from_ntt(lazy_mul32(to_ntt(g, ctx.ntt), sk.f_inv_ntt, ctx.m), ctx.ntt)
    return add32(gf, mu, ctx.q_int)


def _ngs_messages(ctx: NtruContext, bit) -> torch.Tensor:
    """The NGS messages of bits ``bit (...)``: ``(..., L, N)`` rows, ``B^j
    2^drop bit`` in coefficient 0."""
    q = ctx.q_int
    scal = torch.tensor([s % q for s in ctx.basis.scalars], dtype=torch.int64, device=bit.device)
    mu = torch.zeros(tuple(bit.shape) + (scal.shape[0], ctx.n), dtype=torch.int64,
                     device=bit.device)
    mu[..., 0] = (bit.unsqueeze(-1) * scal) % q
    return mu


def ngs_encrypt_bit(generator, ctx: NtruContext, sk: NtruSecret, bit, gaussian):
    """NGS ciphertexts of bits ``bit (...)``: ``(..., L, N)`` coefficient
    rows ``g_j/f + B^j 2^drop bit``, aligned with the gadget scalars of
    ``ctx.basis``."""
    bit = torch.as_tensor(bit, dtype=torch.int64, device=sk.f.device)
    return ntru_encrypt_poly(generator, ctx, sk, _ngs_messages(ctx, bit), gaussian)


EVK_CHUNK_WORDS = 1 << 27  # words of a chunk of the evaluation key (1 GB of int64)


def make_ntru_evks(generator, ctx, sk, lwe_secret, gaussian, ntt: bool = True,
                   mxu: bool = False):
    """EVK_i = NGS(s_i) for every LWE key bit, ``(evk, evk_mxu)``: with
    ``ntt`` the NTT-domain rows ``(n_lwe, L, N)``, with ``mxu`` the MXU pack
    ``(vals, precons)`` (:func:`~..ops.ntru_cmux_mxu.prepare_mxu_evk`,
    ``log_n >= 8``); a form not asked for is None.  ``gaussian`` at the
    NTRU-side sigma.

    The Gaussian draws of all ``n_lwe`` NGS encryptions are taken in one
    batch, in :func:`ngs_encrypt_bit`'s order; the encryptions and the
    transforms then run on chunks of LWE indices of at most
    :data:`EVK_CHUNK_WORDS` key words each (at least one index), written into
    preallocated keys.  Each row depends on its own draws alone, so the keys
    are the one-batch keys word for word; the working set is a chunk's, not
    the key's (NTRU_128's whole key is one chunk; at N = 2^17 the one-batch
    transforms would pass 60 GB)."""
    bits = torch.as_tensor(lwe_secret, dtype=torch.int64, device=sk.f.device)
    n_lwe, level = bits.shape[0], ctx.basis.decompose_length
    g = gaussian.sample_mod(generator, (n_lwe, level, ctx.n), ctx.q_int)
    step = max(1, EVK_CHUNK_WORDS // (level * ctx.n))
    evk = torch.empty_like(g) if ntt else None
    pack = None
    for i in range(0, n_lwe, step):
        j = slice(i, i + step)
        c = ntru_encrypt_from(ctx, sk, _ngs_messages(ctx, bits[j]), g[j])
        if ntt:
            evk[j] = to_ntt(c, ctx.ntt)
        if mxu:
            part = prepare_mxu_evk(ctx, c)
            if pack is None:
                pack = tuple(torch.empty((n_lwe,) + tuple(x.shape[1:]), dtype=x.dtype,
                                         device=x.device) for x in part)
            for whole, x in zip(pack, part):
                whole[j] = x
    return evk, pack


def make_ntru_bootstrap_key(generator, ctx, sk, lwe_secret, gaussian):
    """EVK_i = NGS(s_i) in NTT form, ``(n_lwe, L, N)`` (:func:`make_ntru_evks`);
    ``gaussian`` at the NTRU-side sigma."""
    return make_ntru_evks(generator, ctx, sk, lwe_secret, gaussian)[0]


def make_ntru_bootstrap_key_mxu(generator, ctx, sk, lwe_secret, gaussian):
    """The same NGS material as :func:`make_ntru_bootstrap_key` (same
    generator draws) as the MXU pack ``(vals, precons)``."""
    return make_ntru_evks(generator, ctx, sk, lwe_secret, gaussian, ntt=False, mxu=True)[1]


def ntru_blind_rotate(ctx: NtruContext, evk, lwe_switched, test_poly):
    """The rotated accumulator ``(..., N)`` mod q.

    ``evk``: NTT-domain ``(n_lwe, L, N)`` or the MXU pack ``(vals,
    precons)``; ``lwe_switched``: ``(..., n_lwe+1)`` int32 mod 2N;
    ``test_poly``: ``(N,)`` mod q.  ``acc = v X^{-b}``, then one CMux per
    mask element (a Python loop over the key slices on one
    :class:`~..ops.ntru_cmux_mxu.NtruStepPlan`).  The key is narrowed to
    int32 once a rotation; where the route reads Shoup quotients (kernel B)
    and the key is the NTT tensor, they are made once a rotation on the
    key's device.
    """
    packed = isinstance(evk, (tuple, list))
    vals = evk[0] if packed else evk
    n_lwe = vals.shape[0]
    n, q = ctx.n, ctx.q_int
    batch = lwe_switched.shape[:-1]
    sw = lwe_switched.reshape(-1, n_lwe + 1)
    acc = poly_rotate32(test_poly.to(sw.device).expand(sw.shape[0], n), -sw[:, n_lwe], q)
    a_t = sw[:, :n_lwe].t().to(torch.int32).contiguous()  # (n_lwe, B)
    step = NtruStepPlan(ctx, sw.device)
    kv = narrow_u32(vals).contiguous()
    kpre = None
    if step.reads_precons:
        kpre = narrow_u32(evk[1] if packed else shoup_precons(vals, (q,), 0)).contiguous()
    acc = narrow_u32(acc).contiguous()
    for i in range(n_lwe):
        acc = step(acc, a_t[i], kv[i], None if kpre is None else kpre[i])
    return widen_u32(acc).reshape(*batch, n)


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
    ``gaussian`` at the LWE-side sigma.  The masks' inner products run on
    chunks of input coefficients (at N = 2^17 and NTRU_128's levels the
    masks alone are 11.8 GB)."""
    q = ctx.q_int
    n_in, n_out, level = ctx.n, secret_out.shape[0], ks_basis.decompose_length
    a = sample_uniform(generator, (n_in, level, n_out), q)
    e = gaussian.sample_mod(generator, (n_in, level), q)
    scal = torch.tensor([s % q for s in ks_basis.scalars], dtype=torch.int64,
                        device=secret_out.device)
    ksk = torch.empty((n_in, level, n_out + 1), dtype=torch.int64, device=a.device)
    ksk[..., :n_out] = a
    chunk = max(1, _CHUNK_BYTES // (level * n_out * 8))
    for i in range(0, n_in, chunk):
        j = slice(i, i + chunk)
        msg = (sk.f[j, None] * scal[None, :]) % q
        ksk[j, :, n_out] = ((a[j] * secret_out).sum(dim=-1) + msg + e[j]) % q
    return ksk


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
