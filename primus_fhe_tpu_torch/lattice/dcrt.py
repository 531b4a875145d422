"""DCRT (RNS + NTT domain) gadget products and GLWE/GGSW encryption (port of
``primus_fhe_tpu/lattice/dcrt.py``).

Per decomposition level (the reference's pipeline, SURVEY.md §3.4)::

    compose residues -> big ints        (once, before the level loop)
    unsigned digit + carry per level    (multi-limb window)
    centred re-spread into all moduli   (wrapping_decompose_small)
    NTT per modulus                     (dcrt_forward64_fast)
    pointwise modular multiply-add      (mul64, summed mod q)

Layouts (int64 tensors of u64 words):

- ``CrtGlwe``  coefficient domain: ``(count, ..., k+1, N)``
- ``DcrtGlwe`` NTT domain:         ``(count, ..., k+1, N)``
- ``DcrtGlev`` NTT domain:         ``(L, count, k+1, N)``
- ``DcrtGgsw`` NTT domain:         ``(k+1, L, count, k+1, N)``

Where the reference loops over rows and levels with one transform per
(row, level), :func:`crt_glwe_mul_dcrt_ggsw` decomposes every row at once
and runs ONE forward transform over all ``k+1`` rows, ``L`` levels and the
batch, then one broadcast multiply and one modular sum: the same canonical
words with one kernel launch.  The transforms take ``route`` (see
:mod:`..transforms.dcrt`); encryption also runs the routed transforms, whose
canonical outputs equal the reference's plain ones.  Randomness comes from
an explicit ``torch.Generator`` (not bit-equal to ``jax.random``), and key
generation is batched: :func:`dcrt_ggsw_encrypt` encrypts a whole batch of
GGSWs in one pass.
"""

from __future__ import annotations

import torch

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..distr.sampling import sample_binary, sample_uniform_u64
from ..modular.modops import add64, mul64, sub64, sum_mod64
from ..numeric.limb import u64_tensor
from ..rns.base import RNSBase64
from ..transforms.dcrt import DcrtPlan64, dcrt_forward64_fast, dcrt_inverse64_fast


def gadget_ntt_big(big: torch.Tensor, basis: BigUintApproxSignedBasis, plan: DcrtPlan64,
                   rns_base: RNSBase64, route: str = "auto") -> torch.Tensor:
    """Big integers mod Q ``(..., N, L)`` -> the NTT-domain residues of every
    gadget digit under the moduli of ``plan`` and ``rns_base`` (all of Q's,
    or a residue shard's), ``(count, L, ..., N)``: digits, centred re-spread,
    one forward transform launch."""
    digits = basis.unsigned_decompose(big)  # (L, ..., N)
    residues = rns_base.wrapping_decompose_small(digits, basis.basis)
    return dcrt_forward64_fast(plan, residues.contiguous(), 1, route)


def gadget_ntt(crt_poly: torch.Tensor, basis: BigUintApproxSignedBasis, plan: DcrtPlan64,
               rns_base: RNSBase64, route: str = "auto") -> torch.Tensor:
    """Coefficient-domain residues ``(count, ..., N)`` -> the NTT-domain
    residues of every gadget digit, ``(count, L, ..., N)``."""
    return gadget_ntt_big(rns_base.compose(crt_poly), basis, plan, rns_base, route)


def add_dcrt_glev_mul_crt_poly(acc, glev, crt_poly, basis: BigUintApproxSignedBasis,
                               plan: DcrtPlan64, rns_base: RNSBase64, route: str = "auto"):
    """``acc += glev * gadget_decompose(crt_poly)`` (dcrt.rs:178-260).

    ``acc (count, ..., k+1, N)`` NTT domain, ``glev (L, count, k+1, N)``
    shared across the batch dims, ``crt_poly (count, ..., N)``."""
    f = gadget_ntt(crt_poly, basis, plan, rns_base, route)  # (count, L, ..., N)
    extra = crt_poly.dim() - 2
    L, count, k1, n = glev.shape
    g = glev.transpose(0, 1).reshape((count, L) + (1,) * extra + (k1, n))
    m = rns_base.modulus_bc(extra + 3, acc.device)
    prod = sum_mod64(mul64(g, f.unsqueeze(-2), m), m.map(lambda x: x.squeeze(1)), dim=1)
    return add64(acc, prod, m.value.squeeze(1))


def crt_glwe_mul_dcrt_ggsw(crt_glwe, ggsw, basis: BigUintApproxSignedBasis, plan: DcrtPlan64,
                           rns_base: RNSBase64, route: str = "auto"):
    """External product in the RNS domain (crt.rs:200): ``crt_glwe (count,
    ..., k+1, N)`` coefficient domain times ``ggsw (k+1, L, count, k+1, N)``
    -> a DcrtGlwe ``(count, ..., k+1, N)`` in the NTT domain."""
    return dcrt_ggsw_mac(gadget_ntt(crt_glwe, basis, plan, rns_base, route), ggsw, rns_base)


def dcrt_ggsw_mac(f, ggsw, rns_base: RNSBase64):
    """The external product's multiply-accumulate: gadget digits ``f (count,
    L, ..., k+1, N)`` (:func:`gadget_ntt`) times ``ggsw (k+1, L, count, k+1,
    N)``, summed over rows and levels mod q -> ``(count, ..., k+1, N)``."""
    extra = f.dim() - 4
    k1, L, count, _, n = ggsw.shape
    g = ggsw.permute(2, 1, 0, 3, 4).reshape((count, L) + (1,) * extra + (k1, k1, n))
    m = rns_base.modulus_bc(extra + 4, f.device)
    prod = mul64(g, f.unsqueeze(-2), m)  # (count, L, ..., row, comp, N)
    prod = prod.movedim(1, -3).flatten(-4, -3)  # (count, ..., L * row, comp, N)
    return sum_mod64(prod, rns_base.modulus_bc(extra + 2, f.device), dim=-3)


def _poly_bc(dcrt_poly: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """A DCRT polynomial ``(count, N)`` shaped to broadcast against ``acc
    (count, ..., N)``."""
    return dcrt_poly.reshape(dcrt_poly.shape[:1] + (1,) * (acc.dim() - 2) + dcrt_poly.shape[1:])


def dcrt_glwe_mul_poly(acc, dcrt_poly, rns_base: RNSBase64):
    """``acc * poly`` pointwise per modulus (dcrt.rs:108): ``acc (count, ...,
    k+1, N)`` times ``dcrt_poly (count, N)``, both NTT domain, canonical."""
    m = rns_base.modulus_bc(acc.dim() - 1, acc.device)
    return mul64(acc, _poly_bc(dcrt_poly, acc), m)


def dcrt_glwe_butterfly_mul(a, rhs, dcrt_poly, rns_base: RNSBase64):
    """``(a + rhs, (a - rhs) * poly)`` per modulus: the CMux-shaped inverse
    butterfly of dcrt.rs:130-150, shapes as in :func:`dcrt_glwe_mul_poly`."""
    m = rns_base.modulus_bc(a.dim() - 1, a.device)
    return add64(a, rhs, m.value), mul64(sub64(a, rhs, m.value), _poly_bc(dcrt_poly, a), m)


def dcrt_glwe_secret(generator: torch.Generator, k: int, plan: DcrtPlan64, route: str = "auto"):
    """A binary GLWE secret: ``(coefficients (k, N), NTT domain (count, k,
    N))``, the same polynomial under every modulus."""
    s = sample_binary(generator, (k, plan.n))
    return s, dcrt_forward64_fast(plan, s[None].expand(plan.count, k, plan.n).contiguous(), 1,
                                  route)


def dcrt_glwe_zero_sample(generator: torch.Generator, secret_ntt, gaussian, plan: DcrtPlan64,
                          rns_base: RNSBase64, batch=(), route: str = "auto"):
    """DcrtGlwe encryptions of zero in the NTT domain, ``(*batch, count, k+1,
    N)``: ``(a_1..a_k, sum a_i s_i + e)``.  Masks are uniform per modulus
    (uniform mod Q by the CRT bijection); the noise is sampled once and
    centred into every modulus (CRT-replicated, ``src/common.rs:129-350``)."""
    count, k, n = secret_ntt.shape
    batch = tuple(batch)
    dev = secret_ntt.device
    a = torch.stack([sample_uniform_u64(generator, batch + (k, n), q) for q in plan.moduli])
    fa = dcrt_forward64_fast(plan, a, 1, route)  # (count, *batch, k, N)
    nb = len(batch)
    m = rns_base.modulus_bc(nb + 2, dev)
    m_out = rns_base.modulus_bc(nb + 1, dev)
    s = secret_ntt.reshape((count,) + (1,) * nb + (k, n))
    acc = sum_mod64(mul64(fa, s, m), m_out, dim=-2)  # (count, *batch, N)
    b = dcrt_inverse64_fast(plan, acc, 1, route)
    e = gaussian.sample_signed(generator, batch + (n,))
    q = m_out.value
    b = add64(b, torch.where(e < 0, q + e, e), q)
    body = dcrt_forward64_fast(plan, b, 1, route)
    out = torch.cat([fa, body.unsqueeze(-2)], dim=-2)
    return out.movedim(0, nb)


def dcrt_glwe_phase(glwe_ntt, secret_ntt, plan: DcrtPlan64, rns_base: RNSBase64,
                    route: str = "auto"):
    """``b - sum a_i s_i`` per modulus in the coefficient domain: ``glwe_ntt
    (count, ..., k+1, N)`` -> ``(count, ..., N)``."""
    count, k, n = secret_ntt.shape
    extra = glwe_ntt.dim() - 3
    m = rns_base.modulus_bc(extra + 2, glwe_ntt.device)
    m_out = rns_base.modulus_bc(extra + 1, glwe_ntt.device)
    s = secret_ntt.reshape((count,) + (1,) * extra + (k, n))
    acc = sum_mod64(mul64(glwe_ntt[..., :k, :], s, m), m_out, dim=-2)
    diff = sub64(glwe_ntt[..., k, :], acc, m_out.value)
    return dcrt_inverse64_fast(plan, diff, 1, route)


def dcrt_ggsw_encrypt(generator: torch.Generator, mu, secret_ntt, basis: BigUintApproxSignedBasis,
                      gaussian, plan: DcrtPlan64, rns_base: RNSBase64, batch=(),
                      route: str = "auto"):
    """DcrtGgsw(mu), ``(*batch, k+1, L, count, k+1, N)`` NTT domain: row
    ``r`` level ``l`` is a zero sample plus ``mu * B^l 2^drop`` on component
    ``r`` (a constant polynomial, constant across NTT slots).  ``mu`` is a
    small non-negative int or an int64 tensor of shape ``batch`` (the
    bootstrap key's secret bits)."""
    count, k, n = secret_ntt.shape
    batch = tuple(batch)
    L = basis.decompose_length
    z = dcrt_glwe_zero_sample(generator, secret_ntt, gaussian, plan, rns_base,
                              batch + (k + 1, L), route)
    dev = secret_ntt.device
    scal = u64_tensor(basis.scalars_residue_ints, dev)  # (L, count)
    m = rns_base.tables(dev)["modulus"]  # (count,)
    mu = torch.as_tensor(mu, dtype=torch.int64, device=dev).reshape(batch + (1, 1))
    const = mul64(torch.remainder(mu, m.value), scal, m)  # (*batch, L, count)
    for r in range(k + 1):
        z[..., r, :, :, r, :] = add64(z[..., r, :, :, r, :], const.unsqueeze(-1),
                                      m.value.reshape(count, 1))
    return z
