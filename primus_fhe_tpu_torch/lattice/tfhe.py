"""TFHE external product — exact CRT-NTT backend (port of
``primus_fhe_tpu/lattice/tfhe.py``).

Signed gadget decomposition, per-digit forward transform,
multiply-accumulate against the GGSW rows, one inverse transform and the
integer CRT: the result carries no transform noise.

Shapes (torus words):
- ``glwe``:     ``(B..., k+1, N)``
- ``key``:      coeff ``(k+1, L, k+1, N)``; NTT form ``(kp, k+1, L, k+1, N)``
- ``output``:   ``(B..., k+1, N)``
"""

from __future__ import annotations

import math

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian
from ..modular.modops import lazy_mul32, reduce_once32, sum_mod32
from ..numeric.limb import MASK32
from ..ops import ntt32
from ..ops.rotate import rotate
from ..transforms.torus import TorusConvolver32


def external_product_bound_bits(n: int, level: int, k: int, log_basis: int) -> int:
    """Proven bound on the centered convolution accumulator magnitude:
    ``|acc| <= n * level * (k+1) * (B/2) * 2^31``."""
    return 31 + (log_basis - 1) + math.ceil(math.log2(n * level * (k + 1))) + 1


def make_convolver(n_log: int, level: int, k: int, log_basis: int) -> TorusConvolver32:
    return TorusConvolver32(n_log, external_product_bound_bits(1 << n_log, level, k, log_basis))


def ggsw_to_ntt(conv: TorusConvolver32, ggsw_coeff: torch.Tensor) -> torch.Tensor:
    """Coefficient GGSW ``(k+1, L, k+1, N)`` -> NTT residues ``(kp, k+1, L,
    k+1, N)`` (convert.rs; kernel 1 on a CUDA tensor)."""
    return conv.forward(ggsw_coeff)


def external_product(conv: TorusConvolver32, basis: ApproxSignedBasis32, glwe, key_ntt):
    """``glwe ⊡ key`` (external_product.rs:36-93), exact.

    ``glwe``: ``(B..., k+1, N)``; ``key_ntt``: ``(kp, k+1, L, k+1, N)``.
    """
    batch = glwe.shape[:-2]
    digits = basis.decompose(glwe).movedim(0, -2)  # (B..., k+1, L, N)
    f = conv.forward(digits)  # (kp, B..., k+1, L, N)
    return _external_product_tail(conv, f, key_ntt, len(batch))


def external_product_mac(conv: TorusConvolver32, f, key_ntt, nbatch: int):
    """Gadget MAC in the NTT domain: ``f (kp, B..., k1, L, N)`` digit
    residues (canonical or lazy ``[0, 4p)``) x ``key (kp, k1, L, k1, N)``
    -> canonical ``(kp, B..., k1, N)``.

    Every term is reduced to ``[0, p)``; int64 sums the k1*L terms exactly
    and one Barrett pass reduces the sum, so the result is the canonical
    residue whatever the order of the terms.
    """
    kp = conv.count
    k1, level, k1b, n = key_ntt.shape[1:]
    key_b = key_ntt.reshape((kp,) + (1,) * nbatch + (k1, level, k1b, n))
    m = conv._m(f, nbatch + 2)
    terms = [
        reduce_once32(lazy_mul32(f[..., r, l, None, :], key_b[..., r, l, :, :], m), m.value)
        for r in range(k1)
        for l in range(level)
    ]
    return sum_mod32(torch.stack(terms), m, dim=0)


def _external_product_tail(conv, f, key_ntt, nbatch: int):
    """MAC + inverse NTT + CRT recombine."""
    return conv.recombine(conv.inverse(external_product_mac(conv, f, key_ntt, nbatch)))


def cmux_delta(conv: TorusConvolver32, basis: ApproxSignedBasis32, acc, degrees, key_ntt):
    """``(acc * X^d - acc) ⊡ key`` — one blind-rotation step's increment.

    ``acc``: ``(B, k1, N)`` torus words; ``degrees``: ``(B,)`` (any sign,
    mod 2N); ``key_ntt``: ``(kp, k1, L, k1, N)``.  On a CUDA tensor kernel G
    (:func:`..ops.cmux_front.cmux_front`) builds the digit residues and
    kernel 1 transforms them; on the CPU the composed path (rotation, then
    :func:`external_product`) runs.  Both give the same words.
    """
    if acc.device.type == "cuda":
        from ..ops.cmux_front import cmux_front  # a cycle at import: via ops.cmux_fused

        res = cmux_front(acc, degrees, basis, conv.primes)  # (kp, B, k1, L, N)
        return _external_product_tail(conv, ntt32.forward32(conv.ntt, res, 4), key_ntt, 1)
    return external_product(conv, basis, rotate(acc, degrees, subtract=True), key_ntt)


def ggsw_encrypt_torus(
    mu,  # (*batch, N) torus message polys, or a Python int (constant poly)
    secret: torch.Tensor,  # (k, N)
    basis: ApproxSignedBasis32,
    gaussian: DiscreteGaussian,
    conv: TorusConvolver32,
    generator: torch.Generator,
):
    """GGSW(mu) ``(*batch, k+1, L, k+1, N)``: row r, level l is a GLWE(0)
    plus ``mu * B^l * 2^drop`` at component r (the gadget layout of
    tfhe/external_product.rs:64)."""
    from .glwe import generate_random_zero_sample_torus

    k, n = secret.shape
    level = basis.decompose_length
    if isinstance(mu, int):
        mu_poly = torch.zeros(n, dtype=torch.int64, device=secret.device)
        mu_poly[0] = mu & MASK32
    else:
        mu_poly = mu
    batch = tuple(mu_poly.shape[:-1])
    zs = generate_random_zero_sample_torus(
        secret, gaussian, conv, generator, batch + (k + 1, level)
    )  # (*batch, k+1, L, k+1, N)
    scal = torch.tensor([s & MASK32 for s in basis.scalars], dtype=torch.int64,
                        device=secret.device)
    contrib = (mu_poly.unsqueeze(-2) * scal[:, None]) & MASK32  # (*batch, L, N)
    eye = torch.eye(k + 1, dtype=torch.int64, device=secret.device)  # (row r, component j)
    inj = eye[:, None, :, None] * contrib.unsqueeze(-3).unsqueeze(-2)  # (*batch, k+1, L, k+1, N)
    return (zs + inj) & MASK32
