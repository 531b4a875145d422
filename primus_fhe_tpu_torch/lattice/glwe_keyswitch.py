"""GLWE -> GLWE key switching over the 2^32 torus and the LWE -> GLWE packing
switch (port of ``primus_fhe_tpu/lattice/glwe_keyswitch.py``).

The polynomial analogue of :mod:`.keyswitch`: each input mask polynomial is
gadget-decomposed and multiplied against a GLev encryption of the
corresponding input-secret polynomial under the output key:

    KSK_i = GLev_{s_out}( s_in_i )            (i = 1..k_in)
    out   = (0, ..., b) - sum_i decomp(a_i) ⊡ KSK_i

The digits' forward transforms and the inverse are kernels 1-2 on a CUDA
tensor.  The NTT-domain MAC over ``(k_in, L)`` is torch ops
(:func:`gadget_mac`): no TPU kernel stands behind it, and it serves the
wide sums here (``k_in = n_lwe`` for packing) and the private functional
switch of circuit bootstrapping (``n_ext + 1`` components).
"""

from __future__ import annotations

import math

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian
from ..numeric.limb import MASK32
from ..transforms.torus import TorusConvolver32
from .glwe import generate_random_zero_sample_torus

# Budget of the int64 product tensor built per chunk of input components.
_CHUNK_BYTES = 256 << 20


def gadget_mac(conv: TorusConvolver32, f: torch.Tensor, key_ntt: torch.Tensor,
               nbatch: int) -> torch.Tensor:
    """``acc[p, B..., j, n] = sum_{i,l} f[p, B..., i, l, n] key[p, i, l, j, n]
    mod p_p``, canonical ``(kp, B..., k_out+1, N)``.

    ``f``: ``(kp, B..., k_in, L, N)`` residues below 2^32 (canonical or
    lazy), or with ``N`` of size 1 for constant polynomials (one residue
    serves every NTT slot); ``key_ntt``: ``(kp, k_in, L, k_out+1, N)``
    canonical.  Chunked over ``k_in``: each product (below 2^62) is reduced
    to ``[0, p)`` and int64 sums the chunk's terms exactly; one reduction
    of the total ends.  The result is the canonical residue whatever the
    order of the terms, so it equals the reference's unrolled MAC word for
    word.
    """
    kp, k_in, level, k_out1, n = key_ntt.shape
    batch = tuple(f.shape[1 : 1 + nbatch])
    q = conv.consts(f.device)["modulus"].value.reshape((kp,) + (1,) * (nbatch + 2))
    key_b = key_ntt.reshape((kp,) + (1,) * nbatch + (k_in, level, k_out1, n))
    per_component = 8 * kp * math.prod(batch) * level * k_out1 * n
    chunk = max(1, _CHUNK_BYTES // per_component)
    acc = torch.zeros((kp,) + batch + (k_out1, n), dtype=torch.int64, device=f.device)
    for i in range(0, k_in, chunk):
        t = f[..., i : i + chunk, :, None, :] * key_b[..., i : i + chunk, :, :, :]
        acc += t.remainder_(q.unsqueeze(-1).unsqueeze(-1)).sum(dim=(-4, -3))
    return acc.remainder_(q)


def make_glwe_keyswitch_key(secret_in: torch.Tensor, secret_out: torch.Tensor,
                            basis: ApproxSignedBasis32, gaussian: DiscreteGaussian,
                            conv: TorusConvolver32, generator: torch.Generator) -> torch.Tensor:
    """KSK ``(kp, k_in, L, k_out+1, N)`` NTT residues: entry ``(i, l)``
    encrypts ``s_in_i * B^l * 2^drop`` under ``secret_out (k_out, N)``.
    ``secret_in (k_in, N)``: u32 words; every zero sample in one batch."""
    k_in, n = secret_in.shape
    level = basis.decompose_length
    zs = generate_random_zero_sample_torus(secret_out, gaussian, conv, generator,
                                           (k_in, level))  # (k_in, L, k_out+1, N)
    scal = torch.tensor([s & MASK32 for s in basis.scalars], dtype=torch.int64,
                        device=secret_in.device)
    # a word (< 2^32) times a power of two below 2^32: below 2^63
    zs[..., -1, :] += (secret_in[:, None, :] * scal[None, :, None]) & MASK32
    return conv.forward(zs & MASK32)


def glwe_key_switch(conv: TorusConvolver32, basis: ApproxSignedBasis32, glwe_in: torch.Tensor,
                    ksk_ntt: torch.Tensor) -> torch.Tensor:
    """Switches ``(B..., k_in+1, N)`` to ``(B..., k_out+1, N)``."""
    kp, k_in, level, k_out1, n = ksk_ntt.shape
    batch = tuple(glwe_in.shape[:-2])
    digits = basis.decompose(glwe_in[..., :k_in, :]).movedim(0, -2)  # (B..., k_in, L, N)
    acc = conv.recombine(conv.inverse(gadget_mac(conv, conv.forward(digits), ksk_ntt,
                                                 len(batch))))
    out = torch.zeros(batch + (k_out1, n), dtype=torch.int64, device=glwe_in.device)
    out[..., -1, :] = glwe_in[..., k_in, :]
    return (out - acc) & MASK32


# ---------------------------------------------------------------------------
# LWE -> GLWE packing key switch
# ---------------------------------------------------------------------------


def make_packing_keyswitch_key(lwe_secret: torch.Tensor, glwe_secret: torch.Tensor,
                               basis: ApproxSignedBasis32, gaussian: DiscreteGaussian,
                               conv: TorusConvolver32,
                               generator: torch.Generator) -> torch.Tensor:
    """Packing KSK: input dimension ``i`` keyed by the constant polynomial
    ``s_i`` — ``(kp, n_lwe, L, k_out+1, N)`` NTT residues."""
    s_in = torch.zeros((lwe_secret.shape[0], glwe_secret.shape[1]), dtype=torch.int64,
                       device=lwe_secret.device)
    s_in[:, 0] = lwe_secret
    return make_glwe_keyswitch_key(s_in, glwe_secret, basis, gaussian, conv, generator)


def pack_lwes(conv: TorusConvolver32, basis: ApproxSignedBasis32, lwes: torch.Tensor,
              pksk_ntt: torch.Tensor) -> torch.Tensor:
    """Packs ``count <= N`` LWE samples ``(count, n_lwe + 1)`` into one GLWE
    ``(k_out+1, N)`` encrypting ``sum_j m_j X^j`` (the standard functional
    packing key switch): the mask polynomials ``a_i(X) = sum_j a_{j,i}
    X^j`` and the body ``b(X) = sum_j b_j X^j`` go through
    :func:`glwe_key_switch`."""
    kp, n_lwe, level, k_out1, n = pksk_ntt.shape
    count = lwes.shape[0]
    if count > n:
        raise ValueError(f"at most N = {n} samples fit one GLWE, got {count}")
    glwe_in = torch.zeros((n_lwe + 1, n), dtype=torch.int64, device=lwes.device)
    glwe_in[:, :count] = lwes.t()
    return glwe_key_switch(conv, basis, glwe_in, pksk_ntt)
