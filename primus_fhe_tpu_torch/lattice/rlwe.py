"""RLWE samples ``(..., 2, N)`` = ``[a; b]`` (port of
``primus_fhe_tpu/lattice/rlwe.py``): over a prime ``q`` (zero samples,
encryption, phase, LWE extraction, ``coeff.rs:58-264``) and over the 2^32
torus (:func:`extract_lwe_torus32`).

The prime-q transforms take the prime's one-prime
:class:`~..ops.ntt32.NttTables32` (``NttTables32(log_n, (q,))``), as the
NTRU layer does: a CUDA tensor runs kernels 1-2, a CPU tensor their plain
versions.  ``secret_ntt`` is the secret in that NTT form (bit-reversed,
canonical), the same words as the reference's ``forward32(plan, s)``.
"""

from __future__ import annotations

import torch

from ..distr.sampling import DiscreteGaussian, sample_uniform
from ..modular import modops
from ..modular.modulus import BarrettModulus32
from ..numeric.limb import MASK32
from ..ops.ntt32 import NttTables32
from ..poly.poly import poly_rotate32
from .ntru import from_ntt, to_ntt


def generate_random_zero_sample32(secret_ntt: torch.Tensor, gaussian: DiscreteGaussian,
                                  tables: NttTables32, m: BarrettModulus32, q: int,
                                  generator: torch.Generator) -> torch.Tensor:
    """RLWE encryption of zero ``(2, N)``: ``(a, a*s + e)`` with ``a``
    uniform mod q (coeff.rs:92-121)."""
    a = sample_uniform(generator, (tables.n,), q)
    b = from_ntt(modops.mul32(to_ntt(a, tables), secret_ntt, m), tables)
    e = gaussian.sample_mod(generator, (tables.n,), q)
    return torch.stack([a, modops.add32(b, e, q)], dim=-2)


def encrypt32(message: torch.Tensor, secret_ntt, gaussian, tables, m, q: int,
              generator: torch.Generator) -> torch.Tensor:
    """RLWE encryption of a canonical message polynomial ``(N,)``."""
    ct = generate_random_zero_sample32(secret_ntt, gaussian, tables, m, q, generator)
    ct[..., 1, :] = modops.add32(ct[..., 1, :], message, q)
    return ct


def phase32(rlwe: torch.Tensor, secret_ntt: torch.Tensor, tables: NttTables32,
            m: BarrettModulus32) -> torch.Tensor:
    """``b - a*s`` mod q, canonical: the decryption phase."""
    prod = from_ntt(modops.mul32(to_ntt(rlwe[..., 0, :], tables), secret_ntt, m), tables)
    return modops.sub32(rlwe[..., 1, :], prod, m.value)


def extract_lwe32(rlwe: torch.Tensor, q) -> torch.Tensor:
    """The LWE sample of coefficient 0: ``a'_0 = a_0``, ``a'_j = -a_{n-j}``
    for j >= 1, ``b' = b_0``."""
    return extract_first_few_lwe32(rlwe, 1, q)


def extract_lwe_with_index32(rlwe: torch.Tensor, index, q) -> torch.Tensor:
    """The LWE sample of coefficient ``index`` (coeff.rs:194-229).

    A Python int slices; a tensor (broadcasting against the batch axes)
    takes ``extract_i(a, b) = extract_0(a X^-i, b X^-i)`` through the
    negacyclic rotation.  Both give the same words.
    """
    a = rlwe[..., 0, :]
    b = rlwe[..., 1, :]
    if isinstance(index, int):
        head = a[..., : index + 1].flip(-1)
        tail = modops.neg32(a[..., index + 1 :].flip(-1), q)
        return torch.cat([head, tail, b[..., index : index + 1]], dim=-1)
    d = -torch.as_tensor(index, device=a.device)
    return extract_lwe32(torch.stack([poly_rotate32(a, d, q), poly_rotate32(b, d, q)], dim=-2),
                         q)


def extract_first_few_lwe32(rlwe: torch.Tensor, count: int, q) -> torch.Tensor:
    """A multi-message LWE ``|a'(n)|b(count)|`` (coeff.rs:232)."""
    a = rlwe[..., 0, :]
    tail = modops.neg32(a[..., 1:].flip(-1), q)
    return torch.cat([a[..., :1], tail, rlwe[..., 1, :count]], dim=-1)


def mul_ntt_polynomial32(rlwe: torch.Tensor, ntt_poly: torch.Tensor, tables: NttTables32,
                         m: BarrettModulus32) -> torch.Tensor:
    """``NTT(self) * ntt_poly`` per component (coeff.rs:168-190): the
    NTT-domain RLWE."""
    return modops.mul32(to_ntt(rlwe, tables), ntt_poly, m)


def extract_lwe_torus32(rlwe: torch.Tensor) -> torch.Tensor:
    """Coefficient 0 of ``(..., 2, N)`` ``[a; b]`` over the 2^32 torus as an
    LWE ``(..., N+1)``: ``a'_0 = a_0``, ``a'_j = -a_{N-j}`` for j >= 1,
    ``b' = b_0``."""
    a = rlwe[..., 0, :]
    b = rlwe[..., 1, :]
    tail = (-a[..., 1:].flip(-1)) & MASK32
    return torch.cat([a[..., :1], tail, b[..., :1]], dim=-1)
