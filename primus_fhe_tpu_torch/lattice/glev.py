"""GLev / RLev / GGSW / RGSW construction over a prime modulus (port of
``primus_fhe_tpu/lattice/glev.py``; reference containers
``crates/primus_lattice/src/{glev,rlev,ggsw,rgsw}``).

Layouts (leading batch axes allowed):

- GLev ``(L, k+1, N)``  — level ``l`` is a GLWE of ``m * B^l * 2^drop``
- RLev = GLev with k=1 (``(L, 2, N)``)
- GGSW ``(k+1, L, k+1, N)`` — row ``r`` is a GLev "aimed" at component r
- RGSW = GGSW with k=1

The transforms take the prime's one-prime
:class:`~..ops.ntt32.NttTables32` (kernels 1-2 on a CUDA tensor);
``secret_ntt (k, N)`` is the secret in that NTT form.  The torus variants
live in :mod:`.tfhe`.
"""

from __future__ import annotations

import torch

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian, sample_uniform
from ..modular import modops
from ..modular.modulus import BarrettModulus32
from ..ops.ntt32 import NttTables32
from .ntru import from_ntt, to_ntt


def _glwe_zero_sample32(secret_ntt: torch.Tensor, gaussian: DiscreteGaussian,
                        tables: NttTables32, m: BarrettModulus32, q: int,
                        generator: torch.Generator) -> torch.Tensor:
    """GLWE(0) over prime q ``(k+1, N)``: ``(a_1..a_k, sum a_i s_i + e)``."""
    k, n = secret_ntt.shape
    a = sample_uniform(generator, (k, n), q)
    prods = modops.mul32(to_ntt(a, tables), secret_ntt, m)
    b = from_ntt(modops.sum_mod32(prods, m, dim=0), tables)
    e = gaussian.sample_mod(generator, (n,), q)
    return torch.cat([a, modops.add32(b, e, q).unsqueeze(0)], dim=0)


def glev_encrypt32(message: torch.Tensor, secret_ntt: torch.Tensor,
                   basis: ApproxSignedBasis32, gaussian: DiscreteGaussian, tables: NttTables32,
                   m: BarrettModulus32, q: int, generator: torch.Generator) -> torch.Tensor:
    """GLev(m) ``(L, k+1, N)``: level l = GLWE(0) + ``m * B^l * 2^drop``
    on the body, for a canonical message ``(N,)``."""
    rows = []
    for scal in basis.scalars:
        z = _glwe_zero_sample32(secret_ntt, gaussian, tables, m, q, generator)
        z[-1] = modops.add32(z[-1], modops.mul32(message, scal % q, m), q)
        rows.append(z)
    return torch.stack(rows)


def rlev_encrypt32(message, secret_ntt, basis, gaussian, tables, m, q, generator):
    """RLev = GLev with a single mask polynomial (k = 1)."""
    if secret_ntt.shape[0] != 1:
        raise ValueError("an RLev takes one secret polynomial (k = 1)")
    return glev_encrypt32(message, secret_ntt, basis, gaussian, tables, m, q, generator)


def ggsw_encrypt32(message: torch.Tensor, secret_ntt: torch.Tensor,
                   basis: ApproxSignedBasis32, gaussian: DiscreteGaussian, tables: NttTables32,
                   m: BarrettModulus32, q: int, generator: torch.Generator) -> torch.Tensor:
    """GGSW(m) ``(k+1, L, k+1, N)``: row r level l = GLWE(0) + ``m * B^l *
    2^drop`` at component r."""
    k = secret_ntt.shape[0]
    rows = []
    for r in range(k + 1):
        for scal in basis.scalars:
            z = _glwe_zero_sample32(secret_ntt, gaussian, tables, m, q, generator)
            z[r] = modops.add32(z[r], modops.mul32(message, scal % q, m), q)
            rows.append(z)
    return torch.stack(rows).reshape(k + 1, basis.decompose_length, k + 1, -1)


def rgsw_encrypt32(message, secret_ntt, basis, gaussian, tables, m, q, generator):
    """RGSW = GGSW with k = 1 (``src/rgsw/mod.rs``)."""
    if secret_ntt.shape[0] != 1:
        raise ValueError("an RGSW takes one secret polynomial (k = 1)")
    return ggsw_encrypt32(message, secret_ntt, basis, gaussian, tables, m, q, generator)


def glwe_phase32(glwe: torch.Tensor, secret_ntt: torch.Tensor, tables: NttTables32,
                 m: BarrettModulus32) -> torch.Tensor:
    """``b - sum a_i s_i`` mod q, canonical."""
    k = secret_ntt.shape[0]
    prods = modops.mul32(to_ntt(glwe[..., :k, :], tables), secret_ntt, m)
    acc = modops.sum_mod32(prods, m, dim=-2)
    return modops.sub32(glwe[..., k, :], from_ntt(acc, tables), m.value)
