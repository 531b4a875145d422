"""GLWE samples over the 2^32 torus: ``(..., k+1, N)`` = ``[a_1..a_k; b]``
(port of ``primus_fhe_tpu/lattice/glwe.py``).

Negacyclic products go through the exact CRT-NTT convolver; on a CUDA
tensor its transforms are kernels 1 and 2.
"""

from __future__ import annotations

import torch

from ..distr.sampling import DiscreteGaussian, uniform_u32
from ..modular.modops import sum_mod32
from ..numeric.limb import MASK32
from ..transforms.torus import TorusConvolver32


def zero_sample_draws(secret: torch.Tensor, gaussian: DiscreteGaussian,
                      generator: torch.Generator, batch: tuple = ()):
    """The random draws of :func:`generate_random_zero_sample_torus`, in its
    order: the masks ``(*batch, k, N)``, then the noise ``(*batch, N)``."""
    k, n = secret.shape
    a = uniform_u32(generator, tuple(batch) + (k, n))
    e = gaussian.sample_torus32(generator, tuple(batch) + (n,))
    return a, e


def zero_samples_from(secret: torch.Tensor, conv: TorusConvolver32, a: torch.Tensor,
                      e: torch.Tensor) -> torch.Tensor:
    """GLWE encryptions of zero ``(*batch, k+1, N)`` from their draws (masks
    ``a (*batch, k, N)``, noise ``e (*batch, N)``): ``(a_1..a_k, sum a_i s_i
    + e)``.  Each sample depends on its own draws alone, so any slice of the
    batch gives that slice's words."""
    k, n = secret.shape
    nb = a.dim() - 2
    fa = conv.forward(a)  # (kp, *batch, k, n)
    fs = conv.forward(secret)  # (kp, k, n)
    prod = conv.mul(fa, fs.reshape((conv.count,) + (1,) * nb + (k, n)))
    acc = sum_mod32(prod, conv._m(prod, nb + 1), dim=-2)  # (kp, *batch, n)
    b = (conv.recombine(conv.inverse(acc)) + e) & MASK32
    return torch.cat([a, b.unsqueeze(-2)], dim=-2)


def generate_random_zero_sample_torus(
    secret: torch.Tensor,  # (k, N) binary secret polys
    gaussian: DiscreteGaussian,
    conv: TorusConvolver32,
    generator: torch.Generator,
    batch: tuple = (),
) -> torch.Tensor:
    """GLWE encryptions of zero ``(*batch, k+1, N)``: ``(a_1..a_k,
    sum a_i s_i + e)``, all ``batch`` samples in one pass."""
    return zero_samples_from(secret, conv, *zero_sample_draws(secret, gaussian, generator, batch))


def encrypt_torus(message: torch.Tensor, secret, gaussian, conv, generator) -> torch.Tensor:
    """GLWE encryption of a torus message polynomial ``(N,)``."""
    ct = generate_random_zero_sample_torus(secret, gaussian, conv, generator)
    ct[..., -1, :] = (ct[..., -1, :] + message) & MASK32
    return ct


def phase_torus(glwe: torch.Tensor, secret: torch.Tensor, conv: TorusConvolver32):
    """``b - sum a_i s_i`` mod 2^32 — exact decryption phase."""
    a = glwe[..., :-1, :]
    b = glwe[..., -1, :]
    fa = conv.forward(a)  # (kp, ..., k, n)
    fs = conv.forward(secret)  # (kp, k, n)
    prod = conv.mul(fa, fs.reshape((conv.count,) + (1,) * (fa.dim() - 3) + tuple(secret.shape)))
    acc = sum_mod32(prod, conv._m(prod, prod.dim() - 2), dim=-2)
    return (b - conv.recombine(conv.inverse(acc))) & MASK32
