"""LWE samples ``(..., n+1)`` laid out ``|a (n)|b (1)|`` (port of
``primus_fhe_tpu/lattice/lwe.py``): over the 2^32 torus, and over a prime
``q`` (``phase32``, ``add32``).  A multi-message sample is ``|a (n)|b
(count)|`` (``multiple_message.rs``).

The LWE :func:`add32` is the sample's homomorphic addition; it is
:func:`..modular.modops.add32` on whole samples, which this module reaches
as ``modops.add32`` so that the two names stay apart.
"""

from __future__ import annotations

import torch

from ..distr.sampling import uniform_u32
from ..modular import modops
from ..modular.modulus import BarrettModulus32
from ..numeric.limb import MASK32, mul_lo_u32


def a(lwe: torch.Tensor, n: int) -> torch.Tensor:
    return lwe[..., :n]


def b(lwe: torch.Tensor, n: int) -> torch.Tensor:
    return lwe[..., n:]


def _dot_torus32(x: torch.Tensor, secret: torch.Tensor) -> torch.Tensor:
    """``<x, s> mod 2^32`` over the last axis: each product taken mod 2^32
    first (a ternary secret's -1 is the word 2^32 - 1), so the int64 sum of
    up to 2^31 terms is exact."""
    return mul_lo_u32(x, secret).sum(dim=-1) & MASK32


def phase_torus32(lwe: torch.Tensor, secret: torch.Tensor) -> torch.Tensor:
    """Decryption phase ``b - <a, s> mod 2^32``."""
    n = secret.shape[-1]
    return (lwe[..., n] - _dot_torus32(lwe[..., :n], secret)) & MASK32


def phase32(lwe: torch.Tensor, secret: torch.Tensor, m: BarrettModulus32) -> torch.Tensor:
    """Decryption phase ``b - <a, s> mod q`` (prime-q path), canonical."""
    n = secret.shape[-1]
    dot = modops.dot32(lwe[..., :n], secret, m)
    return modops.sub32(lwe[..., n], dot, m.value)


def add32(x: torch.Tensor, y: torch.Tensor, q) -> torch.Tensor:
    """Homomorphic addition of LWE samples mod prime ``q``."""
    return modops.add32(x, y, q)


def add_torus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x + y) & MASK32


def sub_torus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y) & MASK32


def multi_msg_phase_torus32(lwe: torch.Tensor, secret: torch.Tensor, count: int) -> torch.Tensor:
    """Phases ``b_j - <a, s>`` mod 2^32 of a multi-message LWE ``|a (n)|b
    (count)|`` with one shared secret (multiple_message.rs:250-267)."""
    n = secret.shape[-1]
    dot = _dot_torus32(lwe[..., :n], secret)
    return (lwe[..., n : n + count] - dot.unsqueeze(-1)) & MASK32


def encrypt_torus32(mu: torch.Tensor, secret: torch.Tensor, gaussian,
                    generator: torch.Generator) -> torch.Tensor:
    """Fresh LWE encryptions of torus messages ``mu (...)`` under ``secret
    (n,)``: ``a`` uniform, ``b = <a, s> + mu + e`` with ``e`` from
    ``gaussian`` (the context's LWE-side sampler, at lwe_sigma)."""
    n = secret.shape[-1]
    a_ = uniform_u32(generator, tuple(mu.shape) + (n,))
    e = gaussian.sample_torus32(generator, mu.shape)
    b_ = (_dot_torus32(a_, secret) + mu + e) & MASK32
    return torch.cat([a_, b_.unsqueeze(-1)], dim=-1)
