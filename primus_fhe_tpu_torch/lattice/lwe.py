"""LWE samples ``(..., n+1)`` laid out ``|a (n)|b (1)|`` over the 2^32 torus
(port of the torus part of ``primus_fhe_tpu/lattice/lwe.py``)."""

from __future__ import annotations

import torch

from ..distr.sampling import uniform_u32
from ..numeric.limb import MASK32


def phase_torus32(lwe: torch.Tensor, secret: torch.Tensor) -> torch.Tensor:
    """Decryption phase ``b - <a, s> mod 2^32``.

    Secret entries are small (binary), so each product stays below 2^33
    and the int64 sum is exact before the final mask.
    """
    n = secret.shape[-1]
    dot = (lwe[..., :n] * secret).sum(dim=-1)
    return (lwe[..., n] - dot) & MASK32


def encrypt_torus32(mu: torch.Tensor, secret: torch.Tensor, gaussian,
                    generator: torch.Generator) -> torch.Tensor:
    """Fresh LWE encryptions of torus messages ``mu (...)`` under ``secret
    (n,)``: ``a`` uniform, ``b = <a, s> + mu + e`` with ``e`` from
    ``gaussian`` (the context's LWE-side sampler, at lwe_sigma)."""
    n = secret.shape[-1]
    a = uniform_u32(generator, tuple(mu.shape) + (n,))
    e = gaussian.sample_torus32(generator, mu.shape)
    b = ((a * secret).sum(dim=-1) + mu + e) & MASK32
    return torch.cat([a, b.unsqueeze(-1)], dim=-1)
