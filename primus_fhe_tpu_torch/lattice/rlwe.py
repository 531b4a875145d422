"""LWE sample extraction from an RLWE/GLWE sample over the 2^32 torus (port
of ``extract_lwe_torus32`` in ``primus_fhe_tpu/lattice/rlwe.py``)."""

from __future__ import annotations

import torch

from ..numeric.limb import MASK32


def extract_lwe_torus32(rlwe: torch.Tensor) -> torch.Tensor:
    """Coefficient 0 of ``(..., 2, N)`` ``[a; b]`` as an LWE ``(..., N+1)``:
    ``a'_0 = a_0``, ``a'_j = -a_{N-j}`` for j >= 1, ``b' = b_0``."""
    a = rlwe[..., 0, :]
    b = rlwe[..., 1, :]
    tail = (-a[..., 1:].flip(-1)) & MASK32
    return torch.cat([a[..., :1], tail, b[..., :1]], dim=-1)
