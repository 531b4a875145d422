"""Shoup precomputed-multiplier factors for u32 words (port of the 32-bit
part of ``primus_fhe_tpu/modular/factor.py``).

    q_hat = hi(w_precon * y)
    r     = w * y - q * q_hat        (wrapping, r in [0, 2q))
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..numeric.limb import MASK32, mulhi_u32


class ShoupFactor32(NamedTuple):
    """``(w, floor(w * 2^32 / q))`` for moduli ``q < 2^31`` (int64 tensors)."""

    value: torch.Tensor
    quotient: torch.Tensor

    def map(self, fn) -> "ShoupFactor32":
        return ShoupFactor32(*(fn(x) for x in self))


def shoup32(w, q, device=None) -> ShoupFactor32:
    """Builds a :class:`ShoupFactor32` from host ints (scalar or array)."""
    wb, qb = np.broadcast_arrays(
        np.asarray(w, dtype=np.uint64), np.asarray(q, dtype=np.uint64)
    )
    quot = [((int(a) << 32) // int(b)) & MASK32 for a, b in zip(wb.reshape(-1), qb.reshape(-1))]

    def t(vals):
        return torch.tensor(vals, dtype=torch.int64, device=device).reshape(wb.shape)

    return ShoupFactor32(t([int(a) for a in wb.reshape(-1)]), t(quot))


def factor_mul_lazy32(y, factor: ShoupFactor32, q):
    """``y * w mod q`` in ``[0, 2q)``."""
    q_hat = mulhi_u32(y, factor.quotient)
    return (factor.value * y - q * q_hat) & MASK32


def factor_mul32(y, factor: ShoupFactor32, q):
    """``y * w mod q`` in ``[0, q)`` via the min-trick reduce_once."""
    r = factor_mul_lazy32(y, factor, q)
    return torch.minimum(r, (r - q) & MASK32)
