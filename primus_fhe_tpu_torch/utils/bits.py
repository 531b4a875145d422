"""Bit reversal (copy of ``primus_fhe_tpu/utils/bits.py``)."""

from __future__ import annotations

import numpy as np


def reverse_lsbs(value: int, bits: int) -> int:
    """Reverses the lowest ``bits`` bits of ``value`` (upper bits dropped)."""
    out = 0
    for i in range(bits):
        out = (out << 1) | ((value >> i) & 1)
    return out


def bit_reverse_indices(log_n: int) -> np.ndarray:
    """Vector of ``reverse_lsbs(i, log_n)`` for ``i in range(2**log_n)``.

    Used to build the bit-reversed root tables at plan time (the analogue of
    the ``reverse_lsbs`` mapping stored in ``U64NttTable``).
    """
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    for i in range(log_n):
        out = (out << np.uint64(1)) | ((idx >> np.uint64(i)) & np.uint64(1))
    return out.astype(np.int64)
