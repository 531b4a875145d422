"""Bit reversal (copy of ``reverse_lsbs`` in ``primus_fhe_tpu/utils/bits.py``)."""

from __future__ import annotations


def reverse_lsbs(value: int, bits: int) -> int:
    """Reverses the lowest ``bits`` bits of ``value`` (upper bits dropped)."""
    out = 0
    for i in range(bits):
        out = (out << 1) | ((value >> i) & 1)
    return out
