"""Extended GCD and modular inverses over Python integers (copy of
``xgcd``, ``gcdinv`` and ``mod_inv`` in ``primus_fhe_tpu/utils/gcd.py``).

Plan-time host code: table construction needs a handful of inverses, never
the device.
"""

from __future__ import annotations


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended Euclid: ``(g, x, y)`` with ``a*x + b*y == g = gcd(a, b)``;
    both inputs non-negative."""
    if a < 0 or b < 0:
        raise ValueError("xgcd expects non-negative inputs")
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def gcdinv(a: int, m: int) -> tuple[int, int]:
    """``(inv, g)`` with ``g = gcd(a, m)``, ``inv * a = g (mod m)`` and
    ``0 <= inv < m``."""
    if m <= 0:
        raise ValueError("modulus must be positive")
    g, x, _ = xgcd(a % m, m)
    return x % m, g


def mod_inv(a: int, m: int) -> int:
    """``a^-1 mod m``; raises if ``a`` is not invertible."""
    inv, g = gcdinv(a, m)
    if g != 1:
        raise ValueError(f"{a} is not invertible modulo {m}")
    return inv
