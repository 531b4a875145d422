"""Extended GCD and modular inverses over Python integers (copy of
``primus_fhe_tpu/utils/gcd.py``).

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


def hensel_inv_pow2(a: int, k: int) -> int:
    """Inverse of odd ``a`` modulo ``2^k`` via Hensel / Newton lifting.

    The reference seeds from a 128-entry byte table and doubles precision per
    step (``crates/primus_gcd/src/lib.rs``); the same quadratic lift is used
    here starting from the trivial 1-bit inverse.
    """
    if a % 2 == 0:
        raise ValueError("only odd values are invertible modulo 2^k")
    if k <= 0:
        raise ValueError("k must be positive")
    mask = (1 << k) - 1
    x = 1  # inverse mod 2
    bits = 1
    while bits < k:
        bits *= 2
        x = (x * (2 - a * x)) & ((1 << min(bits, k)) - 1)
    return x & mask
