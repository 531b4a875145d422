"""NTT-friendly primes (copy of
``primus_fhe_tpu/utils/primes.py``), host-side and exact."""

from __future__ import annotations

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit inputs)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_ntt_prime(bits: int, log_n: int, below: int | None = None) -> int:
    """Largest prime ``q < min(2^bits, below)`` with ``q = 1 (mod 2^(log_n+1))``
    (a primitive ``2n``-th root of unity exists: negacyclic NTT)."""
    step = 1 << (log_n + 1)
    start = (1 << bits) - 1 if below is None else below - 1
    q = start - (start % step) + 1
    if q > start:
        q -= step
    while q > step:
        if is_prime(q):
            return q
        q -= step
    raise ValueError(f"no NTT prime with {bits} bits for log_n={log_n}")


def ntt_prime_chain(bits: int, log_n: int, count: int) -> list[int]:
    """``count`` distinct descending NTT-friendly primes just below ``2^bits``."""
    primes: list[int] = []
    below: int | None = None
    for _ in range(count):
        q = next_ntt_prime(bits, log_n, below)
        primes.append(q)
        below = q
    return primes
