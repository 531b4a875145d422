"""Noise-variance bookkeeping (copy of ``primus_fhe_tpu/noise.py``).

Variances in squared torus units (2^32 scale), under the usual TFHE
independence heuristics; the transforms are exact, so no FFT term appears.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class NoiseEstimate:
    """Variance (torus^2 units)."""

    variance: float

    @property
    def stddev(self) -> float:
        return math.sqrt(self.variance)

    def bits(self) -> float:
        """log2 of the ~4-sigma noise amplitude (failure ~6e-5)."""
        return math.log2(4.0 * self.stddev) if self.variance > 0 else 0.0

    def decryption_failure_margin(self, message_bits: int, torus_bits: int = 32) -> float:
        """Ratio of the half-bucket to 4-sigma noise (>1 means safe)."""
        half_bucket = 2.0 ** (torus_bits - message_bits - 2)
        return half_bucket / max(4.0 * self.stddev, 1e-30)


def fresh_lwe(sigma: float) -> NoiseEstimate:
    return NoiseEstimate(sigma * sigma)


def add(a: NoiseEstimate, b: NoiseEstimate) -> NoiseEstimate:
    return NoiseEstimate(a.variance + b.variance)


def scalar_mul(a: NoiseEstimate, c: int) -> NoiseEstimate:
    return NoiseEstimate(a.variance * c * c)


def external_product(input_noise: NoiseEstimate, key_sigma: float, n: int, k: int, level: int,
                     log_basis: int, drop_bits: int) -> NoiseEstimate:
    """Noise after one exact external product: the gadget MAC
    ``(k+1) L n B^2/12 sigma^2``, the carried input and the drop error
    ``(k+1) n eps^2/12 * 1/2`` (``eps = 2^drop_bits``, binary secret)."""
    b2 = float(1 << (2 * log_basis))
    gadget = (k + 1) * level * n * (b2 / 12.0) * key_sigma * key_sigma
    eps = float(1 << drop_bits) if drop_bits > 0 else 0.0
    drop = (k + 1) * n * (eps * eps / 12.0) * 0.5
    return NoiseEstimate(input_noise.variance + gadget + drop)


def cmux(acc_noise: NoiseEstimate, key_sigma: float, n: int, k: int, level: int,
         log_basis: int, drop_bits: int) -> NoiseEstimate:
    """One blind-rotation CMux: the external product of the rotate-diff
    adds noise on top of the carried accumulator noise."""
    return external_product(acc_noise, key_sigma, n, k, level, log_basis, drop_bits)


def blind_rotate(n_lwe: int, key_sigma: float, n: int, k: int, level: int, log_basis: int,
                 drop_bits: int) -> NoiseEstimate:
    """Noise of a freshly bootstrapped sample (before the key switch)."""
    per_step = external_product(NoiseEstimate(0.0), key_sigma, n, k, level, log_basis, drop_bits)
    return NoiseEstimate(n_lwe * per_step.variance)


def key_switch(input_noise: NoiseEstimate, ks_sigma: float, n_in: int, level: int,
               log_basis: int, drop_bits: int) -> NoiseEstimate:
    """LWE-to-LWE key switch: ``n_in L B^2/12 sigma^2`` plus the drop."""
    b2 = float(1 << (2 * log_basis))
    ks = n_in * level * (b2 / 12.0) * ks_sigma * ks_sigma
    eps = float(1 << drop_bits) if drop_bits > 0 else 0.0
    drop = n_in * (eps * eps / 12.0) * 0.5
    return NoiseEstimate(input_noise.variance + ks + drop)


def modulus_switch(input_noise: NoiseEstimate, n_lwe: int, log_2n: int) -> NoiseEstimate:
    """Rounding to Z_2N adds ~ (n_lwe+1)/48 * (2^32/2N)^2 of variance."""
    step = 2.0 ** (32 - log_2n)
    return NoiseEstimate(input_noise.variance + (n_lwe + 1) * step * step / 48.0)
