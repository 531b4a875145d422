"""FHE noise samplers on an explicit ``torch.Generator`` (port of
``primus_fhe_tpu/distr/sampling.py``), with the CRT-replicated samplers that
write one logical draw into every modulus slot (``src/common.rs:129-350``).

Every sampler draws on the generator's device.  ``torch.Generator`` and
``jax.random`` give different numbers from the same seed, so the samplers
are held to the reference statistically, not bit for bit.

``DiscreteGaussian`` keeps both of the reference's paths:

- **CDT** (sigma <= 256): ``P[X <= t]`` to 64-bit fixed point out to
  ``tail_cut`` sigmas; a 64-bit uniform is inverted against the table by
  counting the thresholds below it, then mapped to its offset;
- **rounded continuous** (sigma > 256, e.g. BOOLEAN_128's lwe_sigma of
  2^18.6): ``round(sigma * N(0,1))`` in float32, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..numeric.limb import MASK32, as_i64, mul_hi_u64


def uniform_u32(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform u32 words (int64 tensor) on the generator's device."""
    return torch.randint(
        0, 1 << 32, tuple(shape), generator=generator, dtype=torch.int64,
        device=generator.device,
    )


def sample_binary(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform bits in {0, 1} (``BinaryDistr``)."""
    return uniform_u32(generator, shape) & 1


def _ternary(b: torch.Tensor, q) -> torch.Tensor:
    """Two uniform bits ``b`` -> 0 (b < 2), 1 (b == 2) or ``q - 1`` (b == 3)."""
    return torch.where(b < 2, 0, torch.where(b == 2, 1, q - 1))


def sample_ternary(generator: torch.Generator, shape, q) -> torch.Tensor:
    """{0, +1, -1} with p = 1/2, 1/4, 1/4, -1 as ``q - 1`` (``ternary.rs:10``;
    not :func:`uniform_ternary`'s distribution)."""
    return _ternary(uniform_u32(generator, shape) & 3, q)


def sample_uniform(generator: torch.Generator, shape, q: int) -> torch.Tensor:
    """Uniform in ``[0, q)`` for ``q < 2^31``: ``floor(u64 * q / 2^64)`` of a
    64-bit uniform from two words (bias below 2^-33), computed exactly in
    int64 as ``(hi*q + (lo*q >> 32)) >> 32``."""
    if not 1 < q < 1 << 31:
        raise ValueError("sample_uniform needs 1 < q < 2^31")
    lo = uniform_u32(generator, shape)
    hi = uniform_u32(generator, shape)
    return (hi * q + ((lo * q) >> 32)) >> 32


def sample_uniform_u64(generator: torch.Generator, shape, q: int) -> torch.Tensor:
    """Uniform in ``[0, q)`` for ``q < 2^62`` (int64): the 128-bit
    multiply-shift ``floor(u * q / 2^64)`` of a 64-bit uniform ``u`` made of
    two words."""
    if not 1 < q < 1 << 62:
        raise ValueError("sample_uniform_u64 needs 1 < q < 2^62")
    lo = uniform_u32(generator, shape)
    hi = uniform_u32(generator, shape)
    return mul_hi_u64((hi << 32) | lo, q)


def uniform_ternary(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform in {-1, 0, 1} (int64): the NTRU secret's ``f'`` draw (the
    reference draws it with numpy's ``integers(-1, 2)``; its
    ``sample_ternary`` is another distribution)."""
    return torch.randint(-1, 2, tuple(shape), generator=generator, dtype=torch.int64,
                         device=generator.device)


class DiscreteGaussian:
    """Discrete Gaussian over Z: CDT sampler for small sigma, rounded
    continuous Gaussian above ``_CDT_SIGMA_MAX``."""

    _CDT_SIGMA_MAX = 256.0

    def __init__(self, sigma: float, mean: float = 0.0, tail_cut: float = 10.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        if mean != 0.0:
            raise NotImplementedError("nonzero mean not supported yet")
        self.sigma = float(sigma)
        self._tables: dict = {}
        if sigma > self._CDT_SIGMA_MAX:
            if sigma * tail_cut >= 2.0**31:
                raise ValueError("sigma too large for int32 samples")
            self.offsets = None
            return
        max_t = int(np.ceil(sigma * tail_cut)) + 1
        ts = np.arange(-max_t, max_t + 1)
        w = np.exp(-(ts.astype(np.float64) ** 2) / (2 * self.sigma**2))
        w /= w.sum()
        cdf = np.cumsum(w)
        fixed = [min(int(v), (1 << 64) - 1) for v in (cdf * 2.0**64).astype(object)]
        self.offsets = ts.astype(np.int64)
        # thresholds shifted by -2^63 so that signed int64 order is the
        # unsigned 64-bit order
        self.cdf_shifted = np.array([v - (1 << 63) for v in fixed], dtype=np.int64)

    def _table(self, device):
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = (
                torch.from_numpy(self.cdf_shifted).to(device),
                torch.from_numpy(self.offsets).to(device),
            )
        return self._tables[device]

    def sample_signed(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Signed samples (int64) on the generator's device."""
        shape = tuple(shape)
        if self.offsets is None:  # large-sigma rounded-continuous path
            g = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            return torch.round(g * np.float32(self.sigma)).to(torch.int64)
        u_hi = uniform_u32(generator, shape)
        u_lo = uniform_u32(generator, shape)
        u_shifted = ((u_hi - (1 << 31)) << 32) + u_lo  # u - 2^63
        cdf, offsets = self._table(generator.device)
        # index = #(cdf < u): the 64-bit compare-sum of the reference
        idx = torch.searchsorted(cdf, u_shifted.reshape(-1), right=False)
        idx = idx.clamp_(max=offsets.shape[0] - 1)
        return offsets[idx].reshape(shape)

    def sample_mod(self, generator: torch.Generator, shape, q: int) -> torch.Tensor:
        """Samples wrapped into ``[0, q)`` (``q < 2^31``)."""
        return self.sample_signed(generator, shape).remainder(q)

    def sample_mod_u64(self, generator: torch.Generator, shape, q: int) -> torch.Tensor:
        """Samples wrapped into ``[0, q)`` as u64 patterns (int64)."""
        s = self.sample_signed(generator, shape)
        return torch.where(s < 0, as_i64(q) + s, s)

    def sample_torus32(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Samples wrapped mod 2^32 (TFHE torus)."""
        return self.sample_signed(generator, shape) & MASK32


# ---------------------------------------------------------------------------
# CRT-replicated sampling (src/common.rs:129-350): one logical sample written
# into every modulus slot of a leading ``(k,)`` axis.
# ---------------------------------------------------------------------------


def _moduli_col(moduli, ndim: int, device) -> torch.Tensor:
    """The moduli (a sequence or a 1-D tensor) as a ``(k, 1, ...)`` int64
    column on ``device``."""
    q = torch.as_tensor(moduli, dtype=torch.int64, device=device)
    return q.reshape((-1,) + (1,) * ndim)


def sample_crt_binary(generator: torch.Generator, shape, moduli) -> torch.Tensor:
    """Binary samples replicated along a leading ``(k,)`` modulus axis."""
    v = sample_binary(generator, shape)
    return v.expand((len(moduli),) + tuple(shape))


def sample_crt_ternary(generator: torch.Generator, shape, moduli) -> torch.Tensor:
    """One ternary draw per position, ``-1`` as ``q_i - 1`` in slot ``i``."""
    b = uniform_u32(generator, shape) & 3
    return _ternary(b, _moduli_col(moduli, len(tuple(shape)), b.device))


def sample_crt_gaussian(generator: torch.Generator, shape, moduli,
                        gaussian: DiscreteGaussian) -> torch.Tensor:
    """One Gaussian draw per position, a negative ``s`` as ``q_i + s`` in
    slot ``i``."""
    s = gaussian.sample_signed(generator, shape)
    q = _moduli_col(moduli, s.dim(), s.device)
    return torch.where(s < 0, q + s, s.expand(q.shape[:1] + s.shape))
