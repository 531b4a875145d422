"""Turnkey context construction for a TFHE parameter set (port of
``make_context`` in ``primus_fhe_tpu/params.py``, NTT-domain key kind).

The parameter records (``TfheParams``, ``TOY``, ``BOOLEAN_128``) are the
JAX package's own, which import no JAX.  Three noise widths are kept apart,
as in the reference:

- the bootstrap key is GLWE-encrypted at ``glwe_sigma``;
- key-switch-key rows are LWE samples at ``lwe_sigma``;
- fresh encryptions (:meth:`TfheContext.encrypt`) are sampled at
  ``lwe_sigma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from primus_fhe_tpu import noise
from primus_fhe_tpu.params import BOOLEAN_128, TOY, TfheParams

from .boot.blind_rotate import make_bootstrap_key
from .boot.gates import FALSE_MU, TRUE_MU
from .decompose.primitive import ApproxSignedBasis32
from .distr.sampling import DiscreteGaussian, sample_binary
from .lattice import keyswitch, tfhe
from .lattice.lwe import encrypt_torus32, phase_torus32

__all__ = [
    "BOOLEAN_128", "TOY", "TfheContext", "TfheParams", "from_jax_context",
    "gate_noise_stddev", "make_context",
]


@dataclasses.dataclass
class TfheContext:
    """Everything needed to evaluate: keys, bases, convolver, samplers.

    ``bsk``: ``(n_lwe, kp, k+1, L, k+1, N)`` NTT-domain GGSW rows;
    ``ksk``: ``(k*N, ks_level, n_lwe+1)``; secrets as 0/1 int64 tensors.
    """

    params: TfheParams
    basis: ApproxSignedBasis32
    ks_basis: ApproxSignedBasis32
    conv: tfhe.TorusConvolver32
    gaussian: DiscreteGaussian  # LWE side (lwe_sigma)
    lwe_secret: torch.Tensor
    glwe_secret: torch.Tensor
    bsk: torch.Tensor
    ksk: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.bsk.device

    def encrypt(self, bits, generator: torch.Generator) -> torch.Tensor:
        """Fresh LWE encryptions ``(..., n_lwe+1)`` of booleans ``bits``
        (TRUE = +1/8, FALSE = -1/8), noise at lwe_sigma."""
        bits = torch.as_tensor(bits, device=self.device).to(torch.bool)
        mu = torch.where(bits, TRUE_MU, FALSE_MU).to(torch.int64)
        return encrypt_torus32(mu, self.lwe_secret, self.gaussian, generator)

    def decrypt(self, ct: torch.Tensor) -> torch.Tensor:
        """Booleans from the sign of the centered phase."""
        return self.phase(ct) > 0

    def phase(self, ct: torch.Tensor) -> torch.Tensor:
        """Centered LWE phase in ``[-2^31, 2^31)`` (int64)."""
        ph = phase_torus32(ct, self.lwe_secret)
        return torch.where(ph >= 1 << 31, ph - (1 << 32), ph)


def _bases(p: TfheParams):
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    ks_basis = ApproxSignedBasis32(None, p.ks_log_basis, reverse_length=p.ks_level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    return basis, ks_basis, conv


def make_context(params: TfheParams, device, generator: torch.Generator) -> TfheContext:
    """Generates secrets and evaluation keys for a parameter set on
    ``device``, drawing every random word from ``generator`` (which must
    live on ``device``)."""
    p = params
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError("the generator must live on the context's device")
    basis, ks_basis, conv = _bases(p)
    gaussian = DiscreteGaussian(max(p.lwe_sigma, 1e-6))
    glwe_gaussian = DiscreteGaussian(max(p.glwe_sigma, 1e-6))
    lwe_secret = sample_binary(generator, (p.lwe_dim,))
    glwe_secret = sample_binary(generator, (p.glwe_dim, p.n))
    bsk = make_bootstrap_key(lwe_secret, glwe_secret, basis, glwe_gaussian, conv, generator)
    ksk = keyswitch.make_keyswitch_key(
        glwe_secret.reshape(-1), lwe_secret, ks_basis, gaussian, generator
    )
    return TfheContext(p, basis, ks_basis, conv, gaussian, lwe_secret, glwe_secret, bsk, ksk)


def from_jax_context(params: TfheParams, bsk, ksk, lwe_secret, glwe_secret,
                     device="cpu") -> TfheContext:
    """The port's context over keys made by the JAX package.

    Arrays come as numpy (``np.asarray`` of the JAX context's fields, NTT
    key kind): ``bsk (n_lwe, kp, k+1, L, k+1, N)``, ``ksk (n_in, L,
    n_out+1)``, ``lwe_secret (n_lwe,)``, ``glwe_secret (k, N)``.
    """
    basis, ks_basis, conv = _bases(params)

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    bsk_t = t(bsk)
    if bsk_t.shape[1] != conv.count:
        raise ValueError(f"bsk has {bsk_t.shape[1]} primes, the convolver {conv.count}")
    return TfheContext(
        params, basis, ks_basis, conv, DiscreteGaussian(max(params.lwe_sigma, 1e-6)),
        t(lwe_secret), t(glwe_secret), bsk_t, t(ksk),
    )


def gate_noise_stddev(p: TfheParams) -> float:
    """Predicted stddev (torus units) of a gate output's phase error:
    blind rotation then key switch, by the ``noise.py`` model."""
    basis, ks_basis, _ = _bases(p)
    br = noise.blind_rotate(
        p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level, p.log_basis, basis.drop_bits
    )
    out = noise.key_switch(
        br, p.lwe_sigma, p.glwe_dim * p.n, p.ks_level, p.ks_log_basis, ks_basis.drop_bits
    )
    return out.stddev
