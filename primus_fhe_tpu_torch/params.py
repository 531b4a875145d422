"""Turnkey context construction for the TFHE and NTRU parameter sets (port of
``make_context`` and ``make_ntru_context`` in ``primus_fhe_tpu/params.py``).

The parameter records (``TfheParams``, ``TOY``, ``BOOLEAN_128``,
``BOOLEAN_TFHE_LIB``, ``NtruParams``, ``NTRU_128``) are copies of the JAX
package's, field for field; the security and noise validation of the named
profiles is documented there.  ``save_keys`` / ``load_keys`` read and write
the JAX package's key files.  Noise widths are kept apart, as in the reference:

- TFHE: the bootstrap key is GLWE-encrypted at ``glwe_sigma``;
  key-switch-key rows and fresh encryptions are LWE samples at
  ``lwe_sigma``;
- NTRU: the secret's evaluation key (NGS rows) at ``sigma``; key-switch-key
  rows and fresh encryptions at ``lwe_sigma``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import noise
from .boot.blind_rotate import make_bootstrap_key, make_bootstrap_key_mxu
from .boot.gates import FALSE_MU, TRUE_MU
from .boot.ntru_blind_rotate import (
    NtruContext,
    NtruSecret,
    make_ntru_evks,
    make_ntru_keyswitch_key,
    ntru_keygen,
    ntru_secret,
)
from .decompose.primitive import ApproxSignedBasis32
from .distr.sampling import DiscreteGaussian, sample_binary, sample_uniform
from .lattice import keyswitch, tfhe
from .lattice.lwe import encrypt_torus32, phase_torus32
from .numeric.limb import narrow_u32
from .utils.primes import next_ntt_prime

__all__ = [
    "BOOLEAN_128", "BOOLEAN_TFHE_LIB", "NTRU_128", "NtruGateKeys", "NtruParams", "TOY",
    "TfheContext", "TfheParams", "from_jax_context", "from_jax_ntru_context", "from_jax_ntt_key",
    "gate_noise_stddev", "load_keys", "make_context", "make_ntru_context", "make_ntru_keys",
    "save_keys",
]


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """TFHE-style torus-2^32 parameter set."""

    log_n: int  # GLWE polynomial degree (N = 2^log_n)
    glwe_dim: int  # k (mask polynomial count)
    lwe_dim: int  # n_lwe
    log_basis: int  # gadget basis B = 2^log_basis (bootstrap key)
    level: int  # gadget levels (bootstrap key)
    ks_log_basis: int  # key-switch basis
    ks_level: int  # key-switch levels
    lwe_sigma: float  # LWE noise stddev (torus-2^32 units)
    glwe_sigma: float  # GLWE noise stddev

    @property
    def n(self) -> int:
        return 1 << self.log_n


TOY = TfheParams(
    log_n=5, glwe_dim=1, lwe_dim=8,
    log_basis=8, level=3, ks_log_basis=8, ks_level=3,
    lwe_sigma=3.2, glwe_sigma=3.2,
)

# The estimator-validated 128-bit boolean profile (N=2048).
BOOLEAN_128 = TfheParams(
    log_n=11, glwe_dim=1, lwe_dim=630,
    log_basis=7, level=3, ks_log_basis=1, ks_level=12,
    lwe_sigma=2.0**18.6, glwe_sigma=3.2,
)

# The classic TFHE-lib gate set (N=1024), kept for comparison with the
# reference's benches; NOT a 128-bit profile (its GLWE layer falls short).
BOOLEAN_TFHE_LIB = TfheParams(
    log_n=10, glwe_dim=1, lwe_dim=630,
    log_basis=7, level=3, ks_log_basis=2, ks_level=8,
    lwe_sigma=2.0**17, glwe_sigma=128.0,
)


@dataclasses.dataclass(frozen=True)
class NtruParams:
    """NTRU (FINAL/NGS-style) mod-q parameter set; ``q`` is the largest NTT
    prime below ``2^q_bits`` (= 1 mod 2^(log_n+1))."""

    log_n: int  # NTRU ring degree (N = 2^log_n)
    q_bits: int  # NTRU modulus size
    lwe_dim: int  # n_lwe (binary LWE dimension)
    log_basis: int  # gadget basis for the NGS external product
    level: int  # gadget levels
    ks_log_basis: int  # key-switch basis
    ks_level: int  # key-switch levels
    sigma: float  # NTRU-side noise stddev (keygen and evk; mod-q units)
    lwe_sigma: float = 0.0  # LWE-side stddev: fresh encryptions and ksk rows

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def q(self) -> int:
        return next_ntt_prime(self.q_bits, self.log_n)


# The 128-bit-class NTRU boolean profile (FINAL geometry, N=1024).
NTRU_128 = NtruParams(
    log_n=10, q_bits=20, lwe_dim=700,
    log_basis=3, level=6, ks_log_basis=1, ks_level=16,
    sigma=0.5, lwe_sigma=52.0,
)

BSK_KINDS = ("auto", "ntt", "mxu")


@dataclasses.dataclass
class TfheContext:
    """Everything needed to evaluate: keys, bases, convolver, samplers.

    ``bsk``: ``(n_lwe, kp, k+1, L, k+1, N)`` NTT-domain GGSW rows, or the
    MXU pack ``(vals, precons)``, each ``(n_lwe, kp, k+1, L, k+1, A, 128)``;
    ``ksk``: ``(k*N, ks_level, n_lwe+1)``; secrets as 0/1 int64 tensors.
    """

    params: TfheParams
    basis: ApproxSignedBasis32
    ks_basis: ApproxSignedBasis32
    conv: tfhe.TorusConvolver32
    gaussian: DiscreteGaussian  # LWE side (lwe_sigma)
    lwe_secret: torch.Tensor
    glwe_secret: torch.Tensor
    bsk: torch.Tensor | tuple
    ksk: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.ksk.device

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


def _resolve_bsk_kind(p: TfheParams, bsk_kind: str) -> str:
    """``"auto"`` is ``"ntt"``: the route whose card numbers exist; ``"mxu"``
    needs ``log_n >= 8`` (128 lanes of the natural layout)."""
    if bsk_kind not in BSK_KINDS:
        raise ValueError(f"bsk_kind must be one of {BSK_KINDS}")
    if bsk_kind == "mxu" and p.log_n < 8:
        raise ValueError("bsk_kind='mxu' needs log_n >= 8")
    return "ntt" if bsk_kind == "auto" else bsk_kind


def make_context(params: TfheParams, device, generator: torch.Generator,
                 bsk_kind: str = "auto") -> TfheContext:
    """Generates secrets and evaluation keys for a parameter set on
    ``device``, drawing every random word from ``generator`` (which must
    live on ``device``).  ``bsk_kind`` picks the bootstrap key: ``"ntt"``
    (the two-kernel CMux), ``"mxu"`` (the int8 one-kernel CMux) or
    ``"auto"`` (``"ntt"``).  Both kinds hold the same GGSW material for the
    same generator state."""
    p = params
    kind = _resolve_bsk_kind(p, bsk_kind)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError("the generator must live on the context's device")
    basis, ks_basis, conv = _bases(p)
    gaussian = DiscreteGaussian(max(p.lwe_sigma, 1e-6))
    glwe_gaussian = DiscreteGaussian(max(p.glwe_sigma, 1e-6))
    lwe_secret = sample_binary(generator, (p.lwe_dim,))
    glwe_secret = sample_binary(generator, (p.glwe_dim, p.n))
    make = make_bootstrap_key_mxu if kind == "mxu" else make_bootstrap_key
    bsk = make(lwe_secret, glwe_secret, basis, glwe_gaussian, conv, generator)
    ksk = keyswitch.make_keyswitch_key(
        glwe_secret.reshape(-1), lwe_secret, ks_basis, gaussian, generator
    )
    return TfheContext(p, basis, ks_basis, conv, gaussian, lwe_secret, glwe_secret, bsk, ksk)


def _t(x, device):
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def from_jax_context(params: TfheParams, bsk, ksk, lwe_secret, glwe_secret,
                     device="cuda") -> TfheContext:
    """The port's context over keys made by the JAX package, on ``device``
    (the card unless the caller asks for the CPU).

    Arrays come as numpy (``np.asarray`` of the JAX context's fields):
    ``bsk`` the NTT key ``(n_lwe, kp, k+1, L, k+1, N)`` (stored as
    :func:`make_context` stores it: int32 words, each checked to be a
    canonical residue, :func:`_ntt_bsk`) or the MXU pack ``(vals,
    precons)``, ``ksk (n_in, L, n_out+1)``, ``lwe_secret (n_lwe,)``,
    ``glwe_secret (k, N)``.
    """
    basis, ks_basis, conv = _bases(params)
    kp = np.asarray(bsk[0] if isinstance(bsk, (tuple, list)) else bsk).shape[1]
    if kp != conv.count:
        raise ValueError(f"bsk has {kp} primes, the convolver {conv.count}")
    if isinstance(bsk, (tuple, list)):
        bsk_t = tuple(_t(x, device) for x in bsk)
    else:
        bsk_t = _ntt_bsk(bsk, conv, device)
    return TfheContext(
        params, basis, ks_basis, conv, DiscreteGaussian(max(params.lwe_sigma, 1e-6)),
        _t(lwe_secret, device), _t(glwe_secret, device), bsk_t, _t(ksk, device),
    )


def from_jax_ntt_key(array, conv: tfhe.TorusConvolver32, device="cuda") -> torch.Tensor:
    """An NTT-domain key stack made by the JAX package with ``conv``'s primes
    (a private KSK ``(kp, n_ext+1, L, k+1, N)``, a GLWE or packing KSK
    ``(kp, k_in, L, k_out+1, N)``, a GGSW ``(kp, k+1, L, k+1, N)``), given as
    numpy, as a contiguous int64 tensor on ``device`` (the card unless the
    caller asks for the CPU).  Raises ``ValueError`` unless the leading axis
    is ``conv``'s primes and every word lies below its prime."""
    arr = np.asarray(array).astype(np.int64)
    if arr.ndim < 2 or arr.shape[0] != conv.count:
        raise ValueError(f"expected ({conv.count} primes, ...), got {arr.shape}")
    primes = np.asarray(conv.primes, dtype=np.int64).reshape((-1,) + (1,) * (arr.ndim - 1))
    if arr.min() < 0 or (arr >= primes).any():
        raise ValueError("a word is not a canonical residue of its prime")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _ntt_bsk(bsk, conv: tfhe.TorusConvolver32, device) -> torch.Tensor:
    """An NTT bootstrap key ``(n_lwe, kp, k+1, L, k+1, N)`` given as numpy,
    in the storage :func:`..boot.blind_rotate.make_bootstrap_key` makes:
    every word checked to be a canonical residue of its prime
    (:func:`from_jax_ntt_key`, on the host), then kept as its 32 bits
    (int32), contiguous on ``device``."""
    key = from_jax_ntt_key(np.moveaxis(np.asarray(bsk), 1, 0), conv, "cpu").movedim(0, 1)
    return narrow_u32(key).contiguous().to(device)


def _u32_host(x: torch.Tensor) -> np.ndarray:
    """int64 (or int32-stored) u32 words on any device -> host numpy uint32."""
    return (x.detach().to("cpu", torch.int64) & 0xFFFFFFFF).numpy().astype(np.uint32)


def save_keys(path, ctx: TfheContext) -> None:
    """Writes the evaluation keys, secrets and parameters to an ``.npz``
    (``np.savez_compressed``) in the JAX package's format: the same names,
    uint32 words in the same layouts, ``params`` int64 and ``sigmas``
    float64, so either package loads it (:func:`load_keys`)."""
    if isinstance(ctx.bsk, (tuple, list)):
        raise ValueError(
            "save_keys serializes the NTT-domain key; build the context "
            'with bsk_kind="ntt" (the MXU key pack is a device-resident '
            "derivative — rebuild it after load with make_bootstrap_key_mxu)"
        )
    p = ctx.params
    np.savez_compressed(
        path,
        bsk=_u32_host(ctx.bsk),
        ksk=_u32_host(ctx.ksk),
        lwe_secret=_u32_host(ctx.lwe_secret),
        glwe_secret=_u32_host(ctx.glwe_secret),
        params=np.array([p.log_n, p.glwe_dim, p.lwe_dim, p.log_basis, p.level,
                         p.ks_log_basis, p.ks_level], dtype=np.int64),
        sigmas=np.array([p.lwe_sigma, p.glwe_sigma], dtype=np.float64),
    )


def load_keys(path, device="cuda") -> TfheContext:
    """A full context from a :func:`save_keys` file (or the JAX package's),
    on ``device`` (the card unless the caller asks for the CPU); bases and
    the convolver are derived again from the parameters.  The bootstrap
    key goes through :func:`from_jax_ntt_key` (prime axis first), which
    refuses a word that is not a canonical residue of its prime, and is
    stored as :func:`make_context` stores it (int32 words, :func:`_ntt_bsk`)."""
    with np.load(path) as z:
        pv, sig = z["params"], z["sigmas"]
        params = TfheParams(
            log_n=int(pv[0]), glwe_dim=int(pv[1]), lwe_dim=int(pv[2]),
            log_basis=int(pv[3]), level=int(pv[4]), ks_log_basis=int(pv[5]),
            ks_level=int(pv[6]), lwe_sigma=float(sig[0]), glwe_sigma=float(sig[1]),
        )
        basis, ks_basis, conv = _bases(params)
        return TfheContext(
            params, basis, ks_basis, conv, DiscreteGaussian(max(params.lwe_sigma, 1e-6)),
            _t(z["lwe_secret"], device), _t(z["glwe_secret"], device),
            _ntt_bsk(z["bsk"], conv, device), _t(z["ksk"], device),
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


# -- NTRU ---------------------------------------------------------------------


def make_ntru_context(params: NtruParams = NTRU_128):
    """``(NtruContext, ks_basis)`` of a named NTRU profile (``t_scale=8``)."""
    ctx = NtruContext(params.log_n, params.q, params.log_basis, params.level, t_scale=8)
    return ctx, ApproxSignedBasis32(params.q, params.ks_log_basis, params.ks_level)


@dataclasses.dataclass
class NtruGateKeys:
    """Keys of the NTRU gate family and the LWE side around them.

    ``evk``: NTT-domain ``(n_lwe, L, N)``; ``evk_mxu``: the MXU pack
    ``(vals, precons)`` of the same NGS material (``None`` where absent);
    ``ksk``: ``(N, ks_level, n_lwe+1)`` mod q; ``lwe_secret``: 0/1.
    """

    params: NtruParams
    ctx: NtruContext
    ks_basis: ApproxSignedBasis32
    sk: NtruSecret
    lwe_secret: torch.Tensor
    evk: torch.Tensor | None
    evk_mxu: tuple | None
    ksk: torch.Tensor
    gaussian: DiscreteGaussian  # LWE side (lwe_sigma)

    @property
    def device(self) -> torch.device:
        return self.ksk.device

    def encrypt(self, bits, generator: torch.Generator) -> torch.Tensor:
        """Fresh LWE encryptions ``(..., n_lwe+1)`` mod q of booleans
        (TRUE = +(q-1)/8, FALSE = -(q-1)/8), noise at lwe_sigma."""
        q = self.ctx.q_int
        bits = torch.as_tensor(bits, device=self.device).to(torch.bool)
        t = (q - 1) // 8
        mu = torch.where(bits, t, q - t).to(torch.int64)
        a = sample_uniform(generator, tuple(mu.shape) + (self.lwe_secret.shape[0],), q)
        e = self.gaussian.sample_mod(generator, mu.shape, q)
        b = ((a * self.lwe_secret).sum(dim=-1) + mu + e) % q
        return torch.cat([a, b.unsqueeze(-1)], dim=-1)

    def phase(self, ct: torch.Tensor) -> torch.Tensor:
        """Centered phase ``b - <a, s>`` in ``(-q/2, q/2]`` (int64)."""
        q = self.ctx.q_int
        n = self.lwe_secret.shape[0]
        ph = (ct[..., n] - (ct[..., :n] * self.lwe_secret).sum(dim=-1)) % q
        return torch.where(ph > q // 2, ph - q, ph)

    def decrypt(self, ct: torch.Tensor) -> torch.Tensor:
        return self.phase(ct) > 0


def make_ntru_keys(params: NtruParams, device, generator: torch.Generator) -> NtruGateKeys:
    """NTRU secret, binary LWE secret, both evaluation-key forms (the MXU
    pack for ``log_n >= 8``; kernel C prepares it to ``log_n`` 12, kernel
    1 at 13-17) from one set of NGS draws made in chunks of LWE indices
    (:func:`~.boot.ntru_blind_rotate.make_ntru_evks`), and the key-switch
    key, all on ``device`` from ``generator``.  On the card ``log_n`` up to
    17."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError("the generator must live on the keys' device")
    ctx, ks_basis = make_ntru_context(params)
    sk = ntru_keygen(generator, ctx)
    s = sample_binary(generator, (params.lwe_dim,))
    evk, evk_mxu = make_ntru_evks(generator, ctx, sk, s, DiscreteGaussian(params.sigma),
                                  mxu=params.log_n >= 8)
    lwe_gauss = DiscreteGaussian(params.lwe_sigma)
    ksk = make_ntru_keyswitch_key(generator, ctx, sk, s, ks_basis, lwe_gauss)
    return NtruGateKeys(params, ctx, ks_basis, sk, s, evk, evk_mxu, ksk, lwe_gauss)


def from_jax_ntru_context(params: NtruParams, f, evk, ksk, lwe_secret,
                          device="cuda") -> NtruGateKeys:
    """The port's NTRU keys over keys made by the JAX package, on ``device``
    (the card unless the caller asks for the CPU): numpy arrays
    of the secret's coefficients ``f (N,)``, the evaluation key (NTT-domain
    ``(n_lwe, L, N)`` or the MXU pair ``(vals, precons)``), the key-switch
    key and the binary LWE secret."""
    ctx, ks_basis = make_ntru_context(params)
    sk = ntru_secret(ctx, _t(f, device))
    if sk is None:
        raise ValueError("f is not invertible mod q")
    if isinstance(evk, (tuple, list)):
        evk_t, evk_mxu = None, tuple(_t(x, device) for x in evk)
    else:
        evk_t, evk_mxu = _t(evk, device), None
    return NtruGateKeys(params, ctx, ks_basis, sk, _t(lwe_secret, device), evk_t, evk_mxu,
                        _t(ksk, device), DiscreteGaussian(params.lwe_sigma))
