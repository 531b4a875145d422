"""Core-SVP lattice security estimator for the shipped parameter sets (host
copy of ``primus_fhe_tpu/utils/security.py``).

The reference publishes no parameter sets and no estimator (SURVEY.md §1);
``params.py`` ships named profiles, so the repo carries the standard
"2016 estimate" to validate them: the primal uSVP attack cost model of
Alkim-Ducas-Poppelmann-Schwabe (USENIX'16) plus the simple dual
distinguishing attack, with the Bai-Galbraith rescaling for small
(binary/ternary) secrets — the same core-SVP methodology the public
lattice-estimator's ``rough()`` mode uses.  Costs are *core-SVP* bits
(``0.292 * beta`` classical, ``0.265 * beta`` quantum): the cost of ONE
SVP call in blocksize ``beta``, ignoring polynomial factors — the
conservative convention NIST submissions quote.

Anchors (tests/test_security.py): Kyber-768 (n=768, q=3329, sigma=1)
comes out at the published ~2^182 classical core-SVP, and NewHope-512
(n=512, q=12289, sigma=sqrt(8)) at ~2^112.

This is a sanity validator for the named profiles, not a replacement for
running the maintained lattice estimator against a deployment's exact
distributions (stated in ``params.py``).
"""

from __future__ import annotations

import dataclasses
import math

_LOG2E = math.log2(math.e)

# core-SVP exponents (sieving): classical BDGL'16, quantum Laarhoven
CLASSICAL_COST = 0.292
QUANTUM_COST = 0.265
# log2 of the number of short vectors one sieve call outputs "for free"
# (4/3)^(beta/2) — used by the dual attack's amplification accounting
_SIEVE_VECS = 0.2075

_BETA_MIN, _BETA_MAX = 50, 2000


def secret_variance(secret: str, sigma: float) -> float:
    """Variance of one secret coefficient for the named distribution."""
    if secret == "binary":  # uniform {0,1}
        return 0.25
    if secret == "ternary":  # uniform {-1,0,1}
        return 2.0 / 3.0
    if secret == "gaussian":  # same width as the noise
        return sigma * sigma
    raise ValueError(f"unknown secret distribution {secret!r}")


def _log2_delta(beta: float) -> float:
    """log2 of the BKZ root-Hermite factor delta_beta (GSA model),
    ``delta = ((beta / (2 pi e)) * (pi beta)^(1/beta))^(1 / (2(beta-1)))``
    — accurate for beta >= 50."""
    b = float(beta)
    return (
        math.log2(b / (2.0 * math.pi * math.e))
        + math.log2(math.pi * b) / b
    ) / (2.0 * (b - 1.0))


def _primal_succeeds(
    beta: int, n: int, log2_q: float, sigma: float, omega: float
) -> bool:
    """True if BKZ-``beta`` primal uSVP succeeds for SOME sample count m.

    Success condition (ADPS16, eq. for the scaled Bai-Galbraith
    embedding of dimension ``d = n + m + 1`` and volume
    ``q^m * omega^n``):

        sigma * sqrt(beta) <= delta^(2 beta - d - 1) * Vol^(1/d)
    """
    ld = _log2_delta(beta)
    lhs = math.log2(sigma) + 0.5 * math.log2(beta)
    l_omega = math.log2(omega)
    # rhs(m) is smooth with a single interior maximum; a full scan over
    # m is cheap at these sizes and immune to shape assumptions
    for m in range(max(1, n // 8), 3 * n + 1):
        d = n + m + 1
        rhs = (2 * beta - d - 1) * ld + (m * log2_q + n * l_omega) / d
        if lhs <= rhs:
            return True
    return False


def primal_beta(
    n: int, q: float, sigma: float, secret: str = "binary"
) -> int:
    """Smallest BKZ blocksize whose primal uSVP attack succeeds.

    ``sigma`` is the noise stddev in absolute units (same scale as
    ``q``).  The Bai-Galbraith rescaling multiplies the secret columns
    by ``omega = sigma / sigma_s`` so secret and noise have equal width.
    """
    log2_q = math.log2(q)
    omega = sigma / math.sqrt(secret_variance(secret, sigma))
    lo, hi = _BETA_MIN, _BETA_MAX
    if _primal_succeeds(lo, n, log2_q, sigma, omega):
        return lo
    if not _primal_succeeds(hi, n, log2_q, sigma, omega):
        return _BETA_MAX  # stronger than anything the model prices
    while hi - lo > 1:  # success is monotone in beta
        mid = (lo + hi) // 2
        if _primal_succeeds(mid, n, log2_q, sigma, omega):
            hi = mid
        else:
            lo = mid
    return hi


def dual_cost_bits(
    n: int, q: float, sigma: float, secret: str = "binary"
) -> float:
    """Classical core-SVP bits of the simple dual distinguishing attack.

    BKZ-``beta`` on the dual lattice ``{(x, y) : A^T x = y mod q}`` —
    dimension ``d = m + n``, volume ``(q / omega)^n`` after the
    Bai-Galbraith secret rescaling — yields vectors of length
    ``l = delta^(d-1) * Vol^(1/d)``; each gives distinguishing
    advantage ``eps = exp(-2 pi^2 (l sigma / q)^2)`` (NewHope analysis),
    amplified over ``1/eps^2`` repeats with ``(4/3)^(beta/2)`` vectors
    free per sieve call.
    """
    log2_q = math.log2(q)
    omega = sigma / math.sqrt(secret_variance(secret, sigma))
    log2_vol = n * (log2_q - math.log2(omega))
    best = float("inf")
    for beta in range(_BETA_MIN, _BETA_MAX + 1, 5):
        ld = _log2_delta(beta)
        for m in range(max(1, n // 4), 2 * n + 1, 8):
            d = n + m
            log2_l = (d - 1) * ld + log2_vol / d
            # advantage: log2(1/eps) = 2 pi^2 (l sigma / q)^2 * log2(e)
            x = 2.0 ** (log2_l + math.log2(sigma) - log2_q)
            log2_inv_eps = 2.0 * math.pi * math.pi * x * x * _LOG2E
            if log2_inv_eps > 512:  # hopeless corner, skip the arithmetic
                continue
            cost = CLASSICAL_COST * beta + max(
                0.0, 2.0 * log2_inv_eps - _SIEVE_VECS * beta
            )
            best = min(best, cost)
    return best


@dataclasses.dataclass(frozen=True)
class SecurityEstimate:
    """Core-SVP estimate: attack blocksizes and resulting cost bits."""

    primal_beta: int
    primal_classical_bits: float
    primal_quantum_bits: float
    dual_classical_bits: float

    @property
    def classical_bits(self) -> float:
        return min(self.primal_classical_bits, self.dual_classical_bits)


def lwe_security(
    n: int, q: float, sigma: float, secret: str = "binary"
) -> SecurityEstimate:
    """Core-SVP security of LWE with dimension ``n``, modulus ``q`` and
    Gaussian noise of stddev ``sigma`` (absolute units)."""
    beta = primal_beta(n, q, sigma, secret)
    return SecurityEstimate(
        primal_beta=beta,
        primal_classical_bits=CLASSICAL_COST * beta,
        primal_quantum_bits=QUANTUM_COST * beta,
        dual_classical_bits=dual_cost_bits(n, q, sigma, secret),
    )


def rlwe_security(
    n: int, q: float, sigma: float, secret: str = "binary"
) -> SecurityEstimate:
    """Ring/GLWE security, priced as plain LWE in the full dimension
    (standard practice: no attack exploiting ring structure beats the
    generic lattice attacks for these shapes)."""
    return lwe_security(n, q, sigma, secret)


def ntru_security(n: int, q: float, sigma_key: float) -> SecurityEstimate:
    """NTRU key recovery as uSVP in the 2n-dimensional NTRU lattice
    (volume ``q^n``, target ``(f, g)`` of per-coefficient stddev
    ``sigma_key``) — the right model for non-overstretched moduli
    (``q`` polynomial in ``n``; the fatigue point is far above the
    shipped ``q ~ 2^20`` at ``n = 1024``).

    Structurally this is the primal condition with ``m = n`` and
    secret/noise of equal width, i.e. ``omega = 1``.
    """
    beta = primal_beta(n, q, sigma_key, secret="gaussian")
    return SecurityEstimate(
        primal_beta=beta,
        primal_classical_bits=CLASSICAL_COST * beta,
        primal_quantum_bits=QUANTUM_COST * beta,
        dual_classical_bits=float("inf"),  # no dual analogue for NTRU KR
    )


def required_sigma(
    n: int,
    q: float,
    target_classical_bits: float,
    secret: str = "binary",
) -> float:
    """Smallest noise stddev whose ``lwe_security`` clears the target —
    the parameter-selection helper ``params.py`` profiles were tuned
    with.  Binary-searched on log2(sigma) to 0.01-bit resolution."""
    lo, hi = -2.0, math.log2(q) - 1.0
    if lwe_security(n, q, 2.0**hi, secret).classical_bits < target_classical_bits:
        raise ValueError("target unreachable at any sigma below q/2")
    while hi - lo > 0.01:
        mid = 0.5 * (lo + hi)
        est = lwe_security(n, q, 2.0**mid, secret)
        if est.classical_bits >= target_classical_bits:
            hi = mid
        else:
            lo = mid
    return 2.0**hi


def tfhe_profile_security(params) -> dict:
    """Security report for a :class:`~primus_fhe_tpu.params.TfheParams`:
    the LWE layer (dimension ``lwe_dim``) and the GLWE layer (dimension
    ``glwe_dim * n``), both over the torus modulus 2^32 with binary
    secrets (``make_context`` samples both secrets uniformly binary)."""
    q = float(1 << 32)
    lwe = lwe_security(params.lwe_dim, q, params.lwe_sigma, "binary")
    glwe = rlwe_security(
        params.glwe_dim * params.n, q, params.glwe_sigma, "binary"
    )
    return {
        "lwe": lwe,
        "glwe": glwe,
        "classical_bits": min(lwe.classical_bits, glwe.classical_bits),
    }


def ntru_profile_security(params) -> dict:
    """Security report for a :class:`~primus_fhe_tpu.params.NtruParams`:
    NTRU key recovery at dimension ``n`` plus the binary-LWE layer
    (dimension ``lwe_dim`` mod ``q``).  The LWE layer is priced at
    ``lwe_sigma`` — the noise of BOTH fresh encryptions and the
    key-switch-key rows, the two kinds of LWE sample under the binary
    secret the adversary sees (``params.py`` convention; the benches
    and examples sample both at it)."""
    q = float(params.q)
    ntru = ntru_security(params.n, q, params.sigma)
    if params.lwe_sigma <= 0:
        raise ValueError(
            "NtruParams.lwe_sigma must be set (fresh-LWE + ksk noise)"
        )
    lwe = lwe_security(params.lwe_dim, q, params.lwe_sigma, "binary")
    return {
        "ntru": ntru,
        "lwe": lwe,
        "classical_bits": min(ntru.classical_bits, lwe.classical_bits),
    }
