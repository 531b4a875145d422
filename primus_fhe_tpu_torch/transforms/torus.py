"""Exact torus negacyclic convolution via CRT-NTT (port of
``TorusConvolver32`` and ``TorusConvolver64`` in
``primus_fhe_tpu/transforms/torus.py``).

1. centered lift of torus words into residues mod a few 30-bit NTT primes,
2. per-prime negacyclic NTTs (kernels 1 and 2 on a CUDA tensor,
   :mod:`..ops.ntt32`),
3. pointwise multiply-accumulate in the NTT domain,
4. inverse NTTs and CRT recombination back to the torus, with the CRT
   quotient ``alpha`` recovered by integer fixed-point arithmetic — no
   floats anywhere.

Correctness condition: every centered convolution value satisfies
``|V| < P/8`` where ``P`` is the prime product; ``bound_bits`` (a proven
bound on ``log2 |V|``) picks enough primes.

:class:`TorusConvolver64` does the same for the 2^64 torus (u64 words as
int64 bit patterns), the full 64-bit range exact, through the 32-bit DCRT
transforms (:func:`.dcrt.dcrt_forward32`, kernels 1-2 on a CUDA tensor).
"""

from __future__ import annotations

import numpy as np
import torch

from ..modular.factor import factor_mul32, shoup32
from ..modular.modops import (add32, barrett_lazy_reduce32, lazy_mul32, mul32, reduce_once32,
                              sub32)
from ..modular.modulus import barrett32
from ..numeric.limb import MASK32, as_i64, u64_tensor
from ..ops import ntt32
from ..rns.converter import _alpha_fixed32
from ..utils.gcd import mod_inv
from ..utils.primes import next_ntt_prime


def _pick_primes(log_n: int, bound_bits: int):
    """30-bit NTT primes until the product covers ``bound_bits + 3``."""
    primes: list[int] = []
    below = None
    prod = 1
    while prod.bit_length() <= bound_bits + 3:
        p = next_ntt_prime(30, log_n, below)
        primes.append(p)
        below = p
        prod *= p
    return primes, prod


class TorusConvolver32:
    """Exact negacyclic convolver for the 2^32 torus (int64-carried words).

    Constants live on the CPU and are copied once to each device they are
    used on (:meth:`consts`).
    """

    def __init__(self, log_n: int, bound_bits: int = 56):
        self.log_n = log_n
        self.n = 1 << log_n
        primes, prod = _pick_primes(log_n, bound_bits)
        self.primes = primes
        self.product = prod
        self.count = len(primes)
        self.ntt = ntt32.NttTables32(log_n, primes)

        punctured = [prod // p for p in primes]
        inv_punct = [mod_inv(pp % p, p) for pp, p in zip(punctured, primes)]
        self.inv_punctured = shoup32(inv_punct, primes)  # (k,)
        self.alpha_fix = [(1 << 64) // p for p in primes]  # floor(2^64 / p_i)
        self.punctured_mod_t = [pp % (1 << 32) for pp in punctured]
        self.product_mod_t = prod % (1 << 32)
        # host pack the CMux stage-2 kernel unpacks into CrtConsts
        # (csrc/modarith32.cuh): per prime (P/p)^-1, its Shoup quotient,
        # floor(2^64/p), (P/p) mod 2^32; then P mod 2^32.
        iw = self.inv_punctured
        self.crt_pack = np.array(
            [
                v
                for i in range(self.count)
                for v in (int(iw.value[i]), int(iw.quotient[i]), self.alpha_fix[i],
                          self.punctured_mod_t[i])
            ]
            + [self.product_mod_t],
            dtype=np.uint64,
        )
        self._consts: dict = {}

    def consts(self, device) -> dict:
        """Per-prime constants as ``(k, 1)`` int64 tensors on ``device``."""
        device = torch.device(device)
        if device not in self._consts:
            col = (self.count, 1)

            def t(vals):
                return torch.tensor(vals, dtype=torch.int64, device=device).reshape(col)

            self._consts[device] = dict(
                modulus=barrett32(self.primes, device).map(lambda x: x.reshape(col)),
                wrap_c=t([(1 << 32) % p for p in self.primes]),
                inv_punctured=self.inv_punctured.map(lambda x: x.to(device).reshape(col)),
                alpha_lo=t([a & MASK32 for a in self.alpha_fix]),
                alpha_hi=t([a >> 32 for a in self.alpha_fix]),
                punctured_mod_t=t(self.punctured_mod_t),
            )
        return self._consts[device]

    def _m(self, x: torch.Tensor, extra: int):
        """Barrett record on ``x``'s device, shaped ``(k, 1...)`` with
        ``extra`` trailing singleton axes."""
        shape = (self.count,) + (1,) * extra
        return self.consts(x.device)["modulus"].map(lambda v: v.reshape(shape))

    # -- pipeline stages ----------------------------------------------------

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        """Centered lift: torus words ``(..., n)`` -> residues ``(k, ..., n)``.

        ``value = x - 2^32 * [x >= 2^31]``; residue = ``x mod p`` minus the
        wrap constant when negative.
        """
        nd = x.dim()
        c = self.consts(x.device)
        m = self._m(x, nd)
        xb = x.unsqueeze(0)
        r = reduce_once32(barrett_lazy_reduce32(xb, m), m.value)
        wrap = c["wrap_c"].reshape((self.count,) + (1,) * nd)
        return torch.where((xb >> 31) != 0, sub32(r, wrap, m.value), r)

    def forward(self, x: torch.Tensor, out_factor: int = 1) -> torch.Tensor:
        """Torus poly ``(..., n)`` -> NTT-domain residues ``(k, ..., n)``."""
        return ntt32.forward32(self.ntt, self.lift(x), out_factor)

    def mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Pointwise canonical product of NTT-domain residue tensors
        ``(k, ...)`` (broadcasting)."""
        extra = max(fa.dim(), fb.dim()) - 1
        return mul32(fa, fb, self._m(fa, extra))

    def add_mul_lazy(self, acc: torch.Tensor, fa: torch.Tensor, fb: torch.Tensor,
                     extra: int | None = None) -> torch.Tensor:
        """``acc + fa * fb`` with a lazy product, canonical (the accumulate
        of ``FourierPolynomial::add_mul_assign``: exact, one reduce a
        term).  ``extra``: the trailing axes after the prime axis (default:
        from the operands)."""
        if extra is None:
            extra = max(acc.dim(), fa.dim(), fb.dim()) - 1
        m = self._m(fa, extra)
        t = lazy_mul32(fa, fb, m)
        return reduce_once32(add32(acc, reduce_once32(t, m.value), m.value), m.value)

    def inverse(self, res: torch.Tensor) -> torch.Tensor:
        """NTT-domain residues -> coefficient-domain residues, canonical."""
        return ntt32.inverse32(self.ntt, res)

    def recombine(self, res: torch.Tensor) -> torch.Tensor:
        """Coefficient residues ``(k, ..., n)`` -> torus words ``(..., n)``.

        All-integer CRT: ``y_i = r_i (P/p_i)^-1 mod p_i``;
        ``V = sum y_i (P/p_i) - alpha P`` with
        ``alpha = round(sum y_i / p_i) = (S + 2^63) >> 64`` for the exact
        fixed-point sum ``S = sum y_i * floor(2^64 / p_i)``.  ``S`` is kept
        as ``H * 2^32 + L`` with ``L < 2^32``, so
        ``alpha = (H + 2^31) >> 32``.
        """
        k = self.count
        nd = res.dim() - 1
        c = self.consts(res.device)
        shape = (k,) + (1,) * nd
        m = self._m(res, nd)
        f = c["inv_punctured"].map(lambda v: v.reshape(shape))
        y = factor_mul32(res, f, m.value)  # (k, ..., n) in [0, p_i)
        lo_terms = y * c["alpha_lo"].reshape(shape)  # < 2^62 each
        hi_terms = (lo_terms >> 32) + y * c["alpha_hi"].reshape(shape)
        low = (lo_terms & MASK32).sum(dim=0)
        high = hi_terms.sum(dim=0) + (low >> 32)
        alpha = (high + (1 << 31)) >> 32
        # V mod 2^32 = sum y_i * (P/p_i) - alpha * P   (wrapping)
        total = ((y * c["punctured_mod_t"].reshape(shape)) & MASK32).sum(dim=0)
        return (total - alpha * self.product_mod_t) & MASK32

    # -- composite ----------------------------------------------------------

    def negacyclic_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact ``a * b`` in ``Z_{2^32}[X]/(X^n+1)`` for torus polys."""
        return self.recombine(self.inverse(self.mul(self.forward(a), self.forward(b))))


class TorusConvolver64:
    """Exact negacyclic convolver for the 2^64 torus (int64 tensors of u64
    words): centered lift into 30-bit NTT primes, per-prime NTTs
    (:class:`.dcrt.DcrtPlan32`), and an all-integer CRT recombination with
    ``alpha`` in 2^64 fixed point.  ``bound_bits`` must bound ``log2`` of
    the centered accumulator (``63 + log2(n * level * (k+1) * B/2)`` for an
    external product).  The device of the input picks the kernels or the
    plain versions."""

    def __init__(self, log_n: int, bound_bits: int = 88):
        from .dcrt import build_dcrt_plan32  # a cycle at import: ops.ntt64 -> transforms

        self.log_n = log_n
        self.n = 1 << log_n
        primes, prod = _pick_primes(log_n, bound_bits)
        self.primes = primes
        self.product = prod
        self.count = len(primes)
        self.plan = build_dcrt_plan32(log_n, primes)
        punctured = [prod // p for p in primes]
        self.inv_punctured = shoup32([mod_inv(pp % p, p) for pp, p in zip(punctured, primes)],
                                     primes)
        self.punctured_mod_t = [pp % (1 << 64) for pp in punctured]
        self.product_mod_t = as_i64(prod % (1 << 64))
        self._consts: dict = {}

    def consts(self, device) -> dict:
        """Per-prime constants as ``(k, 1)`` int64 tensors on ``device``
        (u64 words as their patterns)."""
        device = torch.device(device)
        if device not in self._consts:
            col = (self.count, 1)

            def t(vals):
                return u64_tensor(np.array(vals, dtype=object), device).reshape(col)

            self._consts[device] = dict(
                modulus=barrett32(self.primes, device).map(lambda x: x.reshape(col)),
                c32=t([(1 << 32) % p for p in self.primes]),
                c64=t([(1 << 64) % p for p in self.primes]),
                inv_punctured=self.inv_punctured.map(lambda x: x.to(device).reshape(col)),
                alpha_fix=t([(1 << 64) // p for p in self.primes]),
                punctured_mod_t=t(self.punctured_mod_t),
            )
        return self._consts[device]

    def _m(self, x: torch.Tensor, extra: int):
        shape = (self.count,) + (1,) * extra
        return self.consts(x.device)["modulus"].map(lambda v: v.reshape(shape))

    def lift(self, x: torch.Tensor) -> torch.Tensor:
        """Centered lift: u64 words ``(..., n)`` -> residues ``(k, ..., n)``:
        ``value = lo + hi 2^32 - 2^64 [hi >= 2^31]``, so ``r = lo + hi c32 -
        sign c64 (mod p)``."""
        nd = x.dim()
        c = self.consts(x.device)
        m = self._m(x, nd)
        shape = (self.count,) + (1,) * nd
        lo, hi = (x & MASK32).unsqueeze(0), ((x >> 32) & MASK32).unsqueeze(0)
        r_lo = reduce_once32(barrett_lazy_reduce32(lo, m), m.value)
        r_hi = reduce_once32(barrett_lazy_reduce32(hi, m), m.value)
        r = add32(r_lo, mul32(r_hi, c["c32"].reshape(shape), m), m.value)
        return torch.where((hi >> 31) != 0, sub32(r, c["c64"].reshape(shape), m.value), r)

    def forward(self, x: torch.Tensor, out_factor: int = 1) -> torch.Tensor:
        """u64 torus poly ``(..., n)`` -> NTT-domain residues ``(k, ..., n)``."""
        from .dcrt import dcrt_forward32

        return dcrt_forward32(self.plan, self.lift(x), out_factor)

    def mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """Pointwise canonical product of NTT-domain residues (broadcasting)."""
        extra = max(fa.dim(), fb.dim()) - 1
        return mul32(fa, fb, self._m(fa, extra))

    def inverse(self, res: torch.Tensor) -> torch.Tensor:
        """NTT-domain residues -> coefficient-domain residues, canonical."""
        from .dcrt import dcrt_inverse32

        return dcrt_inverse32(self.plan, res)

    def recombine(self, res: torch.Tensor) -> torch.Tensor:
        """Coefficient residues ``(k, ..., n)`` -> u64 torus words ``(..., n)``:
        ``V = sum y_i (P/p_i) - alpha P (mod 2^64)``, ``y_i = r_i (P/p_i)^-1
        mod p_i``, ``alpha = round(sum y_i / p_i)``
        (:func:`..rns.converter._alpha_fixed32`); wrapping int64 products and
        sums are the u64 words mod 2^64."""
        nd = res.dim() - 1
        c = self.consts(res.device)
        shape = (self.count,) + (1,) * nd
        m = self._m(res, nd)
        y = factor_mul32(res, c["inv_punctured"].map(lambda v: v.reshape(shape)), m.value)
        alpha = _alpha_fixed32(y, c["alpha_fix"].reshape(-1))
        u = c["punctured_mod_t"].reshape(shape)
        total = y[0] * u[0]
        for i in range(1, self.count):
            total = total + y[i] * u[i]
        return total - alpha * self.product_mod_t

    def negacyclic_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Exact ``a * b`` in ``Z_{2^64}[X]/(X^n+1)``."""
        return self.recombine(self.inverse(self.mul(self.forward(a), self.forward(b))))
