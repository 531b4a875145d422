"""Large-n u64 NTT (n > 2^15) by four-step composition (port of
``LargeNttPlan64``, ``large_forward64`` and ``large_inverse64`` in
``primus_fhe_tpu/transforms/ntt_large.py``).

With ``n = A * B`` the negacyclic transform is

    batched size-A negacyclic NTTs  (root psi^B)
    one elementwise Shoup twiddle   (the cyclic-vs-negacyclic twist)
    batched size-B negacyclic NTTs  (root psi^A)

The sub-transforms are the ported kernels, on sub-plans built from powers of
the same top-level minimal root ``psi`` (so their outputs are bit-identical
whichever kernel runs them); the twiddles and the block transposes stay
torch ops, as they are XLA ops in the reference.  ``route``:

- ``"butterfly"``: ``ntt64_forward``/``ntt64_inverse`` (:mod:`..ops.ntt64`);
- ``"mxu8"``: ``mxu8_forward64``/``mxu8_inverse64`` (:mod:`..ops.ntt_mxu8`);
- ``"auto"``: ``"mxu8"`` where both factors are at least 2^8 (the reference's
  predicate without its TPU test) and at most 2^12 (the MXU kernels' range),
  else ``"butterfly"``.

Canonical outputs (``out_factor=1``) are the same words on both routes.
CPU tensors take each kernel's plain version.  Valid for ``q < 2^62`` and
factors up to 2^15.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.model import minimal_primitive_root
from ..modular.factor import ShoupFactor64, factor_mul_lazy64
from ..numeric.limb import u64_tensor
from ..ops.ntt64 import NttTables64, ntt64_forward, ntt64_inverse
from ..ops.ntt_mxu8 import Mxu8Tables64, mxu8_forward64, mxu8_inverse64
from ..utils.bits import reverse_lsbs
from .plan import _quot64
from ..utils.gcd import mod_inv

ROUTES = ("auto", "butterfly", "mxu8")


def _shoup_table(tab: np.ndarray, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    quot = np.vectorize(lambda v: _quot64(int(v), q), otypes=[object])(tab)
    return u64_tensor(tab), u64_tensor(quot)


class LargeNttPlan64:
    """Sub-plans and twiddle tables of the four-step u64 NTT of size
    ``2^log_n`` mod ``q``: ``A = 2^h1`` (default ``log_n // 2``), ``B = n /
    A``.  ``ntt_a``/``ntt_b`` are the butterfly tables of the size-A and
    size-B sub-transforms, ``mxu_a``/``mxu_b`` their byte-radix tables
    (built at first use)."""

    def __init__(self, log_n: int, q: int, h1: int | None = None):
        if q >= 1 << 62:
            raise ValueError("LargeNttPlan64 requires q < 2^62")
        self.log_n, self.n, self.q = log_n, 1 << log_n, int(q)
        h1 = log_n // 2 if h1 is None else h1
        h2 = log_n - h1
        if not 1 <= h1 <= 15 or not 1 <= h2 <= 15:
            raise ValueError("factors must each lie in [2, 2^15]")
        self.h1, self.h2 = h1, h2
        self.A, self.B = A, B = 1 << h1, 1 << h2
        n = self.n
        psi = minimal_primitive_root(log_n + 1, q)
        self.root = psi
        self.ntt_a = NttTables64(h1, [q], roots=[pow(psi, B, q)])
        self.ntt_b = NttTables64(h2, [q], roots=[pow(psi, A, q)])
        self.mxu_a, self.mxu_b = Mxu8Tables64(self.ntt_a), Mxu8Tables64(self.ntt_b)

        ordinal = [1] * (2 * n)  # psi^e
        for e in range(1, 2 * n):
            ordinal[e] = ordinal[e - 1] * psi % q
        rev1 = [reverse_lsbs(i, h1) for i in range(A)]
        omega = psi * psi % q
        iomega = mod_inv(omega, q)
        # forward twiddle in the [k0, r0] grid: psi^(k0 (1 - A)) omega^(rev1[r0] k0)
        tw = np.empty((B, A), dtype=object)
        for k0 in range(B):
            base, step = ordinal[(k0 * (1 - A)) % (2 * n)], pow(omega, k0, q)
            pows = [1] * A
            for e in range(1, A):
                pows[e] = pows[e - 1] * step % q
            for r0 in range(A):
                tw[k0, r0] = base * pows[rev1[r0]] % q
        # inverse twiddle in the [r0, k0] grid: psi^(k0 (A - 1)) omega^(-rev1[r0] k0)
        t2 = np.empty((A, B), dtype=object)
        for r0 in range(A):
            step, cur = pow(iomega, rev1[r0], q), 1
            for k0 in range(B):
                t2[r0, k0] = cur * ordinal[(k0 * (A - 1)) % (2 * n)] % q
                cur = cur * step % q
        self.tw, self.tw_pre = _shoup_table(tw, self.q)
        self.t2, self.t2_pre = _shoup_table(t2, self.q)
        self._on: dict = {}

    def twiddles(self, device) -> tuple:
        """``(ShoupFactor64 forward (B, A), ShoupFactor64 inverse (A, B))``
        on ``device``."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = (ShoupFactor64(self.tw.to(device), self.tw_pre.to(device)),
                                ShoupFactor64(self.t2.to(device), self.t2_pre.to(device)))
        return self._on[device]


def resolve_route(plan: LargeNttPlan64, route: str = "auto") -> str:
    """``"mxu8"`` or ``"butterfly"`` for ``route`` on ``plan``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "auto":
        return "mxu8" if all(8 <= h <= 12 for h in (plan.h1, plan.h2)) else "butterfly"
    return route


def large_forward64(plan: LargeNttPlan64, values: torch.Tensor, out_factor: int = 1,
                    route: str = "auto") -> torch.Tensor:
    """Forward negacyclic NTT, contract of :func:`.ntt.forward64`:
    ``values (..., n)`` normal order in ``[0, 4q)``, bit-reversed output,
    canonical for ``out_factor=1``, below ``4q`` for ``4`` (canonical on the
    ``"mxu8"`` route)."""
    if out_factor not in (1, 4):
        raise ValueError("out_factor must be 1 or 4")
    mxu = resolve_route(plan, route) == "mxu8"

    def sub(tabs, mtabs, v, of):
        return mxu8_forward64(mtabs, v, of) if mxu else ntt64_forward(tabs, v, of)

    A, B, n = plan.A, plan.B, plan.n
    batch = values.shape[:-1]
    b = values.numel() // n
    tw, _ = plan.twiddles(values.device)
    # columns: size-A transforms over k1 (rows k0)
    v = values.reshape(b, A, B).transpose(1, 2).reshape(1, b * B, A)
    y = sub(plan.ntt_a, plan.mxu_a, v, 4).reshape(b, B, A)
    y = factor_mul_lazy64(y, tw, plan.q)  # [0, 2q), grid [k0, r0]
    # rows: size-B transforms over k0 (rows r0)
    v2 = y.transpose(1, 2).reshape(1, b * A, B)
    return sub(plan.ntt_b, plan.mxu_b, v2, out_factor).reshape(*batch, n)


def large_inverse64(plan: LargeNttPlan64, values: torch.Tensor, out_factor: int = 1,
                    route: str = "auto") -> torch.Tensor:
    """Inverse negacyclic NTT, contract of :func:`.ntt.inverse64` with input
    in ``[0, 4q)``: bit-reversed input, normal-order output, canonical for
    ``out_factor=1``, below ``2q`` for ``2``."""
    if out_factor not in (1, 2):
        raise ValueError("out_factor must be 1 or 2")
    mxu = resolve_route(plan, route) == "mxu8"

    def sub(tabs, mtabs, v, of, in_factor):
        return mxu8_inverse64(mtabs, v, of) if mxu else ntt64_inverse(tabs, v, of, in_factor)

    A, B, n = plan.A, plan.B, plan.n
    batch = values.shape[:-1]
    b = values.numel() // n
    _, t2 = plan.twiddles(values.device)
    # rows: size-B inverses over r1 (rows r0)
    y = sub(plan.ntt_b, plan.mxu_b, values.reshape(1, b * A, B), 2, 4).reshape(b, A, B)
    y = factor_mul_lazy64(y, t2, plan.q)  # [0, 2q), grid [r0, k0]
    # columns: size-A inverses over r0 (rows k0)
    v2 = y.transpose(1, 2).reshape(1, b * B, A)
    out = sub(plan.ntt_a, plan.mxu_a, v2, out_factor, 2).reshape(b, B, A)
    return out.transpose(1, 2).reshape(*batch, n)
