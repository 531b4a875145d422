"""DCRT table: independent NTTs over a stacked residue axis (port of
``DcrtPlan32``, ``build_dcrt_plan32``, ``dcrt_forward32``, ``dcrt_inverse32``,
``DcrtPlan64``, ``build_dcrt_plan64``, ``dcrt_forward64``, ``dcrt_inverse64``,
``dcrt_monomial64`` and the routed ``dcrt_forward64_fast`` /
``dcrt_inverse64_fast`` of ``primus_fhe_tpu/transforms/dcrt.py``).

The 32-bit half: ``(count, ..., n)`` int64 tensors of u32 residues, prime
``i`` on ``values[i]``, through kernels 1-2 (:mod:`..ops.ntt32`, up to four
primes a launch) on a CUDA tensor and their plain butterflies on the CPU;
lazy outputs (``out_factor`` 4 forward, 2 inverse) are the butterfly's words
on both.

The 64-bit half:

values are ``(count, ..., n)`` int64 tensors of u64 words, modulus ``i`` on
``values[i]``.  ``dcrt_forward64``/``dcrt_inverse64`` are the plain
butterflies (the reference's XLA-staged path); the ``_fast`` transforms
route every modulus through one kernel, one launch a group of up to four
moduli (:func:`..ops.ntt64.mod_groups`; a base may hold any number):

- ``"mxu8"``: the byte-radix four-step on the int8 tensor cores
  (:func:`..ops.ntt_mxu8.mxu8_forward64`), canonical output; at ``log_n``
  13-17 the same function on row 10's passes (to 2^17 on the card);
- ``"butterfly"``: the 64-bit Harvey butterfly
  (:func:`..ops.ntt64.ntt64_forward`);
- ``"auto"``: the reference's predicate ``_mxu_ok`` (``q < 2^62`` and
  ``log_n >= 8``) for every modulus, within the MXU kernels' range
  ``log_n <= 12``; the butterfly otherwise.

Both routes give the same canonical words at ``out_factor=1``.  CPU tensors
take each kernel's plain version, so a CPU run is bit-equal to the
reference's CPU run (which always takes the XLA path) at ``out_factor=1``.
"""

from __future__ import annotations

import torch

from ..ops import ntt32
from ..ops.ntt64 import NttTables64, ntt64_forward, ntt64_forward_plain, ntt64_inverse
from ..ops.ntt64 import ntt64_inverse_plain

ROUTES = ("auto", "butterfly", "mxu8")


class DcrtPlan32:
    """Stacked u32 NTT plans of ``moduli`` (each ``q < 2^31``, ``q = 1 mod
    2n``): the tables of kernels 1-2, in groups of at most
    ``ntt32.MAX_PRIMES`` primes (one launch a group)."""

    def __init__(self, log_n: int, moduli):
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = tuple(int(q) for q in moduli)
        step = ntt32.MAX_PRIMES
        self.groups = [ntt32.NttTables32(log_n, self.moduli[i:i + step])
                       for i in range(0, len(self.moduli), step)]

    @property
    def count(self) -> int:
        return len(self.moduli)


def build_dcrt_plan32(log_n: int, moduli) -> DcrtPlan32:
    return DcrtPlan32(log_n, moduli)


def _per_group(plan: DcrtPlan32, fn, values, out_factor):
    if len(plan.groups) == 1:
        return fn(plan.groups[0], values, out_factor)
    step = ntt32.MAX_PRIMES
    return torch.cat([fn(t, values[i * step:(i + 1) * step], out_factor)
                      for i, t in enumerate(plan.groups)])


def dcrt_forward32(plan: DcrtPlan32, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT over all residues ``(count, ..., n)`` (normal order, words
    in ``[0, 4q)``) -> bit-reversed, canonical (``out_factor`` 1) or in
    ``[0, 4q)`` (4)."""
    return _per_group(plan, ntt32.forward32, values, out_factor)


def dcrt_inverse32(plan: DcrtPlan32, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT over all residues (bit-reversed input in ``[0, 2q)``) ->
    normal order, canonical (``out_factor`` 1) or in ``[0, 2q)`` (2)."""
    return _per_group(plan, ntt32.inverse32, values, out_factor)


class DcrtPlan64:
    """Stacked u64 NTT plans of ``moduli`` (each ``q < 2^62``, ``q = 1 mod
    2n``): the butterfly tables, the four-step tables (built at first use)
    and the monomial tables ``ordinal_roots (count, 2n)`` and
    ``monomial_base (n,)``."""

    def __init__(self, log_n: int, moduli):
        self.log_n = log_n
        self.n = 1 << log_n
        self.moduli = tuple(int(q) for q in moduli)
        self.ntt = NttTables64(log_n, self.moduli)
        self._mxu = None
        self._mono: dict = {}

    @property
    def count(self) -> int:
        return len(self.moduli)

    @property
    def mxu(self):
        """:class:`..ops.ntt_mxu8.Mxu8Tables64` of the moduli (built once);
        the byte-radix route needs ``log_n >= 8`` (``B >= 128`` lanes), as the
        JAX plan does; on the card its kernels take ``log_n`` 8-17 (the
        byte-radix kernels to 12, row 10's passes above)."""
        if self.log_n < 8:
            raise ValueError("the byte-radix plan needs log_n >= 8 (B >= 128 lanes)")
        if self._mxu is None:
            from ..ops.ntt_mxu8 import Mxu8Tables64

            self._mxu = Mxu8Tables64(self.ntt)
        return self._mxu

    def monomial_tables(self, device):
        """``(ordinal_roots (count, 2n), monomial_base (n,))`` on ``device``."""
        device = torch.device(device)
        if device not in self._mono:
            plans = self.ntt.plans
            self._mono[device] = (
                torch.stack([pl.ordinal_roots for pl in plans]).to(device),
                plans[0].monomial_base.to(device),
            )
        return self._mono[device]


def build_dcrt_plan64(log_n: int, moduli) -> DcrtPlan64:
    return DcrtPlan64(log_n, moduli)


def dcrt_forward64(plan: DcrtPlan64, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT over all residues (plain butterfly): ``(count, ..., n)``."""
    return ntt64_forward_plain(plan.ntt, values, out_factor)


def dcrt_inverse64(plan: DcrtPlan64, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT over all residues (plain butterfly)."""
    return ntt64_inverse_plain(plan.ntt, values, out_factor)


def dcrt_monomial64(plan: DcrtPlan64, degree, negate=False) -> torch.Tensor:
    """NTT of ``±X^degree`` for every modulus: ``(count, *shape, n)`` for a
    ``degree`` tensor of shape ``(*shape, 1)`` (degrees wrap mod 2n).  In
    the NTT domain a monomial is diagonal: ``out[j] = psi^((2 rev(j) + 1)
    degree)``, ``negate`` flips the index by ``n`` (``psi^n = -1``)."""
    ordinal, base = plan.monomial_tables(degree.device)
    idx = (base * degree.to(torch.int64)) & (2 * plan.n - 1)
    if negate is not False:
        idx = idx ^ (torch.as_tensor(negate, device=idx.device).to(torch.int64) * plan.n)
    return ordinal[:, idx]


def _mxu_ok(log_n: int, q: int) -> bool:
    """The reference's byte-radix predicate: ``q < 2^62`` and ``log_n >= 8``."""
    return q < (1 << 62) and log_n >= 8


def resolve_route(plan: DcrtPlan64, route: str = "auto") -> str:
    """``"mxu8"`` or ``"butterfly"`` for ``route`` on ``plan``."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if route == "auto":
        ok = plan.log_n <= 12 and all(_mxu_ok(plan.log_n, q) for q in plan.moduli)
        return "mxu8" if ok else "butterfly"
    return route


def dcrt_forward64_fast(plan: DcrtPlan64, values: torch.Tensor, out_factor: int = 1,
                        route: str = "auto"):
    """Forward NTT over all residues, one kernel launch a group of up to
    four moduli (see the module docstring for the routes)."""
    if resolve_route(plan, route) == "mxu8":
        from ..ops.ntt_mxu8 import mxu8_forward64

        return mxu8_forward64(plan.mxu, values, out_factor)
    return ntt64_forward(plan.ntt, values, out_factor)


def dcrt_inverse64_fast(plan: DcrtPlan64, values: torch.Tensor, out_factor: int = 1,
                        route: str = "auto"):
    """Inverse NTT over all residues, one kernel launch a group of up to
    four moduli."""
    if resolve_route(plan, route) == "mxu8":
        from ..ops.ntt_mxu8 import mxu8_inverse64

        return mxu8_inverse64(plan.mxu, values, out_factor)
    return ntt64_inverse(plan.ntt, values, out_factor)
