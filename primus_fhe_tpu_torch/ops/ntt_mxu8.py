"""The byte-radix four-step NTT kernels on the int8 tensor cores.

- Kernel C, ``mxu8_forward32``: the u32 tier (4 byte planes, ``q < 2^30``)
  of ``mxu8_fused_forward64`` (``primus_fhe_tpu/ops/ntt_mxu8.py:917``),
  which ``prepare_mxu_bsk`` and ``prepare_mxu_evk`` run.
- ``mxu8_forward64`` and ``mxu8_inverse64``: the 7- and 8-plane tiers
  (``q < 2^53`` and ``q < 2^62``) of ``mxu8_fused_forward64`` and
  ``mxu8_fused_inverse64`` (``ntt_mxu8.py:917,959``), which the DCRT
  transforms run for ``log_n >= 8``; with their plan
  :class:`Mxu8NttPlan64` (port of ``ntt_mxu8.py:156-300``) and the
  per-modulus stack :class:`Mxu8Tables64`.

- Kernel D, ``mxu8_inverse64_mul``, and kernel E, ``mxu8_roundtrip64_mul``:
  ``mxu8_fused_inverse64_mul`` and ``mxu8_fused_roundtrip64_mul``
  (``ntt_mxu8.py:968,977``), the inverse with a pointwise multiply by a
  fixed NTT-domain operand fused in front, and the whole negacyclic product
  by that operand (forward, multiply, inverse) in one launch; the operand
  comes as a :meth:`Mxu8Tables64.mul_table`.

All but the round trip reach ``pallas_call`` through
``ops/mxu_common._natural_call`` in the reference.  CUDA source:
``csrc/ntt_mxu8.cu``; design and bounds are stated there.

The four-step's natural output order is the butterfly NTT's bit-reversed
order, so each plain version is the canonical butterfly transform
(:mod:`.ntt32` or :mod:`.ntt64`); kernel C's is viewed as ``(..., A, 128)``.

Lazy words, one rule for every byte-radix entry point (rows 9, 12 and 13):
at ``out_factor`` 1 an output is canonical and word-equal to the
reference's; above 1 it is congruent mod q and below ``out_factor * q``
(the reference may leave words up to that bound, these kernels give
canonical ones); an intermediate (row 13's pass-1 halves,
:mod:`.ntt_mxu8_split`) is congruent mod q and below the bound its
docstring states.

The u64 plan keeps the JAX plan's plane matrices with 8 operand planes
instead of P: the kernels feed a u64 word's own 8 unsigned bytes (mma u8 x
s8), so any u64 input is taken whole.  The JAX plan's bias, correction and
Solinas tables exist for its XOR-0x80 signed feed and its u32-pair folds;
none of them is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..modular.factor import ShoupFactor64, factor_mul64, factor_mul_lazy64
from ..numeric.limb import narrow_u32, u64_numpy, u64_tensor, widen_u32
from ..transforms.plan import _quot64
from . import build
from .cmux_mxu import LANES, _balanced_digits, kernel_layout
from .mxu_common import four_step_matrices
from .ntt32 import forward32_plain
from .ntt64 import NttTables64, ntt64_forward_plain, ntt64_inverse_plain


def mxu8_forward32_plain(plan, values: torch.Tensor) -> torch.Tensor:
    """Plain version: per-prime canonical butterfly forward NTT."""
    out = forward32_plain(plan.ntt, values, out_factor=1)
    return out.reshape(*out.shape[:-1], plan.A, plan.B)


def mxu8_forward32(plan, values: torch.Tensor) -> torch.Tensor:
    """Forward NTT of canonical residues ``values (kp, ..., n)`` (prime ``i``
    of ``plan.primes`` on ``values[i]``) -> canonical NTT values in
    bit-reversed order, ``(kp, ..., A, 128)``.

    CPU tensors take the plain version, CUDA tensors kernel C (one launch
    for every prime); the output keeps the input's storage.
    """
    if values.device.type == "cpu":
        out = mxu8_forward32_plain(plan, widen_u32(values))
        return narrow_u32(out) if values.dtype == torch.int32 else out
    if values.device.type != "cuda":
        raise ValueError(f"mxu8_forward32: unsupported device {values.device}")
    kp, n = len(plan.primes), plan.n
    if values.shape[0] != kp or values.shape[-1] != n:
        raise ValueError(f"expected (kp={kp}, ..., n={n}), got {tuple(values.shape)}")
    v = narrow_u32(values).contiguous()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        tabs = plan.kernel_tables(v.device)
        err = build.library().pft_ntt_mxu8_forward(
            v.data_ptr(), out.data_ptr(), tabs["w1_4"].data_ptr(), tabs["w2"].data_ptr(),
            tabs["tw"].data_ptr(), build.ptr(plan.ntt.prime_pack), kp, rows, plan.log_n,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, "mxu8_forward32")
        mxu8_forward32.launches += 1
    out = out.reshape(*out.shape[:-1], plan.A, plan.B)
    return out if values.dtype == torch.int32 else widen_u32(out)


mxu8_forward32.launches = 0


# ---------------------------------------------------------------------------
# The u64 tiers
# ---------------------------------------------------------------------------


def _planes_for(q: int) -> int:
    """4 byte planes for ``q < 2^30``, 7 for ``q < 2^53``, 8 for ``q < 2^62``."""
    if q < 1 << 30:
        return 4
    if q < 1 << 53:
        return 7
    if q < 1 << 62:
        return 8
    raise ValueError("byte-radix MXU plan requires q < 2^62")


def byte_matrix(m, q: int, planes: int, value_planes: int) -> np.ndarray:
    """``W[(c, r), (l, k)] = bal_c(M[r, k] * 2^(8l) mod q)``: ``planes``
    balanced base-256 output digits, ``value_planes`` operand planes."""
    R, K = m.shape
    w = np.zeros((planes * R, value_planes * K), dtype=np.int8)
    for l in range(value_planes):
        digs = _balanced_digits((m * pow(2, 8 * l, q)) % q, planes)
        for c in range(planes):
            w[c * R : (c + 1) * R, l * K : (l + 1) * K] = digs[c]
    return w


def _precon64(m) -> np.ndarray:
    """Object-int matrix -> u64 numpy of its values."""
    return np.asarray([int(v) for v in np.ravel(m)], dtype=np.uint64).reshape(np.shape(m))


class Mxu8NttPlan64:
    """Byte-radix four-step plan of one modulus ``q < 2^62`` at ``8 <= log_n
    <= 14``: ``A = n / 128`` rows by ``B = 128`` lanes (the JAX plan's
    default split in that range), ``planes`` output digit planes (the
    natural tier, or an override at least that), on the minimal root or an
    explicit ``root`` (the four-step sub-plans of ``transforms.ntt_large``).

    ``w1``/``w2`` (forward) and ``wi1``/``wi2`` (inverse, ``inv_n`` folded
    into ``wi2``) have rows ``(c, out)`` and columns ``(l, in)`` over all 8
    operand planes; :meth:`jax_tables` cuts them to the JAX plan's
    ``w1f, w2f, w1mf, w2mf`` (P operand planes).  ``tw``/``twi`` are the
    twiddles ``(A, B)`` with their Shoup quotients, and ``mats`` the four
    pass matrices ``m1 (r0, k1)``, ``m2 (r1, k0)``, ``m2i (k0, r1)``, ``m1i
    (k1, r0)`` (rows out, columns in) as u64 words.
    """

    def __init__(self, log_n: int, q: int, planes: int | None = None, root: int | None = None):
        natural = _planes_for(q)
        if planes is None:
            planes = natural
        elif planes not in (4, 7, 8) or planes < natural:
            raise ValueError(f"planes must be in {{4,7,8}} and >= the natural tier {natural}")
        if not 8 <= log_n <= 14:
            raise ValueError("Mxu8NttPlan64 needs 8 <= log_n <= 14 (B = 128 lanes)")
        self.planes = P = planes
        self.log_n, self.n, self.q = log_n, 1 << log_n, int(q)
        h1 = log_n - 7
        self.A, self.B = 1 << h1, LANES
        fs = four_step_matrices(log_n, q, h1, h1, root)
        self.w1 = byte_matrix(fs["m1"], q, P, 8)  # rows (c, r0), cols (l, k1)
        self.w2 = byte_matrix(fs["m2"], q, P, 8)  # rows (c, r1), cols (l, k0)
        self.wi1 = byte_matrix(fs["m2i"], q, P, 8)  # rows (c, k0), cols (l, r1)
        self.wi2 = byte_matrix(fs["m1i"], q, P, 8)  # rows (c, k1), cols (l, r0)
        self.tw, self.twi = _precon64(fs["tw"]), _precon64(fs["twi"])
        # the four pass matrices (rows out, columns in) for the plain halves
        self.mats = {name: _precon64(fs[name]) for name in ("m1", "m2", "m2i", "m1i")}
        quot = np.vectorize(lambda v: _quot64(int(v), self.q), otypes=[object])
        self.tw_p = _precon64(quot(fs["tw"]))
        self.twi_p = _precon64(quot(fs["twi"]))

    def jax_tables(self) -> dict:
        """The JAX plan's ``w1f, w2f, w1mf, w2mf`` (``P`` operand planes)."""
        P, A, B = self.planes, self.A, self.B
        return dict(w1f=self.w1[:, : P * A], w2f=self.w2[:, : P * B].T,
                    w1mf=self.wi1[:, : P * B].T, w2mf=self.wi2[:, : P * A])


class Mxu8Tables64:
    """The u64 four-step plans of every modulus of a butterfly table stack
    (on its roots) at one plane count (the largest natural tier, at least 7:
    the kernels are built for 7 and 8 planes), and their kernel-side copies.
    The plans are built at first use: the plain versions need only ``ntt``,
    at any ``log_n``."""

    def __init__(self, ntt: NttTables64):
        self.ntt = ntt
        self.log_n, self.n, self.moduli = ntt.log_n, ntt.n, ntt.moduli
        self.planes = max([7] + [_planes_for(q) for q in self.moduli])
        self.A, self.B = max(self.n // LANES, 1), LANES
        self._plans = None
        self._kernel_on: dict = {}
        self._mats_on: dict = {}

    @property
    def plans(self) -> list:
        if self._plans is None:
            self._plans = [Mxu8NttPlan64(self.log_n, q, self.planes, r)
                           for q, r in zip(self.moduli, self.ntt.roots)]
        return self._plans

    def mul_table(self, key) -> torch.Tensor:
        """The fixed operand of kernels D and E (the counterpart of
        ``Mxu8NttPlan64.inverse_mul_tabs``): ``key (count, n)`` canonical
        NTT-domain values in the forward output's bit-reversed order ->
        ``(count, 2, n)`` int64 on ``key``'s device, the values and their
        Shoup quotients ``floor(key * 2^64 / q)`` (u64 patterns)."""
        key = torch.as_tensor(key)
        count, n = len(self.moduli), self.n
        if key.shape != (count, n):
            raise ValueError(f"key must be (count={count}, n={n}), got {tuple(key.shape)}")
        vals = u64_numpy(key.to(torch.int64))
        quot = np.empty_like(vals)
        for i, q in enumerate(self.moduli):
            if (vals[i] >= np.uint64(q)).any():
                raise ValueError("key values must be canonical (below q)")
            quot[i] = [_quot64(int(v), q) for v in vals[i]]
        return u64_tensor(np.stack([vals, quot], axis=1), key.device)

    def pass_matrices(self, device) -> dict:
        """The four pass matrices and both twiddle tables as Shoup factors
        stacked over the moduli, on ``device``: ``m1, m2, m2i, m1i`` (count,
        rows out, columns in) and ``tw, twi`` (count, A, B)."""
        device = torch.device(device)
        if device not in self._mats_on:
            def factor(arrays):
                quot = [np.vectorize(lambda v, q=q: _quot64(int(v), q), otypes=[object])(a)
                        for a, q in zip(arrays, self.moduli)]
                return ShoupFactor64(u64_tensor(np.stack(arrays), device),
                                     u64_tensor(np.stack(quot).astype(np.uint64), device))

            mats = {name: factor([p.mats[name] for p in self.plans])
                    for name in ("m1", "m2", "m2i", "m1i")}
            for name in ("tw", "twi"):
                mats[name] = ShoupFactor64(
                    u64_tensor(np.stack([getattr(p, name) for p in self.plans]), device),
                    u64_tensor(np.stack([getattr(p, name + "_p") for p in self.plans]), device))
            self._mats_on[device] = mats
        return self._mats_on[device]

    def kernel_tables(self, device) -> dict:
        """``w1, w2, wi1, wi2`` (int8, kernel layout: columns ``(k, l)``,
        stacked over moduli) and ``tw (count, 4, n)`` = tw, its quotient,
        twi, its quotient (u64 patterns in int64)."""
        device = torch.device(device)
        if device not in self._kernel_on:
            P, A, B = self.planes, self.A, self.B

            def stack(name, rows):
                arr = np.stack([kernel_layout(getattr(p, name), rows, 8, 8, out_planes=P)
                                for p in self.plans])
                return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

            tw = np.stack([np.stack([p.tw.reshape(-1), p.tw_p.reshape(-1), p.twi.reshape(-1),
                                     p.twi_p.reshape(-1)]) for p in self.plans])
            self._kernel_on[device] = dict(
                w1=stack("w1", A), w2=stack("w2", B), wi1=stack("wi1", B), wi2=stack("wi2", A),
                tw=u64_tensor(tw, device),
            )
        return self._kernel_on[device]


def reduce_any64(values: torch.Tensor, moduli) -> torch.Tensor:
    """Any u64 words ``(count, ...)`` -> canonical residues, modulus ``i`` on
    ``values[i]`` (a Shoup multiply by 1: valid for every u64 word)."""
    shape = (-1,) + (1,) * (values.dim() - 1)
    q = u64_tensor(list(moduli), values.device).reshape(shape)
    one = ShoupFactor64(1, u64_tensor([_quot64(1, m) for m in moduli], values.device).reshape(shape))
    return factor_mul64(values, one, q)


def mxu8_forward64_plain(tables: Mxu8Tables64, values: torch.Tensor) -> torch.Tensor:
    """Plain version: every input word reduced mod q, then the canonical
    butterfly forward NTT (:func:`.ntt64.ntt64_forward_plain`)."""
    return ntt64_forward_plain(tables.ntt, reduce_any64(values, tables.moduli), 1)


def mxu8_inverse64_plain(tables: Mxu8Tables64, values: torch.Tensor) -> torch.Tensor:
    """Plain version: every input word reduced mod q, then the canonical
    butterfly inverse NTT (:func:`.ntt64.ntt64_inverse_plain`)."""
    return ntt64_inverse_plain(tables.ntt, reduce_any64(values, tables.moduli), 1)


def _key_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """``values (count, ..., n)`` (any u64 words) times the key of
    ``mul_tab`` by a lazy Shoup multiply: ``[0, 2q)``."""
    lead = (len(tables.moduli),) + (1,) * (values.dim() - 2)
    q = u64_tensor(list(tables.moduli), values.device).reshape(lead + (1,))
    key = ShoupFactor64(mul_tab[:, 0].reshape(lead + (tables.n,)),
                        mul_tab[:, 1].reshape(lead + (tables.n,)))
    return factor_mul_lazy64(values, key, q)


def mxu8_inverse64_mul_plain(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """Plain version of kernel D: the key multiply, then the canonical
    butterfly inverse NTT."""
    return ntt64_inverse_plain(tables.ntt, _key_mul(tables, values, mul_tab), 1)


def mxu8_roundtrip64_mul_plain(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """Plain version of kernel E: the forward plain version, then kernel D's."""
    return mxu8_inverse64_mul_plain(tables, mxu8_forward64_plain(tables, values), mul_tab)


def _run64(wrapper, plain, entry: str, names, tables: Mxu8Tables64, values, out_factor, allowed,
           mul_tab=None):
    if out_factor not in allowed:
        raise ValueError(f"out_factor must be one of {allowed}")
    keyed = () if mul_tab is None else (mul_tab,)
    if values.device.type == "cpu":
        return plain(tables, values, *keyed)
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")
    count, n = len(tables.moduli), tables.n
    if values.dtype != torch.int64 or values.shape[0] != count or values.shape[-1] != n:
        raise ValueError(f"expected int64 (count={count}, ..., n={n}), got "
                         f"{values.dtype} {tuple(values.shape)}")
    if mul_tab is not None and (mul_tab.device != values.device or mul_tab.dtype != torch.int64
                                or mul_tab.shape != (count, 2, n)
                                or not mul_tab.is_contiguous()):
        raise ValueError(f"{wrapper.__name__}: the key table must be a contiguous int64 "
                         f"(count={count}, 2, n={n}) tensor on {values.device}")
    if not 8 <= tables.log_n <= 12:
        raise ValueError(f"{wrapper.__name__}: the kernels take 8 <= log_n <= 12")
    v = values.contiguous()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        tabs = tables.kernel_tables(v.device)
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(), *(tabs[name].data_ptr() for name in names),
            tabs["tw"].data_ptr(), *(t.data_ptr() for t in keyed), build.ptr(tables.ntt.mod_pack),
            count, rows, tables.log_n, tables.planes,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, entry)
        wrapper.launches += 1
    return out


def mxu8_forward64(tables: Mxu8Tables64, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT of any u64 words ``values (count, ..., n)`` (modulus ``i``
    on ``values[i]``; int64 bit patterns) -> canonical NTT values in
    bit-reversed order (the four-step's natural order), ``(count, ..., n)``.
    ``out_factor`` (1, 2 or 4) bounds the output as in the reference; the
    output is canonical for every one (the lazy-word rule of the module
    docstring).

    CPU tensors take the plain version, CUDA tensors the kernel (one launch
    for every modulus)."""
    return _run64(mxu8_forward64, mxu8_forward64_plain, "pft_ntt_mxu8_forward64", ("w1", "w2"),
                  tables, values, out_factor, (1, 2, 4))


def mxu8_inverse64(tables: Mxu8Tables64, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT of any u64 words ``values (count, ..., n)`` in bit-reversed
    order -> canonical values in normal order (``out_factor`` 1 or 2)."""
    return _run64(mxu8_inverse64, mxu8_inverse64_plain, "pft_ntt_mxu8_inverse64",
                  ("wi1", "wi2"), tables, values, out_factor, (1, 2))


def mxu8_inverse64_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor,
                       out_factor: int = 1):
    """Kernel D: ``INTT(values * key)`` for any u64 words ``values (count,
    ..., n)`` in bit-reversed order and the key of ``mul_tab``
    (:meth:`Mxu8Tables64.mul_table`) -> canonical values in normal order."""
    return _run64(mxu8_inverse64_mul, mxu8_inverse64_mul_plain, "pft_ntt_mxu8_inverse64_mul",
                  ("wi1", "wi2"), tables, values, out_factor, (1, 2), mul_tab)


def mxu8_roundtrip64_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor,
                         out_factor: int = 1):
    """Kernel E: ``INTT(NTT(values) * key)``, the negacyclic product of any
    u64 words ``values (count, ..., n)`` (normal order) by the fixed operand
    of ``mul_tab`` -> canonical values in normal order, in one launch."""
    return _run64(mxu8_roundtrip64_mul, mxu8_roundtrip64_mul_plain,
                  "pft_ntt_mxu8_roundtrip64_mul", ("w1", "w2", "wi1", "wi2"), tables, values,
                  out_factor, (1, 2), mul_tab)


mxu8_forward64.launches = 0
mxu8_inverse64.launches = 0
mxu8_inverse64_mul.launches = 0
mxu8_roundtrip64_mul.launches = 0
