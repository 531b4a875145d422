"""Kernel B: one NGS (NTRU) CMux step per launch on the int8 tensor cores,
the staged step (kernels I, 1 and J) for every shape kernel B cannot take,
and the MXU evaluation-key preparation.

Kernel B replaces ``ntru_cmux_step_nat``
(``primus_fhe_tpu/ops/ntru_cmux_mxu.py:259``, kernel ``_make_ntru_kernel``);
this module also ports ``get_ntru_plan`` and ``prepare_mxu_evk``.  CUDA
source: ``csrc/cmux_mxu.cu`` (kernel A's template with one prime and no
CRT).

Per step, mod one prime ``q < 2^30``: mod-q signed gadget digits of the
accumulator (pre-adjusted above ``wrap_threshold``, made truly signed by
one conditional ``-q``), L forward NTTs as int8 products, the Shoup MAC
against the EVK row, one inverse NTT to ``delta``, then
``acc + rot(delta, a) - delta`` mod q.  The rotation acts on ``delta``
after the inverse NTT, as in the reference.  One thread block per
ciphertext, in clusters of C ciphertexts that share each streamed stage
(kernel A's design, :mod:`.cmux_mxu`); batch 1 uses one SM (widening it is
later work).

Where kernel B cannot take the shape (:func:`ntru_step_route`: ``log_n``
13-17, or a block's plan past 227 KB) the step runs staged, on the evk
row's values read as the canonical bit-reversed NTT rows they are
(``csrc/ntru_stage.cu``): kernel I (:func:`ntru_digits`: the mod-q gadget
digits of the accumulator as ``[0, q)`` residues into a buffer), kernel 1
at ``out_factor=4`` in place on it (:func:`ntru_stage1` is the two), and
kernel J (:func:`ntru_stage2`: the MAC against the evk row, the inverse NTT
and ``acc + rot(delta, a) - delta`` mod q, added in place, and the new
accumulator's digits written over the buffer, which are the next step's
kernel-I words).  :class:`NtruStepPlan` holds the route and the buffer once
a rotation: kernel I for the first step only, then kernel 1 and J, two
launches a step.  Both evaluation-key forms, the NTT-domain ``(n_lwe, L,
N)`` tensor and the MXU pack, hold the same words and run on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..modular.modops import add32, sub32
from ..numeric.limb import narrow_u32, widen_u32
from ..poly.poly import poly_rotate32
from . import build
from .cmux_fused import _aligned16, _basis_pack, _check_device
from .cmux_mxu import (MXU_LOG_N, CmuxMxuPlan, _check_aligned, digit_planes, launch_clusters,
                       mxu_holds, shoup_precons)
from .ntt32 import MAX_LOG_N, forward32, forward32_plain, inverse32_plain
from .ntt_columns import MAC_SUB_LOG, columns_inverse, four_step, mac_sub, mac_sub_pack
from .ntt_mxu8 import mxu8_forward32

NTRU_STAGED_MAX_LEVEL = 32  # kernel J's levels (J_MAX_LEVEL in csrc/ntru_stage.cu)

_PLANS: dict = {}


def get_ntru_plan(log_n: int, q: int) -> CmuxMxuPlan:
    """Cached single-prime plan (the CRT scale ``(q/q)^-1 = 1``)."""
    key = (log_n, q)
    plan = _PLANS.get(key)
    if plan is None:
        plan = CmuxMxuPlan(log_n, (q,))
        plan.fold_inverse_scale(q)
        _PLANS[key] = plan
    return plan


def ntru_step_route(level: int, log_n: int, dp: int) -> str:
    """The card's route for an NGS CMux step on the MXU evk of ``level``
    gadget levels, ring ``2^log_n`` and ``dp`` digit planes
    (:func:`.cmux_mxu.digit_planes`): ``"mxu"`` (kernel B, one launch)
    wherever kernel B takes the shape (:func:`.cmux_mxu.mxu_holds`, asked of
    the card at ``log_n`` 8-12), else ``"staged"`` (kernels I, 1 and J) for
    ``log_n`` 8-17 and ``level`` 1-32.  Decided from the shape before any
    launch; a ``ValueError`` names the limit past both."""
    if dp not in (1, 2):
        raise ValueError(f"NTRU CMux step: {dp} digit planes (1 or 2: gadget bases up to 2^15)")
    if mxu_holds(True, 1, 1, level, log_n, dp):
        return "mxu"
    if not MXU_LOG_N[0] <= log_n <= MAX_LOG_N:
        raise ValueError(f"NTRU CMux step: log_n = {log_n} (the card takes log_n "
                         f"{MXU_LOG_N[0]}-{MAX_LOG_N})")
    if not 1 <= level <= NTRU_STAGED_MAX_LEVEL:
        raise ValueError(f"NTRU CMux step: L = {level} levels (the card takes "
                         f"1-{NTRU_STAGED_MAX_LEVEL})")
    return "staged"


def ntru_mac_rotate(tables, q: int, f, evk_ntt_i, acc, degrees, inverse):
    """``acc + rot(delta, d) - delta`` mod q with ``delta =
    inverse(sum_l f[l] evk[l])``: ``f (L, B, n)`` NTT-domain digits
    (canonical or lazy below 4q), ``evk_ntt_i (L, n)`` canonical; the
    step's second half (kernel J's plain version)."""
    # terms below 4q and q < 2^30: each product is exact in int64
    mac = ((f * evk_ntt_i.unsqueeze(1)) % q).sum(dim=0) % q
    delta = inverse(tables, mac.unsqueeze(0))[0]
    return add32(acc, sub32(poly_rotate32(delta, degrees, q), delta, q), q)


def ntru_cmux_step_plain(plan: CmuxMxuPlan, basis, acc, degrees, kv):
    """Plain version of kernel B on int64 words: the staged step's plain
    versions (:func:`ntru_stage1_plain`, then :func:`ntru_stage2_plain`),
    the key's ``(A, B)`` view read as its bit-reversed NTT row; the
    composed step ``acc + rot(delta, a) - delta`` with ``delta =
    INTT(acc ⊠ EVK_i)`` of the reference's ``boot/ntru_blind_rotate.py``
    scan body."""
    f = ntru_stage1_plain(plan.ntt, basis, acc)
    return ntru_stage2_plain(plan.ntt, f, kv.reshape(kv.shape[0], plan.n), acc, degrees)


def ntru_cmux_step(plan: CmuxMxuPlan, basis, acc: torch.Tensor, degrees: torch.Tensor,
                   kv: torch.Tensor, kpre: torch.Tensor) -> torch.Tensor:
    """One NGS CMux step on the MXU evk: ``acc (B, n)`` canonical mod q,
    ``degrees (B,)`` in ``[0, 2n)``, ``kv``/``kpre`` ``(L, A, 128)`` EVK row
    values and Shoup quotients.  CPU tensors take the plain version, CUDA
    tensors kernel B; the output (canonical) keeps ``acc``'s storage.

    Kernel B's limits on the card are kernel A's
    (:func:`.cmux_mxu.mxu_cmux_step`) with one prime: ``log_n`` 8-12, ``q``
    below 2^30, gadget bases up to 2^15, 16-byte aligned key rows and a
    block's shared memory within 227 KB; past them a ``ValueError`` or the
    C entry's refusal (``RuntimeError``) comes before any launch.  The
    rotation does not reach that refusal: :class:`NtruStepPlan` sends such
    shapes to the staged route."""
    if acc.device.type == "cpu":
        out = ntru_cmux_step_plain(plan, basis, widen_u32(acc), degrees, widen_u32(kv))
        return narrow_u32(out) if acc.dtype == torch.int32 else out
    _check_device("ntru_cmux_step", acc, degrees, kv, kpre)
    bsz, n = acc.shape
    want = (basis.decompose_length, plan.A, plan.B)
    if (len(plan.primes) != 1 or basis.modulus != plan.primes[0] or n != plan.n
            or degrees.shape != (bsz,) or tuple(kv.shape) != want or tuple(kpre.shape) != want):
        raise ValueError(f"ntru_cmux_step: bad shapes {tuple(acc.shape)}, {tuple(kv.shape)}")
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    kvn = narrow_u32(kv).contiguous()
    kpn = narrow_u32(kpre).contiguous()
    out = torch.empty_like(a)
    dp = digit_planes(basis)
    tabs = plan.kernel_tables(a.device)
    pack = _basis_pack(basis)  # held until the call returns
    _check_aligned("ntru_cmux_step", kvn, kpn)
    err = build.library().pft_ntru_cmux_mxu(
        a.data_ptr(), d.data_ptr(), kvn.data_ptr(), kpn.data_ptr(), out.data_ptr(),
        tabs[f"w1_{dp}"].data_ptr(), tabs["w2g"].data_ptr(), tabs["wi1g"].data_ptr(),
        tabs["wi2"].data_ptr(), tabs["tw"].data_ptr(), build.ptr(plan.ntt.prime_pack),
        build.ptr(pack), bsz, plan.log_n, dp,
        launch_clusters(True, 1, 1, plan.log_n, dp, basis.decompose_length, bsz),
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "ntru_cmux_step")
    ntru_cmux_step.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


ntru_cmux_step.launches = 0


def ntru_digits_plain(basis, acc: torch.Tensor) -> torch.Tensor:
    """Kernel I's plain version: the mod-q gadget digits of canonical ``acc
    (B, n)`` as ``[0, q)`` residues, ``(L, B, n)``."""
    return basis.decompose(acc)


def ntru_digits(basis, acc: torch.Tensor, out=None) -> torch.Tensor:
    """Kernel I: the mod-q gadget digits of canonical ``acc (B, n)`` as
    ``[0, q)`` residues ``(L, B, n)``.  CPU tensors take
    :func:`ntru_digits_plain`; CUDA tensors the kernel (a mod-q basis,
    ``B n`` a multiple of 4).  ``out``: contiguous 16-byte aligned int32
    ``(L, B, n)`` to write (returned); else the output keeps ``acc``'s
    storage."""
    if acc.device.type == "cpu":
        res = ntru_digits_plain(basis, widen_u32(acc))
        res = narrow_u32(res) if acc.dtype == torch.int32 else res
        return res if out is None else out.copy_(res)
    _check_device("ntru_digits", acc)
    if basis.modulus is None:
        raise ValueError("ntru_digits: the basis must be mod q")
    a = narrow_u32(acc).contiguous()
    if a.data_ptr() % 16:  # 16-byte loads
        a = a.clone()
    shape = (basis.decompose_length,) + tuple(a.shape)
    given = out is not None
    if not given:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    elif not (out.dtype == torch.int32 and tuple(out.shape) == shape and out.device == a.device
              and out.is_contiguous() and out.data_ptr() % 16 == 0):
        raise ValueError(f"ntru_digits: out must be contiguous 16-byte aligned int32 {shape}")
    if a.numel() % 4:
        raise ValueError(f"ntru_digits: {a.numel()} words (the kernel takes a multiple of 4)")
    if a.numel():
        pack = _basis_pack(basis)  # held until the call returns
        err = build.library().pft_ntru_digits(a.data_ptr(), out.data_ptr(), build.ptr(pack),
                                              a.numel(),
                                              torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "ntru_digits")
        ntru_digits.launches += 1
    return out if given or acc.dtype == torch.int32 else widen_u32(out)


def ntru_stage1_plain(tables, basis, acc: torch.Tensor) -> torch.Tensor:
    """The staged step's first half on int64 words: kernel I's plain
    version, then kernel 1's at ``out_factor=4``: the lazy ``[0, 4q)``
    NTT-domain digits ``(L, B, n)``."""
    return forward32_plain(tables, ntru_digits_plain(basis, acc).unsqueeze(0), 4)[0]


def ntru_stage1(tables, basis, acc: torch.Tensor, out=None) -> torch.Tensor:
    """The staged step's first half: ``acc (B, n)`` canonical -> the lazy
    ``[0, 4q)`` NTT-domain digits ``(L, B, n)``.  CPU tensors take
    :func:`ntru_stage1_plain`; CUDA tensors kernel I, then kernel 1 at
    ``out_factor=4`` in place: two launches, the same words.  ``out``:
    kernel I's ``out``."""
    if acc.device.type == "cpu":
        res = ntru_stage1_plain(tables, basis, widen_u32(acc))
        res = narrow_u32(res) if acc.dtype == torch.int32 else res
        return res if out is None else out.copy_(res)
    digits = ntru_digits(basis, acc, out=out if out is not None else torch.empty(
        (basis.decompose_length,) + tuple(acc.shape), dtype=torch.int32, device=acc.device))
    forward32(tables, digits.unsqueeze(0), 4, out=digits.unsqueeze(0))
    return digits if out is not None or acc.dtype == torch.int32 else widen_u32(digits)


def ntru_stage2_plain(tables, f, evk, acc, degrees, basis=None):
    """Kernel J's plain version on int64 words: :func:`ntru_mac_rotate`
    through the plain inverse; with ``basis`` also the new accumulator's
    gadget digits, ``(out, ntru_digits_plain(basis, out))``."""
    out = ntru_mac_rotate(tables, tables.primes[0], f, evk, acc, degrees, inverse32_plain)
    return out if basis is None else (out, ntru_digits_plain(basis, out))


def stage2_pack(tables, level: int, table_ptrs=(0, 0), basis=None) -> np.ndarray:
    """The host pack ``pft_ntru_stage2`` reads: ``L, log_n``, the device
    addresses of the ``(1, n)`` inverse root table and its Shoup quotients,
    ``NttTables32.prime_pack`` (7 words), then the digit output's basis pack
    (:func:`.cmux_fused._basis_pack`, 10 words; zeros without ``basis``)."""
    chain = _basis_pack(basis) if basis is not None else np.zeros(10, dtype=np.uint64)
    return np.concatenate([np.array([level, tables.log_n, *table_ptrs], dtype=np.uint64),
                           tables.prime_pack, chain])


class NtruStage2Plan:
    """Kernel J's launch constants for one-prime ``tables`` and ``L`` on a
    CUDA ``device``: the host pack and the inverse tables it points to
    (held, so that they outlive every launch); ``basis`` (mod q, ``L``
    levels), for the digit output.  ``plan(f, evk, acc, degrees, out,
    digits)`` launches once on int32 tensors already checked by the
    caller; ``digits`` (or None) receives the output's gadget digits and
    may be ``f``.

    Past ``log_n`` 17 (:attr:`split`) kernel J is three launches around
    the four-step: :func:`.ntt_columns.mac_sub` (the MAC and each
    2^13-word sub-row's inverse stages, lazy words into a ``(B, n)``
    buffer the plan makes once a batch size), the inverse's column launch
    (:func:`.ntt_columns.columns_inverse`, canonical: delta, in place) and
    :func:`ntru_finish` (the rotation, whose source words cross sub-rows,
    and the digits)."""

    def __init__(self, tables, level: int, device, basis=None):
        if len(tables.primes) != 1:
            raise ValueError("kernel J takes one prime")
        if not 1 <= level <= NTRU_STAGED_MAX_LEVEL or not 4 <= tables.log_n <= MAX_LOG_N:
            raise ValueError(f"kernel J: L = {level}, log_n = {tables.log_n} (the card takes L "
                             f"1-{NTRU_STAGED_MAX_LEVEL}, log_n 4-{MAX_LOG_N})")
        if basis is not None and (basis.decompose_length != level
                                  or basis.modulus != tables.primes[0]):
            raise ValueError("kernel J's digits: the basis must be mod q with L levels")
        self.tables, self.level, self.device = tables, level, torch.device(device)
        self._tables = tables.kernel_tables(device)
        self.pack = stage2_pack(tables, level, [t.data_ptr() for t in self._tables[2:]], basis)
        self._pack_ptr = self.pack.ctypes.data
        self._entry = build.library().pft_ntru_stage2
        self.digits = basis is not None
        self.split = four_step(tables.log_n)
        self._subs: dict = {}

    def _sub(self, bsz: int):
        """``(mac_sub's pack, the lazy-word buffer)`` of a batch size."""
        held = self._subs.get(bsz)
        if held is None:
            n = self.tables.n
            pack = mac_sub_pack(1, 1, bsz, self.level, self.tables.log_n,
                                (0, n, bsz * n, 0, 0, n),
                                [t.data_ptr() for t in self._tables[2:]], self.tables.prime_pack)
            part = torch.empty((bsz, n), dtype=torch.int32, device=self.device)
            held = self._subs[bsz] = (pack, part)
        return held

    def __call__(self, f, evk, acc, degrees, out, digits=None) -> None:
        if (f.data_ptr() | evk.data_ptr()) % 16:
            raise ValueError("ntru_stage2: the digits and the evk row must start on 16 bytes")
        if digits is not None and not self.digits:
            raise ValueError("ntru_stage2: a plan without a basis writes no digits")
        if self.split:
            bsz, log_n = acc.shape[0], self.tables.log_n
            pack, part = self._sub(bsz)
            mac_sub(f, evk, part, pack)
            columns_inverse(32, part, part, self._tables[2], self._tables[3],
                            build.ptr(self.tables.prime_pack), 1, bsz, log_n, l=MAC_SUB_LOG)
            ntru_finish(self, part, acc, degrees, out, digits)
            return
        err = self._entry(f.data_ptr(), evk.data_ptr(), acc.data_ptr(), degrees.data_ptr(),
                          out.data_ptr(), None if digits is None else digits.data_ptr(),
                          acc.shape[0], self._pack_ptr,
                          torch.cuda.current_stream(acc.device).cuda_stream)
        build.check(err, "ntru_stage2")
        ntru_stage2.launches += 1


def ntru_finish(plan: NtruStage2Plan, delta, acc, degrees, out, digits=None) -> None:
    """Kernel J's last launch past ``log_n`` 17 on CUDA int32 tensors:
    ``out = acc + rot(delta, d) - delta`` mod q for ``delta (B, n)``
    canonical, and with ``digits`` (``(L, B, n)``, may be the digits the
    MAC read) the output's gadget digits (``out`` may be ``acc``)."""
    err = build.library().pft_ntru_finish(
        delta.data_ptr(), acc.data_ptr(), degrees.data_ptr(), out.data_ptr(),
        None if digits is None else digits.data_ptr(), acc.shape[0], plan._pack_ptr,
        torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(err, "ntru_finish")
    ntru_finish.launches += 1


def ntru_finish_plain(q: int, delta: torch.Tensor, acc: torch.Tensor, degrees: torch.Tensor,
                      basis=None):
    """Plain version of :func:`ntru_finish` on int64 words: ``acc +
    rot(delta, d) - delta`` mod q, and with ``basis`` also its digits ``(L,
    B, n)`` (:func:`ntru_digits_plain`'s words)."""
    out = add32(acc, sub32(poly_rotate32(delta, degrees, q), delta, q), q)
    return out if basis is None else (out, ntru_digits_plain(basis, out))


def ntru_stage2(tables, f: torch.Tensor, evk: torch.Tensor, acc: torch.Tensor,
                degrees: torch.Tensor, out=None, basis=None) -> torch.Tensor:
    """Kernel J: ``acc + rot(delta, d) - delta`` mod q, ``delta =
    INTT(sum_l f[l] evk[l])``, for ``f (L, B, n)`` lazy ``[0, 4q)`` digits
    (:func:`ntru_stage1`'s), ``evk (L, n)`` canonical, ``acc (B, n)``
    canonical and ``degrees (B,)`` of any sign.  CPU tensors take
    :func:`ntru_stage2_plain`; CUDA tensors the kernel, one launch (L 1-32,
    log_n 4-17; a ``ValueError`` past them, before any launch).  ``out``
    may be ``acc`` (contiguous int32: the kernel adds in place); else the
    output keeps ``acc``'s storage.  With ``basis`` (mod q, L levels) the
    output's gadget digits, ``[0, q)`` residues as kernel I writes them,
    overwrite ``f`` (then contiguous, on the card int32 on 16 bytes): the
    next step's digits, in place."""
    if acc.device.type == "cpu":
        res = ntru_stage2_plain(tables, widen_u32(f), widen_u32(evk), widen_u32(acc), degrees,
                                basis)
        if basis is not None:
            res, digits = res
            f.copy_(digits)
        res = narrow_u32(res) if acc.dtype == torch.int32 else res
        return res if out is None else out.copy_(res)
    _check_device("ntru_stage2", f, evk, acc, degrees)
    bsz, n = acc.shape
    level = evk.shape[0]
    if evk.shape != (level, n) or f.shape != (level, bsz, n) or degrees.shape != (bsz,) \
            or n != tables.n:
        raise ValueError(f"ntru_stage2: bad shapes f {tuple(f.shape)}, evk {tuple(evk.shape)}, "
                         f"acc {tuple(acc.shape)}")
    if basis is not None and not (f.dtype == torch.int32 and f.is_contiguous()
                                  and f.data_ptr() % 16 == 0):
        raise ValueError("ntru_stage2: digits over f need f contiguous int32 on 16 bytes")
    plan = NtruStage2Plan(tables, level, acc.device, basis)
    f32, evk32 = _aligned16(narrow_u32(f).contiguous()), _aligned16(narrow_u32(evk).contiguous())
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    given = out is not None
    if not given:
        out = torch.empty_like(a)
    elif not (out.dtype == torch.int32 and out.shape == a.shape and out.device == a.device
              and out.is_contiguous()):
        raise ValueError(f"ntru_stage2: out must be contiguous int32 {tuple(a.shape)}")
    if bsz:
        plan(f32, evk32, a, d, out, None if basis is None else f32)
    return out if given or acc.dtype == torch.int32 else widen_u32(out)


def launch_grid(log_n: int, bsz: int) -> tuple[int, int, int, int]:
    """Kernel J's launch on the current CUDA device for ``bsz`` ciphertexts
    at ``log_n``: ``(blocks a row C, threads a block, shared bytes a block,
    clusters the card holds at once)`` (the C entry's own rule,
    ``pick_slices`` in ``csrc/ntt_split.cuh``)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    build.check(build.library().pft_ntru_stage2_grid(log_n, bsz, ctypes.addressof(out)),
                "pft_ntru_stage2_grid")
    return tuple(out)


class NtruStepPlan:
    """One NTRU rotation's CMux steps on ``device``: ``plan(acc, degrees,
    kv, kpre)`` is ``acc + rot(delta, d) - delta`` for the evk row ``kv``
    (``(L, n)`` NTT-domain, or the MXU pack's ``(L, A, 128)``: the same
    words) and its Shoup quotients ``kpre`` (the same shape, read only by
    kernel B: :attr:`reads_precons`; else None).

    Built once before the loop, the route is :func:`ntru_step_route`'s (a
    ``ValueError`` before any launch past it): ``"mxu"`` runs kernel B, one
    launch a step (:func:`ntru_cmux_step`); ``"staged"`` keeps a digit
    buffer ``(L, B, n)`` int32 that kernel J refills with the next step's
    digits, so kernel I runs only for the first step of an accumulator, and
    each step is kernel 1 at ``out_factor=4`` in place on the buffer and
    kernel J into ``acc`` and the buffer in place: two launches.  The
    buffer belongs to the accumulator the last call returned; a call on
    another tensor, or on one changed in place since, starts again with
    kernel I.  On the card a call takes int32 ``acc (B, n)`` canonical,
    ``degrees (B,)`` and the evk row, contiguous.  On the CPU it runs the
    staged functions' plain versions, which equal kernel B's."""

    def __init__(self, ctx, device):
        self.ctx = ctx
        self.device = torch.device(device)
        self.dp = digit_planes(ctx.basis)
        self.route = None
        if self.device.type == "cpu":
            return
        level = ctx.basis.decompose_length
        self.route = ntru_step_route(level, ctx.log_n, self.dp)
        if self.route == "mxu":
            self._plan = get_ntru_plan(ctx.log_n, ctx.q_int)
        else:
            self._stage2 = NtruStage2Plan(ctx.ntt, level, self.device, ctx.basis)
            self._digits = None  # (acc, its version, the buffer of its digits)

    @property
    def reads_precons(self) -> bool:
        """Whether a step reads the evk's Shoup quotients (kernel B only)."""
        return self.route == "mxu"

    def __call__(self, acc: torch.Tensor, degrees: torch.Tensor, kv: torch.Tensor,
                 kpre: torch.Tensor | None) -> torch.Tensor:
        ctx, level = self.ctx, self.ctx.basis.decompose_length
        if self.route == "mxu":
            want = (level, self._plan.A, self._plan.B)
            return ntru_cmux_step(self._plan, ctx.basis, acc, degrees, kv.reshape(want),
                                  kpre.reshape(want))
        evk = kv.reshape(level, ctx.n)
        if self.route is None:
            return ntru_stage2(ctx.ntt, ntru_stage1(ctx.ntt, ctx.basis, acc), evk, acc, degrees)
        bsz = acc.shape[0]
        if not (acc.shape == (bsz, ctx.n) and degrees.shape == (bsz,)
                and acc.dtype == evk.dtype == degrees.dtype == torch.int32
                and acc.is_contiguous() and evk.is_contiguous() and degrees.is_contiguous()
                and acc.device == evk.device == degrees.device == self.device):
            raise ValueError("NtruStepPlan: contiguous int32 acc (B, n), degrees (B,) and evk "
                             f"row on {self.device}")
        if bsz:
            held = self._digits
            if held is not None and held[0] is acc and held[1] == acc._version:
                digits = held[2]
            else:  # the accumulator's first step: kernel I
                digits = ntru_digits(ctx.basis, acc, out=torch.empty(
                    (level, bsz, ctx.n), dtype=torch.int32, device=self.device))
            forward32(ctx.ntt, digits.unsqueeze(0), 4, out=digits.unsqueeze(0))
            self._stage2(digits, evk, acc, degrees, acc, digits)
            self._digits = (acc, acc._version, digits)
        return acc


ntru_digits.launches = 0
ntru_stage2.launches = 0
ntru_finish.launches = 0


def prepare_mxu_evk(ctx, evk_coeff: torch.Tensor):
    """Coefficient-domain EVK ``(n_lwe, L, n)`` mod q -> MXU pack
    ``(vals, precons)``, each ``(n_lwe, L, A, 128)`` int64: kernel C (kernel
    1 at ``log_n`` 13-17, :func:`.ntt_mxu8.mxu8_forward32`), then the exact
    Shoup quotients."""
    plan = get_ntru_plan(ctx.log_n, ctx.q_int)
    vals = mxu8_forward32(plan, evk_coeff.unsqueeze(0))[0].contiguous()
    return vals, shoup_precons(vals, (ctx.q_int,), 0).contiguous()
