"""Kernels 3-4: the blind-rotation CMux step, one launch a step.

Replaces ``cmux_stage1`` and ``cmux_stage2``
(``primus_fhe_tpu/ops/cmux_fused.py:140,226``), which the JAX
``fused_cmux_step`` composes, with one hand-written kernel
(``csrc/cmux_fused.cu``): a thread-block cluster of ``kp x k1`` blocks per
ciphertext, one per (prime, accumulator row).

- each block reads its row once (the rotate-diff is index arithmetic plus a
  sign), runs the signed-digit carry chain once per coefficient for all L
  levels, lifts the digits mod its prime and runs the L forward NTTs in
  shared memory, 8 coefficients a thread through 3 butterfly stages in
  registers between exchanges, its prime's twiddles staged once;
- MAC against the GGSW rows, one Barrett reduction per sum of L products;
- over distributed shared memory the block of row ``r`` sums the k1 rows'
  partials of output component ``j = r`` and runs its inverse NTT; the kp
  blocks of component ``j`` then split its integer CRT and the wrapping add
  to ``acc``.

Nothing goes through device memory between the phases.  What bounds it on
the card, and the measured times, are in the source's note and PERF.md.

The one-launch kernel holds a ciphertext's cluster in shared memory, so it
takes ``kp*k1 <= 8``, ``k1 <= 4``, ``L <= 16``, ``log_n`` 4-12 and ``(2 +
kp + L + k1) * 4n`` bytes within 227 KB.  Every other shape with ``kp <=
4``, ``L <= 32`` and ``log_n`` 4-26 runs the staged route, under the JAX's
names: :func:`cmux_stage1` (kernel G, then kernel 1 at ``out_factor=4``)
writes the lazy NTT-domain digits to device memory and :func:`cmux_stage2`
(kernel H, ``csrc/cmux_stage2.cu``: a cluster of kp x C blocks a
ciphertext and output component, a row over C slices, the MAC, the inverse
NTT and the CRT; past ``log_n`` 17 two launches around the four-step,
:class:`Stage2Plan`) adds the product into ``acc``.  :func:`step_route` is the
rule, a pure function of the shape.

The plain versions stay the two stages (:func:`cmux_stage1_plain`,
:func:`cmux_stage2_plain`): CPU tensors take their composition, and the
on-card checks hold both routes bit-equal to it.  :class:`CmuxStepPlan`
holds what stays fixed across a rotation's steps (the route, the constant
packs, the table pointers, the staged route's digit buffer), so that the
blind-rotation loop pays one bound C call a launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.tfhe import external_product_mac
from ..numeric.limb import MASK32, narrow_u32, widen_u32
from . import build
from .ntt32 import forward32_plain, inverse32_plain
from .ntt_columns import (MAC_SUB_LOG, MAX_LOG_N, four_step, inverse_stages, mac_sub,
                          mac_sub_pack)
from .rotate import rotate_plain

MAX_CLUSTER = 8  # kp * k1 blocks a ciphertext (MAX_CLUSTER in csrc/cmux_fused.cu)
MAX_K1 = 4  # accumulator rows (MAX_K1 there)
MAX_LEVEL = 16  # L products below 2^60 sum below 2^64 (MAX_LEVEL there)
SMEM_MAX = 232448  # the most shared memory a block may ask for on the card
STAGED_MAX_KP = 4  # kernel H's primes (PFT_MAX_KP in csrc/modarith32.cuh)
STAGED_MAX_LEVEL = 32  # kernel H's levels (H_MAX_LEVEL in csrc/cmux_stage2.cu)
STAGED_LOG_N = (4, MAX_LOG_N)  # kernel H's rings (split past 17); kernels G and 1 take them too


def step_route(kp: int, k1: int, level: int, log_n: int) -> str:
    """The card's route for a CMux step of ``kp`` primes, ``k1`` accumulator
    rows, ``level`` gadget levels and ring ``2^log_n``: ``"fused"`` (the
    one-launch kernel) wherever it holds the shape, else ``"staged"``
    (kernel G, kernel 1, kernel H).  A ``ValueError`` names the limit past
    both."""
    if (kp * k1 <= MAX_CLUSTER and k1 <= MAX_K1 and 1 <= level <= MAX_LEVEL
            and 4 <= log_n <= 12 and (2 + kp + level + k1) * 4 << log_n <= SMEM_MAX):
        return "fused"
    lo, hi = STAGED_LOG_N
    if not 1 <= kp <= STAGED_MAX_KP:
        raise ValueError(f"CMux step: kp = {kp} primes (the card takes 1-{STAGED_MAX_KP})")
    if not 1 <= level <= STAGED_MAX_LEVEL:
        raise ValueError(f"CMux step: L = {level} levels (the card takes 1-{STAGED_MAX_LEVEL})")
    if not lo <= log_n <= hi:
        raise ValueError(f"CMux step: log_n = {log_n} (the card takes log_n {lo}-{hi})")
    if k1 < 1:
        raise ValueError(f"CMux step: k1 = {k1} accumulator rows")
    return "staged"


def cmux_stage1_plain(conv, basis, acc: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """The step's first half on int64 words: ``acc (B, k1, n)``, ``degrees
    (B,)`` -> ``(kp, B*k1, L, n)`` lazy NTT-domain digits."""
    bsz, k1, n = acc.shape
    diff = rotate_plain(acc, degrees, subtract=True)
    digits = basis.decompose(diff)  # (L, B, k1, n)
    digits = digits.permute(1, 2, 0, 3).reshape(bsz * k1, basis.decompose_length, n)
    return forward32_plain(conv.ntt, conv.lift(digits), out_factor=4)


def cmux_stage2_plain(conv, f: torch.Tensor, key: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The step's second half on int64 words: ``f (kp, B*k1, L, n)``,
    ``key (kp, k1, L, k1, n)``, ``acc (B, k1, n)`` -> ``acc + delta``."""
    bsz, k1, n = acc.shape
    fb = f.reshape(conv.count, bsz, k1, key.shape[2], n)
    mac = external_product_mac(conv, fb, key, nbatch=1)  # (kp, B, k1, n)
    delta = conv.recombine(inverse32_plain(conv.ntt, mac))
    return (acc + delta) & MASK32


def _basis_pack(basis) -> np.ndarray:
    """Host pack of a gadget basis: ``BasisConsts`` (the step kernel, kernel
    G) reads the first 7 words, the MXU kernels' ``MxuBasis`` (mod-q mode)
    all 10."""
    return np.array(
        [basis.decompose_length, basis.log_basis, basis.drop_bits, basis.basis_minus_one,
         basis.carry_mask, basis.modulus_minus_basis, basis.init_carry_mask or 0,
         basis.wrap_threshold or 0, basis.adjust_add, basis.modulus or 0],
        dtype=np.uint64,
    )


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), or a copy of it where it does not start on 16
    bytes: kernels H and J read their digits and key rows in 16-byte
    loads."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_device(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors must share one CUDA device")


def step_pack(conv, basis, k1: int, table_ptrs=(0, 0, 0, 0)) -> np.ndarray:
    """The host pack ``pft_cmux_step`` reads: ``kp, k1, log_n``, the device
    addresses of the ``(kp, n)`` root tables (forward, its Shoup quotients,
    inverse, its quotients), then ``NttTables32.prime_pack`` (7 words a
    prime), ``crt_pack`` (4 a prime and P mod 2^32) and the gadget's 7
    ``BasisConsts`` words."""
    return np.concatenate([
        np.array([conv.count, k1, conv.log_n, *table_ptrs], dtype=np.uint64),
        conv.ntt.prime_pack, conv.crt_pack, _basis_pack(basis)[:7],
    ])


def stage2_pack(conv, k1: int, level: int, table_ptrs=(0, 0)) -> np.ndarray:
    """The host pack ``pft_cmux_stage2`` reads: ``kp, k1, L, log_n``, the
    device addresses of the ``(kp, n)`` inverse root table and its Shoup
    quotients, then ``NttTables32.prime_pack`` (7 words a prime) and
    ``crt_pack`` (4 a prime and P mod 2^32)."""
    return np.concatenate([
        np.array([conv.count, k1, level, conv.log_n, *table_ptrs], dtype=np.uint64),
        conv.ntt.prime_pack, conv.crt_pack,
    ])


class Stage2Plan:
    """Kernel H's launch constants for a convolver, ``k1`` and ``L`` on a
    CUDA ``device``: the host pack and the inverse tables it points to
    (held, so that they outlive every launch).  ``plan(f, key, acc, out)``
    launches once on int32 tensors already checked by the caller.

    Past ``log_n`` 17 (:attr:`split`) kernel H is two launches around the
    four-step: :func:`.ntt_columns.mac_sub` (the MAC and each 2^13-word
    sub-row's inverse stages, lazy words into a ``(kp, B, k1, n)`` buffer
    the plan makes once a batch size) and :func:`cmux_stage2_cols` (the
    last stages across the sub-rows, the CRT and the add into ``out``)."""

    def __init__(self, conv, k1: int, level: int, device):
        step_route(conv.count, k1, level, conv.log_n)  # the card's limits
        self.conv, self.k1, self.level = conv, k1, level
        self.device = torch.device(device)
        self._tables = conv.ntt.kernel_tables(device)
        self.pack = stage2_pack(conv, k1, level,
                                [t.data_ptr() for t in self._tables[2:]])
        self._pack_ptr = self.pack.ctypes.data
        self.split = four_step(conv.log_n)
        self._entry = build.library().pft_cmux_stage2
        self._subs: dict = {}

    def _sub(self, bsz: int):
        """``(mac_sub's pack, the lazy-word buffer)`` of a batch size."""
        held = self._subs.get(bsz)
        if held is None:
            conv, k1, level, n = self.conv, self.k1, self.level, self.conv.n
            strides = (bsz * k1 * level * n, k1 * level * n, n, k1 * level * k1 * n, n, k1 * n)
            pack = mac_sub_pack(conv.count, k1, bsz, k1 * level, conv.log_n, strides,
                                [t.data_ptr() for t in self._tables[2:]], conv.ntt.prime_pack)
            part = torch.empty((conv.count, bsz, k1, n), dtype=torch.int32, device=self.device)
            held = self._subs[bsz] = (pack, part)
        return held

    def __call__(self, f, key, acc, out, bsz: int) -> None:
        if (f.data_ptr() | key.data_ptr()) % 16:
            raise ValueError("cmux_stage2: the digits and the key must start on 16 bytes")
        if self.split:
            pack, part = self._sub(bsz)
            mac_sub(f, key, part, pack)
            cmux_stage2_cols(self, part, acc, out, bsz)
            return
        err = self._entry(f.data_ptr(), key.data_ptr(), acc.data_ptr(), out.data_ptr(), bsz,
                          self._pack_ptr, torch.cuda.current_stream(acc.device).cuda_stream)
        build.check(err, "cmux_stage2")
        cmux_stage2.launches += 1


def cmux_stage2_cols(plan: Stage2Plan, part, acc, out, bsz: int) -> None:
    """Kernel H's column launch past ``log_n`` 17 on CUDA int32 tensors:
    ``out = acc + CRT(INTT(...))`` from :func:`.ntt_columns.mac_sub`'s lazy
    words ``part (kp, B, k1, n)`` (the inverse's last ``log_n - 13``
    stages, canonical, then kernel H's CRT and add; ``out`` may be
    ``acc``)."""
    err = build.library().pft_cmux_stage2_cols(part.data_ptr(), acc.data_ptr(), out.data_ptr(),
                                                bsz, plan._pack_ptr,
                                                torch.cuda.current_stream(acc.device).cuda_stream)
    build.check(err, "cmux_stage2_cols")
    cmux_stage2_cols.launches += 1


def cmux_stage2_cols_plain(conv, part: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cmux_stage2_cols` on int64 words: ``part (kp,
    B, k1, n)`` lazy, ``acc (B, k1, n)`` -> ``acc + CRT(...)``."""
    plans = conv.ntt.plans_on(part.device)
    res = torch.stack([inverse_stages(pl, part[i], MAC_SUB_LOG, pl.log_n, 32, 1)
                       for i, pl in enumerate(plans)])
    return (acc + conv.recombine(res)) & MASK32


def launch_grid(conv, k1: int, bsz: int) -> tuple[int, int, int, int]:
    """Kernel H's launch on the current CUDA device for ``bsz`` ciphertexts
    of ``k1`` components on ``conv``: ``(blocks a row C, threads a block,
    shared bytes a block, clusters the card holds at once)`` (the C entry's
    own rule, ``pick_slices`` in ``csrc/ntt_split.cuh``)."""
    import ctypes

    out = (ctypes.c_int * 4)()
    err = build.library().pft_cmux_stage2_grid(conv.count, k1, bsz, conv.log_n,
                                                ctypes.addressof(out))
    build.check(err, "pft_cmux_stage2_grid")
    return tuple(out)


def cmux_stage1(conv, basis, acc: torch.Tensor, degrees: torch.Tensor, out=None) -> torch.Tensor:
    """The step's first half, ``acc (B, k1, n)``, ``degrees (B,)`` (any
    sign) -> the lazy ``[0, 4p)`` NTT-domain digits of ``acc*X^d - acc``,
    ``(kp, B*k1, L, n)``.  CPU tensors take :func:`cmux_stage1_plain`; CUDA
    tensors kernel G (:func:`..ops.cmux_front.cmux_front`) and kernel 1 at
    ``out_factor=4`` in place: two launches, the same words.  ``out``:
    contiguous int32 ``(kp, B, k1, L, n)`` words to write (returned in the
    ``(kp, B*k1, L, n)`` view); else the output keeps ``acc``'s storage."""
    from .cmux_front import cmux_front  # a cycle at import: cmux_front reads _basis_pack
    from .ntt32 import forward32

    bsz, k1, n = acc.shape
    level = basis.decompose_length
    if acc.device.type == "cpu":
        res = cmux_stage1_plain(conv, basis, widen_u32(acc), degrees)
        res = narrow_u32(res) if acc.dtype == torch.int32 else res
        return res if out is None else out.copy_(res.reshape(out.shape)).reshape(res.shape)
    digits = cmux_front(acc, degrees, basis, conv.primes,
                        out=torch.empty((conv.count, bsz, k1, level, n), dtype=torch.int32,
                                        device=acc.device) if out is None else out)
    forward32(conv.ntt, digits, 4, out=digits)
    digits = digits.reshape(conv.count, bsz * k1, level, n)
    return digits if out is not None or acc.dtype == torch.int32 else widen_u32(digits)


def cmux_stage2(conv, f: torch.Tensor, key: torch.Tensor, acc: torch.Tensor, out=None):
    """The step's second half: ``acc + CRT(INTT(sum_{r,l} f[:, b k1 + r, l]
    key[:, r, l, j]))`` for ``f (kp, B*k1, L, n)`` lazy ``[0, 4p)`` digits
    (:func:`cmux_stage1`'s), ``key (kp, k1, L, k1, n)`` canonical and ``acc
    (B, k1, n)``.  CPU tensors take :func:`cmux_stage2_plain`; CUDA tensors
    kernel H, one launch (kp 1-4, any k1, L 1-32, log_n 4-17; two at 18-26,
    :class:`Stage2Plan`; a
    ``ValueError`` past them, before any launch).  ``out`` may be ``acc``
    (contiguous int32: the kernel adds in place); else the output keeps
    ``acc``'s storage."""
    if acc.device.type == "cpu":
        res = cmux_stage2_plain(conv, widen_u32(f), widen_u32(key), widen_u32(acc))
        res = narrow_u32(res) if acc.dtype == torch.int32 else res
        return res if out is None else out.copy_(res)
    _check_device("cmux_stage2", f, key, acc)
    bsz, k1, n = acc.shape
    level = key.shape[2]
    if (key.shape != (conv.count, k1, level, k1, n)
            or f.shape != (conv.count, bsz * k1, level, n)):
        raise ValueError(f"cmux_stage2: bad shapes f {tuple(f.shape)}, key {tuple(key.shape)}, "
                         f"acc {tuple(acc.shape)}")
    plan = Stage2Plan(conv, k1, level, acc.device)
    f32, key32 = _aligned16(narrow_u32(f).contiguous()), _aligned16(narrow_u32(key).contiguous())
    a = narrow_u32(acc).contiguous()
    given = out is not None
    if not given:
        out = torch.empty_like(a)
    elif not (out.dtype == torch.int32 and out.shape == a.shape and out.device == a.device
              and out.is_contiguous()):
        raise ValueError(f"cmux_stage2: out must be contiguous int32 {tuple(a.shape)}")
    if bsz:
        plan(f32, key32, a, out, bsz)
    return out if given or acc.dtype == torch.int32 else widen_u32(out)


class CmuxStepPlan:
    """One rotation's CMux steps on ``device``: ``plan(acc, degrees, key)``
    is :func:`fused_cmux_step` without its per-call set-up.

    Built once before the loop: the route (:func:`step_route`, before any
    launch) and what it launches with.  The fused route: the host pack the
    C entry reads (``kp``, ``k1``, ``log_n``, the prime's root-table
    pointers, the prime, CRT and gadget constants; the cluster is ``kp x
    k1``) and the bound entry; a step is one launch.  The staged route:
    kernel H's :class:`Stage2Plan` and a digit buffer ``(kp, B, k1, L, n)``
    int32 made once a batch size; a step is :func:`cmux_stage1` (kernels G
    and 1) into the buffer, then kernel H into ``out``: three launches.  On
    the card a call takes int32 ``acc (B, k1, n)``, ``degrees (B,)`` and
    ``key (kp, k1, L, k1, n)``, contiguous; ``out`` may be ``acc`` itself
    (either route updates it in place).  On the CPU it runs the plain
    composition.
    """

    def __init__(self, conv, basis, k1: int, device):
        self.conv, self.basis, self.k1 = conv, basis, k1
        self.device = torch.device(device)
        kp, level, n = conv.count, basis.decompose_length, conv.n
        self.acc_tail = (k1, n)
        self.key_shape = (kp, k1, level, k1, n)
        if self.device.type == "cpu":
            return
        if self.device.type != "cuda":
            raise ValueError(f"fused_cmux_step: unsupported device {self.device}")
        self.route = step_route(kp, k1, level, conv.log_n)
        if self.route == "staged":
            self._stage2 = Stage2Plan(conv, k1, level, self.device)
            self._digits: dict = {}
            return
        # held by the plan: the kernel's tables must outlive every launch
        self._tables = conv.ntt.kernel_tables(self.device)
        self.pack = step_pack(conv, basis, k1, [t.data_ptr() for t in self._tables])
        self._pack_ptr = self.pack.ctypes.data
        self._entry = build.library().pft_cmux_step

    def __call__(self, acc: torch.Tensor, degrees: torch.Tensor, key: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        if self.device.type == "cpu":
            res = cmux_stage2_plain(
                self.conv, cmux_stage1_plain(self.conv, self.basis, widen_u32(acc), degrees),
                widen_u32(key), widen_u32(acc))
            res = narrow_u32(res) if acc.dtype == torch.int32 else res
            return res if out is None else out.copy_(res)
        bsz = acc.shape[0]
        if (acc.shape[1:] != self.acc_tail or key.shape != self.key_shape
                or degrees.shape != (bsz,)):
            raise ValueError(f"fused_cmux_step: bad shapes {tuple(acc.shape)}, "
                             f"{tuple(degrees.shape)}, {tuple(key.shape)}")
        if not (acc.dtype == key.dtype == degrees.dtype == torch.int32
                and acc.device == key.device == degrees.device == self.device
                and acc.is_contiguous() and key.is_contiguous() and degrees.is_contiguous()):
            raise ValueError("fused_cmux_step: the plan takes contiguous int32 tensors on "
                             f"{self.device}")
        if out is None:
            out = torch.empty_like(acc)
        if bsz and self.route == "staged":
            digits = self._digits.get(bsz)
            if digits is None:
                digits = self._digits[bsz] = torch.empty(
                    (self.conv.count, bsz) + self.key_shape[1:3] + (self.acc_tail[1],),
                    dtype=torch.int32, device=self.device)
            f = cmux_stage1(self.conv, self.basis, acc, degrees, out=digits)
            self._stage2(f, key, acc, out, bsz)
        elif bsz:
            err = self._entry(acc.data_ptr(), degrees.data_ptr(), key.data_ptr(), out.data_ptr(),
                              bsz, self._pack_ptr,
                              torch.cuda.current_stream(self.device).cuda_stream)
            build.check(err, "fused_cmux_step")
            fused_cmux_step.launches += 1
        return out


def fused_cmux_step(conv, basis, acc: torch.Tensor, degrees: torch.Tensor, key: torch.Tensor):
    """One blind-rotation step: ``acc + (acc*X^d - acc) ⊡ key``.

    ``acc``: ``(B, k1, n)``; ``degrees``: ``(B,)``, any sign (taken mod
    2n); ``key``: ``(kp, k1, L, k1, n)`` canonical NTT-domain GGSW.  CPU
    tensors take the plain composition ``cmux_stage2_plain(
    cmux_stage1_plain(...))``, CUDA tensors the kernel; the output keeps
    ``acc``'s storage (int64 or int32).

    The route on the card is :func:`step_route`'s: the one-launch kernel
    where it holds the shape (a cluster of ``kp * k1 <= 8`` blocks with
    ``k1 <= 4``, ``L`` 1-16, ``log_n`` 4-12, ``(2 + kp + L + k1) * 4n``
    bytes of shared memory within 227 KB), else :func:`cmux_stage1` then
    :func:`cmux_stage2` (``kp`` 1-4, any ``k1``, ``L`` 1-32, ``log_n``
    4-26); :class:`CmuxStepPlan` raises ``ValueError`` past those, before
    any launch.  The plain composition takes any shape.
    """
    if acc.device.type == "cpu":
        return CmuxStepPlan(conv, basis, acc.shape[1], "cpu")(acc, degrees, key)
    _check_device("fused_cmux_step", acc, degrees, key)
    a = narrow_u32(acc).contiguous()
    out = CmuxStepPlan(conv, basis, acc.shape[1], a.device)(
        a, degrees.to(torch.int32).contiguous(), narrow_u32(key).contiguous())
    return out if acc.dtype == torch.int32 else widen_u32(out)


fused_cmux_step.launches = 0
cmux_stage2.launches = 0
cmux_stage2_cols.launches = 0
