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

The plain versions stay the two stages (:func:`cmux_stage1_plain`,
:func:`cmux_stage2_plain`): CPU tensors take their composition, and the
on-card checks hold the kernel bit-equal to it.  :class:`CmuxStepPlan`
holds what stays fixed across a rotation's steps (the constant pack, the
table pointers, the cluster shape), so that the blind-rotation loop pays
one bound C call a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.tfhe import external_product_mac
from ..numeric.limb import MASK32, narrow_u32, widen_u32
from . import build
from .ntt32 import forward32_plain, inverse32_plain
from .rotate import rotate_plain

MAX_CLUSTER = 8  # kp * k1 blocks a ciphertext (MAX_CLUSTER in csrc/cmux_fused.cu)
MAX_K1 = 4  # accumulator rows (MAX_K1 there)
MAX_LEVEL = 16  # L products below 2^60 sum below 2^64 (MAX_LEVEL there)
SMEM_MAX = 232448  # the most shared memory a block may ask for on the card


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


class CmuxStepPlan:
    """One rotation's CMux steps on ``device``: ``plan(acc, degrees, key)``
    is :func:`fused_cmux_step` without its per-call set-up.

    Built once before the loop: the host pack the C entry reads (``kp``,
    ``k1``, ``log_n``, the prime's root-table pointers, the prime, CRT and
    gadget constants; the cluster is ``kp x k1``), and the bound entry.  On
    the card a call takes int32 ``acc (B, k1, n)``, ``degrees (B,)`` and
    ``key (kp, k1, L, k1, n)``, contiguous, and launches the kernel once;
    ``out`` may be ``acc`` itself (the kernel updates it in place).  On the
    CPU it runs the plain composition.
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
        if kp * k1 > MAX_CLUSTER or k1 > MAX_K1:
            raise ValueError(f"fused_cmux_step: a cluster of kp*k1 = {kp}*{k1} blocks "
                             f"(at most {MAX_CLUSTER}, k1 at most {MAX_K1})")
        if not 1 <= level <= MAX_LEVEL or not 4 <= conv.log_n <= 12:
            raise ValueError(f"fused_cmux_step: L = {level} (1-{MAX_LEVEL}), "
                             f"log_n = {conv.log_n} (4-12)")
        if (2 + kp + level + k1) * 4 * n > SMEM_MAX:
            raise ValueError(f"fused_cmux_step: n = {n} with L = {level} needs more than "
                             f"{SMEM_MAX} bytes of shared memory")
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
        if bsz:
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

    The kernel's limits on the card (:class:`CmuxStepPlan` raises
    ``ValueError`` past them, before any launch): a cluster of ``kp * k1 <=
    8`` blocks with ``k1 <= 4``, ``L`` 1-16 (the MAC's 64-bit sum),
    ``log_n`` 4-12, and ``(2 + kp + L + k1) * 4n`` bytes of shared memory
    within 227 KB.  The plain composition takes any shape.
    """
    if acc.device.type == "cpu":
        return CmuxStepPlan(conv, basis, acc.shape[1], "cpu")(acc, degrees, key)
    _check_device("fused_cmux_step", acc, degrees, key)
    a = narrow_u32(acc).contiguous()
    out = CmuxStepPlan(conv, basis, acc.shape[1], a.device)(
        a, degrees.to(torch.int32).contiguous(), narrow_u32(key).contiguous())
    return out if acc.dtype == torch.int32 else widen_u32(out)


fused_cmux_step.launches = 0
