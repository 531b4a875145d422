"""Kernels 3 and 4: the fused blind-rotation CMux step, two launches per step.

Replaces ``cmux_stage1`` and ``cmux_stage2``
(``primus_fhe_tpu/ops/cmux_fused.py:140,226``); stage 1 is kernel G
(:mod:`.cmux_front`) with the forward NTT fused in, on the same device
functions.  CUDA source: ``csrc/cmux_fused.cu``.

- **stage 1** (:func:`cmux_stage1`): rotate-diff ``acc*X^d - acc`` ->
  signed gadget digit -> centered lift mod each prime -> forward NTT.  One
  thread block per (prime, accumulator row, level): the rotation is index
  arithmetic plus a sign (no conditional-roll chain), the digit of the
  block's level is re-derived per coefficient from the carry chain, and the
  NTT runs in shared memory.  Output ``(kp, B*k1, L, n)``, lazy ``[0,4p)``.
- **stage 2** (:func:`cmux_stage2`): MAC of the digits against the GGSW
  rows -> inverse NTT per prime -> Shoup multiply by ``(P/p_i)^-1`` ->
  integer CRT in native 64-bit arithmetic -> wrapping add to ``acc``.  One
  thread block per (ciphertext, output component), holding every prime's
  row in shared memory (16 KB at N=2048 with two primes).

What bounds it on the card: at batch 1 and BOOLEAN_128 shapes a step moves
about 0.2 MB (the key slice, 196 KB, dominates) through 12 + 2 blocks, so
the card is mostly idle.  Stage 2 then runs on two SMs, its MAC and two
inverse NTTs one after another in each block (~22 us a step on an H100 at
700 W), and the host's time per step in the Python loop exceeds both
kernels together.  At batch 64 stage 1's 768 blocks of shared-memory NTT
stages take the larger share.  Launch overhead is left alone here; CUDA
graphs, more blocks for stage 2 and keeping the key slices in L2 are
later work.

Beside each kernel stands its plain PyTorch version (``*_plain``), which
CPU tensors take and which the on-card check compares against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..lattice.tfhe import external_product_mac
from ..numeric.limb import MASK32, narrow_u32, widen_u32
from . import build
from .ntt32 import forward32_plain, inverse32_plain
from .rotate import rotate_plain


def cmux_stage1_plain(conv, basis, acc: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 3 on int64 words: ``acc (B, k1, n)``,
    ``degrees (B,)`` -> ``(kp, B*k1, L, n)`` lazy NTT-domain digits."""
    bsz, k1, n = acc.shape
    diff = rotate_plain(acc, degrees, subtract=True)
    digits = basis.decompose(diff)  # (L, B, k1, n)
    digits = digits.permute(1, 2, 0, 3).reshape(bsz * k1, basis.decompose_length, n)
    return forward32_plain(conv.ntt, conv.lift(digits), out_factor=4)


def cmux_stage2_plain(conv, f: torch.Tensor, key: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 4 on int64 words: ``f (kp, B*k1, L, n)``,
    ``key (kp, k1, L, k1, n)``, ``acc (B, k1, n)`` -> ``acc + delta``."""
    bsz, k1, n = acc.shape
    fb = f.reshape(conv.count, bsz, k1, key.shape[2], n)
    mac = external_product_mac(conv, fb, key, nbatch=1)  # (kp, B, k1, n)
    delta = conv.recombine(inverse32_plain(conv.ntt, mac))
    return (acc + delta) & MASK32


def _basis_pack(basis) -> np.ndarray:
    """Host pack of a gadget basis: the stage-1 kernel's ``BasisConsts``
    reads the first 7 words, the MXU kernels' ``MxuBasis`` (mod-q mode) all
    10."""
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


def cmux_stage1(conv, basis, acc: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """``acc (B, k1, n)`` + ``degrees (B,)`` in ``[0, 2n)`` ->
    ``(kp, B*k1, L, n)`` NTT-domain digit residues of ``acc*X^d - acc``,
    lazy ``[0, 4p)``.  CPU tensors take the plain version, CUDA tensors
    kernel 3; the output keeps ``acc``'s storage (int64 or int32)."""
    if acc.device.type == "cpu":
        out = cmux_stage1_plain(conv, basis, widen_u32(acc), degrees)
        return narrow_u32(out) if acc.dtype == torch.int32 else out
    _check_device("cmux_stage1", acc, degrees)
    bsz, k1, n = acc.shape
    if n != conv.n or degrees.shape != (bsz,):
        raise ValueError(f"cmux_stage1: bad shapes {tuple(acc.shape)}, {tuple(degrees.shape)}")
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    kp, level = conv.count, basis.decompose_length
    out = torch.empty((kp, bsz * k1, level, n), dtype=torch.int32, device=a.device)
    roots, roots_p, _, _ = conv.ntt.kernel_tables(a.device)
    pack = _basis_pack(basis)  # held until the call returns
    err = build.library().pft_cmux_stage1(
        a.data_ptr(), d.data_ptr(), out.data_ptr(), roots.data_ptr(), roots_p.data_ptr(),
        build.ptr(conv.ntt.prime_pack), build.ptr(pack), kp, bsz, k1,
        conv.log_n, torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "cmux_stage1")
    cmux_stage1.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


def cmux_stage2(conv, f: torch.Tensor, key: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``f (kp, B*k1, L, n)`` digits x ``key (kp, k1, L, k1, n)`` canonical
    GGSW -> new accumulator ``acc + delta`` ``(B, k1, n)``.  CPU tensors
    take the plain version, CUDA tensors kernel 4; the output keeps
    ``acc``'s storage."""
    if acc.device.type == "cpu":
        out = cmux_stage2_plain(conv, widen_u32(f), widen_u32(key), widen_u32(acc))
        return narrow_u32(out) if acc.dtype == torch.int32 else out
    _check_device("cmux_stage2", f, key, acc)
    bsz, k1, n = acc.shape
    kp, level = conv.count, key.shape[2]
    if key.shape != (kp, k1, level, k1, n) or f.shape != (kp, bsz * k1, level, n):
        raise ValueError(f"cmux_stage2: bad shapes {tuple(f.shape)}, {tuple(key.shape)}")
    fk = narrow_u32(f).contiguous()
    kk = narrow_u32(key).contiguous()
    a = narrow_u32(acc).contiguous()
    out = torch.empty_like(a)
    _, _, inv_roots, inv_roots_p = conv.ntt.kernel_tables(a.device)
    err = build.library().pft_cmux_stage2(
        fk.data_ptr(), kk.data_ptr(), a.data_ptr(), out.data_ptr(), inv_roots.data_ptr(),
        inv_roots_p.data_ptr(), build.ptr(conv.ntt.prime_pack), build.ptr(conv.crt_pack),
        kp, bsz, k1, level, conv.log_n, torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "cmux_stage2")
    cmux_stage2.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


cmux_stage1.launches = 0
cmux_stage2.launches = 0


def fused_cmux_step(conv, basis, acc: torch.Tensor, degrees: torch.Tensor, key: torch.Tensor):
    """One blind-rotation step: ``acc + (acc*X^d - acc) ⊡ key``.

    ``acc``: ``(B, k1, n)``; ``degrees``: ``(B,)`` in ``[0, 2n)``;
    ``key``: ``(kp, k1, L, k1, n)`` canonical NTT-domain GGSW.
    """
    return cmux_stage2(conv, cmux_stage1(conv, basis, acc, degrees), key, acc)
