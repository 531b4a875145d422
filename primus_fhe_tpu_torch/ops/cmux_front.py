"""Kernel G, ``cmux_front``: the CMux front end, rotate-diff -> signed gadget
digits -> centered lift mod each prime, without the NTT.

Replaces ``pallas_cmux_front`` (``primus_fhe_tpu/ops/cmux_pallas.py:74``).
A thread takes a group of 4 coefficients of a row: kernel F's rotation
window (two aligned 16-byte loads, one sign each) less the group's own
16-byte load, four carry chains side by side giving the digits of every
level, and each level's 4 digits lifted mod each prime and written as one
streaming 16-byte store (kp L stores a group; kp is compiled in, so the
primes' constants stay in the parameter bank).  The grid is flat over the
groups, 128 threads a block (:func:`launch_grid` reads the C entry's
rule); rows under 4 words or a source off 16-byte alignment take a
coefficient a thread.  It runs the device functions of the fused CMux step
(``csrc/modarith32.cuh``), which feeds the same front end into its forward
NTTs.  CUDA source: ``csrc/cmux_front.cu``.  Its caller is
:func:`..lattice.tfhe.cmux_delta`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..numeric.limb import narrow_u32, widen_u32
from . import build
from .cmux_fused import _basis_pack
from .rotate import rotate_plain


GROUP_PRIMES = 4  # primes a launch (PFT_MAX_KP in csrc/modarith32.cuh)


@functools.lru_cache(maxsize=None)
def _lift_pack(primes: tuple) -> np.ndarray:
    """The kernels' ``PrimeSet`` host pack with the lift's constants only:
    per prime ``q, 0, 0, 0, 0, 2^32 mod q, floor(2^64 / q)``."""
    return np.array([[p, 0, 0, 0, 0, (1 << 32) % p, (1 << 64) // p] for p in primes],
                    dtype=np.uint64).reshape(-1)


def launch_grid(rows: int, log_n: int, aligned: bool = True) -> tuple[int, int, int]:
    """``(groups, threads a block, blocks)`` of kernel G's launch on
    ``rows`` rows of ``2^log_n`` words: groups 1 for a thread a group of 4
    words, 0 for a thread a coefficient (the C entry's own rule)."""
    import ctypes

    out = (ctypes.c_int * 3)()
    err = build.library().pft_cmux_front_grid(rows, log_n, int(aligned), ctypes.addressof(out))
    build.check(err, "pft_cmux_front_grid")
    return tuple(out)


def cmux_front_plain(acc: torch.Tensor, degrees: torch.Tensor, basis, primes) -> torch.Tensor:
    """Plain version on int64 words: ``acc (B, k1, n)``, ``degrees (B,)`` ->
    ``(kp, B, k1, L, n)`` canonical residues of the digits of ``acc*X^d -
    acc``, each digit's centered value (``x - 2^32`` for ``x >= 2^31``)
    taken mod the prime."""
    diff = rotate_plain(acc, degrees, subtract=True)
    digits = basis.decompose(diff).movedim(0, -2)  # (B, k1, L, n)
    centered = torch.where(digits >= 1 << 31, digits - (1 << 32), digits)
    q = torch.tensor(list(primes), dtype=torch.int64, device=acc.device)
    return centered.unsqueeze(0).remainder(q.reshape((-1,) + (1,) * centered.dim()))


def cmux_front(acc: torch.Tensor, degrees: torch.Tensor, basis, primes) -> torch.Tensor:
    """``acc (B, k1, n)`` torus words and ``degrees (B,)`` (any sign, taken
    mod 2n) -> the NTT-ready digit residues ``(kp, B, k1, L, n)`` of
    ``acc*X^d - acc`` over the torus-mode gadget ``basis``, canonical mod
    each of ``primes`` (below 2^30).  CPU tensors take the plain version,
    CUDA tensors kernel G, which takes up to :data:`GROUP_PRIMES` primes a
    launch: more primes launch it once a group, each group into its slice
    ``out[g0:g1]`` of the one output.  The output keeps ``acc``'s
    storage."""
    primes = tuple(int(p) for p in primes)
    if acc.device.type == "cpu":
        out = cmux_front_plain(widen_u32(acc), degrees, basis, primes)
        return narrow_u32(out) if acc.dtype == torch.int32 else out
    if acc.device.type != "cuda" or degrees.device != acc.device:
        raise ValueError(f"cmux_front: tensors must share one CUDA device, got {acc.device}, "
                         f"{degrees.device}")
    if acc.dim() != 3 or degrees.shape != (acc.shape[0],) or acc.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"cmux_front: bad input {acc.dtype} {tuple(acc.shape)}, degrees "
                         f"{tuple(degrees.shape)}")
    if not primes or basis.modulus is not None:
        raise ValueError("cmux_front: at least one prime and a torus-mode basis")
    bsz, k1, n = acc.shape
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    level = basis.decompose_length
    out = torch.empty((len(primes), bsz, k1, level, n), dtype=torch.int32, device=a.device)
    if a.numel():
        pack = _basis_pack(basis)  # held until the call returns
        for g0 in range(0, len(primes), GROUP_PRIMES):
            group = primes[g0 : g0 + GROUP_PRIMES]
            err = build.library().pft_cmux_front(
                a.data_ptr(), d.data_ptr(), out[g0 : g0 + len(group)].data_ptr(),
                build.ptr(_lift_pack(group)), build.ptr(pack), len(group), bsz, k1,
                n.bit_length() - 1, torch.cuda.current_stream(a.device).cuda_stream,
            )
            build.check(err, "cmux_front")
            cmux_front.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


cmux_front.launches = 0
