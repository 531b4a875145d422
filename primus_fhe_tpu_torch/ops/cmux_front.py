"""Kernel G, ``cmux_front``: the CMux front end, rotate-diff -> signed gadget
digits -> centered lift mod each prime, without the NTT.

Replaces ``pallas_cmux_front`` (``primus_fhe_tpu/ops/cmux_pallas.py:74``).
One block per accumulator row (ciphertext, component): the rotation is index
arithmetic plus a sign, one carry chain per coefficient gives the digits of
every level, and each digit is lifted mod every prime and written out.  It
runs the device functions of CMux stage 1 (``csrc/modarith32.cuh``), which
fuses the same front end with the forward NTT.  CUDA source:
``csrc/cmux_front.cu``.  Its caller is :func:`..lattice.tfhe.cmux_delta`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..numeric.limb import narrow_u32, widen_u32
from . import build
from .cmux_fused import _basis_pack
from .rotate import rotate_plain


@functools.lru_cache(maxsize=None)
def _lift_pack(primes: tuple) -> np.ndarray:
    """The kernels' ``PrimeSet`` host pack with the lift's constants only:
    per prime ``q, 0, 0, 0, 0, 2^32 mod q, floor(2^64 / q)``."""
    return np.array([[p, 0, 0, 0, 0, (1 << 32) % p, (1 << 64) // p] for p in primes],
                    dtype=np.uint64).reshape(-1)


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
    CUDA tensors kernel G; the output keeps ``acc``'s storage."""
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
    if not 1 <= len(primes) <= 4 or basis.modulus is not None:
        raise ValueError("cmux_front: 1 to 4 primes and a torus-mode basis")
    bsz, k1, n = acc.shape
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    level = basis.decompose_length
    out = torch.empty((len(primes), bsz, k1, level, n), dtype=torch.int32, device=a.device)
    if a.numel():
        pack = _basis_pack(basis)  # held until the call returns
        err = build.library().pft_cmux_front(
            a.data_ptr(), d.data_ptr(), out.data_ptr(), build.ptr(_lift_pack(primes)),
            build.ptr(pack), len(primes), bsz, k1, n.bit_length() - 1,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
        build.check(err, "cmux_front")
        cmux_front.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


cmux_front.launches = 0
