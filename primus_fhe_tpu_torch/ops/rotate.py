"""Kernel F, ``rotate``: the negacyclic torus rotation ``v * X^d`` (optionally
minus ``v``) with one degree per ciphertext.

Replaces ``pallas_rotate`` (``primus_fhe_tpu/ops/rotate_pallas.py:29``).  The
TPU kernel rolls the row through ``log2(2N)`` conditional static shifts; on
Hopper a coefficient's source is index arithmetic plus a sign, one block per
(ciphertext, component) row.  CUDA source: ``csrc/cmux_front.cu``.  The
blind rotation (:mod:`..boot.blind_rotate`) runs it once a bootstrap, for
the accumulator's initial ``v * X^-b``.
"""

from __future__ import annotations

import torch

from ..numeric.limb import MASK32, narrow_u32, widen_u32
from ..poly.poly import rot_index
from . import build


def rotate_plain(values: torch.Tensor, degrees: torch.Tensor, subtract: bool = False):
    """Plain version on int64 words: ``values (B, ..., n)``, ``degrees (B,)``
    (any sign, taken mod 2n; the index math of :func:`..poly.poly.rot_index`)."""
    deg = degrees.to(values.device).reshape((values.shape[0],) + (1,) * (values.dim() - 2))
    idx, neg = rot_index(values.shape[-1], deg.expand(values.shape[:-1]))
    g = torch.gather(values, -1, idx)
    out = torch.where(neg, (-g) & MASK32, g)
    return (out - values) & MASK32 if subtract else out


def rotate(values: torch.Tensor, degrees: torch.Tensor, subtract: bool = False) -> torch.Tensor:
    """``values[b] * X^degrees[b]`` mod ``X^n + 1`` (minus ``values[b]`` when
    ``subtract``) for torus words ``values (B, ..., n)`` and ``degrees
    (B,)`` of any sign.  CPU tensors take the plain version, CUDA tensors
    kernel F; the output keeps the input's storage (int64 words or int32)."""
    if values.device.type == "cpu":
        out = rotate_plain(widen_u32(values), degrees, subtract)
        return narrow_u32(out) if values.dtype == torch.int32 else out
    if values.device.type != "cuda" or degrees.device != values.device:
        raise ValueError(f"rotate: tensors must share one CUDA device, got {values.device}, "
                         f"{degrees.device}")
    n = values.shape[-1] if values.dim() >= 2 else 0
    if n < 2 or n & (n - 1) or degrees.shape != values.shape[:1] or values.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"rotate: bad input {values.dtype} {tuple(values.shape)}, degrees "
                         f"{tuple(degrees.shape)}")
    v = narrow_u32(values).contiguous()
    # int32 truncation keeps every degree mod 2n (2n divides 2^32)
    d = degrees.to(torch.int32).contiguous()
    out = torch.empty_like(v)
    if v.numel():
        bsz = values.shape[0]
        rows = v.numel() // (bsz * n)
        err = build.library().pft_rotate(
            v.data_ptr(), d.data_ptr(), out.data_ptr(), bsz, rows, n.bit_length() - 1,
            int(subtract), torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, "rotate")
        rotate.launches += 1
    return out if values.dtype == torch.int32 else widen_u32(out)


rotate.launches = 0
