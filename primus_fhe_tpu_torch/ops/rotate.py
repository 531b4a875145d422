"""Kernel F, ``rotate``: the negacyclic torus rotation ``v * X^d`` (optionally
minus ``v``) with one degree per ciphertext.

Replaces ``pallas_rotate`` (``primus_fhe_tpu/ops/rotate_pallas.py:29``).  The
TPU kernel rolls the row through ``log2(2N)`` conditional static shifts; on
Hopper a coefficient's source is index arithmetic plus a sign, four output
words a thread in one 16-byte store (their sources in a window of two
aligned 16-byte loads).  CUDA source: ``csrc/cmux_front.cu``.  The blind
rotation (:mod:`..boot.blind_rotate`) runs it once a bootstrap, for the
accumulator's initial ``v * X^-b``: the test polynomial expanded to the
batch (a source row stride of 0, the one row read in place) and written
through ``out=`` into the accumulator's last component, so nothing is
copied around the launch.
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


def _rows(t: torch.Tensor, n: int) -> torch.Tensor | None:
    """``t`` as ``(rows, n)`` without a copy (any row stride, 0 for one
    broadcast row), or None where its rows are not evenly spaced."""
    if t.stride(-1) != 1:
        return None
    try:
        return t.view(-1, n)
    except RuntimeError:
        return None


def check_row(what: str, n: int) -> None:
    """Raises a ``ValueError`` naming the cap where kernels F and G take no
    rows of ``n`` words: the cap is the library's own (``FG_MAX_LOG_N`` in
    ``csrc/cmux_front.cu``, 29: every index of a row in an int)."""
    cap = build.library().pft_rotate_max_log_n()
    if n > 1 << cap:
        raise ValueError(f"{what}: the kernel takes rows of up to 2^{cap} words, got {n}")


def rotate(values: torch.Tensor, degrees: torch.Tensor, subtract: bool = False,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """``values[b] * X^degrees[b]`` mod ``X^n + 1`` (minus ``values[b]`` when
    ``subtract``) for torus words ``values (B, ..., n)`` and ``degrees
    (B,)`` of any sign.  CPU tensors take the plain version, CUDA tensors
    kernel F.  ``values`` may be a view with evenly spaced rows, a
    broadcast (``expand``) included: the kernel reads it as it lies.  The
    output keeps the input's storage (int64 words or int32), or goes into
    ``out``: int32 storage of ``values``' shape, any view with evenly spaced
    rows (``acc[:, -1, :]``), not overlapping ``values``; ``out`` is
    returned.  On the card rows of up to ``2^29`` words (:func:`check_row`:
    a ``ValueError`` past it, before any launch)."""
    if out is not None and (out.dtype != torch.int32 or out.shape != values.shape
                            or out.device != values.device):
        raise ValueError(f"rotate: out must be int32 {tuple(values.shape)} on {values.device}, "
                         f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if values.device.type == "cpu":
        res = rotate_plain(widen_u32(values), degrees, subtract)
        if out is not None:
            return out.copy_(narrow_u32(res))
        return narrow_u32(res) if values.dtype == torch.int32 else res
    if values.device.type != "cuda" or degrees.device != values.device:
        raise ValueError(f"rotate: tensors must share one CUDA device, got {values.device}, "
                         f"{degrees.device}")
    n = values.shape[-1] if values.dim() >= 2 else 0
    if n < 2 or n & (n - 1) or degrees.shape != values.shape[:1] or values.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"rotate: bad input {values.dtype} {tuple(values.shape)}, degrees "
                         f"{tuple(degrees.shape)}")
    check_row("rotate", n)
    v = narrow_u32(values)
    src = _rows(v, n)
    if src is None:
        src = v.contiguous().view(-1, n)
    if out is None:
        res = torch.empty(values.shape, dtype=torch.int32, device=values.device)
    else:
        res = out
    dst = _rows(res, n)
    if dst is None:
        raise ValueError(f"rotate: out's rows must be evenly spaced, got strides {res.stride()}")
    # int32 truncation keeps every degree mod 2n (2n divides 2^32)
    d = degrees.to(torch.int32).contiguous()
    if src.shape[0]:
        bsz = values.shape[0]
        single = src.shape[0] == 1  # one row: its stride is immaterial
        err = build.library().pft_rotate(
            src.data_ptr(), n if single else src.stride(0), d.data_ptr(), dst.data_ptr(),
            n if single else dst.stride(0), bsz, src.shape[0] // bsz, n.bit_length() - 1,
            int(subtract), torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, "rotate")
        rotate.launches += 1
    if out is not None or values.dtype == torch.int32:
        return res
    return widen_u32(res)


rotate.launches = 0
