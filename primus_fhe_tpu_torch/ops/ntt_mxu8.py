"""Kernel C: the byte-radix four-step forward NTT of the MXU key preparations.

Replaces the u32 tier (4 byte planes, ``q < 2^30``) of
``mxu8_fused_forward64`` (``primus_fhe_tpu/ops/ntt_mxu8.py:917``, reached
through ``ops/mxu_common._natural_call``), which ``prepare_mxu_bsk`` and
``prepare_mxu_evk`` run.  The 7- and 8-plane tiers, the inverse, the fused
multiply and the round trip are not ported.  CUDA source:
``csrc/ntt_mxu8.cu``; design and bounds are stated there.

The four-step's natural output order is the butterfly NTT's bit-reversed
order, so the plain version is kernel 1's plain forward, canonical, viewed
as ``(..., A, 128)``.
"""

from __future__ import annotations

import torch

from ..numeric.limb import narrow_u32, widen_u32
from . import build
from .ntt32 import forward32_plain


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
