"""Kernel B: one NGS (NTRU) CMux step per launch on the int8 tensor cores,
and the MXU evaluation-key preparation.

Replaces ``ntru_cmux_step_nat`` (``primus_fhe_tpu/ops/ntru_cmux_mxu.py:259``,
kernel ``_make_ntru_kernel``) and ports ``get_ntru_plan`` and
``prepare_mxu_evk``.  CUDA source: ``csrc/cmux_mxu.cu`` (kernel A's
template with one prime and no CRT).

Per step, mod one prime ``q < 2^30``: mod-q signed gadget digits of the
accumulator (pre-adjusted above ``wrap_threshold``, made truly signed by
one conditional ``-q``), L forward NTTs as int8 products, the Shoup MAC
against the EVK row, one inverse NTT to ``delta``, then
``acc + rot(delta, a) - delta`` mod q.  The rotation acts on ``delta``
after the inverse NTT, as in the reference.  One thread block per
ciphertext, in clusters of C ciphertexts that share each streamed stage
(kernel A's design, :mod:`.cmux_mxu`); batch 1 uses one SM (widening it is
later work).
"""

from __future__ import annotations

import torch

from ..modular.modops import add32, sub32
from ..numeric.limb import narrow_u32, widen_u32
from ..poly.poly import poly_rotate32
from . import build
from .cmux_fused import _basis_pack, _check_device
from .cmux_mxu import (CmuxMxuPlan, _check_aligned, digit_planes, launch_clusters,
                       shoup_precons)
from .ntt32 import forward32_plain, inverse32_plain
from .ntt_mxu8 import mxu8_forward32

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


def ntru_ntt_step(tables, q: int, basis, acc, degrees, evk_ntt_i, forward, inverse):
    """The composed NGS step ``acc + rot(delta, a) - delta`` with
    ``delta = INTT(acc ⊠ EVK_i)``: decompose, ``forward`` each digit
    polynomial, MAC, ``inverse`` (``boot/ntru_blind_rotate.py`` scan body
    of the reference).

    ``acc``: ``(B, n)`` canonical mod q; ``degrees``: ``(B,)``;
    ``evk_ntt_i``: ``(L, n)`` canonical, bit-reversed; ``forward`` and
    ``inverse`` take ``(tables, (1, ..., n))`` (the kernels 1-2 wrappers or
    their plain versions).
    """
    f = forward(tables, basis.decompose(acc).unsqueeze(0))[0]  # (L, B, n)
    # canonical terms below 2^30: each product is exact in int64
    mac = ((f * evk_ntt_i.unsqueeze(1)) % q).sum(dim=0) % q
    delta = inverse(tables, mac.unsqueeze(0))[0]
    return add32(acc, sub32(poly_rotate32(delta, degrees, q), delta, q), q)


def ntru_cmux_step_plain(plan: CmuxMxuPlan, basis, acc, degrees, kv):
    """Plain version of kernel B on int64 words: :func:`ntru_ntt_step`
    through the plain butterfly transforms, the key's ``(A, B)`` view read
    as its bit-reversed NTT row."""
    evk = kv.reshape(kv.shape[0], plan.n)
    return ntru_ntt_step(plan.ntt, plan.primes[0], basis, acc, degrees, evk,
                         forward32_plain, inverse32_plain)


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
    C entry's refusal (``RuntimeError``) comes before any launch."""
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


def prepare_mxu_evk(ctx, evk_coeff: torch.Tensor):
    """Coefficient-domain EVK ``(n_lwe, L, n)`` mod q -> MXU pack
    ``(vals, precons)``, each ``(n_lwe, L, A, 128)`` int64: kernel C, then
    the exact Shoup quotients."""
    plan = get_ntru_plan(ctx.log_n, ctx.q_int)
    vals = mxu8_forward32(plan, evk_coeff.unsqueeze(0))[0].contiguous()
    return vals, shoup_precons(vals, (ctx.q_int,), 0).contiguous()
