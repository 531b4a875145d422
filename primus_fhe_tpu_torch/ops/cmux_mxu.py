"""Kernel A: one TFHE CMux step per launch on the int8 tensor cores, its plan,
and the MXU bootstrap-key preparation.

Replaces ``mxu_cmux_step_nat`` (``primus_fhe_tpu/ops/cmux_mxu.py:621``,
kernel ``_make_cmux_kernel``) and ports ``CmuxMxuPlan``, ``get_plan`` and
``prepare_mxu_bsk``.  CUDA source: ``csrc/cmux_mxu.cu`` (shared device code
in ``csrc/mxu8.cuh``).

The plan
--------
:class:`CmuxMxuPlan` keeps what the Hopper kernels read: the int8 plane
matrices ``w1d``, ``w2f``, ``w1mf``, ``w2m`` (equal to the JAX plan's) and
the twiddle tables ``t``/``tp`` and ``ti``/``tip`` with their Shoup
quotients, plus ``w1f``, the 4-plane forward pass-1 matrix of kernel C.
The JAX plan's bias tables (``ct``, ``cb2``, ``cti``, ``cbi``, ``b2_*``,
``t16``, ``w16``, ``prec1``) exist because the TPU kernel feeds XOR-0x80
biased bytes and packs planes into 16-bit groups; the Hopper kernels feed
each word's own unsigned bytes (``mma`` u8 x s8) and reduce every product
in 64-bit arithmetic, so none of them is ported.  :meth:`kernel_tables`
reorders the matrices into the kernels' layout, with the byte-plane index
innermost in the contraction (so a u32 word in shared memory is its own 4
operand bytes).

The kernel
----------
One thread block per (ciphertext, prime), the kp blocks of a ciphertext in
one thread-block cluster that shares the CRT terms through distributed
shared memory; every step of ``acc + (acc*X^d - acc) ⊡ BSK_i`` runs inside
it (rotate-diff, digits, 4 int8 passes, Shoup MAC, CRT, wrapping add).  So
batch 1 uses kp of 132 SMs, and the forward digits are computed once per
prime (no recomputation per output component).  Widening batch 1 is later
work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.gcd import mod_inv

from ..numeric.limb import MASK32, narrow_u32, widen_u32
from . import build
from .cmux_fused import _basis_pack, _check_device, cmux_stage1_plain, cmux_stage2_plain
from .mxu_common import four_step_matrices
from .ntt32 import NttTables32

LANES = 128  # B: the natural layout views a length-n row as (A, 128)


def _balanced_digits(ms, planes: int):
    """Balanced base-256 digits in ``[-128, 127]`` of object ints."""
    x = ms.astype(object, copy=True)
    digs = []
    for _ in range(planes):
        d = x & 255
        x = x >> 8
        over = d >= 128
        d = d - over * 256
        x = x + over
        digs.append(d.astype(np.int8))
    assert (x == 0).all(), "balanced digit overflow"
    return digs


def _byte_matrix4(m, q: int, value_planes: int = 4) -> np.ndarray:
    """``W[(c, r), (l, k)] = bal_c(M[r, k] * 2^(8l) mod q)``: 4 output planes,
    ``value_planes`` operand planes."""
    R, K = m.shape
    w = np.zeros((4 * R, value_planes * K), dtype=np.int8)
    for l in range(value_planes):
        digs = _balanced_digits((m * pow(2, 8 * l, q)) % q, 4)
        for c in range(4):
            w[c * R : (c + 1) * R, l * K : (l + 1) * K] = digs[c]
    return w


def _u32t(a) -> np.ndarray:
    return np.asarray([int(v) & MASK32 for v in np.ravel(a)], dtype=np.uint32).reshape(np.shape(a))


def _precon32(w, q: int) -> np.ndarray:
    """``floor(w * 2^32 / q)`` for canonical ``w`` (exact, host)."""
    return np.asarray([(int(v) << 32) // q for v in np.ravel(w)],
                      dtype=np.uint64).astype(np.uint32).reshape(np.shape(w))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_layout(w: np.ndarray, rows: int, planes: int, used: int,
                  out_planes: int = 4) -> np.ndarray:
    """A JAX-layout plane matrix ``(out_planes * rows, planes * K)`` with
    columns ``(l, k)`` -> the kernels' ``(out_planes * rows8, K8)`` with
    columns ``(k, l)`` for the first ``used`` planes; rows padded to a
    multiple of 8 and columns to a multiple of 32 bytes with zeros."""
    k = w.shape[1] // planes
    x = w.reshape(out_planes, rows, planes, k)[:, :, :used, :].transpose(0, 1, 3, 2)
    x = x.reshape(out_planes, rows, k * used)
    out = np.zeros((out_planes, _round_up(rows, 8), _round_up(k * used, 32)), dtype=np.int8)
    out[:, :rows, : k * used] = x
    return out.reshape(-1, out.shape[-1])


class CmuxMxuPlan:
    """Per-``(log_n, primes)`` tables of the byte-radix four-step kernels.

    ``A = n / 128`` rows by ``B = 128`` lanes (``log_n >= 8``).  int32
    bound of every plane product: see ``csrc/mxu8.cuh`` (at most 512 terms
    of ``|u8 * s8| < 2^15``, so ``|sum| < 2^24``).
    """

    def __init__(self, log_n: int, primes: tuple[int, ...]):
        if log_n < 8:
            raise ValueError("cmux_mxu needs log_n >= 8 (B = 128 lanes)")
        self.log_n = log_n
        self.n = 1 << log_n
        h1 = log_n - 7
        self.A = 1 << h1
        self.B = LANES
        self.primes = tuple(int(p) for p in primes)
        if any(p >= 1 << 30 for p in self.primes):
            raise ValueError("cmux_mxu primes must be < 2^30")
        self.ntt = NttTables32(log_n, self.primes)
        self.per_prime = []
        for p in self.primes:
            fs = four_step_matrices(log_n, p, h1, h1)
            w2 = _byte_matrix4(fs["m2"], p)  # rows (c, r1), cols (l, k0)
            w1m = _byte_matrix4(fs["m2i"], p)  # rows (c, k0), cols (l, r1)
            self.per_prime.append(dict(
                w1d=_byte_matrix4(fs["m1"], p, value_planes=2),  # (4A, 2A)
                w1f=_byte_matrix4(fs["m1"], p),  # (4A, 4A), kernel C
                w2f=np.ascontiguousarray(w2.T),
                w1mf=np.ascontiguousarray(w1m.T),
                w2m=_byte_matrix4(fs["m1i"], p),  # rows (c, k1), cols (l, r0)
                t=_u32t(fs["tw"]), tp=_precon32(fs["tw"], p),
                ti=_u32t(fs["twi"]), tip=_precon32(fs["twi"], p),
            ))
        self._kernel_on: dict = {}

    def crt_consts(self, product: int):
        """CRT constants under the prime product ``P``: ``((floor(2^64 /
        p_i), (P / p_i) mod 2^32) per prime, P mod 2^32)``."""
        return tuple(((1 << 64) // p, (product // p) % (1 << 32)) for p in self.primes) + (
            product % (1 << 32),)

    def fold_inverse_scale(self, product: int) -> None:
        """Folds ``(P / p_i)^-1 mod p_i`` into ``w2m`` (once), so that the
        inverse transform yields the CRT terms ``y_i`` directly."""
        for per_p, p in zip(self.per_prime, self.primes):
            if per_p.get("_scaled"):
                continue
            c = mod_inv((product // p) % p, p)
            fs = four_step_matrices(self.log_n, p, self.log_n - 7, self.log_n - 7)
            per_p["w2m"] = _byte_matrix4((fs["m1i"] * c) % p, p)
            per_p["_scaled"] = True
        self._kernel_on.clear()

    def kernel_tables(self, device) -> dict:
        """The kernels' tables on ``device``, stacked over primes:
        ``w1_1``/``w1_2`` (forward pass 1 for 1- or 2-byte digits), ``w1_4``
        (kernel C's pass 1), ``w2``, ``wi1``, ``wi2`` (int8) and ``tw``
        ``(kp, 4, n)`` = tw, its precon, twi, its precon (int32 storage)."""
        device = torch.device(device)
        if device not in self._kernel_on:
            A, B = self.A, self.B

            def stack(fn, dtype=torch.int8):
                arr = np.stack([fn(pp) for pp in self.per_prime])
                return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype).to(device)

            self._kernel_on[device] = dict(
                w1_1=stack(lambda pp: kernel_layout(pp["w1d"], A, 2, 1)),
                w1_2=stack(lambda pp: kernel_layout(pp["w1d"], A, 2, 2)),
                w1_4=stack(lambda pp: kernel_layout(pp["w1f"], A, 4, 4)),
                w2=stack(lambda pp: kernel_layout(pp["w2f"].T, B, 4, 4)),
                wi1=stack(lambda pp: kernel_layout(pp["w1mf"].T, B, 4, 4)),
                wi2=stack(lambda pp: kernel_layout(pp["w2m"], A, 4, 4)),
                tw=stack(lambda pp: np.stack(
                    [pp[k].reshape(-1) for k in ("t", "tp", "ti", "tip")]).astype(np.int64),
                    torch.int64).to(torch.int32),
            )
        return self._kernel_on[device]


_PLANS: dict = {}


def get_plan(log_n: int, primes: tuple, product: int) -> CmuxMxuPlan:
    """Cached plan with the CRT scale of ``product`` folded in."""
    key = (log_n, tuple(primes))
    plan = _PLANS.get(key)
    if plan is None:
        plan = CmuxMxuPlan(log_n, tuple(primes))
        plan.fold_inverse_scale(product)
        _PLANS[key] = plan
    return plan


def plan_for(conv) -> CmuxMxuPlan:
    """The plan of a :class:`~..transforms.torus.TorusConvolver32`."""
    return get_plan(conv.log_n, tuple(conv.primes), conv.product)


def digit_planes(basis) -> int:
    """Signed bytes a gadget digit needs: 1 up to 2^8, 2 up to 2^15."""
    if basis.log_basis > 15:
        raise ValueError("the MXU kernels take gadget bases up to 2^15")
    return 1 if basis.log_basis <= 8 else 2


def mxu_cmux_step_plain(conv, basis, acc, degrees, key_vals):
    """Plain version of kernel A on int64 words: the composed stage-1 /
    stage-2 step of :mod:`.cmux_fused` with the key's natural ``(A, B)``
    view read as the bit-reversed NTT row it is."""
    kp, k1, level, k1b = key_vals.shape[:4]
    key = key_vals.reshape(kp, k1, level, k1b, -1)
    return cmux_stage2_plain(conv, cmux_stage1_plain(conv, basis, acc, degrees), key, acc)


def mxu_cmux_step(plan: CmuxMxuPlan, basis, conv, acc: torch.Tensor, degrees: torch.Tensor,
                  key_vals: torch.Tensor, key_precons: torch.Tensor) -> torch.Tensor:
    """One CMux step ``acc + (acc*X^d - acc) ⊡ BSK_i`` on the MXU key pack.

    ``acc``: ``(B, k1, n)`` torus words (a row-major view of JAX's natural
    ``(B, k1, A, 128)``); ``degrees``: ``(B,)`` in ``[0, 2n)``;
    ``key_vals``/``key_precons``: ``(kp, k1, L, k1, A, 128)`` canonical
    NTT-domain GGSW rows and their Shoup quotients.  ``conv`` (the
    convolver of the plan's primes) stands where JAX passes ``crt``: it
    carries the CRT constants and the plain version's transforms.  CPU
    tensors take the plain version, CUDA tensors kernel A; the output keeps
    ``acc``'s storage (int64 or int32).
    """
    if acc.device.type == "cpu":
        out = mxu_cmux_step_plain(conv, basis, widen_u32(acc), degrees, widen_u32(key_vals))
        return narrow_u32(out) if acc.dtype == torch.int32 else out
    _check_device("mxu_cmux_step", acc, degrees, key_vals, key_precons)
    bsz, k1, n = acc.shape
    kp, level = len(plan.primes), basis.decompose_length
    want = (kp, k1, level, k1, plan.A, plan.B)
    if (n != plan.n or degrees.shape != (bsz,) or tuple(key_vals.shape) != want
            or tuple(key_precons.shape) != want or tuple(plan.primes) != tuple(conv.primes)):
        raise ValueError(f"mxu_cmux_step: bad shapes {tuple(acc.shape)}, {tuple(key_vals.shape)}")
    a = narrow_u32(acc).contiguous()
    d = degrees.to(torch.int32).contiguous()
    kv = narrow_u32(key_vals).contiguous()
    kpre = narrow_u32(key_precons).contiguous()
    out = torch.empty_like(a)
    dp = digit_planes(basis)
    tabs = plan.kernel_tables(a.device)
    pack = _basis_pack(basis)  # held until the call returns
    err = build.library().pft_cmux_mxu(
        a.data_ptr(), d.data_ptr(), kv.data_ptr(), kpre.data_ptr(), out.data_ptr(),
        tabs[f"w1_{dp}"].data_ptr(), tabs["w2"].data_ptr(), tabs["wi1"].data_ptr(),
        tabs["wi2"].data_ptr(), tabs["tw"].data_ptr(), build.ptr(plan.ntt.prime_pack),
        build.ptr(conv.crt_pack), build.ptr(pack), kp, bsz, k1, plan.log_n, dp,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    build.check(err, "mxu_cmux_step")
    mxu_cmux_step.launches += 1
    return out if acc.dtype == torch.int32 else widen_u32(out)


mxu_cmux_step.launches = 0


def shoup_precons(vals: torch.Tensor, primes, axis: int) -> torch.Tensor:
    """Exact ``floor(w * 2^32 / p)`` of canonical ``vals`` (int64), prime
    ``i`` along ``axis``: ``w < 2^30`` keeps ``w << 32`` inside int64."""
    shape = [1] * vals.dim()
    shape[axis] = len(primes)
    p = torch.tensor(primes, dtype=torch.int64, device=vals.device).reshape(shape)
    return torch.div(vals << 32, p, rounding_mode="floor")


def prepare_mxu_bsk(conv, ggsw_coeff: torch.Tensor):
    """Coefficient-domain stacked GGSW ``(n_lwe, k1, L, k1, n)`` torus words
    -> MXU key pack ``(vals, precons)``, each ``(n_lwe, kp, k1, L, k1, A,
    128)`` int64 and contiguous: the centered lift, kernel C per prime,
    then the exact Shoup quotients."""
    from .ntt_mxu8 import mxu8_forward32

    plan = plan_for(conv)
    vals = mxu8_forward32(plan, conv.lift(ggsw_coeff)).movedim(0, 1).contiguous()
    return vals, shoup_precons(vals, conv.primes, 1).contiguous()
