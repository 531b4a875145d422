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
quotients.
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
One thread block per (ciphertext, prime); every step of ``acc + (acc*X^d -
acc) ⊡ BSK_i`` runs inside it (rotate-diff, digits, 4 int8 passes, Shoup
MAC, CRT, wrapping add), the two large passes on ``wgmma`` from shared
memory.  A producer warp streams the plane matrices and the key rows into a
ring of 16 KB stages by bulk copy, in the order of :func:`wgmma_layout`'s
tables (``w2g``, ``wi1g``).  Blocks run in clusters of ``kp * C``: the kp
primes of a ciphertext share the CRT terms through distributed shared
memory, and the C blocks of a prime receive each stage from one multicast
copy; :func:`launch_clusters` picks C from the batch and the card's cluster
occupancy.  So batch 1 uses kp of 132 SMs.  Widening batch 1 is later
work.

The route
---------
Kernel A takes ``log_n`` 8-12 and a block's plan within 227 KB.  The
blind rotation decides once a rotation, before any launch, where a step
runs (:func:`mxu_step_route`): kernel A wherever its C entry's
``configure()`` accepts the shape (:func:`mxu_holds`), else the NTT key's
route of :mod:`.cmux_fused` (the one-launch fused step or the staged
kernels G, 1 and H) on the pack's values, which are the canonical
bit-reversed NTT rows the NTT key holds.  The key preparation runs kernel
C to ``log_n`` 12 and kernel 1 at 13-17 (:func:`prepare_mxu_bsk`); the
plan's int8 tables are built at first use, only for kernel A's shapes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.gcd import mod_inv

from ..numeric.limb import MASK32, narrow_u32, widen_u32
from . import build
from .cmux_fused import (_basis_pack, _check_device, cmux_stage1_plain, cmux_stage2_plain,
                         step_route)
from .mxu_common import four_step_matrices
from .ntt32 import NttTables32

LANES = 128  # B: the natural layout views a length-n row as (A, 128)
MXU_LOG_N = (8, 12)  # kernels A and B's rings (valid() in csrc/cmux_mxu.cu)
_REFUSED = 1  # cudaErrorInvalidValue: the C entries' refusal of a shape


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


def wgmma_layout(w: np.ndarray) -> np.ndarray:
    """A ``(4 * 128, 512)`` kernel-layout plane matrix (rows ``(c, r1)``,
    columns ``(k0, l)``) in kernels A/B's stream order for ``wgmma``.

    Row ``(c, r1)`` with ``c = 2s + h`` and ``r1 = 32u + 8w + g`` (``u = 2
    * round + wg``) becomes row ``16w + 8h + g`` of M tile ``2u + s``, so a
    thread of warpgroup ``wg`` gets the four planes of output ``r1`` in its
    accumulators.  The flat result is 16 stages of 16 KB, ``[round][k-stage
    (8, 64 bytes of K each)]``, each ``[wg][s][k-step (2)][8 row groups][2
    halves][8 rows][16 bytes]``: 2 KB core-matrix tiles of 64 rows by 32
    bytes (``csrc/mxu8.cuh``)."""
    x = w.reshape(2, 2, 2, 2, 4, 8, 8, 2, 2, 16)  # s h round wg w g ks kk half byte
    return np.ascontiguousarray(x.transpose(2, 6, 3, 0, 7, 4, 1, 8, 5, 9)).reshape(-1)


def cluster_ciphertexts(bsz: int, kp: int, fits) -> int:
    """C, the ciphertexts a cluster of kernels A/B takes: ``kp * C`` blocks,
    at most 8 (the portable cluster size), and no more than the batch.  Of
    those, the largest C whose grid runs in the fewest waves, ``fits(C)``
    being how many clusters of ``kp * C`` blocks the card holds at once.  A
    larger C shares each plane-tile copy among more blocks; a wave more
    costs a whole step."""
    best = None
    for c in range(max(1, min(8 // kp, bsz)), 0, -1):
        waves = -(-(-(-bsz // c)) // max(fits(c), 1))
        if best is None or waves < best[0]:
            best = (waves, c)
    return best[1]


@functools.lru_cache(maxsize=None)
def launch_clusters(ntru: bool, kp: int, k1: int, log_n: int, dp: int, level: int,
                    bsz: int) -> int:
    """:func:`cluster_ciphertexts` for kernel A (or B) at this shape and
    batch, ``fits`` from the card's occupancy query; cached per process, as
    the blind rotations launch the same shape hundreds of times."""
    def fits(c: int) -> int:
        out = ctypes.c_int(0)
        build.check(build.library().pft_cmux_mxu_clusters(
            int(ntru), kp, k1, log_n, dp, level, c, ctypes.addressof(out)), "cmux_mxu clusters")
        return out.value
    return cluster_ciphertexts(bsz, kp, fits)


@functools.lru_cache(maxsize=None)
def mxu_holds(ntru: bool, kp: int, k1: int, level: int, log_n: int, dp: int) -> bool:
    """Whether kernel A (``ntru``: kernel B, one prime and one row) takes
    the shape: its C entry's ``valid()`` and ``configure()`` (a block's
    plan within 227 KB) accept it, and the card holds a cluster of it.
    Asks the card at ``log_n`` 8-12 only; outside, ``False``."""
    if not MXU_LOG_N[0] <= log_n <= MXU_LOG_N[1]:
        return False
    out = ctypes.c_int(0)
    err = build.library().pft_cmux_mxu_clusters(int(ntru), kp, k1, log_n, dp, level, 1,
                                                ctypes.addressof(out))
    if err == _REFUSED:
        return False
    build.check(err, "cmux_mxu clusters")
    return out.value >= 1


def mxu_step_route(kp: int, k1: int, level: int, log_n: int, dp: int) -> str:
    """The card's route for a CMux step on the MXU key of ``kp`` primes,
    ``k1`` accumulator rows, ``level`` gadget levels, ring ``2^log_n`` and
    ``dp`` digit planes (:func:`digit_planes`): ``"mxu"`` (kernel A, one
    launch) wherever :func:`mxu_holds`, else the NTT key's route,
    :func:`.cmux_fused.step_route`'s ``"fused"`` or ``"staged"``, on the
    pack's values read as the NTT rows they are.  Decided from the shape
    before any launch; a ``ValueError`` names the limit past every route."""
    if dp not in (1, 2):
        raise ValueError(f"MXU CMux step: {dp} digit planes (1 or 2: gadget bases up to 2^15)")
    if log_n < MXU_LOG_N[0]:
        raise ValueError(f"MXU CMux step: log_n = {log_n} (the MXU key needs log_n >= 8)")
    if mxu_holds(False, kp, k1, level, log_n, dp):
        return "mxu"
    return step_route(kp, k1, level, log_n)


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
        self._per_prime = None
        self._product = None  # the CRT product whose scale w2m folds in
        self._kernel_on: dict = {}

    @property
    def per_prime(self) -> list:
        """Kernel A's and B's int8 plane matrices and twiddles, a dict a
        prime, built at first use: object-int matrices that cost host
        seconds at ``A`` = 256-512, which only kernels A and B (``log_n``
        8-12) and the plain models read; the staged route and kernel C run
        on ``self.ntt``."""
        if self._per_prime is None:
            h1 = self.log_n - 7
            per = []
            for p in self.primes:
                fs = four_step_matrices(self.log_n, p, h1, h1)
                w2 = _byte_matrix4(fs["m2"], p)  # rows (c, r1), cols (l, k0)
                w1m = _byte_matrix4(fs["m2i"], p)  # rows (c, k0), cols (l, r1)
                m1i = fs["m1i"]
                if self._product is not None:
                    m1i = (m1i * mod_inv((self._product // p) % p, p)) % p
                per.append(dict(
                    w1d=_byte_matrix4(fs["m1"], p, value_planes=2),  # (4A, 2A)
                    w2f=np.ascontiguousarray(w2.T),
                    w1mf=np.ascontiguousarray(w1m.T),
                    w2m=_byte_matrix4(m1i, p),  # rows (c, k1), cols (l, r0)
                    t=_u32t(fs["tw"]), tp=_precon32(fs["tw"], p),
                    ti=_u32t(fs["twi"]), tip=_precon32(fs["twi"], p),
                ))
            self._per_prime = per
        return self._per_prime

    def crt_consts(self, product: int):
        """CRT constants under the prime product ``P``: ``((floor(2^64 /
        p_i), (P / p_i) mod 2^32) per prime, P mod 2^32)``."""
        return tuple(((1 << 64) // p, (product // p) % (1 << 32)) for p in self.primes) + (
            product % (1 << 32),)

    def fold_inverse_scale(self, product: int) -> None:
        """Folds ``(P / p_i)^-1 mod p_i`` into ``w2m`` (once), so that the
        inverse transform yields the CRT terms ``y_i`` directly; tables not
        built yet take it when :attr:`per_prime` builds them."""
        if self._product is not None:
            return
        self._product = product
        if self._per_prime is not None:
            self._per_prime = None
            self._kernel_on.clear()

    def kernel_tables(self, device) -> dict:
        """The kernels' tables on ``device``, stacked over primes:
        ``w1_1``/``w1_2`` (forward pass 1 for 1- or 2-byte digits), ``w2``,
        ``wi1``, ``wi2`` (int8; ``w2`` and ``wi1`` for the plain models),
        ``w2g`` and ``wi1g`` (``w2`` and ``wi1`` in :func:`wgmma_layout`'s
        stream order, kernels A and B) and ``tw`` ``(kp, 4, n)`` = tw, its
        precon, twi, its precon (int32 storage).  Kernel C reads none of
        them: it runs on ``self.ntt``'s root tables."""
        device = torch.device(device)
        if device not in self._kernel_on:
            A, B = self.A, self.B

            def stack(fn, dtype=torch.int8):
                arr = np.stack([fn(pp) for pp in self.per_prime])
                return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype).to(device)

            def w2(pp):
                return kernel_layout(pp["w2f"].T, B, 4, 4)

            def wi1(pp):
                return kernel_layout(pp["w1mf"].T, B, 4, 4)

            self._kernel_on[device] = dict(
                w1_1=stack(lambda pp: kernel_layout(pp["w1d"], A, 2, 1)),
                w1_2=stack(lambda pp: kernel_layout(pp["w1d"], A, 2, 2)),
                w2=stack(w2),
                wi1=stack(wi1),
                w2g=stack(lambda pp: wgmma_layout(w2(pp))),
                wi1g=stack(lambda pp: wgmma_layout(wi1(pp))),
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


def _check_aligned(name: str, *ts) -> None:
    """Kernels A and B bulk-copy key rows: their base must be 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: key rows must start on a 16-byte boundary")


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

    Kernel A's limits on the card: ``log_n`` 8-12 and primes below 2^30
    (:class:`CmuxMxuPlan` raises ``ValueError`` below 8 or on a larger
    prime), at most 4 primes, gadget bases up to 2^15 (:func:`digit_planes`
    raises ``ValueError``), key rows starting on a 16-byte boundary
    (``ValueError``), and a block's shared memory within 227 KB (e.g. not
    ``log_n`` 12 with ``k1 * L = 6``): the C entry refuses a shape past
    these before any launch (a ``RuntimeError`` from :func:`build.check`),
    so no word is wrong.  The blind rotation does not reach that refusal:
    :func:`mxu_step_route` sends such shapes to the NTT key's route.
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
    _check_aligned("mxu_cmux_step", kv, kpre)
    err = build.library().pft_cmux_mxu(
        a.data_ptr(), d.data_ptr(), kv.data_ptr(), kpre.data_ptr(), out.data_ptr(),
        tabs[f"w1_{dp}"].data_ptr(), tabs["w2g"].data_ptr(), tabs["wi1g"].data_ptr(),
        tabs["wi2"].data_ptr(), tabs["tw"].data_ptr(), build.ptr(plan.ntt.prime_pack),
        build.ptr(conv.crt_pack), build.ptr(pack), kp, bsz, k1, plan.log_n, dp,
        launch_clusters(False, kp, k1, plan.log_n, dp, level, bsz),
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


def mxu_key_values(conv, ggsw_coeff: torch.Tensor) -> torch.Tensor:
    """Coefficient-domain stacked GGSW ``(n_lwe, k1, L, k1, n)`` torus words
    -> the MXU key pack's values, ``(n_lwe, kp, k1, L, k1, A, 128)`` int64
    (a view, prime-major underneath): the centered lift, then kernel C (one
    launch for every prime: the canonical forward NTT on kernel 1's radix-8
    passes; kernel 1 itself at ``log_n`` 13-17,
    :func:`.ntt_mxu8.mxu8_forward32`)."""
    from .ntt_mxu8 import mxu8_forward32

    return mxu8_forward32(plan_for(conv), conv.lift(ggsw_coeff)).movedim(0, 1)


def prepare_mxu_bsk(conv, ggsw_coeff: torch.Tensor):
    """Coefficient-domain stacked GGSW ``(n_lwe, k1, L, k1, n)`` torus words
    -> MXU key pack ``(vals, precons)``, each ``(n_lwe, kp, k1, L, k1, A,
    128)`` int64 and contiguous: :func:`mxu_key_values`, then the exact
    Shoup quotients."""
    vals = mxu_key_values(conv, ggsw_coeff).contiguous()
    return vals, shoup_precons(vals, conv.primes, 1).contiguous()
