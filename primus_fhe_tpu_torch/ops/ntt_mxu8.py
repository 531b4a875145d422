"""The byte-radix four-step NTT kernels on the int8 tensor cores, and the
transforms of the same functions on butterflies.

- Kernel C, ``mxu8_forward32``: the u32 tier (``q < 2^30``) of
  ``mxu8_fused_forward64`` (``primus_fhe_tpu/ops/ntt_mxu8.py:917``), which
  ``prepare_mxu_bsk`` and ``prepare_mxu_evk`` run.  Its function is kernel
  1's canonical forward NTT (:mod:`.ntt32`), and so is its design: a
  persistent kernel in ``csrc/ntt32.cu`` on kernel 1's radix-8 register
  passes, each block taking a range of (prime, tile of rows) items, one
  thread bulk-copying the next tile's rows into a ring of three shared
  slots while the block transforms the current one, the output drained
  from its slot by a bulk store (:func:`launch_grid` gives the tile and
  grid the launch picks).  No byte plane.
- ``mxu8_forward64`` and ``mxu8_inverse64``: the 7- and 8-plane tiers
  (``q < 2^53`` and ``q < 2^62``) of ``mxu8_fused_forward64`` and
  ``mxu8_fused_inverse64`` (``ntt_mxu8.py:917,959``), which the DCRT
  transforms run for ``log_n >= 8``; with their plan
  :class:`Mxu8NttPlan64` (port of ``ntt_mxu8.py:156-300``) and the
  per-modulus stack :class:`Mxu8Tables64`.

- Kernel D, ``mxu8_inverse64_mul``, and kernel E, ``mxu8_roundtrip64_mul``:
  ``mxu8_fused_inverse64_mul`` and ``mxu8_fused_roundtrip64_mul``
  (``ntt_mxu8.py:968,977``), the inverse with a pointwise multiply by a
  fixed NTT-domain operand fused in front, and the whole negacyclic product
  by that operand (forward, multiply, inverse) in one launch; the operand
  comes as a :meth:`Mxu8Tables64.mul_table`.

All but the round trip reach ``pallas_call`` through
``ops/mxu_common._natural_call`` in the reference.  CUDA source:
``csrc/ntt_mxu8.cu`` (kernel C: ``csrc/ntt32.cu``; kernel E:
``csrc/ntt64.cu``); design, bounds and shared-memory budgets are stated
there.  ``mxu8_forward64`` runs on ``wgmma`` in clusters of blocks that each
take a tile of rows and a slice of pass 2's output columns (the launch picks
both from the rows and the card), streaming the plane matrices in
:func:`forward_stream_tables`' order (``kernel_tables()["w1s"]``,
``["w2s"]``).  ``mxu8_inverse64`` and kernel D mirror it: a block takes a
tile of R rows (``R * A <= 128``) and a slice of S of the large pass 1's 128
output columns, streams the slice's ``wi1`` once through a ring of bulk
copies, so that each ``wi1`` byte reaching an SM serves ``R * A`` operand
rows (the one-row-a-block kernel served ``A``), then ``wi2`` into the tile's
freed input buffer (:func:`inverse_stream_tables`, ``["wi1s"]``,
``["wi2s"]``); no block needs another's output, so there is no cluster.
Both are bounded by the function they compute (16 bytes a word through
device memory; D adds its key), far below what either kernel reaches: the
method's int8 products and plane-matrix streams set their pace.  Kernel E
computes the same function as ``mxu8_forward64`` then D, but on row 10's
butterfly passes (:mod:`.ntt64`, whose root tables it reads), not on byte
planes: a tile of rows a block runs the forward's radix-8 passes, the key
multiply and the inverse's passes in shared memory, so the forward's words
never reach device memory; on this card the butterflies take less than half
the byte-radix kernels' time at ``bench.py``'s shape.

The four-step's natural output order is the butterfly NTT's bit-reversed
order, so each plain version is the canonical butterfly transform
(:mod:`.ntt32` or :mod:`.ntt64`); kernel C's is viewed as ``(..., A, 128)``.

Lazy words, one rule for every byte-radix entry point (rows 9, 12 and 13):
at ``out_factor`` 1 an output is canonical and word-equal to the
reference's; above 1 it is congruent mod q and below ``out_factor * q``
(the reference may leave words up to that bound, these kernels give
canonical ones); an intermediate (row 13's pass-1 halves,
:mod:`.ntt_mxu8_split`) is congruent mod q and below the bound its
docstring states.

The u64 plan keeps the JAX plan's plane matrices with 8 operand planes
instead of P: the kernels feed a u64 word's own 8 unsigned bytes (mma u8 x
s8), so any u64 input is taken whole.  The JAX plan's bias, correction and
Solinas tables exist for its XOR-0x80 signed feed and its u32-pair folds;
none of them is ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..modular.factor import ShoupFactor64, factor_mul64, factor_mul_lazy64
from ..numeric.limb import narrow_u32, u64_numpy, u64_tensor, widen_u32
from ..transforms.plan import _quot64, build_plan64
from ..utils.bits import reverse_lsbs
from ..utils.contracts import check_range_u64
from . import build
from .cmux_mxu import LANES, _balanced_digits, kernel_layout
from .mxu_common import four_step_matrices
from .ntt32 import forward32_plain
from .ntt64 import NttTables64, ntt64_forward_plain, ntt64_inverse_plain
from .ntt64 import pick_tile as ntt64_pick_tile

C_LOG_N = (8, 12)  # kernel C's rows on the card (C_MIN_LOG_N, C_MAX_LOG_N in csrc/ntt32.cu)


def mxu8_forward32_plain(plan, values: torch.Tensor) -> torch.Tensor:
    """Plain version: per-prime canonical butterfly forward NTT."""
    out = forward32_plain(plan.ntt, values, out_factor=1)
    return out.reshape(*out.shape[:-1], plan.A, plan.B)


def mxu8_forward32(plan, values: torch.Tensor) -> torch.Tensor:
    """Forward NTT of canonical residues ``values (kp, ..., n)`` (prime ``i``
    of ``plan.primes`` on ``values[i]``) -> canonical NTT values in
    bit-reversed order, ``(kp, ..., A, 128)``.

    CPU tensors take the plain version, CUDA tensors kernel C (one launch
    for every prime), which takes ``log_n`` 8-12 (a ``ValueError``
    outside, before any launch); the output keeps the input's storage.
    """
    if values.device.type == "cpu":
        out = mxu8_forward32_plain(plan, widen_u32(values))
        return narrow_u32(out) if values.dtype == torch.int32 else out
    if values.device.type != "cuda":
        raise ValueError(f"mxu8_forward32: unsupported device {values.device}")
    kp, n = len(plan.primes), plan.n
    if values.shape[0] != kp or values.shape[-1] != n:
        raise ValueError(f"expected (kp={kp}, ..., n={n}), got {tuple(values.shape)}")
    if not C_LOG_N[0] <= plan.log_n <= C_LOG_N[1]:
        raise ValueError(f"mxu8_forward32: the kernel takes log_n {C_LOG_N[0]}-{C_LOG_N[1]} on "
                         f"the card, got {plan.log_n}")
    v = narrow_u32(values).contiguous()
    if v.data_ptr() % 16:  # the tiles move by bulk copies of 16-byte units
        v = v.clone()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        roots, roots_p = plan.ntt.kernel_tables(v.device)[:2]
        err = build.library().pft_mxu8_forward32(
            v.data_ptr(), out.data_ptr(), roots.data_ptr(), roots_p.data_ptr(),
            build.ptr(plan.ntt.prime_pack), kp, rows, plan.log_n,
            torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, "mxu8_forward32")
        mxu8_forward32.launches += 1
    out = out.reshape(*out.shape[:-1], plan.A, plan.B)
    return out if values.dtype == torch.int32 else widen_u32(out)


mxu8_forward32.launches = 0


def launch_grid(plan, rows: int) -> tuple[int, int]:
    """``(T, blocks)`` of kernel C's launch on ``rows`` rows a prime on the
    current CUDA device: the rows a tile and the persistent grid (the C
    entry's own pick)."""
    import ctypes

    tile, grid = ctypes.c_int(), ctypes.c_int()
    err = build.library().pft_mxu8_forward32_grid(len(plan.primes), rows, plan.log_n,
                                                  ctypes.addressof(tile), ctypes.addressof(grid))
    build.check(err, "pft_mxu8_forward32_grid")
    return tile.value, grid.value


# ---------------------------------------------------------------------------
# The u64 tiers
# ---------------------------------------------------------------------------


def _planes_for(q: int) -> int:
    """4 byte planes for ``q < 2^30``, 7 for ``q < 2^53``, 8 for ``q < 2^62``."""
    if q < 1 << 30:
        return 4
    if q < 1 << 53:
        return 7
    if q < 1 << 62:
        return 8
    raise ValueError("byte-radix MXU plan requires q < 2^62")


def byte_matrix(m, q: int, planes: int, value_planes: int) -> np.ndarray:
    """``W[(c, r), (l, k)] = bal_c(M[r, k] * 2^(8l) mod q)``: ``planes``
    balanced base-256 output digits, ``value_planes`` operand planes."""
    R, K = m.shape
    w = np.zeros((planes * R, value_planes * K), dtype=np.int8)
    for l in range(value_planes):
        digs = _balanced_digits((m * pow(2, 8 * l, q)) % q, planes)
        for c in range(planes):
            w[c * R : (c + 1) * R, l * K : (l + 1) * K] = digs[c]
    return w


def _precon64(m) -> np.ndarray:
    """Object-int matrix -> u64 numpy of its values."""
    return np.asarray([int(v) for v in np.ravel(m)], dtype=np.uint64).reshape(np.shape(m))


def cyclic_tables(om_b: int, q: int) -> tuple[np.ndarray, np.ndarray]:
    """The root tables of the 128-point cyclic transform on ``om_b`` (a
    primitive 128th root mod ``q``) in the radix passes' layout
    (``csrc/ntt_passes.cuh``), each ``(2, 128)`` u64: the roots, then their
    Shoup quotients; word 0 unused (0).

    - forward (Cooley-Tukey stages 0-6, natural in, bit-reversed out: pass
      2's ``m2[r1, k0] = om_b^(brv7(r1) k0)``): stage ``s``'s block ``k`` at
      ``[2^s + k]`` = ``om_b^brv6(k)``;
    - inverse (Gentleman-Sande stages 0-6, bit-reversed in, natural out, no
      ``1/128``: inverse pass 1's ``m2i``): stage ``s``'s block ``j`` at
      ``[129 - (128 >> s) + j]`` = ``om_b^-brv6(j)``.
    """
    om_i = pow(om_b, -1, q)
    fwd, inv = [0] * LANES, [0] * LANES
    for s in range(7):
        for k in range(1 << s):
            fwd[(1 << s) + k] = pow(om_b, reverse_lsbs(k, 6), q)
        for j in range(64 >> s):
            inv[LANES + 1 - (LANES >> s) + j] = pow(om_i, reverse_lsbs(j, 6), q)
    return tuple(np.array([t, [_quot64(v, q) for v in t]], dtype=np.uint64) for t in (fwd, inv))


def col_tables(log_n: int, q: int, psi_a: int) -> tuple[np.ndarray, np.ndarray]:
    """The root tables of row 13's column transforms, pass 1's ``m1`` and
    inverse pass 2's ``m1i``, each ``(2, A)`` u64: the roots, then their
    Shoup quotients.  ``m1[r0, k1] = psi_A^k1 om_a^(brv(r0) k1)``, with
    ``psi_A = psi^128 = m1[0, 1]`` a primitive ``2A``-th root (``psi`` the
    plan's ``2n``-th), is the A-point negacyclic NTT with bit-reversed
    output, so the tables are row 10's (:func:`..transforms.plan.build_plan64`
    at ``log_A`` on root ``psi_A``, ``csrc/ntt_passes.cuh``'s layout):

    - forward (Cooley-Tukey, natural in, bit-reversed out): the plan's
      ``roots``, stage ``s``'s block ``k`` at ``[2^s + k]``;
    - inverse (Gentleman-Sande, bit-reversed in, natural out): the plan's
      ``inv_roots``, stage ``s``'s block ``j`` at ``[1 + A - (A >> s) +
      j]``; ``m1i`` folds ``1/n``, not the plan's ``1/A``, into the last
      stage, whose two factors are ``1/n`` (``Mod64.inv_n`` of the
      ``n``-point plan) and ``1/n`` times the plan's ``inv_roots[A - 1]``,
      held in word 0, which no stage reads.
    """
    log_a = log_n - 7
    a = 1 << log_a
    plan = build_plan64(log_a, q, root=psi_a)
    fwd = [int(v) for v in u64_numpy(plan.roots)]
    inv = [int(v) for v in u64_numpy(plan.inv_roots)]
    inv[0] = pow(1 << log_n, -1, q) * inv[a - 1] % q
    return tuple(np.array([t, [_quot64(v, q) for v in t]], dtype=np.uint64) for t in (fwd, inv))


class Mxu8NttPlan64:
    """Byte-radix four-step plan of one modulus ``q < 2^62`` at ``8 <= log_n
    <= 14``: ``A = n / 128`` rows by ``B = 128`` lanes (the JAX plan's
    default split in that range), ``planes`` output digit planes (the
    natural tier, or an override at least that), on the minimal root or an
    explicit ``root`` (the four-step sub-plans of ``transforms.ntt_large``).

    ``w1``/``w2`` (forward) and ``wi1``/``wi2`` (inverse, ``inv_n`` folded
    into ``wi2``) have rows ``(c, out)`` and columns ``(l, in)`` over all 8
    operand planes; :meth:`jax_tables` cuts them to the JAX plan's
    ``w1f, w2f, w1mf, w2mf`` (P operand planes).  ``tw``/``twi`` are the
    twiddles ``(A, B)`` with their Shoup quotients, and ``mats`` the four
    pass matrices ``m1 (r0, k1)``, ``m2 (r1, k0)``, ``m2i (k0, r1)``, ``m1i
    (k1, r0)`` (rows out, columns in) as u64 words.  ``cyclic`` and
    ``cyclic_inv`` are pass 2's and inverse pass 1's 128-point cyclic
    transforms as butterfly root tables (:func:`cyclic_tables`, on ``m2``'s
    root ``om_b = m2[brv7(1), 1]``): row 13's K2 and Ki1 run them; ``col``
    and ``col_inv`` pass 1's and inverse pass 2's A-point negacyclic
    transforms (:func:`col_tables`, on ``m1``'s ``psi_A = m1[0, 1]``): K1
    and Ki2 run them.  The byte-plane matrices are built at first use (row
    9's kernels and the JAX tables read them; row 13 does not).
    """

    def __init__(self, log_n: int, q: int, planes: int | None = None, root: int | None = None):
        natural = _planes_for(q)
        if planes is None:
            planes = natural
        elif planes not in (4, 7, 8) or planes < natural:
            raise ValueError(f"planes must be in {{4,7,8}} and >= the natural tier {natural}")
        if not 8 <= log_n <= 14:
            raise ValueError("Mxu8NttPlan64 needs 8 <= log_n <= 14 (B = 128 lanes)")
        self.planes = planes
        self.log_n, self.n, self.q = log_n, 1 << log_n, int(q)
        h1 = log_n - 7
        self.A, self.B = 1 << h1, LANES
        self._fs = fs = four_step_matrices(log_n, q, h1, h1, root)
        self.tw, self.twi = _precon64(fs["tw"]), _precon64(fs["twi"])
        # the four pass matrices (rows out, columns in) for the plain halves
        self.mats = {name: _precon64(fs[name]) for name in ("m1", "m2", "m2i", "m1i")}
        quot = np.vectorize(lambda v: _quot64(int(v), self.q), otypes=[object])
        self.tw_p = _precon64(quot(fs["tw"]))
        self.twi_p = _precon64(quot(fs["twi"]))
        self.cyclic, self.cyclic_inv = cyclic_tables(int(fs["m2"][LANES // 2, 1]), self.q)
        self.col, self.col_inv = col_tables(log_n, self.q, int(fs["m1"][0, 1]))

    def _planes(self, name):
        return byte_matrix(self._fs[name], self.q, self.planes, 8)

    # the byte-plane matrices: rows (c, out), columns (l, in)
    w1 = functools.cached_property(lambda self: self._planes("m1"))  # (c, r0), (l, k1)
    w2 = functools.cached_property(lambda self: self._planes("m2"))  # (c, r1), (l, k0)
    wi1 = functools.cached_property(lambda self: self._planes("m2i"))  # (c, k0), (l, r1)
    wi2 = functools.cached_property(lambda self: self._planes("m1i"))  # (c, k1), (l, r0)

    def jax_tables(self) -> dict:
        """The JAX plan's ``w1f, w2f, w1mf, w2mf`` (``P`` operand planes)."""
        P, A, B = self.planes, self.A, self.B
        return dict(w1f=self.w1[:, : P * A], w2f=self.w2[:, : P * B].T,
                    w1mf=self.wi1[:, : P * B].T, w2mf=self.wi2[:, : P * A])


class Mxu8Tables64:
    """The u64 four-step plans of every modulus of a butterfly table stack
    (on its roots) at one plane count (the largest natural tier, at least 7:
    the kernels are built for 7 and 8 planes), and their kernel-side copies.
    The plans are built at first use: the plain versions and kernel E need
    only ``ntt``, at any ``log_n``."""

    def __init__(self, ntt: NttTables64):
        self.ntt = ntt
        self.log_n, self.n, self.moduli = ntt.log_n, ntt.n, ntt.moduli
        self.planes = max([7] + [_planes_for(q) for q in self.moduli])
        self.A, self.B = max(self.n // LANES, 1), LANES
        self._plans = None
        self._kernel_on: dict = {}
        self._split_on: dict = {}
        self._mats_on: dict = {}

    @property
    def plans(self) -> list:
        if self._plans is None:
            self._plans = [Mxu8NttPlan64(self.log_n, q, self.planes, r)
                           for q, r in zip(self.moduli, self.ntt.roots)]
        return self._plans

    def mul_table(self, key) -> torch.Tensor:
        """The fixed operand of kernels D and E (the counterpart of
        ``Mxu8NttPlan64.inverse_mul_tabs``): ``key (count, n)`` canonical
        NTT-domain values in the forward output's bit-reversed order ->
        ``(count, 2, n)`` int64 on ``key``'s device, the values and their
        Shoup quotients ``floor(key * 2^64 / q)`` (u64 patterns)."""
        key = torch.as_tensor(key)
        count, n = len(self.moduli), self.n
        if key.shape != (count, n):
            raise ValueError(f"key must be (count={count}, n={n}), got {tuple(key.shape)}")
        vals = u64_numpy(key.to(torch.int64))
        quot = np.empty_like(vals)
        for i, q in enumerate(self.moduli):
            if (vals[i] >= np.uint64(q)).any():
                raise ValueError("key values must be canonical (below q)")
            quot[i] = [_quot64(int(v), q) for v in vals[i]]
        return u64_tensor(np.stack([vals, quot], axis=1), key.device)

    def pass_matrices(self, device) -> dict:
        """The four pass matrices and both twiddle tables as Shoup factors
        stacked over the moduli, on ``device``: ``m1, m2, m2i, m1i`` (count,
        rows out, columns in) and ``tw, twi`` (count, A, B)."""
        device = torch.device(device)
        if device not in self._mats_on:
            def factor(arrays):
                quot = [np.vectorize(lambda v, q=q: _quot64(int(v), q), otypes=[object])(a)
                        for a, q in zip(arrays, self.moduli)]
                return ShoupFactor64(u64_tensor(np.stack(arrays), device),
                                     u64_tensor(np.stack(quot).astype(np.uint64), device))

            mats = {name: factor([p.mats[name] for p in self.plans])
                    for name in ("m1", "m2", "m2i", "m1i")}
            for name in ("tw", "twi"):
                mats[name] = ShoupFactor64(
                    u64_tensor(np.stack([getattr(p, name) for p in self.plans]), device),
                    u64_tensor(np.stack([getattr(p, name + "_p") for p in self.plans]), device))
            self._mats_on[device] = mats
        return self._mats_on[device]

    def split_tables(self, device) -> dict:
        """The tables row 13's kernels read (``csrc/ntt_mxu8_split.cu``), no
        byte plane among them (u64 patterns in int64): ``tw (count, 4, n)``
        = tw, its quotient, twi, its quotient; ``cyclic``, ``cyclic_inv``
        ``(count, 2, 128)`` (:func:`cyclic_tables`, K2 and Ki1); ``col``,
        ``col_inv`` ``(count, 2, A)`` (:func:`col_tables`, K1 and Ki2)."""
        device = torch.device(device)
        if device not in self._split_on:
            tw = np.stack([np.stack([p.tw.reshape(-1), p.tw_p.reshape(-1), p.twi.reshape(-1),
                                     p.twi_p.reshape(-1)]) for p in self.plans])
            tabs = {"tw": u64_tensor(tw, device)}
            for name in ("cyclic", "cyclic_inv", "col", "col_inv"):
                tabs[name] = u64_tensor(np.stack([getattr(p, name) for p in self.plans]), device)
            self._split_on[device] = tabs
        return self._split_on[device]

    def kernel_tables(self, device) -> dict:
        """``w1, w2, wi1, wi2`` (int8, kernel layout: columns ``(k, l)``,
        stacked over moduli), ``w1s, w2s`` (``w1``/``w2`` in the forward
        kernel's stream order, :func:`forward_stream_tables`), ``wi1s,
        wi2s`` (``wi1``/``wi2`` in the inverse kernel's,
        :func:`inverse_stream_tables`), and the :meth:`split_tables` (the
        twiddles ``tw`` among them)."""
        device = torch.device(device)
        if device not in self._kernel_on:
            P, A, B = self.planes, self.A, self.B
            lay = {name: np.stack([kernel_layout(getattr(p, name), rows, 8, 8, out_planes=P)
                                   for p in self.plans])
                   for name, rows in (("w1", A), ("w2", B), ("wi1", B), ("wi2", A))}
            streams = [forward_stream_tables(a, b, P) for a, b in zip(lay["w1"], lay["w2"])]
            lay["w1s"] = np.stack([s[0] for s in streams])
            lay["w2s"] = np.stack([s[1] for s in streams])
            streams = [inverse_stream_tables(a, b, P) for a, b in zip(lay["wi1"], lay["wi2"])]
            lay["wi1s"] = np.stack([s[0] for s in streams])
            lay["wi2s"] = np.stack([s[1] for s in streams])
            tabs = {name: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
                    for name, arr in lay.items()}
            tabs.update(self.split_tables(device))
            self._kernel_on[device] = tabs
        return self._kernel_on[device]


# ---------------------------------------------------------------------------
# The forward kernel's stream tables (csrc/ntt_mxu8.cu, mxu8_forward64)
# ---------------------------------------------------------------------------

FWD_GROUPS = 8  # column groups of 16 pass-2 outputs r1 (so at most 8 slices)
FWD_KCHUNKS = 8  # k-chunks of 128 bytes a column group: one ring stage each


def _wgmma_stages(w: np.ndarray, planes: int, groups: int, kb: int) -> np.ndarray:
    """A kernel-layout plane matrix ``(P rows_p, K)`` (rows ``(c, r)``) ->
    the forward kernel's wgmma N-side stages: ``[group of 16 r][k-chunk of
    kb bytes][k-step s][n-group (2 P)][k half][8 rows][16 bytes]``, n-group
    ``c + P * half`` holding plane ``c`` of rows ``r = 16 group + 8 half +
    rho`` (rows past ``rows_p`` zero)."""
    P, K = planes, w.shape[1]
    x = np.zeros((P, 16 * groups, K), dtype=np.int8)
    x[:, : w.shape[0] // P] = w.reshape(P, -1, K)
    x = x.reshape(P, groups, 2, 8, K // kb, kb // 32, 2, 16)
    return x.transpose(1, 4, 5, 2, 0, 6, 3, 7)  # group, k-chunk, s, half, c, k half, rho, byte


def forward_stream_tables(w1: np.ndarray, w2: np.ndarray, planes: int):
    """One modulus's kernel-layout ``w1 (P np1, kb1)`` and ``w2 (P 128,
    1024)`` -> the forward kernel's stream order, one ring stage per bulk
    copy, each the N side of a ``wgmma`` pass (:func:`_wgmma_stages`):
    ``w1s`` = ``ceil(np1 / 16) x kb1 / min(kb1, 128)`` stages (warpgroup
    ``g`` of pass 1 takes r0 in ``[16 g, 16 g + 16)``), ``w2s`` = 64 stages
    (column group ``cg < 8`` of 16 outputs ``r1``, k-chunk ``kc < 8`` of 128
    bytes).  A slice of the output columns is a run of whole column groups,
    so its stages are contiguous."""
    kb1 = w1.shape[1]
    x1 = _wgmma_stages(w1, planes, -(-(w1.shape[0] // planes) // 16), min(kb1, 128))
    x2 = _wgmma_stages(w2, planes, FWD_GROUPS, 128)
    return np.ascontiguousarray(x1).reshape(-1), np.ascontiguousarray(x2).reshape(-1)


def inverse_stream_tables(wi1: np.ndarray, wi2: np.ndarray, planes: int):
    """One modulus's kernel-layout ``wi1 (P 128, 1024)`` and ``wi2 (P np1,
    kb1)`` -> the inverse kernel's stream order, the forward's mirrored:
    ``wi1s`` in ``w2s``' stages (column group ``cg < 8`` of 16 outputs
    ``k0``, k-chunk ``kc < 8`` of 128 bytes; a slice's stages contiguous),
    ``wi2s`` in ``w1s``' (group ``g`` of 16 outputs ``k1``, k-chunk of
    ``min(kb1, 128)`` bytes), each stage the N side of a ``wgmma`` pass."""
    wi2s, wi1s = forward_stream_tables(wi2, wi1, planes)
    return wi1s, wi2s


def reduce_any64(values: torch.Tensor, moduli) -> torch.Tensor:
    """Any u64 words ``(count, ...)`` -> canonical residues, modulus ``i`` on
    ``values[i]`` (a Shoup multiply by 1: valid for every u64 word)."""
    shape = (-1,) + (1,) * (values.dim() - 1)
    q = u64_tensor(list(moduli), values.device).reshape(shape)
    one = ShoupFactor64(1, u64_tensor([_quot64(1, m) for m in moduli], values.device).reshape(shape))
    return factor_mul64(values, one, q)


def mxu8_forward64_plain(tables: Mxu8Tables64, values: torch.Tensor) -> torch.Tensor:
    """Plain version: every input word reduced mod q, then the canonical
    butterfly forward NTT (:func:`.ntt64.ntt64_forward_plain`)."""
    return ntt64_forward_plain(tables.ntt, reduce_any64(values, tables.moduli), 1)


def mxu8_inverse64_plain(tables: Mxu8Tables64, values: torch.Tensor) -> torch.Tensor:
    """Plain version: every input word reduced mod q, then the canonical
    butterfly inverse NTT (:func:`.ntt64.ntt64_inverse_plain`)."""
    return ntt64_inverse_plain(tables.ntt, reduce_any64(values, tables.moduli), 1)


def _key_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """``values (count, ..., n)`` (any u64 words) times the key of
    ``mul_tab`` by a lazy Shoup multiply: ``[0, 2q)``."""
    lead = (len(tables.moduli),) + (1,) * (values.dim() - 2)
    q = u64_tensor(list(tables.moduli), values.device).reshape(lead + (1,))
    key = ShoupFactor64(mul_tab[:, 0].reshape(lead + (tables.n,)),
                        mul_tab[:, 1].reshape(lead + (tables.n,)))
    return factor_mul_lazy64(values, key, q)


def mxu8_inverse64_mul_plain(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """Plain version of kernel D: the key multiply, then the canonical
    butterfly inverse NTT."""
    return ntt64_inverse_plain(tables.ntt, _key_mul(tables, values, mul_tab), 1)


def mxu8_roundtrip64_mul_plain(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor):
    """Plain version of kernel E: the forward plain version, then kernel D's."""
    return mxu8_inverse64_mul_plain(tables, mxu8_forward64_plain(tables, values), mul_tab)


def _run64(wrapper, plain, entry: str, names, tables: Mxu8Tables64, values, out_factor, allowed,
           mul_tab=None):
    """One launch of ``entry`` on ``values`` (CPU tensors: ``plain``);
    ``names``: the byte-radix kernel tables it reads, or None for kernel E,
    which reads the butterfly tables ``tables.ntt``."""
    if out_factor not in allowed:
        raise ValueError(f"out_factor must be one of {allowed}")
    keyed = () if mul_tab is None else (mul_tab,)
    if values.device.type == "cpu":
        return plain(tables, values, *keyed)
    if values.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {values.device}")
    count, n = len(tables.moduli), tables.n
    if values.dtype != torch.int64 or values.shape[0] != count or values.shape[-1] != n:
        raise ValueError(f"expected int64 (count={count}, ..., n={n}), got "
                         f"{values.dtype} {tuple(values.shape)}")
    if mul_tab is not None and (mul_tab.device != values.device or mul_tab.dtype != torch.int64
                                or mul_tab.shape != (count, 2, n)
                                or not mul_tab.is_contiguous()):
        raise ValueError(f"{wrapper.__name__}: the key table must be a contiguous int64 "
                         f"(count={count}, 2, n={n}) tensor on {values.device}")
    if not 8 <= tables.log_n <= 12:
        raise ValueError(f"{wrapper.__name__}: the kernels take 8 <= log_n <= 12")
    v = values.contiguous()
    out = torch.empty_like(v)
    rows = v[0].numel() // n
    if rows:
        if names is None:
            tabs, planes = tables.ntt.kernel_tables(v.device), ()
        else:
            kt = tables.kernel_tables(v.device)
            tabs, planes = [kt[name] for name in names] + [kt["tw"]], (tables.planes,)
        err = getattr(build.library(), entry)(
            v.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
            *(t.data_ptr() for t in keyed), build.ptr(tables.ntt.mod_pack), count, rows,
            tables.log_n, *planes, torch.cuda.current_stream(v.device).cuda_stream,
        )
        build.check(err, entry)
        wrapper.launches += 1
    return out


def mxu8_forward64(tables: Mxu8Tables64, values: torch.Tensor, out_factor: int = 1):
    """Forward NTT of any u64 words ``values (count, ..., n)`` (modulus ``i``
    on ``values[i]``; int64 bit patterns) -> canonical NTT values in
    bit-reversed order (the four-step's natural order), ``(count, ..., n)``.
    ``out_factor`` (1, 2 or 4) bounds the output as in the reference; the
    output is canonical for every one (the lazy-word rule of the module
    docstring).

    CPU tensors take the plain version, CUDA tensors the kernel (one launch
    for every modulus).  Under ``PRIMUS_DEBUG=1`` it holds the input to the
    reference's contract, words below ``2^(8 planes)`` below 8 planes."""
    if tables.planes < 8:
        check_range_u64(values, 1 << (8 * tables.planes), 1, "mxu8_forward64 input")
    return _run64(mxu8_forward64, mxu8_forward64_plain, "pft_ntt_mxu8_forward64", ("w1s", "w2s"),
                  tables, values, out_factor, (1, 2, 4))


def mxu8_inverse64(tables: Mxu8Tables64, values: torch.Tensor, out_factor: int = 1):
    """Inverse NTT of any u64 words ``values (count, ..., n)`` in bit-reversed
    order -> canonical values in normal order (``out_factor`` 1 or 2; the
    output is canonical for both).

    CPU tensors take the plain version, CUDA tensors the tiled kernel (one
    launch for every modulus), which takes ``8 <= log_n <= 12`` and raises
    ``ValueError`` above, where the plan allows 14 (``route="auto"`` sends
    those to the butterfly)."""
    return _run64(mxu8_inverse64, mxu8_inverse64_plain, "pft_ntt_mxu8_inverse64",
                  ("wi1s", "wi2s"), tables, values, out_factor, (1, 2))


def mxu8_inverse64_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor,
                       out_factor: int = 1):
    """Kernel D: ``INTT(values * key)`` for any u64 words ``values (count,
    ..., n)`` in bit-reversed order and the key of ``mul_tab``
    (:meth:`Mxu8Tables64.mul_table`) -> canonical values in normal order.

    CPU tensors take the plain version, CUDA tensors :func:`mxu8_inverse64`'s
    tiled kernel with the key multiplied in as each word is loaded; on the
    card ``8 <= log_n <= 12`` only (``ValueError`` above)."""
    return _run64(mxu8_inverse64_mul, mxu8_inverse64_mul_plain, "pft_ntt_mxu8_inverse64_mul",
                  ("wi1s", "wi2s"), tables, values, out_factor, (1, 2), mul_tab)


def mxu8_roundtrip64_mul(tables: Mxu8Tables64, values: torch.Tensor, mul_tab: torch.Tensor,
                         out_factor: int = 1):
    """Kernel E: ``INTT(NTT(values) * key)``, the negacyclic product of any
    u64 words ``values (count, ..., n)`` (normal order) by the fixed operand
    of ``mul_tab`` -> canonical values in normal order (``out_factor`` 1 or
    2; canonical for both), in one launch.

    CPU tensors take the plain version, CUDA tensors the kernel of
    ``csrc/ntt64.cu`` (row 10's radix-8 passes for both transforms, the key
    between them, one launch for every modulus; the launch picks its tile of
    rows, :func:`roundtrip_tile`); on the card ``8 <= log_n <= 12`` only
    (``ValueError`` outside)."""
    return _run64(mxu8_roundtrip64_mul, mxu8_roundtrip64_mul_plain, "pft_ntt64_roundtrip_mul",
                  None, tables, values, out_factor, (1, 2), mul_tab)


def roundtrip_tile(tables: Mxu8Tables64, rows: int) -> int:
    """Rows of one modulus a block of kernel E's launch on ``rows`` rows a
    modulus, on the current CUDA device (the C entry's own pick)."""
    return ntt64_pick_tile(2, tables.ntt, rows)


mxu8_forward64.launches = 0
mxu8_inverse64.launches = 0
mxu8_inverse64_mul.launches = 0
mxu8_roundtrip64_mul.launches = 0
