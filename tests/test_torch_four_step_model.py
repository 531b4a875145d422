"""A numpy model of the four-step through device memory (``csrc/ntt_columns.cuh``
and ``.cu``, the sub-row launches of ``csrc/ntt32.cu`` and ``csrc/ntt64.cu``,
kernel H's column launch in ``csrc/cmux_stage2.cu``, kernel J's last launch
in ``csrc/ntru_stage.cu``), held word for word against the plain versions
and against the JAX ``transforms/ntt.py``.

The model runs the launches' data flow as written, at toy rings with the
sub-row forced small (log_n 10-12, sub-rows of 2^4-2^8 words, so c = 2-8
column stages): the column launch's tiles (``col_log_tile`` columns of one
row, each word of the row loaded and stored by exactly one block), the
column passes on a column as a row of C words (the forward on the row's
own root table, ``FwdTable`` index ``2^(s0+e) + hi 2^e + j``; the inverse on
``InvTable`` with ``lo = C - n``, the last pass folding ``inv_n`` in); the
sub-row launch's blocks (sub-row h of row ``blk >> c``), the forward's
passes on ``FwdSliceTable`` with ``m = C + h`` and the inverse's on
``SliceInvTable`` at rank h (the row's index recovered from the slice's by
``ceil(log2(2^l + 1 - ti))``), none the row's last.  Kernel D multiplies
each word by the key as the sub-row loads it; kernel E runs the forward's
columns (each word brought below 2q first), the sub-row's forward passes,
the fused pass (the forward's last, the key, the inverse's first) and the
inverse's sub-row passes, then the inverse's columns.  Kernel H: mac_sub
(the MAC of each sub-row, the inverse's sub-row stages), then its column
launch (each prime's last stages, times (P/p_i)^-1, the integer CRT, the
add to acc).  Kernel J: mac_sub, the inverse's columns, then the rotation
across sub-rows and the digits.  Every butterfly's outputs are checked in
their lazy range.  One case at log_n 18 (the kernels' sub-rows of 2^14
words) against the JAX forward32 and inverse32.  Tolerance: zero.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.transforms import ntt as jntt
from primus_fhe_tpu.transforms.plan import build_plan32 as jax_plan32
from primus_fhe_tpu.transforms.plan import build_plan64 as jax_plan64
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import cmux_fused, ntru_cmux_mxu, ntt32, ntt64, ntt_columns, ntt_mxu8
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

Q32 = next_ntt_prime(30, 12)
Q64 = next_ntt_prime(62, 12)  # lazy words past 2^63


COL_TILE_LOG_WORDS = 12  # in csrc/ntt_columns.cuh


def col_log_tile(c: int, l: int) -> int:
    """``col_log_tile`` in ``csrc/ntt_columns.cuh``: 2^12 words a tile."""
    return max(0, min(l, COL_TILE_LOG_WORDS - c))


def remainder_stages(log_n: int) -> int:
    return log_n - 3 * ((log_n - 1) // 3)


M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)


def mulhi64(a, b):
    """The high word of the u64 product ``a b``, exactly, from 32-bit halves."""
    a0, a1, b0, b1 = a & M32, a >> S32, b & M32, b >> S32
    p01, p10 = a0 * b1, a1 * b0
    mid = ((a0 * b0) >> S32) + (p01 & M32) + (p10 & M32)
    return a1 * b1 + (p01 >> S32) + (p10 >> S32) + (mid >> S32)


class Arith:
    """Word arithmetic of one modulus at 32 or 64 bits on numpy uint64
    arrays (u32 products below 2^62; u64 products wrap, their high words
    by :func:`mulhi64`)."""

    def __init__(self, q: int, bits: int):
        self.q, self.bits = q, bits

    def arr(self, x):
        x = np.asarray(x)
        if x.dtype == object:
            return np.array([int(v) & ((1 << 64) - 1) for v in x.reshape(-1)],
                            dtype=np.uint64).reshape(x.shape)
        return x.astype(np.uint64)

    def shoup(self, y, w, wp):
        y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
        if self.bits == 32:
            return (w * y - np.uint64(self.q) * ((y * wp) >> S32)) & M32
        return w * y - np.uint64(self.q) * mulhi64(y, wp)

    def below(self, x, bound):
        assert (np.asarray(x) < np.uint64(bound)).all(), bound

    def fwd_bf(self, x, y, w, wp):
        two_q = np.uint64(2 * self.q)
        tx = np.where(x >= two_q, x - two_q, x)
        ty = self.shoup(y, w, wp)
        x2, y2 = tx + ty, tx + two_q - ty
        self.below(x2, 4 * self.q)
        self.below(y2, 4 * self.q)
        return x2, y2

    def inv_bf(self, x, y, w, wp):
        two_q = np.uint64(2 * self.q)
        s = x + y
        x2 = np.where(s >= two_q, s - two_q, s)
        y2 = self.shoup(x + two_q - y, w, wp)
        self.below(x2, 2 * self.q)
        self.below(y2, 2 * self.q)
        return x2, y2

    def sub_if(self, x, m):
        m = np.uint64(m)
        return np.where(x >= m, x - m, x)


class Tables:
    """A plan's tables as words: roots, quotients, inverse roots, theirs."""

    def __init__(self, plan, ar: Arith):
        def words(t):
            return ar.arr(u64_numpy(t.to(torch.int64)) if ar.bits == 64 else t.numpy())
        self.w, self.wp = words(plan.roots), words(plan.roots_precon)
        self.iw, self.iwp = words(plan.inv_roots), words(plan.inv_roots_precon)
        self.inv_n, self.inv_n_p = plan.inv_n, plan.inv_n_precon
        self.inv_n_w, self.inv_n_w_p = plan.inv_n_w, plan.inv_n_w_precon


def fwd_pass(ar, tile, log_n, s0, R, tw_index, w, wp):
    """``fwd_pass`` on every row of ``tile (rows, 2^log_n)``: group g's
    slots ``hi 2^(t+R) + k 2^t + lo``; ``tw_index(s0, e, hi, j)`` the
    table index of block j at stage e of the pass."""
    log_t = log_n - s0 - R
    g = np.arange(1 << (log_n - R))
    hi = g >> log_t
    base = (hi << (log_t + R)) + (g & ((1 << log_t) - 1))
    slots = base[:, None] + (np.arange(1 << R) << log_t)[None, :]
    assert sorted(slots.reshape(-1)) == list(range(1 << log_n))
    v = [tile[:, slots[:, k]] for k in range(1 << R)]
    for e in range(R):
        h = 1 << (R - 1 - e)
        for k in range(1 << R):
            if not k & h:
                i = tw_index(s0, e, hi, k >> (R - e))
                v[k], v[k + h] = ar.fwd_bf(v[k], v[k + h], w[i], wp[i])
    for k in range(1 << R):
        tile[:, slots[:, k]] = v[k]


def inv_pass(ar, tile, log_n, s0, R, last, table, tabs, fold=None):
    """``inv_pass`` on every row of ``tile (rows, 2^log_n)``: group g's
    slots ``hi 2^(s0+R) + k 2^s0 + lo``; ``table(ti)`` the row's table
    index of the pass's twiddle ti; ``last``: the final stage folds inv_n
    in (``fold``: "canonical" or "lazy")."""
    n = 1 << log_n
    g = np.arange(1 << (log_n - R))
    hi = g >> s0
    base = (hi << (s0 + R)) + (g & ((1 << s0) - 1))
    slots = base[:, None] + (np.arange(1 << R) << s0)[None, :]
    assert sorted(slots.reshape(-1)) == list(range(n))
    v = [tile[:, slots[:, k]] for k in range(1 << R)]
    q, two_q = ar.q, np.uint64(2 * ar.q)
    for e in range(R):
        h = 1 << e
        start = 1 + n - (n >> (s0 + e))
        for k in range(1 << R):
            if k & h:
                continue
            if last and e == R - 1:
                x, y = v[k], v[k + h]
                s = x + y
                tx = np.where(s >= two_q, s - two_q, s)
                v[k] = ar.shoup(tx, tabs.inv_n, tabs.inv_n_p)
                v[k + h] = ar.shoup(x + two_q - y, tabs.inv_n_w, tabs.inv_n_w_p)
                if fold == "canonical":
                    v[k], v[k + h] = ar.sub_if(v[k], q), ar.sub_if(v[k + h], q)
                ar.below(v[k], 2 * q)
                ar.below(v[k + h], 2 * q)
            else:
                i = table(start + (hi << (R - 1 - e)) + (k >> (e + 1)))
                v[k], v[k + h] = ar.inv_bf(v[k], v[k + h], tabs.iw[i], tabs.iwp[i])
    for k in range(1 << R):
        tile[:, slots[:, k]] = v[k]


def slice_inv_index(ti, l, log_n, rank):
    """``SliceInvTable::index``: ``l - s = 32 - clz(2^l - ti)``."""
    ti = np.asarray(ti)
    ls = np.array([int(x).bit_length() for x in ((1 << l) - ti).reshape(-1)]).reshape(ti.shape)
    j = ti - 1 - (1 << l) + (1 << ls)
    return 1 + (1 << log_n) - (1 << (log_n - l + ls)) + (rank << (ls - 1)) + j


# ---------------------------------------------------------------------------
# The launches


def column_tiles(rows, log_n, l):
    """The column launch's blocks: ``(row, word addresses (C, T))``, each
    word of every row owned by exactly one block."""
    c = log_n - l
    log_tj = col_log_tile(c, l)
    owned = np.zeros((rows, 1 << log_n), dtype=np.int64)
    out = []
    for blk in range(rows << (l - log_tj)):
        row, j0 = blk >> (l - log_tj), (blk & ((1 << (l - log_tj)) - 1)) << log_tj
        i = np.arange(1 << (log_tj + c))
        k, jj = i >> log_tj, i & ((1 << log_tj) - 1)
        addr = np.zeros((1 << log_tj, 1 << c), dtype=np.int64)
        addr[jj, k] = (k << l) + j0 + jj
        owned[row, addr.reshape(-1)] += 1
        out.append((row, addr))
    assert (owned == 1).all()
    return out


def columns_forward(ar, tabs, x, log_n, l, load=lambda v: v):
    """The forward's column launch: its first c stages, in place."""
    c = log_n - l
    x = x.copy()
    for row, addr in column_tiles(x.shape[0], log_n, l):
        tile = load(x[row][addr])  # (T, C): column jj as a row of C words
        for s0 in range(0, c, 3):
            fwd_pass(ar, tile, c, s0, min(3, c - s0),
                     lambda s0_, e, hi, j: (1 << (s0_ + e)) + (hi << e) + j, tabs.w, tabs.wp)
        x[row][addr] = tile
    return x


def columns_inverse(ar, tabs, x, log_n, l, fold="canonical", scale=None):
    """The inverse's column launch: its last c stages (``InvTable`` at lo =
    C - n), the final folding inv_n in; ``scale(tile)`` as the last pass
    stores (kernel H's CRT constant)."""
    c = log_n - l
    x = x.copy()
    lo = (1 << c) - (1 << log_n)
    for row, addr in column_tiles(x.shape[0], log_n, l):
        tile = x[row][addr]
        s0 = 0
        while c - s0 > 3:
            inv_pass(ar, tile, c, s0, 3, False, lambda ti: ti - lo, tabs)
            s0 += 3
        inv_pass(ar, tile, c, s0, c - s0, True, lambda ti: ti - lo, tabs, fold)
        x[row][addr] = tile if scale is None else scale(tile)
    return x


def subrow_blocks(rows, log_n, l):
    """The sub-row launch's blocks: ``(row, h, the sub-row's addresses)``."""
    lc = log_n - l
    owned = np.zeros((rows, 1 << log_n), dtype=np.int64)
    out = []
    for blk in range(rows << lc):
        h, row = blk & ((1 << lc) - 1), blk >> lc
        addr = (h << l) + np.arange(1 << l)
        owned[row, addr] += 1
        out.append((row, h, addr))
    assert (owned == 1).all()
    return out


def sub_forward(ar, tabs, y, log_n, l, canonical, last=None):
    """The forward's sub-row launch on the columns' output: every pass on
    ``FwdSliceTable`` (m = C + h); ``last`` replaces the last pass (kernel
    E's fused pass), else canonical or lazy words out."""
    lc, r = log_n - l, remainder_stages(l)
    y = y.copy()
    for row, h, addr in subrow_blocks(y.shape[0], log_n, l):
        tile = y[row][addr][None, :]
        m = (1 << lc) + h

        def idx(s0, e, hi, j, m=m):
            return (m << (s0 + e)) + (hi << e) + j
        for s0 in range(0, l - r, 3):
            fwd_pass(ar, tile, l, s0, 3, idx, tabs.w, tabs.wp)
        if last is None:
            fwd_pass(ar, tile, l, l - r, r, idx, tabs.w, tabs.wp)
            if canonical:
                tile = ar.sub_if(ar.sub_if(tile, 2 * ar.q), ar.q)
        else:
            tile = last(tile, row, h, idx)
        y[row][addr] = tile[0]
    return y


def sub_inverse(ar, tabs, x, log_n, l, load=None, first=None):
    """The inverse's sub-row launch: ``slice_inverse`` on ``SliceInvTable``
    at rank h (the remainder pass first, none the row's last), lazy words
    out; ``load(row, h, words)`` the first pass's load (kernel D's key),
    ``first`` replaces the state before the remainder pass (kernel E)."""
    r = remainder_stages(l)
    x = x.copy()
    for row, h, addr in subrow_blocks(x.shape[0], log_n, l):
        tile = x[row][addr][None, :]
        if load is not None:
            tile = load(row, h, tile)

        def table(ti, h=h):
            return slice_inv_index(ti, l, log_n, h)
        inv_pass(ar, tile, l, 0, r, False, table, tabs)
        for s0 in range(r, l, 3):
            inv_pass(ar, tile, l, s0, 3, False, table, tabs)
        x[row][addr] = tile[0]
    return x


def four_step_forward(ar, tabs, x, log_n, l, canonical=True):
    return sub_forward(ar, tabs, columns_forward(ar, tabs, x, log_n, l), log_n, l, canonical)


def four_step_inverse(ar, tabs, x, log_n, l, fold="canonical"):
    return columns_inverse(ar, tabs, sub_inverse(ar, tabs, x, log_n, l), log_n, l, fold)


def as_numpy(t, bits):
    return u64_numpy(t) if bits == 64 else t.numpy().astype(np.uint64)


def same(got, want):
    np.testing.assert_array_equal(np.asarray([int(v) for v in np.asarray(got).reshape(-1)],
                                             dtype=np.uint64),
                                  np.asarray(want, dtype=np.uint64).reshape(-1))


# ---------------------------------------------------------------------------
# u32 and u64 transforms


CASES = [(10, 4), (10, 8), (12, 6), (12, 8)]  # (log_n, l): c = 6, 2, 6, 4


def _input(bits, q, shape, factor, seed):
    rng = np.random.default_rng(seed)
    if bits == 32:
        return rng.integers(0, factor * q, shape, dtype=np.int64)
    return np.array([int(v) for v in rng.integers(0, factor * q, shape, dtype=np.uint64)
                     .reshape(-1)], dtype=object).reshape(shape) % (factor * q)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("log_n,l", CASES)
def test_four_step_transforms_equal_plain_and_jax(bits, log_n, l):
    """Forward (out_factor 4 and 1) and inverse (2 and 1) over 2 rows: the
    model against the port's plain transforms, and the lazy forward and the
    canonical inverse against the JAX ones too."""
    q = Q32 if bits == 32 else Q64
    ar = Arith(q, bits)
    if bits == 32:
        tables = ntt32.NttTables32(log_n, [q])
        plan, jplan = tables.plans[0], jax_plan32(log_n, q)
    else:
        tables = ntt64.NttTables64(log_n, [q])
        plan, jplan = tables.plans[0], jax_plan64(log_n, q)
    tabs = Tables(plan, ar)
    x4, x2 = _input(bits, q, (2, 1 << log_n), 4, log_n + l), _input(bits, q, (2, 1 << log_n), 2, l)
    for canonical in (False, True):
        got = four_step_forward(ar, tabs, ar.arr(x4), log_n, l, canonical)
        xt = torch.from_numpy(x4.astype(np.int64)) if bits == 32 else u64_tensor(x4)
        of = 1 if canonical else 4
        plain = (ntt32.forward32_plain(tables, xt[None], of) if bits == 32
                 else ntt64.ntt64_forward_plain(tables, xt[None], of))[0]
        same(got, as_numpy(plain, bits))
        if canonical:
            continue
        jx = (jntt.forward32(jplan, jnp.asarray(x4.astype(np.uint32)), of) if bits == 32
              else jfrom(jntt.forward64(jplan, jto(np.asarray(x4, dtype=np.uint64)), of)))
        same(got, np.asarray(jx))
    for fold in ("lazy", "canonical"):
        got = four_step_inverse(ar, tabs, ar.arr(x2), log_n, l, fold)
        xt = torch.from_numpy(x2.astype(np.int64)) if bits == 32 else u64_tensor(x2)
        of = 1 if fold == "canonical" else 2
        plain = (ntt32.inverse32_plain(tables, xt[None], of) if bits == 32
                 else ntt64.ntt64_inverse_plain(tables, xt[None], of))[0]
        same(got, as_numpy(plain, bits))
        if fold == "lazy":
            continue
        jx = (jntt.inverse32(jplan, jnp.asarray(x2.astype(np.uint32)), of) if bits == 32
              else jfrom(jntt.inverse64(jplan, jto(np.asarray(x2, dtype=np.uint64)), of)))
        same(got, np.asarray(jx))


@pytest.mark.parametrize("bits", [32, 64])
def test_plain_stage_splits_compose(bits):
    """The column launches' plain versions and the remaining stages compose
    to the whole plain transforms (the yardsticks the card holds the column
    kernels to)."""
    log_n, l = 11, 5
    q = Q32 if bits == 32 else Q64
    tables = ntt32.NttTables32(log_n, [q]) if bits == 32 else ntt64.NttTables64(log_n, [q])
    plans = tables.plans
    x = torch.from_numpy(_input(bits, q, (1, 3, 1 << log_n), 2, 7).astype(np.int64)) \
        if bits == 32 else u64_tensor(_input(bits, q, (1, 3, 1 << log_n), 2, 7))
    fwd = ntt32.forward32_plain if bits == 32 else ntt64.ntt64_forward_plain
    inv = ntt32.inverse32_plain if bits == 32 else ntt64.ntt64_inverse_plain
    cols = ntt_columns.columns_forward_plain(plans, x, l, bits)
    assert torch.equal(ntt_columns.forward_stages(plans[0], cols[0], log_n - l, log_n, bits),
                       fwd(tables, x, 4)[0])
    sub = ntt_columns.inverse_stages(plans[0], x[0], 0, l, bits)
    assert torch.equal(ntt_columns.columns_inverse_plain(plans, sub[None], l, bits),
                       inv(tables, x, 1))


def test_kernel_d_and_e_equal_plain():
    """Kernel D (the key as the sub-row loads each word, then the inverse's
    columns) and kernel E (the forward's columns on any u64 word, the
    sub-row's passes with the fused pass, the inverse's columns) against
    the plain versions, any u64 words in."""
    log_n, l = 11, 6
    q = Q64
    ar = Arith(q, 64)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [q]))
    tabs = Tables(tables.ntt.plans[0], ar)
    rng = np.random.default_rng(3)
    x = np.array([int(v) for v in rng.integers(0, 1 << 64, 2 << log_n, dtype=np.uint64)],
                 dtype=object).reshape(2, 1 << log_n)
    key = torch.from_numpy(rng.integers(0, q, (1, 1 << log_n), dtype=np.int64))
    mt = tables.mul_table(key)
    kv, kp = (ar.arr(u64_numpy(mt[0, i])) for i in (0, 1))
    p1 = int(ntt64.mod_pack64(tables.ntt.plans)[7])

    def key_load(row, h, tile):
        i = (h << l) + np.arange(1 << l)
        return ar.shoup(tile, kv[i], kp[i])
    got = columns_inverse(ar, tabs, sub_inverse(ar, tabs, ar.arr(x), log_n, l, load=key_load),
                          log_n, l)
    want = ntt_mxu8.mxu8_inverse64_mul_plain(tables, u64_tensor(x)[None], mt)[0]
    same(got, u64_numpy(want))

    # kernel E: the forward's columns with each word below 2q first
    y = columns_forward(ar, tabs, ar.arr(x), log_n, l, load=lambda v: ar.shoup(v, 1, p1))
    r = remainder_stages(l)

    def fused(tile, row, h, idx):
        """The forward's last pass, the key and the inverse's first (FwdKeyIn
        then inv_pass at s0 0), then the inverse's later sub-row passes."""
        fwd_pass(ar, tile, l, l - r, r, idx, tabs.w, tabs.wp)
        i = (h << l) + np.arange(1 << l)
        tile = ar.shoup(tile, kv[i], kp[i])

        def table(ti):
            return slice_inv_index(ti, l, log_n, h)
        inv_pass(ar, tile, l, 0, r, False, table, tabs)
        for s0 in range(r, l, 3):
            inv_pass(ar, tile, l, s0, 3, False, table, tabs)
        return tile
    got = columns_inverse(ar, tabs, sub_forward(ar, tabs, y, log_n, l, False, last=fused),
                          log_n, l)
    want = ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, u64_tensor(x)[None], mt)[0]
    same(got, u64_numpy(want))


# ---------------------------------------------------------------------------
# Kernels H and J past 2^17


def mac_sub_model(ar, tabs, f_rows, key_rows, log_n, l):
    """mac_sub: each sub-row's MAC (digits brought below q, products summed
    mod q, canonical), then the inverse's stages within it (SliceInvTable at
    rank h), lazy words out; ``f_rows``, ``key_rows`` ``(R, M, n)``."""
    q = ar.q
    mac = ((f_rows % q) * key_rows % q).sum(axis=1) % q
    return sub_inverse(ar, tabs, ar.arr(mac), log_n, l)


def test_kernel_h_split_equals_plain():
    """BOOLEAN_128's gadget (kp 3, L 3, k1 2) at N = 2^11 with sub-rows of
    2^5 words: mac_sub per prime, then H's column launch (each prime's last
    6 stages, canonical, times (P/p_i)^-1, the kernel's integer CRT, the add
    to acc) against ``cmux_stage2_plain``."""
    log_n, l, bsz, k1, level = 11, 5, 2, 2, 3
    conv = tfhe.make_convolver(log_n, level, 1, 7)
    kp, n = conv.count, 1 << log_n
    rng = np.random.default_rng(11)
    qs = np.array(conv.primes, dtype=np.int64).reshape(-1, 1, 1, 1)
    f = rng.integers(0, 1 << 40, (kp, bsz * k1, level, n)) % (4 * qs)
    key = rng.integers(0, 1 << 40, (kp, k1, level, k1, n)) % qs[..., None]
    acc = rng.integers(0, 1 << 32, (bsz, k1, n), dtype=np.int64)
    crt = conv.crt_pack
    ys = []
    for pi, q in enumerate(conv.primes):
        ar = Arith(q, 32)
        tabs = Tables(conv.ntt.plans[pi], ar)
        f_rows = f[pi].reshape(bsz, 1, k1 * level, n).repeat(k1, axis=1).reshape(-1, k1 * level, n)
        key_rows = np.broadcast_to(key[pi].transpose(2, 0, 1, 3).reshape(1, k1, k1 * level, n),
                                   (bsz, k1, k1 * level, n)).reshape(-1, k1 * level, n)
        part = mac_sub_model(ar, tabs, f_rows.astype(np.uint64), key_rows.astype(np.uint64),
                             log_n, l)
        iw, ipq = int(crt[4 * pi]), int(crt[4 * pi + 1])
        ys.append(columns_inverse(ar, tabs, part, log_n, l, "canonical",
                                  scale=lambda t, ar=ar, iw=iw, ipq=ipq:
                                  ar.sub_if(ar.shoup(t, iw, ipq), ar.q)))
    # the kernel's CRT: fix = sum y_i afix_i mod 2^64 and its carries
    m64 = (1 << 64) - 1
    out = np.empty(bsz * k1 * n, dtype=np.int64)
    flat = [y.reshape(-1) for y in ys]
    for t in range(bsz * k1 * n):
        fix, over, total = 0, 0, 0
        for pi in range(kp):
            y = int(flat[pi][t])
            nf = (fix + y * int(crt[4 * pi + 2])) & m64
            over += nf < fix
            fix = nf
            total = (total + y * int(crt[4 * pi + 3])) & 0xFFFFFFFF
        alpha = (over + (fix >> 63)) & 0xFFFFFFFF
        out[t] = (int(acc.reshape(-1)[t]) + total - alpha * int(crt[4 * kp])) & 0xFFFFFFFF
    want = cmux_fused.cmux_stage2_plain(conv, torch.from_numpy(f), torch.from_numpy(key),
                                        torch.from_numpy(acc))
    np.testing.assert_array_equal(out.reshape(bsz, k1, n), want.numpy())


def test_kernel_j_split_equals_plain():
    """NTRU_128's gadget at N = 2^10 (sub-rows of 2^4 words, c = 6):
    mac_sub, the inverse's columns (delta, canonical), then ntru_finish's
    rotation across sub-rows (sources in other sub-rows, negated past n)
    and the digits, against ``ntru_stage2_plain`` with the basis, and the
    plain pieces against each other."""
    log_n, l, bsz = 10, 4, 3
    ctx, _ = P.make_ntru_context(dataclasses.replace(P.NTRU_128, log_n=log_n))
    q, n, level = ctx.q_int, ctx.n, ctx.basis.decompose_length
    ar = Arith(q, 32)
    tabs = Tables(ctx.ntt.plans[0], ar)
    g = torch.Generator().manual_seed(19)
    acc = torch.randint(0, q, (bsz, n), generator=g)
    evk = torch.randint(0, q, (level, n), generator=g)
    deg = torch.tensor([5, n + 37, 2 * n - 1], dtype=torch.int32)
    f = ntru_cmux_mxu.ntru_stage1_plain(ctx.ntt, ctx.basis, acc)  # (L, B, n) lazy
    part = mac_sub_model(ar, tabs, f.numpy().transpose(1, 0, 2).astype(np.uint64),
                         np.broadcast_to(evk.numpy(), (bsz, level, n)).astype(np.uint64), log_n, l)
    delta = columns_inverse(ar, tabs, part, log_n, l).astype(np.int64)
    # ntru_finish: word g of row b, a thread each
    out = np.empty((bsz, n), dtype=np.int64)
    a = acc.numpy()
    for b in range(bsz):
        d = int(deg[b]) % (2 * n)
        for gi in range(n):
            e = gi - d + (2 * n if gi < d else 0)
            neg = e >= n
            r = int(delta[b, e - n if neg else e])
            r = q - r if neg and r else r
            own = int(delta[b, gi])
            t = r - own if r >= own else r + q - own
            out[b, gi] = (int(a[b, gi]) + t) % q
    want, want_dig = ntru_cmux_mxu.ntru_stage2_plain(ctx.ntt, f, evk, acc, deg, ctx.basis)
    np.testing.assert_array_equal(out, want.numpy())
    fin, dig = ntru_cmux_mxu.ntru_finish_plain(q, torch.from_numpy(delta), acc, deg, ctx.basis)
    assert torch.equal(fin, want) and torch.equal(dig, want_dig)


def test_cmux_stage2_cols_plain_composes():
    """The split H's plain pieces compose to ``cmux_stage2_plain``: the MAC,
    the inverse's first 13 stages (``mac_sub_plain``), then
    ``cmux_stage2_cols_plain`` (at N = 2^14, one sub-row stage past 13)."""
    log_n, bsz, k1, level = 14, 1, 2, 3
    conv = tfhe.make_convolver(log_n, level, 1, 7)
    kp, n = conv.count, 1 << log_n
    g = torch.Generator().manual_seed(23)
    qs = torch.tensor(conv.primes).reshape(-1, 1, 1, 1)
    f = torch.randint(0, 1 << 40, (kp, bsz * k1, level, n), generator=g) % (4 * qs)
    key = torch.randint(0, 1 << 40, (kp, k1, level, k1, n), generator=g) % qs[..., None]
    acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=g)
    f_rows = f.reshape(kp, bsz, k1 * level, n).unsqueeze(2).expand(kp, bsz, k1, k1 * level, n)
    key_rows = key.permute(0, 3, 1, 2, 4).reshape(kp, 1, k1, k1 * level, n).expand(
        kp, bsz, k1, k1 * level, n)
    part = ntt_columns.mac_sub_plain(conv.ntt.plans, f_rows, key_rows)
    got = cmux_fused.cmux_stage2_cols_plain(conv, part, acc)
    assert torch.equal(got, cmux_fused.cmux_stage2_plain(conv, f, key, acc))


def test_log_n_18_one_row_against_jax():
    """log_n 18 at the kernels' own sub-rows of 2^14 words (c = 4): one row
    through the column and sub-row launches, forward (out_factor 4) and
    inverse (canonical), against the JAX forward32 and inverse32."""
    log_n, l = 18, ntt_columns.SUB_LOG
    q = next_ntt_prime(30, log_n)
    ar = Arith(q, 32)
    tabs = Tables(ntt32.NttTables32(log_n, [q]).plans[0], ar)
    jplan = jax_plan32(log_n, q)
    rng = np.random.default_rng(18)
    x4 = rng.integers(0, 4 * q, (1, 1 << log_n), dtype=np.int64)
    got = four_step_forward(ar, tabs, ar.arr(x4), log_n, l, canonical=False)
    same(got, np.asarray(jntt.forward32(jplan, jnp.asarray(x4.astype(np.uint32)), 4)))
    x2 = rng.integers(0, 2 * q, (1, 1 << log_n), dtype=np.int64)
    got = four_step_inverse(ar, tabs, ar.arr(x2), log_n, l)
    same(got, np.asarray(jntt.inverse32(jplan, jnp.asarray(x2.astype(np.uint32)), 1)))


def test_wrappers_route_past_2_17():
    """The routes the card takes past 2^17, decided before any launch: the
    staged CMux step (split H) and the NTRU staged step (split J) to
    log_n 26; 27 refused by name."""
    assert cmux_fused.step_route(3, 2, 3, 18) == "staged"
    assert cmux_fused.step_route(3, 2, 3, 26) == "staged"
    with pytest.raises(ValueError, match="log_n 4-26"):
        cmux_fused.step_route(3, 2, 3, 27)
    assert ntru_cmux_mxu.ntru_step_route(6, 20, 1) == "staged"
    with pytest.raises(ValueError, match="log_n 8-26"):
        ntru_cmux_mxu.ntru_step_route(6, 27, 1)
