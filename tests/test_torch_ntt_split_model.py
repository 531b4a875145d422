"""A numpy model of kernels 1-2 at log_n 15-17 (``csrc/ntt32.cu``'s split
kernels on ``csrc/ntt_split.cuh``), held word for word against the plain
versions ``ops.ntt32.forward32_plain`` / ``inverse32_plain`` and against
the JAX ``transforms.ntt.forward32`` / ``inverse32`` on one row.

The model runs the kernels' data flow as written: a row over a cluster of
C = 2^(log_n - 14) blocks (2, 4, 8), slice k holding words k 2^14 .. (k+1) 2^14 - 1
at the swizzled index ``SwzNtt``; the forward's first log_n - 14 stages on
groups of one word a slice (offset j in this block's share of the
offsets), loaded from the input, their twiddles the 7 registers of
``FwdFirst``, each word stored into its slice; then each slice's radix-8
passes with ``FwdSliceTable``'s twiddle index ``(C + rank) 2^s + j``; the
inverse's slice passes on ``SliceInvTable`` (the row's index recovered from
the slice's by ``ceil(log2(2^l + 1 - ti))``), then the last stages on
groups gathered from the slices, the final one folding ``inv_n`` in.
Every word is checked below 2^32 and inside its lazy range, every offset
owned by exactly one block.  Tolerance: zero (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.transforms import ntt as jntt
from primus_fhe_tpu.transforms.plan import build_plan32 as jax_plan32
from primus_fhe_tpu_torch.ops import ntt32
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

M32 = np.uint64(0xFFFFFFFF)
SLICE_LOG = 14  # SLICE_LOG in csrc/ntt32.cu
PRIMES = [next_ntt_prime(30, 17)]  # = 1 mod 2^18: rows to 2^17
PRIMES.append(next_ntt_prime(30, 17, PRIMES[0]))


def swz(i):
    """``SwzNtt::at``."""
    return i ^ ((i >> 3) & 31) ^ ((i >> 5) & 3)


def remainder_stages(log_n: int) -> int:
    return log_n - 3 * ((log_n - 1) // 3)


def shoup(y, w, wp, q):
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    return (w * y - np.uint64(q) * ((y * wp) >> np.uint64(32))) & M32


def below(x, bound):
    assert (np.asarray(x) < np.uint64(bound)).all()


def fwd_bf(x, y, w, wp, q):
    two_q = np.uint64(2 * q)
    tx = np.where(x >= two_q, x - two_q, x)
    ty = shoup(y, w, wp, q)
    x2, y2 = tx + ty, tx + two_q - ty
    below(x2, 4 * q)
    below(y2, 4 * q)
    return x2, y2


def inv_bf(x, y, w, wp, q):
    two_q = np.uint64(2 * q)
    s = x + y
    x2 = np.where(s >= two_q, s - two_q, s)
    y2 = shoup(x + two_q - y, w, wp, q)
    below(x2, 2 * q)
    below(y2, 2 * q)
    return x2, y2


def shares(l: int, lc: int):
    """Each block's offsets of the cross stages: ``[rank per, (rank + 1)
    per)`` with ``per = 2^(l - lc)``, a block's threads striding over
    them; every offset of a slice exactly once."""
    per = 1 << (l - lc)
    out = [np.arange(rank * per, (rank + 1) * per) for rank in range(1 << lc)]
    assert sorted(np.concatenate(out)) == list(range(1 << l))
    return out


def fwd_slice_passes(l: int):
    """``(s0, R)`` of a slice's forward passes: radix 8, the remainder last."""
    r = remainder_stages(l)
    return [(s0, 3) for s0 in range(0, l - r, 3)] + [(l - r, r)]


def model_forward(plan, x: np.ndarray, log_n: int, out_factor: int) -> np.ndarray:
    """The split forward kernel on one prime's rows ``x (rows, n)`` below 4q."""
    q, n = plan.q, 1 << log_n
    lc, l = log_n - SLICE_LOG, SLICE_LOG
    C = 1 << lc
    roots = plan.roots.numpy().astype(np.uint64)
    roots_p = plan.roots_precon.numpy().astype(np.uint64)
    rows = x.shape[0]
    sm = np.zeros((rows, C, 1 << l), dtype=np.uint64)  # each slice's shared memory
    # cross_forward: group j is words j + k 2^l; FwdFirst's registers roots[1 .. C-1]
    for rank, js in enumerate(shares(l, lc)):
        v = [x[:, js + (k << l)].copy() for k in range(C)]
        for e in range(lc):  # fwd_stages<LC>: stage e pairs k, k + 2^(LC-1-e)
            h = 1 << (lc - 1 - e)
            for k in range(C):
                if not k & h:
                    ti = (1 << e) + (k >> (lc - e))
                    assert ti < C
                    v[k], v[k + h] = fwd_bf(v[k], v[k + h], roots[ti], roots_p[ti], q)
        for k in range(C):
            sm[:, k, swz(js)] = v[k]
    out = np.full_like(x, 0xDEADBEEF)
    for rank in range(C):
        m = C + rank  # FwdSliceTable
        passes = fwd_slice_passes(l)
        for i, (s0, r) in enumerate(passes):
            log_t = l - s0 - r
            g = np.arange(1 << (l - r))
            hi, lo = g >> log_t, g & ((1 << log_t) - 1)
            base = (hi << (log_t + r)) + lo
            slots = base[None, :] + (np.arange(1 << r)[:, None] << log_t)
            v = [sm[:, rank, swz(slots[k])] for k in range(1 << r)]
            for e in range(r):
                h = 1 << (r - 1 - e)
                run = (m << (s0 + e)) + (hi << e)  # the stage's 2^e roots
                assert (run % (1 << e) == 0).all()
                for k in range(1 << r):
                    if not k & h:
                        ti = run + (k >> (r - e))
                        # the row's stage lc + s0 + e, block rank 2^(s0+e) + j
                        s = lc + s0 + e
                        j = (rank << (s0 + e)) + ((slots[k] >> (l - s0 - e)))
                        np.testing.assert_array_equal(ti, (1 << s) + j)
                        v[k], v[k + h] = fwd_bf(v[k], v[k + h], roots[ti], roots_p[ti], q)
            if i < len(passes) - 1:
                for k in range(1 << r):
                    sm[:, rank, swz(slots[k])] = v[k]
            else:  # the last pass: 2^R adjacent words into the slice's output
                assert log_t == 0
                for k in range(1 << r):
                    w = v[k]
                    if out_factor == 1:
                        w = np.where(w >= 2 * q, w - 2 * q, w)
                        w = np.where(w >= q, w - q, w)
                    out[:, (rank << l) + slots[k]] = w
    assert (out != 0xDEADBEEF).all()
    return out


def slice_inv_index(ti, l: int, log_n: int, rank: int):
    """``SliceInvTable``: the row's table index of the slice's ``ti``."""
    ls = np.frexp(((1 << l) - ti).astype(np.float64))[1]  # 32 - clz: the bit length
    j = ti - 1 - (1 << l) + (1 << ls)
    return 1 + (1 << log_n) - (1 << (log_n - l + ls)) + (rank << (ls - 1)) + j


def model_inverse(plan, x: np.ndarray, log_n: int, out_factor: int) -> np.ndarray:
    """The split inverse kernel on one prime's rows ``x (rows, n)`` below 2q."""
    q, n = plan.q, 1 << log_n
    two_q = np.uint64(2 * q)
    lc, l = log_n - SLICE_LOG, SLICE_LOG
    C = 1 << lc
    tw = plan.inv_roots.numpy().astype(np.uint64)
    twp = plan.inv_roots_precon.numpy().astype(np.uint64)
    rows = x.shape[0]
    sm = np.zeros((rows, C, 1 << l), dtype=np.uint64)
    r0 = remainder_stages(l)
    passes = [(0, r0)] + [(s0, 3) for s0 in range(r0, l, 3)]
    for rank in range(C):
        src = x[:, rank << l:(rank + 1) << l]
        for i, (s0, r) in enumerate(passes):
            g = np.arange(1 << (l - r))
            hi, lo = g >> s0, g & ((1 << s0) - 1)
            base = (hi << (s0 + r)) + lo
            slots = base[None, :] + (np.arange(1 << r)[:, None] << s0)
            if i == 0:  # 2^R adjacent words from device memory
                assert s0 == 0 and (slots[0] % (1 << r) == 0).all()
                v = [src[:, slots[k]] for k in range(1 << r)]
            else:
                v = [sm[:, rank, swz(slots[k])] for k in range(1 << r)]
            for e in range(r):
                h = 1 << e
                start = 1 + (1 << l) - ((1 << l) >> (s0 + e))
                for k in range(1 << r):
                    if not k & h:
                        ti = start + (hi << (r - 1 - e)) + (k >> (e + 1))
                        gi = slice_inv_index(ti, l, log_n, rank)
                        s = s0 + e  # the row's stage: block rank 2^(l-s-1) + j
                        j = slots[k] >> (s + 1)
                        np.testing.assert_array_equal(
                            gi, 1 + n - (n >> s) + (rank << (l - s - 1)) + j)
                        assert (gi < n - 1).all()
                        v[k], v[k + h] = inv_bf(v[k], v[k + h], tw[gi], twp[gi], q)
            for k in range(1 << r):
                sm[:, rank, swz(slots[k])] = v[k]
    # cross_inverse: group j gathers word j of each slice
    out = np.full_like(x, 0xDEADBEEF)
    for rank, js in enumerate(shares(l, lc)):
        v = [sm[:, k, swz(js)].copy() for k in range(C)]
        for e in range(lc):
            h = 1 << e
            start = 1 + n - (n >> (l + e))
            for k in range(C):
                if k & h:
                    continue
                if e == lc - 1:  # the row's last stage, inv_n folded in
                    xv, yv = v[k], v[k + h]
                    s = xv + yv
                    tx = np.where(s >= two_q, s - two_q, s)
                    a = shoup(tx, plan.inv_n, plan.inv_n_precon, q)
                    b = shoup(xv + two_q - yv, plan.inv_n_w, plan.inv_n_w_precon, q)
                    if out_factor == 1:
                        a, b = np.where(a >= q, a - q, a), np.where(b >= q, b - q, b)
                    below(a, out_factor * q)
                    below(b, out_factor * q)
                    v[k], v[k + h] = a, b
                else:
                    ti = start + (k >> (e + 1))
                    v[k], v[k + h] = inv_bf(v[k], v[k + h], tw[ti], twp[ti], q)
        for k in range(C):
            out[:, js + (k << l)] = v[k]
    assert (out != 0xDEADBEEF).all()
    return out


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_split_model_matches_plain_and_jax(log_n):
    """Two primes, two rows a prime, every ``out_factor``; row 0 of prime 0
    also against the JAX transforms (whose words the plain versions are)
    at 15 and 16 (at 17 their compiles would take most of the test's time:
    the plain versions there are the same code)."""
    tables = ntt32.NttTables32(log_n, PRIMES)
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    q = np.array(PRIMES, dtype=np.uint64).reshape(-1, 1, 1)
    x4 = rng.integers(0, 1 << 62, (2, 2, n), dtype=np.uint64) % (4 * q)
    x4[:, 0, :2] = np.concatenate([np.zeros_like(q[:, 0]), 4 * q[:, 0] - 1], axis=1)
    x2 = x4 % (2 * q)
    jplan = jax_plan32(log_n, PRIMES[0]) if log_n < 17 else None
    for of in (1, 4):
        got = np.stack([model_forward(pl, x4[i], log_n, of)
                        for i, pl in enumerate(tables.plans)])
        want = ntt32.forward32_plain(tables, torch.from_numpy(x4.astype(np.int64)), of).numpy()
        np.testing.assert_array_equal(got.astype(np.int64), want)
        if jplan is not None:
            jax_row = jntt.forward32(jplan, jnp.asarray(x4[0, :1].astype(np.uint32)), of)
            np.testing.assert_array_equal(np.asarray(jax_row).astype(np.int64), want[0, :1])
    for of in (1, 2):
        got = np.stack([model_inverse(pl, x2[i], log_n, of)
                        for i, pl in enumerate(tables.plans)])
        want = ntt32.inverse32_plain(tables, torch.from_numpy(x2.astype(np.int64)), of).numpy()
        np.testing.assert_array_equal(got.astype(np.int64), want)
        if jplan is not None:
            jax_row = jntt.inverse32(jplan, jnp.asarray(x2[0, :1].astype(np.uint32)), of)
            np.testing.assert_array_equal(np.asarray(jax_row).astype(np.int64), want[0, :1])


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_split_passes_cover_every_stage_once_and_banks(log_n):
    """The cross stages and the slice's passes run every stage of the row
    once, in order; each warp of a slice's radix-8 passes and of the cross
    stages' sweep (32 consecutive offsets) hits 32 distinct banks."""
    lc, l = log_n - SLICE_LOG, SLICE_LOG
    fwd = list(range(lc)) + [lc + s0 + e for s0, r in fwd_slice_passes(l) for e in range(r)]
    r0 = remainder_stages(l)
    inv = [s0 + e for s0, r in [(0, r0)] + [(s0, 3) for s0 in range(r0, l, 3)]
           for e in range(r)] + list(range(l, log_n))
    assert fwd == inv == list(range(log_n))
    assert sorted(swz(np.arange(1 << l))) == list(range(1 << l))
    for js in shares(l, lc):
        assert all(len(set(w)) == 32 for w in (swz(js) % 32).reshape(-1, 32))
    for s0, r in fwd_slice_passes(l):
        if r == 3:
            log_t = l - s0 - r
            g = np.arange(1 << (l - r))
            base = ((g >> log_t) << (log_t + r)) + (g & ((1 << log_t) - 1))
            for k in range(8):
                assert all(len(set(w)) == 32 for w in (swz(base + (k << log_t)) % 32).reshape(-1, 32))
