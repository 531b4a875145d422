"""Row 10 and kernel E with a row over a cluster (``csrc/ntt64.cu`` on
``csrc/ntt_split.cuh``'s scheme, u64 words), and row 9's four u64 functions
at log_n 16-17, on the CPU.

- ``Mxu8NttPlan64``'s split (``A``, ``B``) equals the JAX plan's at log_n 16
  and 17, as do ``Mxu8Tables64``'s (whose card route builds no byte plane);
- the four wrappers (``mxu8_forward64``, ``mxu8_inverse64``, kernel D
  ``mxu8_inverse64_mul``, kernel E ``mxu8_roundtrip64_mul``) on CPU tensors
  give the words of JAX ``mxu8_fused_forward64``, ``_inverse64``,
  ``_inverse64_mul`` and ``_roundtrip64_mul`` (Pallas in interpret mode, as
  ``tests/test_ntt_mxu8.py`` runs them) at log_n 16 on 2 rows;
- a numpy model of the kernels' data flow at log_n 15-17 (LC = log_n - 14 =
  1, 2, 3: a row over a cluster of 2^LC blocks, slice k holding words k 2^14
  .. (k+1) 2^14 - 1 at ``swz64``): the forward's first LC stages on groups
  of one word a slice (offset j in this block's share), the 7 registers of
  ``FwdFirst`` their twiddles, each word stored into its slice; the slice's
  radix-8 passes on ``SliceTable``'s view of the row's table; the inverse's
  slice passes on ``SliceInvTable``, then the last LC stages on groups
  gathered from the slices, the final one folding ``inv_n`` in; kernel E's
  fused pass (the forward's last group, the key, the inverse's first) on
  the slice's groups.  Every twiddle index is held to the row's own (stage,
  block), every word below 2^64 and inside its lazy range, every offset
  owned by one block, every output word written once; held word for word
  to the plain versions: the forward (input chain or any u64 word), the
  inverse (input chain, times 1, times D's key) and E, on a 62-bit and a
  50-bit modulus.

Inputs from a numpy seed; tolerance zero (bit-equal words).
"""

import numpy as np
import pytest

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops import ntt_mxu8 as jmxu
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime
from test_torch_ntt64_model import (_u64, check_words, forward_passes, fwd_slots, inv_slots,
                                    inverse_passes, shoup, swz64)

SLICE_LOG = 14  # SLICE_LOG in csrc/ntt64.cu: a block's slice of a row, 2^14 words
Q30 = next_ntt_prime(30, 17)  # 4 planes: the split does not depend on q
MODULI = [next_ntt_prime(62, 17), next_ntt_prime(50, 17)]  # lazy words past 2^63; 7 planes
M64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def jplan16():
    q = next_ntt_prime(50, 16)
    return q, jmxu.Mxu8NttPlan64(16, q)


@pytest.mark.parametrize("log_n", [16, 17])
def test_plan_split_matches_jax(log_n, jplan16):
    """``A``, ``B`` of the port's split, plan and table stack are the JAX
    plan's (its default ``h1``: ``A = 256`` and ``B = 256``, ``512``); the
    table stack builds no plan until a byte-radix kernel asks for one."""
    jplan = jplan16[1] if log_n == 16 else jmxu.Mxu8NttPlan64(log_n, Q30)
    want = (jplan.A, jplan.B)
    assert ntt_mxu8.four_step_split(log_n) == want == (256, 1 << (log_n - 8))
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [Q30]))
    assert (tables.A, tables.B) == want and tables._plans is None
    if log_n == 16:
        plan = ntt_mxu8.Mxu8NttPlan64(log_n, jplan16[0])
        assert (plan.A, plan.B) == want and plan.cyclic is None


def test_wrappers_match_jax_at_log_n_16(jplan16):
    """Two rows of a 50-bit modulus (7 planes): the forward, the inverse of
    its output, D with a key and E with the same key."""
    q, jplan = jplan16
    n = 1 << 16
    rng = np.random.default_rng(28)
    x = rng.integers(0, q, (2, n), dtype=np.uint64)
    key = rng.integers(0, q, (n,), dtype=np.uint64)
    jtabs = jplan.inverse_mul_tabs(key, 2)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(16, [q]))
    mt = tables.mul_table(u64_tensor(key)[None])
    f = jfrom(jmxu.mxu8_fused_forward64(jplan, jto(x), 1, 2))
    np.testing.assert_array_equal(_u64(ntt_mxu8.mxu8_forward64(tables, u64_tensor(x)[None]))[0], f)
    want = jfrom(jmxu.mxu8_fused_inverse64(jplan, jto(f), 1, 2))
    got = ntt_mxu8.mxu8_inverse64(tables, u64_tensor(f)[None])
    np.testing.assert_array_equal(_u64(got)[0], want)
    want = jfrom(jmxu.mxu8_fused_inverse64_mul(jplan, jto(f), jtabs, 1, 2))
    got = ntt_mxu8.mxu8_inverse64_mul(tables, u64_tensor(f)[None], mt)
    np.testing.assert_array_equal(_u64(got)[0], want)
    want = jfrom(jmxu.mxu8_fused_roundtrip64_mul(jplan, jto(x), jtabs, 1, 2))
    got = ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x)[None], mt)
    np.testing.assert_array_equal(_u64(got)[0], want)
    assert tables._plans is None  # the plain versions need the butterfly tables only


# ---------------------------------------------------------------------------
# The numpy model of the cluster kernels
# ---------------------------------------------------------------------------


def shares(l: int, lc: int):
    """Each block's offsets of the cross stages: ``[rank per, (rank + 1)
    per)`` with ``per = 2^(l - lc)``; every offset of a slice exactly once."""
    per = 1 << (l - lc)
    out = [np.arange(rank * per, (rank + 1) * per) for rank in range(1 << lc)]
    assert sorted(np.concatenate(out).tolist()) == list(range(1 << l))
    return out


def slice_fwd_twiddle(s0, hi, e, j, lc, rank):
    """``SliceTable``: the index of block j's root at stage e of the slice's
    pass (s0, hi), a run of 2^e roots read in 16-byte accesses."""
    run = (1 << (s0 + lc + e)) + ((hi + (rank << s0)) << e)
    assert (run % (1 << e) == 0).all()
    return run + j


def slice_inv_index(ti, l: int, log_n: int, rank: int):
    """``SliceInvTable``: the row's table index of the slice's twiddle ti."""
    ls = np.frexp(((1 << l) - ti).astype(np.float64))[1]  # 32 - clz: the bit length
    j = ti - 1 - (1 << l) + (1 << ls)
    return 1 + (1 << log_n) - (1 << (log_n - l + ls)) + (rank << (ls - 1)) + j


def fwd_bf(x, y, w, wp, q):
    two_q = np.uint64(2 * q)
    tx = np.where(x >= two_q, x - two_q, x)
    ty = shoup(y, w, wp, q)
    with np.errstate(over="ignore"):
        x2, y2 = tx + ty, tx + two_q - ty
    check_words(x2, 4 * q)
    check_words(y2, 4 * q)
    return x2, y2


def inv_bf(x, y, w, wp, q):
    two_q = np.uint64(2 * q)
    s = x + y
    x2 = np.where(s >= two_q, s - two_q, s)
    y2 = shoup(x + two_q - y, w, wp, q)
    check_words(x2, 2 * q)
    check_words(y2, 2 * q)
    return x2, y2


def final_bf(x, y, pl, q, canonical):
    """The row's last inverse stage, inv_n and inv_n_w folded in."""
    two_q = np.uint64(2 * q)
    s = x + y
    a = shoup(np.where(s >= two_q, s - two_q, s), pl.inv_n, pl.inv_n_precon, q)
    b = shoup(x + two_q - y, pl.inv_n_w, pl.inv_n_w_precon, q)
    if canonical:
        a, b = np.where(a >= q, a - np.uint64(q), a), np.where(b >= q, b - np.uint64(q), b)
    check_words(a, (1 if canonical else 2) * q)
    check_words(b, (1 if canonical else 2) * q)
    return a, b


class Cluster:
    """The shared memory of a row's 2^lc slices, ``(rows, 2^l)`` each at
    ``swz64``; a read of a word not yet written fails."""

    def __init__(self, rows: int, l: int, lc: int):
        self.w = np.zeros((1 << lc, rows, 1 << l), dtype=np.uint64)
        self.ok = np.zeros((1 << lc, 1 << l), dtype=bool)

    def read(self, rank, slots):
        idx = swz64(slots)
        assert self.ok[rank, idx].all(), "shared memory read before it was written"
        return self.w[rank][:, idx].copy()

    def write(self, rank, slots, v):
        idx = swz64(slots)
        self.w[rank][:, idx] = v
        self.ok[rank, idx] = True


def cross_forward(x, pl, l, lc, any_words):
    """The forward's first lc stages over the slices, from the row ``x (rows,
    n)``: group j (in block rank's share) is words j + k 2^l."""
    q, C = pl.q, 1 << lc
    roots, roots_p = _u64(pl.roots), _u64(pl.roots_precon)
    sm = Cluster(x.shape[0], l, lc)
    for rank, js in enumerate(shares(l, lc)):
        v = [x[:, js + (k << l)].copy() for k in range(C)]
        if any_words:  # each word to [0, 2q) first: a lazy Shoup multiply by 1
            v = [shoup(w, 1, (1 << 64) // q, q) for w in v]
        for w in v:
            check_words(w, 4 * q)
        for e in range(lc):  # fwd_stages<LC>: stage e pairs k, k + 2^(LC-1-e)
            h = 1 << (lc - 1 - e)
            for k in range(C):
                if not k & h:
                    ti = (1 << e) + (k >> (lc - e))
                    assert ti < C  # FwdFirst's registers: roots[1 .. C-1]
                    # the row's stage e, block (j + k 2^l) >> (log_n - e)
                    assert ti == (1 << e) + ((k << l) >> (l + lc - e))
                    v[k], v[k + h] = fwd_bf(v[k], v[k + h], roots[ti], roots_p[ti], q)
        for k in range(C):
            sm.write(k, js, v[k])
    return sm


def fwd_slice_pass(sm, rank, pl, l, lc, s0, r):
    """One forward pass of the slice ``rank``: its groups' words (from the
    slice) after the pass's r stages, and the slots."""
    q = pl.q
    roots, roots_p = _u64(pl.roots), _u64(pl.roots_precon)
    slots, hi, log_t = fwd_slots(l, s0, r)
    v = [sm.read(rank, slots[k]) for k in range(1 << r)]
    for e in range(r):
        h = 1 << (r - 1 - e)
        for k in range(1 << r):
            if not k & h:
                ti = slice_fwd_twiddle(s0, hi, e, k >> (r - e), lc, rank)
                s = lc + s0 + e  # the row's stage, block rank 2^(s0+e) + the slice's
                j = (rank << (s0 + e)) + (slots[k] >> (l - s0 - e))
                np.testing.assert_array_equal(ti, (1 << s) + j)
                v[k], v[k + h] = fwd_bf(v[k], v[k + h], roots[ti], roots_p[ti], q)
    return v, slots, log_t


def inv_slice_pass(v, rank, pl, l, log_n, s0, r):
    """The r inverse stages of a slice pass at s0 on its groups' words ``v``
    (none of them the row's last), twiddles through ``SliceInvTable``."""
    q, n = pl.q, 1 << log_n
    tw, twp = _u64(pl.inv_roots), _u64(pl.inv_roots_precon)
    slots, hi, _ = inv_slots(l, s0, r)
    for e in range(r):
        h = 1 << e
        start = 1 + (1 << l) - ((1 << l) >> (s0 + e))
        for k in range(1 << r):
            if not k & h:
                ti = start + (hi << (r - 1 - e)) + (k >> (e + 1))
                gi = slice_inv_index(ti, l, log_n, rank)
                s = s0 + e  # the row's stage: block rank 2^(l-s-1) + the slice's
                np.testing.assert_array_equal(
                    gi, 1 + n - (n >> s) + (rank << (l - s - 1)) + (slots[k] >> (s + 1)))
                assert (gi < n - 1).all()
                v[k], v[k + h] = inv_bf(v[k], v[k + h], tw[gi], twp[gi], q)
    return v, slots


def cross_inverse(sm, pl, l, lc, log_n, out, canonical):
    """The inverse's last lc stages on groups gathered from the slices, into
    the row ``out``; every word written once."""
    q, n, C = pl.q, 1 << log_n, 1 << lc
    tw, twp = _u64(pl.inv_roots), _u64(pl.inv_roots_precon)
    writes = np.zeros(out.shape[1], dtype=np.int64)
    for rank, js in enumerate(shares(l, lc)):
        v = [sm.read(k, js) for k in range(C)]
        for e in range(lc):
            h = 1 << e
            start = 1 + n - (n >> (l + e))
            for k in range(C):
                if k & h:
                    continue
                if e == lc - 1:
                    v[k], v[k + h] = final_bf(v[k], v[k + h], pl, q, canonical)
                else:
                    ti = start + (k >> (e + 1))
                    # the row's stage l + e, block (j + k 2^l) >> (l + e + 1)
                    assert ti == 1 + n - (n >> (l + e)) + ((k << l) >> (l + e + 1))
                    v[k], v[k + h] = inv_bf(v[k], v[k + h], tw[ti], twp[ti], q)
        for k in range(C):
            out[:, js + (k << l)] = v[k]
            writes[js + (k << l)] += 1
    assert (writes == 1).all()


def model_forward(pl, x, log_n, out_factor, any_words=False):
    """The forward kernel on one modulus's rows ``x (rows, n)`` (below 4q;
    ``any_words``: any u64 words, row 9's forward)."""
    q, lc = pl.q, log_n - SLICE_LOG
    l = SLICE_LOG
    sm = cross_forward(x, pl, l, lc, any_words)
    out = np.zeros_like(x)
    writes = np.zeros(x.shape[1], dtype=np.int64)
    passes = forward_passes(l)
    for rank in range(1 << lc):
        for i, (s0, r) in enumerate(passes):
            v, slots, log_t = fwd_slice_pass(sm, rank, pl, l, lc, s0, r)
            if i < len(passes) - 1:
                for k in range(1 << r):
                    sm.write(rank, slots[k], v[k])
                continue
            # the last pass: 2^R adjacent words, 16-byte aligned, into device memory
            assert log_t == 0 and (slots[0] % (1 << r) == 0).all()
            for k in range(1 << r):
                w = v[k]
                if out_factor == 1:
                    w = np.where(w >= 2 * q, w - np.uint64(2 * q), w)
                    w = np.where(w >= q, w - np.uint64(q), w)
                out[:, (rank << l) + slots[k]] = w
                writes[(rank << l) + slots[k]] += 1
    assert (writes == 1).all()
    return out


def slice_load(x, pl, rank, l, load, in_factor, key):
    """The inverse's first-pass load of slice ``rank``: the input chain, any
    u64 word times 1 (``"any"``), or times the key (``"key"``: ``key (2,
    n)``, the words and quotients, at the slice's slots)."""
    q = pl.q
    src = x[:, rank << l:(rank + 1) << l].copy()
    if load == "key":
        src = shoup(src, key[0, rank << l:(rank + 1) << l], key[1, rank << l:(rank + 1) << l], q)
    elif load == "any":
        src = shoup(src, 1, (1 << 64) // q, q)
    f = in_factor // 2 if load == "chain" else 1
    while f >= 2:
        src = np.where(src >= np.uint64(f * q), src - np.uint64(f * q), src)
        f //= 2
    check_words(src, 2 * q)
    return src


def model_inverse(pl, x, log_n, out_factor, in_factor=2, load="chain", key=None):
    """The inverse kernel on one modulus's rows ``x (rows, n)``."""
    lc, l = log_n - SLICE_LOG, SLICE_LOG
    sm = Cluster(x.shape[0], l, lc)
    passes = inverse_passes(l)
    for rank in range(1 << lc):
        src = slice_load(x, pl, rank, l, load, in_factor, key)
        for i, (s0, r) in enumerate(passes):
            slots, _, _ = inv_slots(l, s0, r)
            if i == 0:  # 2^R adjacent words a group from device memory
                assert s0 == 0 and (slots[0] % (1 << r) == 0).all()
                v = [src[:, slots[k]] for k in range(1 << r)]
            else:
                v = [sm.read(rank, slots[k]) for k in range(1 << r)]
            v, slots = inv_slice_pass(v, rank, pl, l, log_n, s0, r)
            for k in range(1 << r):
                sm.write(rank, slots[k], v[k])
    out = np.zeros_like(x)
    cross_inverse(sm, pl, l, lc, log_n, out, out_factor == 1)
    return out


def model_roundtrip(pl, x, log_n, key):
    """Kernel E on one modulus's rows ``x (rows, n)`` (any u64 words) and
    its key ``(2, n)``: the cross stages, the slice's forward passes but the
    last, the fused pass, the inverse's later slice passes, the cross
    inverse stages; canonical words out."""
    q, lc, l = pl.q, log_n - SLICE_LOG, SLICE_LOG
    sm = cross_forward(x, pl, l, lc, True)
    fwd, inv = forward_passes(l), inverse_passes(l)
    assert fwd[-1][1] == inv[0][1] and inv[0][0] == 0
    for rank in range(1 << lc):
        for s0, r in fwd[:-1]:
            v, slots, _ = fwd_slice_pass(sm, rank, pl, l, lc, s0, r)
            for k in range(1 << r):
                sm.write(rank, slots[k], v[k])
        # the fused pass: one group of 2^R adjacent words is the forward's
        # last (lazy [0, 4q), unfolded) and the inverse's first
        s0, r = fwd[-1]
        v, slots, log_t = fwd_slice_pass(sm, rank, pl, l, lc, s0, r)
        islots, _, _ = inv_slots(l, 0, r)
        assert log_t == 0 and (slots == islots).all() and (slots[0] % (1 << r) == 0).all()
        g = (rank << l) + slots
        v = [shoup(v[k], key[0, g[k]], key[1, g[k]], q) for k in range(1 << r)]
        for w in v:
            check_words(w, 2 * q)
        v, _ = inv_slice_pass(v, rank, pl, l, log_n, 0, r)
        for k in range(1 << r):
            sm.write(rank, slots[k], v[k])
        for s0, r in inv[1:]:
            slots, _, _ = inv_slots(l, s0, r)
            v = [sm.read(rank, slots[k]) for k in range(1 << r)]
            v, slots = inv_slice_pass(v, rank, pl, l, log_n, s0, r)
            for k in range(1 << r):
                sm.write(rank, slots[k], v[k])
    out = np.zeros_like(x)
    cross_inverse(sm, pl, l, lc, log_n, out, True)
    return out


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_cluster_models_match_plain(log_n):
    """Clusters of 2, 4 and 8 slices on one row of a 62-bit modulus and two
    of a 50-bit one: the forward from words below 4q (``out_factor`` 4 and
    1) and from any u64 word (row 9's forward), the inverse from ``in_factor``
    4 (``out_factor`` 2), times 1 (row 9's inverse) and times the key (D),
    and E, against the plain versions."""
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, MODULI))
    key = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in MODULI])
    key[:, :2] = [[0, q - 1] for q in MODULI]
    mt = tables.mul_table(u64_tensor(key))
    mt_np = _u64(mt)
    for mi, (q, rows) in enumerate(zip(MODULI, (1, 2))):
        pl = tables.ntt.plans[mi]
        x = rng.integers(0, 1 << 64, (rows, n), dtype=np.uint64)
        x[0, :4] = [0, M64, 1 << 63, q]
        x4 = x % np.uint64(4 * q)
        x4[0, 0] = 4 * q - 1
        full = np.zeros((len(MODULI), rows, n), dtype=np.uint64)

        def plain(fn, words, *args):
            full[mi] = words
            return _u64(fn(tables.ntt if fn.__module__.endswith("ntt64") else tables,
                           u64_tensor(full), *args))[mi]

        for of in (4, 1):
            np.testing.assert_array_equal(model_forward(pl, x4, log_n, of),
                                          plain(ntt64.ntt64_forward_plain, x4, of))
        np.testing.assert_array_equal(model_forward(pl, x, log_n, 1, any_words=True),
                                      plain(ntt_mxu8.mxu8_forward64_plain, x))
        np.testing.assert_array_equal(model_inverse(pl, x4, log_n, 2, in_factor=4),
                                      plain(ntt64.ntt64_inverse_plain, x4, 2, 4))
        np.testing.assert_array_equal(model_inverse(pl, x, log_n, 1, load="any"),
                                      plain(ntt_mxu8.mxu8_inverse64_plain, x))
        np.testing.assert_array_equal(model_inverse(pl, x, log_n, 1, load="key", key=mt_np[mi]),
                                      plain(ntt_mxu8.mxu8_inverse64_mul_plain, x, mt))
        np.testing.assert_array_equal(model_roundtrip(pl, x, log_n, mt_np[mi]),
                                      plain(ntt_mxu8.mxu8_roundtrip64_mul_plain, x, mt))


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_cluster_stages_once_and_half_warps(log_n):
    """The cross stages and the slice's passes run every stage of the row
    once, in order, on both sides; a slice is 128 KB (one block's shared
    memory, 8 blocks at most: a portable cluster); each half-warp of the
    cross stages' sweep (16 consecutive offsets, 8-byte words) hits 16
    distinct words mod 16."""
    lc, l = log_n - SLICE_LOG, SLICE_LOG
    assert 1 <= lc <= 3 and 8 << l == 128 * 1024
    fwd = list(range(lc)) + [lc + s0 + e for s0, r in forward_passes(l) for e in range(r)]
    inv = [s0 + e for s0, r in inverse_passes(l) for e in range(r)] + list(range(l, log_n))
    assert fwd == inv == list(range(log_n))
    for js in shares(l, lc):
        assert all(len(set(w.tolist())) == 16 for w in (swz64(js) % 16).reshape(-1, 16))
