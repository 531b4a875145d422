"""A numpy model of row 13's column halves K1 and Ki2 (``split_col_kernel``
in ``csrc/ntt_mxu8_split.cu``), held against the plain versions
``ops.ntt_mxu8_split.split_k1_plain`` / ``split_ki2_plain`` on the CPU, and
the column root tables held to the pass matrices they replace.

Each lane's A words go through pass 1's A-point negacyclic transform (K1:
log A Cooley-Tukey stages, natural in, bit-reversed out, then the twiddle
``tw[r0][k0]``) or inverse pass 2's (Ki2: log A Gentleman-Sande stages,
bit-reversed in, natural out, ``1/n`` folded into the last stage) as
butterflies on the root tables ``Mxu8Tables64.split_tables()["col"]`` /
``["col_inv"]``: row 10's tables (``build_plan64`` at ``log_A`` on
``psi^128``) in the radix passes' layout, the inverse's word 0 holding the
last stage's ``1/n`` times its root.

The model runs the kernel's data flow as written: the grid of moduli x
blocks (of 128 threads in the kernel; 64 and 256 too here); T threads a lane (1 for A <= 16, 4 for A
= 32, A / 16 above), W = A / T words a thread, a warp 32 / T adjacent
lanes (lane index ``u (32 / T) + c``), a ragged last block's dead threads
running on the last lane and storing nothing; the two layouts, L2 (thread u
holds words u W + r) for the stages within a thread's W words and L1
(thread u holds words j W + u G + i, G = W / T) for the stages W apart or
more, the forward loading in L1 and storing from L2, the inverse the other
way round, one layout change through the warp's slice of shared memory (W
words a thread, word k of column c at ((k ^ f(k)) 32 / T + c), f(k) = ((k
>> log G) ^ (k >> log W)) mod T / 2); the table
staged into the block's shared memory (seeded with random words, every
read checked against what was written); each word brought to [0, 2q) as it
loads (a lazy Shoup multiply by 1), but the forward's stage-0 y words.
Every shared-memory access of a warp is checked free of bank conflicts
(each half-warp's 8-byte accesses on 16 distinct bank pairs), every word
inside its lazy range (forward [0, 4q), inverse [0, 2q); q up to 2^62),
every output word written once.  Tolerance: zero (Ki2 bit-equal; K1 below
2q and equal mod q, the lazy rule of ``ops/ntt_mxu8_split.py``).
"""

import numpy as np
import pytest

from test_torch_ntt64_model import _u64, check_words, shoup
from test_torch_ntt_rt64_model import Smem
from test_torch_split_rows_model import Conflicts
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
from primus_fhe_tpu_torch.transforms.ntt import forward64, inverse64
from primus_fhe_tpu_torch.transforms.plan import build_plan64
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

B = 128
THREADS = (64, 128, 256)  # blocks the model runs (the kernel's: COL_THREADS)
COL_THREADS = 128
Q50 = 1125899906826241  # bench.py's q: 7 byte planes, = 1 mod 2^14
Q60 = 1152921504606830593  # 8 planes
Q62 = 4611686018427322369  # lazy [0, 4q) words pass 2^63
Q14 = next_ntt_prime(50, 14)  # = 1 mod 2^15: log_n 14
Q14_8 = next_ntt_prime(60, 14)  # the same, 8 planes
M64 = (1 << 64) - 1


def geometry(log_a: int):
    """``(T, W, G, lanes a warp)``: threads a lane, words a thread, L1's
    groups (``csrc`` ``col_log_t``)."""
    log_t = 0 if log_a <= 4 else 2 if log_a == 5 else log_a - 4
    t, w = 1 << log_t, 1 << (log_a - log_t)
    return t, w, w // t, 32 // t


def col_slot(k, c, T, W, G):
    """``col_slot``: the word of the warp's slice holding word k of column c."""
    f = ((k // G) ^ (k // W)) & (T // 2 - 1) if T > 1 else 0
    return (k ^ f) * (32 // T) + c


def smem_words(log_a: int, threads: int) -> int:
    """``col_smem`` in words: the table, then W words a thread where T > 1."""
    T, W, _, _ = geometry(log_a)
    return 2 * (1 << log_a) + (threads * W if T > 1 else 0)


# -- the tables -----------------------------------------------------------


@pytest.mark.parametrize("log_n,q", [(8, Q50), (12, Q50), (13, Q50), (14, Q14), (12, Q60)])
def test_col_tables_give_m1_and_m1i(log_n, q):
    """``col`` is ``build_plan64(log_A, q, root=psi^128)``'s forward table
    and its forward transform is ``m1``; ``col_inv`` is that plan's inverse
    table (word 0: ``1/n`` times its last root) and its inverse times
    ``1/128`` is ``m1i``: the identity that lets K1 / Ki2 run butterflies."""
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, [q]))
    tabs = tables.split_tables("cpu")
    A = tables.A
    psi = int(tables.ntt.plans[0].ordinal_roots[1])
    plan = build_plan64(log_n - 7, q, root=pow(psi, B, q))
    fwd, inv = (_u64(tabs[k][0]).astype(object) for k in ("col", "col_inv"))
    assert fwd.shape == inv.shape == (2, A)
    np.testing.assert_array_equal(fwd[0], _u64(plan.roots).astype(object))
    np.testing.assert_array_equal(inv[0][1:], _u64(plan.inv_roots).astype(object)[1:])
    assert inv[0][0] == pow(1 << log_n, -1, q) * int(_u64(plan.inv_roots)[A - 1]) % q
    for t in (fwd, inv):
        assert all(t[1][i] == (int(t[0][i]) << 64) // q for i in range(A))
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, q, (1, A, 7), dtype=np.uint64)
    m1 = split._pass_plain(tables, "m1", u64_tensor(x))[0]
    assert (_u64(m1) == _u64(forward64(plan, u64_tensor(x[0].T)).T)).all()
    m1i = _u64(split._pass_plain(tables, "m1i", u64_tensor(x))[0]).astype(object)
    want = _u64(inverse64(plan, u64_tensor(x[0].T)).T).astype(object) * pow(B, -1, q) % q
    assert (m1i == want).all()


@pytest.mark.parametrize("log_a", range(1, 8))
def test_layouts_cover_each_word_once(log_a):
    """A lane's A words over its T threads, W each, every word once in L1
    and in L2; a warp holds 32 / T whole lanes; L1's groups hold the stages
    W apart or more (the forward's first log T, the inverse's last log T),
    L2's the rest; the slot map is one-to-one on the warp's slice, and
    every 8-byte access of either layout change is free of bank conflicts;
    the shared memory fits 227 KB."""
    T, W, G, cpw = geometry(log_a)
    A = 1 << log_a
    assert T * W == A and W <= 16 and T * cpw == 32 and (T <= 2 or G >= 2)
    u = np.arange(32) // cpw
    c = np.arange(32) % cpw
    l1 = [sorted(j * W + uu * G + i for j in range(T) for i in range(G)) for uu in range(T)]
    l2 = [list(range(uu * W, uu * W + W)) for uu in range(T)]
    for lay in (l1, l2):
        assert sorted(sum(lay, [])) == list(range(A))
    for s_ in range(log_a):  # forward stage s pairs words A >> (s + 1) apart
        d = A >> (s_ + 1)
        lay = l1 if s_ < log_a - (W.bit_length() - 1) else l2
        assert all((k ^ d) in lay[uu] for uu in range(T) for k in lay[uu])
    if T > 1:
        slots = [col_slot(k, cc, T, W, G) for k in range(A) for cc in range(cpw)]
        assert sorted(slots) == list(range(32 * W))
        for r in range(W):
            for k_of in (lambda uu: r // G * W + uu * G + r % G, lambda uu: uu * W + r):
                words = np.array([col_slot(k_of(uu), cc, T, W, G) for uu, cc in zip(u, c)])
                Conflicts.check(words, 8)
    assert all(smem_words(log_a, t) * 8 <= 232448 for t in THREADS)


# -- the model ------------------------------------------------------------


def model_cols(tables, kind, x, threads, batch=1, k0_off=0, seed=0):
    """``split_col_kernel`` on ``x (count, A, lanes)`` (any u64 words):
    ``kind`` "k1" or "ki2", blocks of ``threads`` threads."""
    count, A, lanes = x.shape
    log_a = A.bit_length() - 1
    T, W, G, cpw = geometry(log_a)
    log_t, log_w = T.bit_length() - 1, W.bit_length() - 1
    per_block = threads // 32 * cpw
    inverse = kind == "ki2"
    rng = np.random.default_rng(seed)
    tabs = {k: _u64(v) for k, v in tables.split_tables("cpu").items()}
    tw_all = tabs["tw"]
    pack = tables.ntt.mod_pack.reshape(-1, 9)
    out = np.zeros_like(x)
    writes = np.zeros(x.shape, dtype=np.int64)
    tid = np.arange(threads)
    lane = tid & 31
    u, cw = lane // cpw, lane % cpw
    r_ = np.arange(W)[:, None]
    l1 = (r_ // G) * W + u[None, :] * G + r_ % G  # (W, threads): word of register r
    l2 = u[None, :] * W + r_
    slice0 = 2 * A + (tid >> 5)[None, :] * 32 * W  # each thread's warp slice
    for mi in range(count):
        q, inv_n, inv_n_p, p1 = int(pack[mi, 0]), pack[mi, 1], pack[mi, 2], pack[mi, 7]
        two_q = np.uint64(2 * q)
        g = tabs["col_inv" if inverse else "col"][mi]  # (2, A)
        for b in range(-(-lanes // per_block)):
            col = b * per_block + (tid >> 5) * cpw + cw
            live = col < lanes
            c = np.where(live, col, lanes - 1)
            sm = Smem(smem_words(log_a, threads), rng)

            def table(ti):
                """The staged roots and quotients at ``ti`` (one per thread):
                the threads of a lane part read one word."""
                ti = np.broadcast_to(ti, (threads,))
                for w0 in range(0, threads, 32):
                    assert len(np.unique(ti[w0:w0 + 32])) <= T
                return sm.read(ti), sm.read(A + ti)

            def relayout(v, src, dst):
                """Registers in layout ``src`` -> layout ``dst`` through the
                warps' slices (8-byte accesses, a __syncwarp between)."""
                for r in range(W):
                    words = slice0[0] + col_slot(src[r], cw, T, W, G)
                    for w0 in range(0, threads, 32):
                        Conflicts.check(words[w0:w0 + 32] - slice0[0][w0], 8)
                    sm.write(words, v[r])
                got = np.empty_like(v)
                for r in range(W):
                    words = slice0[0] + col_slot(dst[r], cw, T, W, G)
                    for w0 in range(0, threads, 32):
                        Conflicts.check(words[w0:w0 + 32] - slice0[0][w0], 8)
                    got[r] = sm.read(words)
                return got

            lay_in = l2 if inverse else l1
            v = x[mi][lay_in, c[None, :]].copy()  # (W, threads)
            if not inverse:
                k0 = k0_off + c // batch
                f, fp = tw_all[mi, 0][l2 * B + k0], tw_all[mi, 1][l2 * B + k0]
            red = np.arange(W) < (W if inverse else W // 2)  # the forward's stage-0 x words
            v[red] = shoup(v[red], 1, p1, q)
            check_words(v[red], 2 * q)
            sm.write(np.arange(2 * A), g.reshape(-1))
            with np.errstate(over="ignore"):
                if not inverse:
                    for e in range(log_t):  # in L1, on each group of T words
                        h = (T >> (e + 1)) * G  # registers j G + i, j T >> (e + 1) apart
                        for r in range(W):
                            j = r // G
                            if j & (T >> (e + 1)):
                                continue
                            _fwd_bf(v, r, r + h, *table((1 << e) + (j >> (log_t - e))), q)
                    if T > 1:
                        v = relayout(v, l1, l2)
                    for e in range(log_w):  # in L2, on the thread's words
                        h = W >> (e + 1)
                        for r in range(W):
                            if r & h:
                                continue
                            ti = (1 << (log_t + e)) + (u << e) + (r >> (log_w - e))
                            _fwd_bf(v, r, r + h, *table(ti), q)
                    v = shoup(v, f, fp, q)
                    check_words(v, 2 * q)
                else:
                    for e in range(log_w if log_t else log_w - 1):  # in L2
                        h = 1 << e
                        for r in range(W):
                            if r & h:
                                continue
                            ti = 1 + A - (A >> e) + u * (W >> (e + 1)) + (r >> (e + 1))
                            _inv_bf(v, r, r + h, *table(ti), q)
                    fy, fyp = table(0)  # the last stage's x - y factor
                    if T > 1:
                        v = relayout(v, l2, l1)
                        for e in range(log_t - 1):  # in L1, on each group
                            h = (1 << e) * G
                            for r in range(W):
                                j = r // G
                                if j & (1 << e):
                                    continue
                                ti = 1 + A - (A >> (log_w + e)) + (j >> (e + 1))
                                _inv_bf(v, r, r + h, *table(ti), q)
                    h = W // 2  # the last stage: registers W / 2 apart in either layout
                    for r in range(h):
                        xk, yk = v[r].copy(), v[r + h].copy()
                        s_ = xk + yk
                        v[r] = shoup(np.where(s_ >= two_q, s_ - two_q, s_), inv_n, inv_n_p, q)
                        v[r + h] = shoup(xk + two_q - yk, fy, fyp, q)
                    check_words(v, 2 * q)
                    v = np.where(v >= np.uint64(q), v - np.uint64(q), v)
            lay_out = l1 if inverse else l2
            cols_ = np.broadcast_to(col, (W, threads))
            keep = np.broadcast_to(live, (W, threads))
            out[mi][lay_out[keep], cols_[keep]] = v[keep]
            np.add.at(writes[mi], (lay_out[keep], cols_[keep]), 1)
    assert (writes == 1).all()  # every output word written exactly once
    return out


def _fwd_bf(v, i, j, w, wp, q):
    """Harvey butterfly on registers i, j of ``v``: inputs below 4q (y any
    word in stage 0: the Shoup multiply takes it), outputs below 4q."""
    two_q = np.uint64(2 * q)
    check_words(v[i], 4 * q)
    tx = np.where(v[i] >= two_q, v[i] - two_q, v[i])
    ty = shoup(v[j], w, wp, q)
    with np.errstate(over="ignore"):
        v[i], v[j] = tx + ty, tx + two_q - ty
    check_words(v[i], 4 * q)
    check_words(v[j], 4 * q)


def _inv_bf(v, i, j, w, wp, q):
    """Gentleman-Sande butterfly on slots i, j of ``v``: inputs below 2q."""
    two_q = np.uint64(2 * q)
    xk, yk = v[i].copy(), v[j].copy()
    check_words(xk, 2 * q)
    check_words(yk, 2 * q)
    s = xk + yk
    with np.errstate(over="ignore"):
        d = xk + two_q - yk
    v[i] = np.where(s >= two_q, s - two_q, s)
    v[j] = shoup(d, w, wp, q)
    check_words(v[i], 2 * q)
    check_words(v[j], 2 * q)


# -- the model against the plain versions ------------------------------------


def _case(moduli, log_n, lanes, seed):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 64, (len(moduli), tables.A, lanes), dtype=np.uint64)
    for i, q in enumerate(moduli):  # the word extremes
        x[i, 0, :3] = [0, q, M64]
        x[i, -1, -3:] = [M64, 2 * q - 1, 4 * q]
    return tables, x


def _lazy_equal(got, want, moduli):
    for mi, q in enumerate(moduli):
        g = got[mi].astype(object)
        assert (g < 2 * q).all()
        np.testing.assert_array_equal((g % q).astype(np.uint64), want[mi])


@pytest.mark.parametrize("log_n,moduli,lanes,batch,k0_off,threads", [
    (8, [Q50], 37, 1, 0, 64), (9, [Q60], 96, 3, 5, 128), (10, [Q62], 64, 2, 16, 64),
    (11, [Q50, Q62], 70, 7, 3, 256), (12, [Q50], 128, 2, 64, 64), (12, [Q60], 33, 33, 127, 128),
    (13, [Q50], 128, 2, 64, 64), (13, [Q60], 40, 5, 100, 256), (14, [Q14], 64, 2, 96, 64),
    (14, [Q14_8], 24, 3, 7, 128)])
def test_col_model_matches_plain(log_n, moduli, lanes, batch, k0_off, threads):
    """K1 below 2q and equal mod q to its plain version and Ki2 bit-equal,
    at every A (2 to 128: one thread a lane to 32 words, 2 and 4 threads a
    lane at A = 64, 128), shard offsets k0_off > 0, batch 1-33, ragged last
    blocks, one or two moduli, 7 and 8 planes, the word extremes in."""
    tables, x = _case(moduli, log_n, lanes, log_n + lanes)
    want = _u64(split.split_k1_plain(tables, u64_tensor(x), batch, k0_off))
    _lazy_equal(model_cols(tables, "k1", x, threads, batch, k0_off), want, moduli)
    want = _u64(split.split_ki2_plain(tables, u64_tensor(x)))
    np.testing.assert_array_equal(model_cols(tables, "ki2", x, threads), want)


def test_blocks_at_phase_16():
    """128 threads a block (``COL_THREADS``): 32768 lanes at D = 2 and 16384
    at D = 4 (512 rows, A = 32: 4 threads a lane) make 1024 and 512 blocks,
    the n = 2^14 shards (A = 128, 8 threads a lane) 2048 and 1024; every
    block's shared memory fits the 48 KB a launch gets without opting in."""
    for log_a, lanes, blocks in ((5, 32768, 1024), (5, 16384, 512), (7, 32768, 2048),
                                 (7, 16384, 1024)):
        T = geometry(log_a)[0]
        assert -(-lanes // (COL_THREADS // T)) == blocks
    assert max(smem_words(a, COL_THREADS) for a in range(1, 8)) * 8 <= 48 * 1024
