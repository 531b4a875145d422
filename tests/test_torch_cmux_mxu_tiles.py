"""A numpy model of kernels A and B as they run on Hopper (``csrc/cmux_mxu.cu``):
the wgmma passes read the stream-order tables ``w2g``/``wi1g``
(``ops/cmux_mxu.wgmma_layout``) stage by stage through the shared-memory
descriptors (core matrices, LBO/SBO), the operands sit in shared memory in
core-matrix order (``wg_op_offset``), each thread's accumulator fragments
map back to ``(c, r1, m)`` as the kernel's epilogue reads them, and the key
rows arrive in the producer's stage order (the 32-bit plane reduction and
the cluster choice have tests of their own below).  The model equals
``mxu_cmux_step_plain`` / ``ntru_cmux_step_plain`` word for word at
BOOLEAN_128's and NTRU_128's shapes, a 2-byte-digit case, three primes,
chunked operands (more than 96 rows) and log_n 8 to 12, so the tables and
index maps are right before a card runs them.

Tolerance: zero (bit-equal words).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_mxu, ntt_mxu8
from primus_fhe_tpu_torch.ops.ntru_cmux_mxu import get_ntru_plan, ntru_cmux_step_plain
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

B = 128
STAGE = 16384
MAX_N = 96
KEY_WORDS = STAGE // 8


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _chunk_width(rows):
    return next(w for w in (8, 16, 32, 48, 64, 96) if rows <= w) if rows <= MAX_N else MAX_N


def _wg_rows(rows):
    """``wg_padded_rows``: rows an operand occupies in chunks."""
    full = (rows - 1) // MAX_N
    return full * MAX_N + _chunk_width(rows - full * MAX_N)


def _op_offset(m, word):
    """``wg_op_offset`` of ``csrc/mxu8.cuh`` (numpy-broadcast)."""
    return ((((m >> 3) << 5) + (word >> 2)) << 7) + ((m & 7) << 4) + ((word & 3) << 2)


def _desc_rows(buf, start, lbo, sbo, rows):
    """The ``rows x 32`` bytes a K-major, no-swizzle wgmma descriptor at
    byte ``start`` reads: row r, byte k at ``start + (r / 8) sbo + (k / 16)
    lbo + (r % 8) 16 + k % 16``."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return buf[start + (r >> 3) * sbo + (k >> 4) * lbo + (r & 7) * 16 + (k & 15)]


def _store_words(op, rows_idx, words_idx, vals):
    """u32 words into the operand bytes at ``wg_op_offset``."""
    at = _op_offset(rows_idx, words_idx)
    v = vals.astype(np.uint32)
    for byte in range(4):
        op[at + byte] = ((v >> (8 * byte)) & 255).astype(np.uint8)


def _wg_pass(table, op, rows, q):
    """Forward pass 2 / inverse pass 1: ``table`` (16 stages of 16 KB, int8)
    against ``rows`` operand rows of ``op`` (uint8) -> ``V[m][r1]``
    canonical mod q, read back through the kernel's fragment map."""
    stages = table.reshape(16, STAGE).view(np.uint8)
    out = np.zeros((rows, B), dtype=np.int64)
    for m0 in range(0, rows, MAX_N):
        nw = _chunk_width(rows - m0)
        opc = (m0 >> 3) * 4096
        for rnd in range(2):
            for wg in range(2):
                d = np.zeros((2, 64, nw), dtype=np.int64)
                for ks in range(8):
                    st = stages[rnd * 8 + ks]
                    for kk in range(2):
                        bt = _desc_rows(op, opc + (2 * ks + kk) * 256, 128, 4096, nw)
                        for s in range(2):
                            at = _desc_rows(st, wg * 8192 + s * 4096 + kk * 2048, 128, 256, 64)
                            d[s] += at.view(np.int8).astype(np.int64) @ bt.astype(np.int64).T
                # tile s of pair u sits in warpgroup 2 * wg + s; its thread (warp w,
                # lane 4g + t) holds r1 = 32u + 8w + g, column m = 8j + 2t + e, planes
                # 2s (d[4j + e], row g) and 2s + 1 (d[4j + 2 + e], row g + 8)
                u = 2 * rnd + wg
                for w in range(4):
                    for g in range(8):
                        r1 = 32 * u + 8 * w + g
                        planes = [d[0, 16 * w + g], d[0, 16 * w + 8 + g],
                                  d[1, 16 * w + g], d[1, 16 * w + 8 + g]]
                        val = sum(p << (8 * c) for c, p in enumerate(planes)) % q
                        m = np.arange(nw)
                        keep = m0 + m < rows
                        out[m0 + m[keep], r1] = val[keep]
    return out


def _planes(a_bytes, w, np_, n_real, q):
    """``mm_planes_w`` + ``reduce_planes32`` (the two mma.sync passes)."""
    d = a_bytes.astype(np.int64) @ w.astype(np.int64).T
    d = d.reshape(-1, 4, np_)[:, :, :n_real]
    return (d * (1 << (8 * np.arange(4)))[None, :, None]).sum(1) % q


def _key_stages(kv, kpre, n, k1, level):
    """The producer's key stages in order: stage s -> (j, h, r, l) decoded
    as ``produce`` does, values at word 0 and quotients at word 2048."""
    kw = min(n, KEY_WORDS)
    halves = n // kw
    out = []
    for s in range(k1 * halves * k1 * level):
        l, r = s % level, (s // level) % k1
        h, j = (s // (level * k1)) % halves, s // (level * k1 * halves)
        st = np.zeros(STAGE // 4, dtype=np.int64)
        st[:kw] = kv[r, l, j, h * kw:(h + 1) * kw]
        st[KEY_WORDS:KEY_WORDS + kw] = kpre[r, l, j, h * kw:(h + 1) * kw]
        out.append(st)
    return out, kw, halves


def _model_block(plan, tabs, pi, q, digits, dp, kv, kpre, k1, level):
    """One (ciphertext, prime) block: signed digits ``(k1 * L, n)`` -> y
    ``(k1, n)`` canonical mod q (the folded inverse scale included)."""
    A, n = plan.A, plan.n
    P = k1 * level
    nf, ni = P * A, k1 * A
    # forward pass 1 (mma.sync) + twiddle -> operand rows (poly, r0), words k0
    x = digits.reshape(P, A, B).transpose(0, 2, 1)
    w1 = tabs[f"w1_{dp}"][pi]
    s0 = x.astype(np.int8)
    planes = [s0, ((x - s0.astype(np.int64)) >> 8).astype(np.int8)][:dp]
    a1 = np.zeros((P * B, w1.shape[1]), dtype=np.int8)
    a1[:, :A * dp] = np.stack(planes, -1).reshape(P * B, A * dp)
    X = _planes(a1, w1, w1.shape[0] // 4, A, q).reshape(P, B, A).transpose(0, 2, 1)
    tw, twp, twi, twip = (tabs["tw"][pi][i].reshape(A, B) for i in range(4))
    Y = (X * tw - q * ((X * twp) >> 32)) & 0xFFFFFFFF  # [poly][r0][k0], lazy
    op = np.zeros(max(_wg_rows(nf), _wg_rows(ni)) * 512, dtype=np.uint8)
    rows = (np.arange(P)[:, None] * A + np.arange(A))[:, :, None]
    m, k0 = np.broadcast_arrays(rows, np.arange(B))
    _store_words(op, m, k0, Y)
    # forward pass 2 (wgmma) -> F[poly][r0 * B + r1]
    F = _wg_pass(tabs["w2g"][pi], op, nf, q).reshape(P, n)
    # MAC, key rows from the stage stream
    stages, kw, halves = _key_stages(kv, kpre, n, k1, level)
    op[:] = 0
    it = 0
    for j in range(k1):
        for h in range(halves):
            s = np.zeros(kw, dtype=np.int64)
            for r in range(k1):
                for l in range(level):
                    st = stages[it]
                    it += 1
                    f = F[r * level + l, h * kw:(h + 1) * kw]
                    t = (st[:kw] * f - q * ((f * st[KEY_WORDS:KEY_WORDS + kw]) >> 32)) & 0xFFFFFFFF
                    s = (s + t % q) % q
            c = h * kw + np.arange(kw)
            _store_words(op, j * A + (c >> 7), c & (B - 1), s)
    assert it == len(stages)
    # inverse pass 1 (wgmma) + twiddle -> inverse pass-2 operand [(j, k0)][r0]
    Z = _wg_pass(tabs["wi1g"][pi], op, ni, q).reshape(k1, A, B)
    Zt = ((Z * twi - q * ((Z * twip) >> 32)) & 0xFFFFFFFF).transpose(0, 2, 1)
    wi2 = tabs["wi2"][pi]
    a4 = np.zeros((k1 * B, wi2.shape[1]), dtype=np.uint8)
    a4[:, :4 * A] = np.ascontiguousarray(Zt.reshape(k1 * B, A).astype(np.uint32)).view(
        np.uint8).reshape(k1 * B, 4 * A)
    y = _planes(a4, wi2, wi2.shape[0] // 4, A, q)
    return y.reshape(k1, B, A).transpose(0, 2, 1).reshape(k1, n)


def _tables(plan):
    tabs = {k: v.numpy().astype(np.int64) if v.dtype != torch.int8 else v.numpy()
            for k, v in plan.kernel_tables("cpu").items()}
    tabs["tw"] = tabs["tw"] & 0xFFFFFFFF
    return tabs


def test_wgmma_layout_is_a_row_permutation():
    """Stage ``round * 8 + ks``, tile ``(wg, s, kk)``, row ``16w + 8h + g``
    holds plane ``c = 2s + h`` of output ``r1 = 32(2 round + wg) + 8w + g``,
    K bytes ``64 ks + 32 kk + [0, 32)``."""
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (512, 512)).astype(np.int8)
    flat = cmux_mxu.wgmma_layout(w)
    assert flat.shape == (16 * STAGE,)
    for rnd, ks, wg, s, kk, w_, h, g in [(0, 0, 0, 0, 0, 0, 0, 0), (1, 7, 1, 1, 1, 3, 1, 7),
                                           (0, 3, 1, 0, 1, 2, 1, 5), (1, 2, 0, 1, 0, 1, 0, 3)]:
        tile = (rnd * 8 + ks) * STAGE + ((wg * 2 + s) * 2 + kk) * 2048
        got = _desc_rows(flat.view(np.uint8), tile, 128, 256, 64)[16 * w_ + 8 * h + g]
        row = (2 * s + h) * B + 32 * (2 * rnd + wg) + 8 * w_ + g
        np.testing.assert_array_equal(got.view(np.int8), w[row, 64 * ks + 32 * kk:][:32])


@pytest.mark.parametrize("rows", [1, 8, 12, 33, 96, 97, 144, 192])
def test_chunk_widths_cover_rows(rows):
    """Chunks of at most 96 rows at int8 wgmma widths cover every row once."""
    covered, m0 = [], 0
    while m0 < rows:
        w = _chunk_width(rows - m0)
        assert w in (8, 16, 32, 48, 64, 96) and w >= min(rows - m0, MAX_N)
        covered += list(range(m0, min(m0 + w, rows)))
        m0 += MAX_N
    assert covered == list(range(rows)) and _wg_rows(rows) >= rows


@pytest.mark.parametrize(
    "log_n,log_basis,level,k,bound",
    [(11, 7, 3, 1, None),   # BOOLEAN_128
     (8, 10, 2, 2, None),   # 2-byte digits, k = 2 (k1 * L * A = 12: a padded chunk)
     (8, 8, 2, 1, None),
     (9, 6, 2, 1, 75),      # three primes
     (11, 7, 3, 2, None),   # 144 operand rows: chunks of 96 and 48
     (12, 7, 3, 1, None)],  # 192 operand rows, key rows over two stages
)
def test_tile_model_cmux_matches_plain(log_n, log_basis, level, k, bound):
    n, k1 = 1 << log_n, k + 1
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    conv = (tfhe.make_convolver(log_n, level, k, log_basis) if bound is None
            else TorusConvolver32(log_n, bound))
    plan = cmux_mxu.plan_for(conv)
    dp = cmux_mxu.digit_planes(basis)
    tabs = _tables(plan)
    rng = np.random.default_rng(log_n * 7 + level)
    acc = rng.integers(0, 1 << 32, (1, k1, n), dtype=np.int64)
    degrees = np.array([2 * n - 3])
    ggsw = torch.from_numpy(rng.integers(0, 1 << 32, (1, k1, level, k1, n), dtype=np.int64))
    kv, kpre = (x[0] for x in cmux_mxu.prepare_mxu_bsk(conv, ggsw))
    want = cmux_mxu.mxu_cmux_step_plain(conv, basis, _t(acc), torch.tensor(degrees), kv)
    kp = len(conv.primes)
    kvn = kv.reshape(kp, k1, level, k1, n).numpy()
    kpn = kpre.reshape(kp, k1, level, k1, n).numpy()
    idx = (np.arange(n) - degrees[0]) % (2 * n)
    rotated = np.where(idx >= n, (-acc[0][:, idx % n]) & 0xFFFFFFFF, acc[0][:, idx % n])
    digits = basis.decompose(_t((rotated - acc[0]) & 0xFFFFFFFF)).numpy()  # (L, k1, n)
    digits = digits.transpose(1, 0, 2).reshape(k1 * level, n)
    digits = np.where(digits >= 1 << 31, digits - (1 << 32), digits)
    ys = [_model_block(plan, tabs, pi, p, digits, dp, kvn[pi], kpn[pi], k1, level)
          for pi, p in enumerate(conv.primes)]
    total = sum(np.asarray(y, dtype=object) * (conv.product // p) for y, p in zip(ys, conv.primes))
    v = np.array([[int(t) % conv.product for t in row] for row in total], dtype=object)
    v = np.where(v > conv.product // 2, v - conv.product, v)
    got = ((acc[0].astype(object) + v) % (1 << 32)).astype(np.int64)
    np.testing.assert_array_equal(got, want[0].numpy())


@pytest.mark.parametrize("log_n,q,log_basis,level",
                         [(10, 1038337, 3, 6),  # NTRU_128
                          (8, 1038337, 10, 2)])  # 2-byte digits
def test_tile_model_ntru_matches_plain(log_n, q, log_basis, level):
    n = 1 << log_n
    plan = get_ntru_plan(log_n, q)
    basis = ApproxSignedBasis32(q, log_basis, level)
    dp = cmux_mxu.digit_planes(basis)
    tabs = _tables(plan)
    rng = np.random.default_rng(log_n + level)
    acc = rng.integers(0, q, (1, n), dtype=np.int64)
    degrees = np.array([n + 5])
    kv = ntt_mxu8.mxu8_forward32_plain(plan, _t(rng.integers(0, q, (1, level, n))))[0]
    kpre = cmux_mxu.shoup_precons(kv[None], (q,), 0)[0]
    want = ntru_cmux_step_plain(plan, basis, _t(acc), torch.tensor(degrees), kv)
    d = basis.decompose(_t(acc[0])).numpy()  # (L, n) canonical mod q
    signed = np.where(d > basis.basis_minus_one, d - q, d)
    kvn = kv.numpy().reshape(1, level, 1, n)
    kpn = kpre.numpy().reshape(1, level, 1, n)
    delta = _model_block(plan, tabs, 0, q, signed, dp, kvn, kpn, 1, level)[0]
    idx = (np.arange(n) - degrees[0]) % (2 * n)
    src = delta[idx % n]
    rot = np.where((idx >= n) & (src != 0), q - src, src)
    np.testing.assert_array_equal((acc[0] + rot - delta) % q, want[0].numpy())


def test_cluster_choice():
    """C: at most 8 blocks a cluster and the batch; the largest C of the
    fewest waves, given how many clusters the card holds at once."""
    def room(c):  # no limit
        return 1 << 20

    assert [cmux_mxu.cluster_ciphertexts(b, 2, room) for b in (1, 3, 5, 64)] == [1, 3, 4, 4]
    assert cmux_mxu.cluster_ciphertexts(64, 1, room) == 8
    assert cmux_mxu.cluster_ciphertexts(9, 3, room) == 2
    # 16 clusters of 8 blocks do not fit at once, 32 of 4 do: C = 2 at kp = 2
    fits = {4: 9, 3: 11, 2: 32, 1: 66}.__getitem__
    assert cmux_mxu.cluster_ciphertexts(64, 2, fits) == 2
    assert cmux_mxu.cluster_ciphertexts(16, 2, fits) == 4
    # nothing fits in one wave: the fewest waves, then the largest C
    assert cmux_mxu.cluster_ciphertexts(640, 2, fits) == 2


@pytest.mark.parametrize("q", [1073692673, 1073668097, 1038337, 998244353])
def test_plane_reduction_32bit_is_exact(q):
    """``reduce_planes32`` / ``plane_pair`` / ``plane_finish`` of
    ``csrc/mxu8.cuh`` in u32 arithmetic (Shoup per plane on d_c + 2^24, the
    offsets taken out by ``corr``) give the canonical sum_c 2^(8c) d_c mod q
    for plane sums |d_c| < 2^24, lazy ranges included."""
    m32 = (1 << 32) - 1
    ratio = (1 << 64) // q

    def lazy(v):  # barrett_lazy_wide, v < 2^64
        return (v - ((v * ratio) >> 64) * q) & m32

    def once(x, m):
        return x - m if x >= m else x

    w, wp = [1], []
    for c in range(4):
        x = w[c] << 32
        qh = (x * ratio) >> 64
        wp.append(qh + (x - qh * q >= q))
        w.append(once(lazy(w[c] << 8), q))
    off = 0
    for c in range(4):
        off = once(off + once(lazy(w[3] * w[c]), q), q)
    corr = (q - off) % q

    def pair(a, b, c0):
        t = [(w[c] * ((d + (1 << 24)) & m32) - q * ((((d + (1 << 24)) & m32) * wp[c]) >> 32)) & m32
             for d, c in ((a, c0), (b, c0 + 1))]
        assert all(x < 2 * q for x in t)
        return once(t[0] + t[1], 2 * q)

    rng = np.random.default_rng(q % 1000)
    edge = [-(1 << 24) + 1, (1 << 24) - 1, 0, -1, 1]
    cases = [list(x) for x in rng.integers(-(1 << 24) + 1, 1 << 24, (4000, 4))]
    cases += [[edge[(i >> (3 * c)) % 5] for c in range(4)] for i in range(625)]
    for ds in cases:
        x = once(pair(ds[0], ds[1], 0) + pair(ds[2], ds[3], 2), 2 * q) + corr
        got = once(x - 2 * q if x >= 2 * q else x, q)
        assert got == sum(int(d) << (8 * c) for c, d in enumerate(ds)) % q
