"""A numpy model of ``mxu8_forward64`` as it runs on Hopper
(``csrc/ntt_mxu8.cu``): one block a (modulus, tile of R rows, slice of S of
pass 2's output columns), clusters of C = min(S, 2 R) slices of a tile, on
explicit grids (R, S) that give clusters of 1, 2, 4 and 8 blocks (the
launch's own pick lives in the C source); the producer's stage order over
the stream tables ``w1s``/``w2s`` (``ntt_mxu8.forward_stream_tables``);
pass 1 on chunks of 64 operand rows (a row's ``k0`` half, halves outer),
chunk ``ch`` by the cluster's block ``ch % C``, its words copied into the
chunk buffer at the kernel's offsets and its outputs stored into every
block's operand rows at ``wg_op_offset64`` (each word once in each block);
both passes on ``wgmma`` with their operands read through the kernel's
descriptors (pass 1: the chunk's rows as M, each warpgroup's 16 r0 as N;
pass 2: the operand rows' M tiles, or one tile split over k by the two
warpgroups), N rows in plane-major groups so a thread holds every plane of
its outputs; pass 2 accumulating each column group over its eight k-chunk
stages; each slice's outputs stored at their bit-reversed positions
``out[row0 * n + m * 128 + r1]``, rows past a partial tile stored nowhere.
It runs the schedule with exact integer products and equals
``mxu8_forward64_plain`` word for word at log_n 8-12, 7 and 8 planes, two
moduli and rows 1, 3, R + 1 and 17 (partial tiles), every output written
exactly once;
the plain version equals the JAX ``mxu8_fused_forward64`` (interpret mode)
at log_n 8; on CPU tensors the wrapper is the plain version.

Tolerance: zero (bit-equal words).
"""

import functools

import numpy as np
import pytest
import torch

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops import ntt_mxu8 as jmxu
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8

Q50 = [1125899906826241, 1125899906629633]  # 7 planes
Q8P = [1152921504606830593, 4611686018427322369]  # 60- and 62-bit: 8 planes
M64 = (1 << 64) - 1
TILE_OPERAND_ROWS = 128  # pass-2 operand rows (row, r0) a tile holds at most
LDA2 = 8 * 128 + 32  # the kernel's pass-2 operand row stride (bytes)


def _shoup(y, w, wp, q):
    """``w*y - q*hi(y*wp)`` mod 2^64 on object ints (csrc shoup64_lazy)."""
    return (w * y - q * ((y * wp) >> 64)) & M64


def _consts(tables, mi):
    pack = tables.ntt.mod_pack.reshape(-1, 9)[mi].astype(object)
    return dict(zip(("q", "inv_n", "inv_n_p", "inv_n_w", "inv_n_w_p", "c32", "c32_p", "p1",
                     "off"), (int(v) for v in pack)))


def _fold(d, c):
    """csrc ``fold_planes`` on ``d (..., P)`` int64 plane sums -> object words."""
    d = d.astype(object)
    P = d.shape[-1]
    lo = sum(d[..., i] * (1 << (8 * i)) for i in range(4))
    hi = sum(d[..., i] * (1 << (8 * (i - 4))) for i in range(4, P))
    return (lo + c["off"]) + _shoup(hi + c["off"], c["c32"], c["c32_p"], c["q"])


def _canonical(y, c):
    r = _shoup(y, 1, c["p1"], c["q"])
    return np.where(r >= c["q"], r - c["q"], r)


def _products(a, w):
    """Exact plane sums ``d[m, n, c] = sum_k a[m, k] w[c, n, k]``."""
    P, nn, kb = w.shape
    return (a @ w.reshape(P * nn, kb).T).reshape(a.shape[0], P, nn).transpose(0, 2, 1)


def _op_offset64(m, word):
    """``wg_op_offset64``: byte offset of u64 word ``word`` of operand row ``m``."""
    return ((((m >> 3) << 6) + (word >> 1)) << 7) + ((m & 7) << 4) + ((word & 1) << 3)


def _desc_read(buf, start, lbo, sbo, rows):
    """The ``rows x 32`` bytes a K-major, no-swizzle wgmma descriptor at
    ``start`` reads: row r, byte k at ``start + (r / 8) sbo + (k / 16) lbo +
    (r % 8) 16 + k % 16``."""
    r = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    return buf[start + (r >> 3) * sbo + (k >> 4) * lbo + (r & 7) * 16 + (k & 15)]


def _n_map(P):
    """A wgmma N side of 16 P rows: row n holds plane ``(n / 8) % P`` of
    output ``8 ((n / 8) / P) + n % 8`` of the stage's 16."""
    n = np.arange(16 * P)
    return (n >> 3) % P, 8 * ((n >> 3) // P) + (n & 7)


def _pass1_chunk(words, stages, tw, c, h, A, kb1, P):
    """One chunk (a row's k0 half ``h``, ``words (A, 64)`` as ``[k1][k0]``),
    copied into the chunk buffer at the kernel's offsets and multiplied by
    the ``w1`` stages through the kernel's wgmma descriptors, folded and
    twiddled -> ``(A, 64)`` words ``[r0][k0]``."""
    kbc = min(kb1, 128)
    k1c = kb1 // kbc
    g1 = len(stages) // k1c
    sc = np.zeros(64 * kb1, dtype=np.uint8)
    k0 = np.arange(64)[:, None]
    w = np.arange(words.shape[0])[None, :]
    at = ((k0 >> 3) * (kb1 >> 4) + (w >> 1)) * 128 + (k0 & 7) * 16 + (w & 1) * 8  # copy_chunk
    b = np.ascontiguousarray(words.T.astype(np.uint64)).view(np.uint8).reshape(64, -1, 8)
    for byte in range(8):
        sc[at + byte] = b[:, :, byte]
    n_c, n_r = _n_map(P)
    y = np.zeros((A, 64), dtype=object)
    for wg in range(g1):
        acc = np.zeros((64, 16 * P), dtype=np.int64)
        for kk in range(k1c):
            stage = stages[wg * k1c + kk].view(np.uint8)
            for s32 in range(kbc // 32):
                a = _desc_read(sc, (kk * kbc // 16 + 2 * s32) * 128, 128, 8 * kb1, 64)
                bm = _desc_read(stage, s32 * 512 * P, 128, 256, 16 * P).view(np.int8)
                acc += a.astype(np.int64) @ bm.astype(np.int64).T
        d = np.zeros((64, 16, P), dtype=np.int64)
        d[:, n_r, n_c] = acc
        r0 = 16 * wg + np.arange(16)
        keep = r0 < A
        idx = r0[keep][None, :] * 128 + (64 * h + np.arange(64))[:, None]
        y[r0[keep]] = _shoup(_fold(d[:, keep], c), tw[0][idx], tw[1][idx], c["q"]).T
    return y


def _model(tables, x, grid):
    """``mxu8_forward64`` on ``x (count, rows, n)`` uint64 as the kernel's
    clusters compute it -> ``(count, rows, n)`` uint64, and how many times
    each output word was stored."""
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    P, A, n = tables.planes, tables.A, tables.n
    count, rows = x.shape[:2]
    R, S = grid
    np1, kb1 = -(-A // 8) * 8, -(-8 * A // 32) * 32
    nw1 = -(-np1 // 16) * (kb1 // min(kb1, 128))
    w1b, w2b = 512 * P * (min(kb1, 128) // 32), P * 16 * 128
    groups = ntt_mxu8.FWD_GROUPS // S
    tiles = -(-rows // R)
    rows2 = -(-R * A // 64) * 64
    mtiles = rows2 // 64
    nw = 16 * P  # pass 2's N: n = 8 (c + P half) + rho holds plane c of r1 = 8 half + rho
    n_c, n_r1 = _n_map(P)
    out = np.zeros((count, rows, n), dtype=object)
    written = np.zeros((count, rows, n), dtype=np.int64)
    for cluster in range(count * tiles):  # blocks cluster * S + sl
        tile, mi = cluster % tiles, cluster // tiles
        row0 = tile * R
        g_rows = min(R, rows - row0)
        c = _consts(tables, mi)
        tw = tabs["tw"][mi].view(np.uint64).astype(object)
        w1m, w2m = tabs["w1s"][mi], tabs["w2s"][mi].view(np.uint8)
        w1v = [w1m[i * w1b:(i + 1) * w1b] for i in range(nw1)]
        # pass 1: chunk ch = (half ch / g_rows, row ch % g_rows) by rank ch % C
        # of each cluster of C slices, its words stored at wg_op_offset64 into
        # the operand rows of every block of that cluster
        C = min(S, 2 * R)  # a tile has 2 R chunks
        assert S % C == 0
        srs = [np.zeros(rows2 * 1024, dtype=np.uint8) for _ in range(C)]
        stores = np.zeros((C, rows2, 128), dtype=np.int64)
        for rank in range(C):
            for ch in range(rank, 2 * g_rows, C):
                h, r = divmod(ch, g_rows)
                words = x[mi, row0 + r].reshape(A, 128)[:, 64 * h: 64 * h + 64]
                y = _pass1_chunk(words, w1v, tw, c, h, A, kb1, P).astype(np.uint64)
                m = r * A + np.arange(A)[:, None]
                at = _op_offset64(m, 64 * h + np.arange(64)[None, :])  # (A, 64)
                b = np.ascontiguousarray(y).view(np.uint8).reshape(A, 64, 8)
                for q in range(C):
                    for byte in range(8):
                        srs[q][at + byte] = b[:, :, byte]
                    stores[q, r * A:(r + 1) * A, 64 * h: 64 * h + 64] += 1
        assert (stores[:, :g_rows * A] == 1).all() and (stores[:, g_rows * A:] == 0).all()
        assert all((sr == srs[0]).all() for sr in srs)
        sr = srs[0]
        m_real = g_rows * A
        for sl in range(S):
            # the producer's stages, in the consumers' order: w1, then the slice's w2
            first = sl * groups * ntt_mxu8.FWD_KCHUNKS
            it = 0
            for cg in range(groups):
                # per warpgroup: M tile wg, or (one M tile) k-steps 2 wg, 2 wg + 1
                part = np.zeros((2, rows2, nw), dtype=np.int64)
                for kc in range(ntt_mxu8.FWD_KCHUNKS):
                    stage = w2m[(first + it) * w2b:(first + it + 1) * w2b]
                    for wg in range(2):
                        mt = wg if mtiles == 2 else 0
                        steps = range(4) if mtiles == 2 else (2 * wg, 2 * wg + 1)
                        for s32 in steps:
                            a = _desc_read(sr, mt * 8 * 8192 + (kc * 8 + 2 * s32) * 128, 128,
                                           8192, 64).astype(np.int64)
                            bm = _desc_read(stage, s32 * 512 * P, 128, 256, nw)
                            bm = bm.view(np.int8).astype(np.int64)
                            part[wg, 64 * mt: 64 * mt + 64] += a @ bm.T
                    it += 1
                acc = part.sum(axis=0)  # (rows2, nw); one M tile: the halves' swap
                d = np.zeros((rows2, 16, P), dtype=np.int64)
                d[:, n_r1, n_c] = acc
                vals = _canonical(_fold(d[:m_real], c), c)  # (m_real, 16)
                r1 = 16 * (sl * groups + cg) + np.arange(16)
                for m in range(m_real):
                    row, r0 = row0 + m // A, m % A
                    out[mi, row, r0 * 128 + r1] = vals[m]
                    written[mi, row, r0 * 128 + r1] += 1
            assert it == groups * ntt_mxu8.FWD_KCHUNKS
    return out.astype(np.uint64), written


@functools.lru_cache(maxsize=None)
def _tables(log_n, planes):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, Q50 if planes == 7 else Q8P))
    assert tables.planes == planes
    return tables


# (rows, tile, slices); R is the largest tile, 128 / A rows.  At log_n 12
# (R = 4) the clusters are 2, 4, 8, 8, 2 and 1 blocks wide.  On an H100 the
# launch picks, for two moduli at log_n 12, (1, 8) at 1 row a modulus, (2,
# 8) at 5, (4, 8) at 16, (4, 2) at 64 and (4, 1) at 256; for one modulus of
# 64 rows (a residue shard), (4, 4).
GRIDS = [("1", "1", 8), ("3", "R/2", 8), ("R+1", "R", 8), ("17", "R", 4), ("R+1", "R", 2),
         ("17", "R", 1)]


@pytest.mark.parametrize("rows,tile,slices", GRIDS)
@pytest.mark.parametrize("planes", [7, 8])
@pytest.mark.parametrize("log_n", [8, 9, 10, 11, 12])
def test_forward_schedule_model_matches_plain(log_n, planes, rows, tile, slices):
    tables = _tables(log_n, planes)
    r_max = TILE_OPERAND_ROWS // tables.A
    nrows = {"1": 1, "3": 3, "R+1": r_max + 1, "17": 17}[rows]
    grid = ({"1": 1, "R/2": r_max // 2, "R": r_max}[tile], slices)
    rng = np.random.default_rng(log_n * 100 + planes * 10 + nrows)
    x = rng.integers(0, 1 << 64, (2, nrows, 1 << log_n), dtype=np.uint64)
    x[:, 0, :4] = [0, M64, 1 << 63, tables.moduli[0]]
    got, written = _model(tables, x, grid)
    assert (written == 1).all()
    want = u64_numpy(ntt_mxu8.mxu8_forward64_plain(tables, u64_tensor(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("planes", [7, 8])
@pytest.mark.parametrize("log_n", [8, 9, 10, 11, 12])
def test_stream_tables_are_the_plane_matrices(log_n, planes):
    """Every stage of ``w1s``/``w2s``, read back through the kernel's
    ``wgmma`` descriptors, is its block of the kernel-layout ``w1``/``w2``:
    r0 group ``g`` (of 16), k-chunk ``kk`` of pass 1's; column group ``cg``,
    k-chunk ``kc`` of pass 2's, at ``(cg * 8 + kc)`` stages from the
    modulus's start; row ``n`` of a k-step is plane ``(n / 8) % P`` of
    output ``16 g + 8 ((n / 8) / P) + n % 8`` (zero past the matrix)."""
    tables = _tables(log_n, planes)
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    P, A = planes, tables.A
    np1, kb1 = -(-A // 8) * 8, -(-8 * A // 32) * 32
    for mi in range(2):
        w1 = tabs["w1"][mi].reshape(P, np1, kb1).astype(np.int64)
        w2 = tabs["w2"][mi].reshape(P, 128, 1024).astype(np.int64)
        assert tabs["w2s"][mi].size == w2.size
        kbc = min(kb1, 128)
        b1 = 512 * P * (kbc // 32)
        n_c, n_r = _n_map(P)
        assert tabs["w1s"][mi].size == -(-np1 // 16) * (kb1 // kbc) * b1
        for i in range(-(-np1 // 16) * (kb1 // kbc)):
            g1, kk = divmod(i, kb1 // kbc)
            stage = tabs["w1s"][mi][i * b1:(i + 1) * b1].view(np.uint8)
            for s32 in range(kbc // 32):
                got = _desc_read(stage, s32 * 512 * P, 128, 256, 16 * P).view(np.int8)
                r0 = 16 * g1 + n_r
                k = kk * kbc + 32 * s32
                want = np.where((r0 < np1)[:, None],
                                w1[n_c, np.minimum(r0, np1 - 1), k:k + 32], 0)
                np.testing.assert_array_equal(got, want)
        b2 = P * 2048
        n = np.arange(16 * P)
        rows_n = ((n >> 3) % P) * 128 + 8 * ((n >> 3) // P) + (n & 7)  # (c, r1) of n
        for i in range(64):
            cg, kc = divmod(i, 8)
            stage = tabs["w2s"][mi][i * b2:(i + 1) * b2].view(np.uint8)
            for s32 in range(4):
                got = _desc_read(stage, s32 * 512 * P, 128, 256, 16 * P).view(np.int8)
                want = w2.reshape(P * 128, 1024)[rows_n + 16 * cg,
                                                 128 * kc + 32 * s32: 128 * kc + 32 * s32 + 32]
                np.testing.assert_array_equal(got, want)


def test_plain_matches_jax_fused_forward():
    """The plain version (which the model equals) against the JAX byte-radix
    kernel in interpret mode at one small shape, 7 planes."""
    tables = _tables(8, 7)
    rng = np.random.default_rng(8)
    x = rng.integers(0, Q50[1], (2, 3, 256), dtype=np.uint64)
    got = u64_numpy(ntt_mxu8.mxu8_forward64(tables, u64_tensor(x)))
    for mi, q in enumerate(Q50):
        want = jfrom(jmxu.mxu8_fused_forward64(jmxu.Mxu8NttPlan64(8, q), jto(x[mi]), 1))
        np.testing.assert_array_equal(got[mi], want)


@pytest.mark.parametrize("out_factor", [1, 2, 4, 3])
def test_wrapper_on_cpu_tensors_is_the_plain_version(out_factor):
    """On CPU tensors the wrapper returns the plain version's canonical
    words for each ``out_factor`` it accepts, and refuses any other."""
    tables = _tables(8, 7)
    x = torch.from_numpy(np.random.default_rng(out_factor).integers(
        -(1 << 63), (1 << 63) - 1, (2, 3, 256), dtype=np.int64))
    if out_factor == 3:
        with pytest.raises(ValueError):
            ntt_mxu8.mxu8_forward64(tables, x, out_factor)
        return
    got = ntt_mxu8.mxu8_forward64(tables, x, out_factor)
    assert torch.equal(got, ntt_mxu8.mxu8_forward64_plain(tables, x))
    q = torch.tensor(tables.moduli, dtype=torch.int64).reshape(-1, 1, 1)
    assert bool(((got >= 0) & (got < q)).all())
