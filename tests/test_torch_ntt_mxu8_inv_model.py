"""A numpy model of ``mxu8_inverse64`` and kernel D (``mxu8_inverse64_mul``)
as they run on Hopper (``csrc/ntt_mxu8.cu``, ``ntt_mxu8_inverse64_kernel<P,
MUL>``): one block a (modulus, tile of R rows, slice of S of pass 1's 128
output columns k0), on explicit grids (R, S) (the launch's own pick lives
in the C source; there are no clusters: no block reads another's output);
the tile's words loaded into pass 1's operand rows at ``wg_op_offset64`` by
the kernel's 16-byte units (eight row-neighbours a phase), kernel D's key
multiplied in by a lazy Shoup at load (at A >= 8 each key pair read once a
tile, its unit taken in every row); the producer's stage order, the
slice's ``wi1s`` stages and then the whole ``wi2s`` into the tile's freed
operand buffer (``ntt_mxu8.inverse_stream_tables``); pass 1 on ``wgmma``
with its operands read through the kernel's descriptors (two M tiles: one a
warpgroup, all 16 P rows of a stage; one M tile: half of a stage's rows a
warpgroup, at 7 planes with the n-group of the other half read and
dropped), N rows in plane-major groups so a thread holds every plane of its
outputs; the fold, the Shoup by ``twi[r0][k0]`` and the store of word r0 of
pass 2's operand row (row, k0) into K-major core matrices of kb1 bytes;
pass 2's tasks (64-row M tile, 16 outputs k1) over the two warpgroups on
the resident ``wi2``; canonical words stored at ``out[row n + k1 128 +
k0]``, rows past a partial tile stored nowhere.  Shared memory the kernel
does not write first holds random bytes, so a read of it would show.

It runs the schedule with exact integer products and equals
``mxu8_inverse64_plain`` and ``mxu8_inverse64_mul_plain`` word for word at
log_n 8-12, 7 and 8 planes, the key multiply on and off, two moduli, rows
1, 3, R + 1 and 17 (partial tiles), inputs over the whole u64 range, every
output written exactly once; the stream tables are the plane matrices
stage by stage; the plain versions equal the JAX ``mxu8_fused_inverse64``
and ``mxu8_fused_inverse64_mul`` (interpret mode) at log_n 8; on CPU tensors
the wrappers are the plain versions.

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
SMEM_MAX, SLOT, MAX_SLOTS = 232448, 16384, 8  # csrc/ntt_mxu8.cu FWD_SMEM_MAX, FWD_SLOT, ...
GROUPS, KCHUNKS = 8, 8  # INV_GROUPS, INV_KCHUNKS


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


def _op_offset64(m, word):
    """``wg_op_offset64``: byte offset of u64 word ``word`` of operand row ``m``."""
    return ((((m >> 3) << 6) + (word >> 1)) << 7) + ((m & 7) << 4) + ((word & 1) << 3)


def _desc_read(buf, starts, lbo, sbo, rows):
    """The ``rows x 32 len(starts)`` bytes that K-major, no-swizzle wgmma
    descriptors at ``starts`` (one a k-step) read: row r, byte k of k-step t
    at ``starts[t] + (r / 8) sbo + (k / 16) lbo + (r % 8) 16 + k % 16``."""
    r = np.arange(rows)[:, None, None]
    k = np.arange(32)[None, None, :]
    at = np.asarray(starts)[None, :, None] + (r >> 3) * sbo + (k >> 4) * lbo + (r & 7) * 16 + (k & 15)
    return buf[at].reshape(rows, -1)


def _product(a, b):
    """Exact ``a (M, K) u8 @ b (N, K) s8 .T`` (every sum below 2^53)."""
    return (a.astype(np.float64) @ b.view(np.int8).astype(np.float64).T).astype(np.int64)


def geometry(log_n, P, R, S):
    """``inv_geometry`` (csrc/ntt_mxu8.cu) and whether the block fits."""
    n = 1 << log_n
    A = n // 128
    np1, kb1 = -(-A // 8) * 8, -(-8 * A // 32) * 32
    kbc = min(kb1, 128)
    g = dict(n=n, A=A, np1=np1, kb1=kb1, g1=-(-np1 // 16), kbc=kbc, k1c=kb1 // kbc,
             cols=128 // S, groups=GROUPS // S, rows1=-(-R * A // 64) * 64,
             rows2=-(-R * (128 // S) // 64) * 64, w1_bytes=P * 2048, w2_bytes=512 * P * (kbc // 32))
    g["nw2"] = g["g1"] * g["k1c"]
    x = max(g["rows1"] * 1024, g["nw2"] * g["w2_bytes"])
    fixed = x + g["rows2"] * kb1 + 16
    slots = MAX_SLOTS
    while slots > 2 and slots * (SLOT + 16) + fixed > SMEM_MAX:
        slots -= 1
    g.update(x_bytes=x, slots=slots, smem=slots * SLOT + fixed + 16 * slots)
    g["fits"] = R * A <= 128 and g["smem"] <= SMEM_MAX
    return g


def _n_rows(P, start, count):
    """Plane and output (of a stage's 16) of each of ``count`` N rows read from
    n-group ``start`` on: n-group j holds plane ``j % P`` of outputs ``8 (j / P)
    + rho``."""
    j = start + np.arange(count) // 8
    return j % P, 8 * (j // P) + np.arange(count) % 8


def _planes(acc, planes, outs, P):
    """``acc (M, N)`` columns (plane, output) -> ``d (M, 16, P)`` for the
    outputs present (every plane of each), and a mask of those outputs."""
    d = np.zeros((acc.shape[0], 16, P), dtype=np.int64)
    have = np.zeros((16, P), dtype=bool)
    d[:, outs, planes] = acc
    have[outs, planes] = True
    return d, have.all(axis=1)


def _block(tables, tabs, x, key, mi, tile, sl, R, S, geo, out, written, rng):
    P, n, A, kb1, cols = tables.planes, geo["n"], geo["A"], geo["kb1"], geo["cols"]
    rows = x.shape[1]
    row0 = tile * R
    g_rows = min(R, rows - row0)
    c = _consts(tables, mi)
    q = c["q"]
    twi = tabs["tw"][mi].view(np.uint64).astype(object)[2:]  # twi, its quotient
    sx = rng.integers(0, 256, geo["x_bytes"], dtype=np.uint8)
    sy = rng.integers(0, 256, geo["rows2"] * kb1, dtype=np.uint8)

    # load: unit u -> (row m of 8-row group u / 512, word pair, row u % 8); for
    # D at A >= 8 the units of the tile's first row, each in every row
    m_real1 = g_rows * A
    if key is not None and A % 8 == 0:
        u = np.arange(A * 64)
        j = np.arange(g_rows)[:, None]
        m = ((((u >> 9) << 3) + (u & 7)) + j * A).reshape(-1)
        w = np.broadcast_to(2 * ((((u >> 5) & 15) << 2) + ((u >> 3) & 3)), (g_rows, u.size))
        w = w.reshape(-1)
    else:
        u = np.arange(-(-m_real1 // 8) * 8 * 64)
        m = ((u >> 9) << 3) + (u & 7)
        w = 2 * ((((u >> 5) & 15) << 2) + ((u >> 3) & 3))
        keep = m < m_real1
        m, w = m[keep], w[keep]
    assert np.unique(m * 128 + w).size == m_real1 * 64  # each word pair once
    words = x[mi, row0:row0 + g_rows].reshape(-1, 128)[m[:, None], w[:, None] + np.arange(2)]
    if key is not None:
        ci = (m % A)[:, None] * 128 + w[:, None] + np.arange(2)
        words = _shoup(words.astype(object), key[mi, 0][ci], key[mi, 1][ci], q).astype(np.uint64)
    at = _op_offset64(m, w)
    sx[at[:, None] + np.arange(16)] = np.ascontiguousarray(words).view(np.uint8).reshape(-1, 16)

    # pass 1: the slice's wi1 stages in the producer's order, column group by group
    w1b = geo["w1_bytes"]
    stages = tabs["wi1s"][mi].view(np.uint8)[(sl * geo["stages"]) * w1b:]
    k0s = sl * cols
    stores = np.zeros((geo["rows2"], A), dtype=np.int64)
    it = 0
    for cg in range(geo["groups"]):
        k0g = 16 * (sl * geo["groups"] + cg)
        for wg in range(2):
            if geo["mtiles1"] == 2:  # M tile wg, all of each stage's 16 P rows
                a_tile, nrows, start = wg * 8 * 8192, 16 * P, 0
            else:  # the one M tile, half wg of the rows from n-group wg (2P - 8)
                a_tile, nrows, start = 0, 64, wg * (2 * P - 8)
            a = _desc_read(sx, [a_tile + (kc * 8 + 2 * s) * 128 for kc in range(KCHUNKS)
                                for s in range(4)], 128, 8192, 64)
            b = np.concatenate([_desc_read(stages[(it + kc) * w1b:(it + kc + 1) * w1b],
                                           [s * 512 * P + start * 256 for s in range(4)], 128,
                                           256, nrows) for kc in range(KCHUNKS)], axis=1)
            planes, outs = _n_rows(P, start, nrows)
            d, have = _planes(_product(a, b), planes, outs, P)
            if geo["mtiles1"] == 1:
                have &= np.arange(16) // 8 == wg  # the other half's n-group is dropped
            mm = 64 * (wg if geo["mtiles1"] == 2 else 0) + np.arange(64)
            ok = mm < m_real1
            k0 = k0g + np.arange(16)[have]
            row, r0 = mm[ok] // A, mm[ok] % A
            idx = r0[:, None] * 128 + k0[None, :]
            y = _shoup(_fold(d[ok][:, have], c), twi[0][idx], twi[1][idx], q).astype(np.uint64)
            m2 = row[:, None] * cols + k0[None, :] - k0s
            at = ((m2 >> 3) * (kb1 >> 4) + (r0[:, None] >> 1)) * 128 + (m2 & 7) * 16 + (
                r0[:, None] & 1) * 8
            sy[at[..., None] + np.arange(8)] = np.ascontiguousarray(y).view(np.uint8).reshape(*y.shape, 8)
            np.add.at(stores, (m2, np.broadcast_to(r0[:, None], m2.shape)), 1)
        it += KCHUNKS
    assert it == geo["stages"]
    m_real2 = g_rows * cols
    assert (stores[:m_real2] == 1).all() and (stores[m_real2:] == 0).all()

    # wi2 into the tile's operand buffer, then pass 2's tasks
    w2b, nw2 = geo["w2_bytes"], geo["nw2"]
    assert nw2 * w2b <= geo["x_bytes"]
    sx[:nw2 * w2b] = tabs["wi2s"][mi].view(np.uint8)
    for t in range(geo["mtiles2"] * geo["g1"]):  # on warpgroup t % 2
        mt, g = divmod(t, geo["g1"])
        a = _desc_read(sy, [mt * 64 * kb1 + (kk * geo["kbc"] // 16 + 2 * s) * 128
                            for kk in range(geo["k1c"]) for s in range(geo["kbc"] // 32)],
                       128, 8 * kb1, 64)
        b = np.concatenate([_desc_read(sx[(g * geo["k1c"] + kk) * w2b:], [
            s * 512 * P for s in range(geo["kbc"] // 32)], 128, 256, 16 * P)
            for kk in range(geo["k1c"])], axis=1)
        planes, outs = _n_rows(P, 0, 16 * P)
        d, _ = _planes(_product(a, b), planes, outs, P)
        mm = 64 * mt + np.arange(64)
        k1 = 16 * g + np.arange(16)
        ok_m, ok_k = mm < m_real2, k1 < A
        vals = _canonical(_fold(d[ok_m][:, ok_k], c), c)
        row = mm[ok_m] // cols
        k0 = k0s + mm[ok_m] % cols
        col = k1[ok_k][None, :] * 128 + k0[:, None]
        out[mi, row0 + row[:, None], col] = vals
        written[mi, row0 + row[:, None], col] += 1


def _model(tables, x, grid, key=None):
    """``mxu8_inverse64`` (or, with ``key (count, 2, n)`` object ints, kernel
    D) on ``x (count, rows, n)`` uint64 as the kernel's blocks compute it ->
    ``(count, rows, n)`` uint64, and how many times each word was stored."""
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    R, S = grid
    geo = geometry(tables.log_n, tables.planes, R, S)
    assert geo["fits"]
    geo.update(mtiles1=geo["rows1"] // 64, mtiles2=geo["rows2"] // 64,
               stages=geo["groups"] * KCHUNKS)
    count, rows, n = x.shape
    out = np.zeros((count, rows, n), dtype=object)
    written = np.zeros((count, rows, n), dtype=np.int64)
    rng = np.random.default_rng(7)
    tiles = -(-rows // R)
    for bx in range(count * tiles * S):
        sl, tile, mi = bx % S, (bx // S) % tiles, bx // (S * tiles)
        _block(tables, tabs, x, key, mi, tile, sl, R, S, geo, out, written, rng)
    return out.astype(np.uint64), written


@functools.lru_cache(maxsize=None)
def _tables(log_n, planes):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, Q50 if planes == 7 else Q8P))
    assert tables.planes == planes
    return tables


def _fitting(log_n, R, S):
    """``S``, doubled until the block fits (at the largest tile S = 1 never
    does, and at log_n 8 not S = 2 either)."""
    while not geometry(log_n, 8, R, S)["fits"]:
        S *= 2
    return S


# (rows, tile, slices); R is the largest tile, 128 / A rows: two M tiles in
# pass 1 at "R", one below.  On an H100 the launch picks, at log_n 12, (1, 8)
# for two moduli of 2 rows (phase 10's batch 1), (4, 8) for two of 32 (its
# batch 16), (4, 4) for one of 16 (a residue shard), (4, 2) for one of 512
# (kernel D in bench.py's round trip).
GRIDS = [("1", "1", 8), ("3", "R/2", 4), ("R+1", "R", 2), ("17", "R/2", 1)]


@pytest.mark.parametrize("mul", [False, True])
@pytest.mark.parametrize("rows,tile,slices", GRIDS)
@pytest.mark.parametrize("planes", [7, 8])
@pytest.mark.parametrize("log_n", [8, 9, 10, 11, 12])
def test_inverse_schedule_model_matches_plain(log_n, planes, rows, tile, slices, mul):
    tables = _tables(log_n, planes)
    r_max = 128 // tables.A
    nrows = {"1": 1, "3": 3, "R+1": r_max + 1, "17": 17}[rows]
    R = {"1": 1, "R/2": r_max // 2, "R": r_max}[tile]
    grid = (R, _fitting(log_n, R, slices))
    rng = np.random.default_rng(log_n * 100 + planes * 10 + nrows + mul)
    n = 1 << log_n
    x = rng.integers(0, 1 << 64, (2, nrows, n), dtype=np.uint64)
    x[:, 0, :4] = [0, M64, 1 << 63, tables.moduli[0]]
    if mul:
        kv = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in tables.moduli])
        kv[:, :2] = [[0, q - 1] for q in tables.moduli]
        mt = tables.mul_table(u64_tensor(kv))
        got, written = _model(tables, x, grid, u64_numpy(mt).astype(object))
        want = ntt_mxu8.mxu8_inverse64_mul_plain(tables, u64_tensor(x), mt)
    else:
        got, written = _model(tables, x, grid)
        want = ntt_mxu8.mxu8_inverse64_plain(tables, u64_tensor(x))
    assert (written == 1).all()
    np.testing.assert_array_equal(got, u64_numpy(want))


@pytest.mark.parametrize("planes", [7, 8])
@pytest.mark.parametrize("log_n", [8, 9, 10, 11, 12])
def test_inverse_stream_tables_are_the_plane_matrices(log_n, planes):
    """Every stage of ``wi1s``/``wi2s``, read back through the kernel's
    ``wgmma`` descriptors, is its block of the kernel-layout ``wi1``/``wi2``:
    column group ``cg`` (16 outputs k0), k-chunk ``kc`` of pass 1's at ``cg *
    8 + kc`` stages from the modulus's start; group ``g`` (16 outputs k1),
    k-chunk ``kk`` of pass 2's; row ``n`` of a k-step is plane ``(n / 8) %
    P`` of output ``8 ((n / 8) / P) + n % 8`` of the stage's 16 (zero past
    the matrix)."""
    tables = _tables(log_n, planes)
    tabs = {k: v.numpy() for k, v in tables.kernel_tables("cpu").items()}
    P, geo = planes, geometry(log_n, planes, 1, 8)
    np1, kb1, kbc = geo["np1"], geo["kb1"], geo["kbc"]
    planes_n, outs_n = _n_rows(P, 0, 16 * P)
    for mi in range(2):
        wi1 = tabs["wi1"][mi].reshape(P, 128, 1024)
        wi2 = tabs["wi2"][mi].reshape(P, np1, kb1)
        b1 = geo["w1_bytes"]
        assert tabs["wi1s"][mi].size == wi1.size
        for i in range(GROUPS * KCHUNKS):
            cg, kc = divmod(i, KCHUNKS)
            stage = tabs["wi1s"][mi][i * b1:(i + 1) * b1].view(np.uint8)
            got = _desc_read(stage, [s * 512 * P for s in range(4)], 128, 256, 16 * P)
            want = wi1[planes_n, 16 * cg + outs_n, 128 * kc:128 * kc + 128]
            np.testing.assert_array_equal(got.view(np.int8), want)
        b2 = geo["w2_bytes"]
        assert tabs["wi2s"][mi].size == geo["nw2"] * b2
        for i in range(geo["nw2"]):
            g, kk = divmod(i, geo["k1c"])
            stage = tabs["wi2s"][mi][i * b2:(i + 1) * b2].view(np.uint8)
            got = _desc_read(stage, [s * 512 * P for s in range(kbc // 32)], 128, 256, 16 * P)
            k1 = 16 * g + outs_n
            want = np.where((k1 < np1)[:, None],
                            wi2[planes_n, np.minimum(k1, np1 - 1), kk * kbc:(kk + 1) * kbc], 0)
            np.testing.assert_array_equal(got.view(np.int8), want)


def test_plain_matches_jax_fused_inverse():
    """The plain versions (which the model equals) against the JAX
    byte-radix kernels in interpret mode at one small shape, 7 planes: the
    inverse and the inverse with a key multiply."""
    tables = _tables(8, 7)
    rng = np.random.default_rng(9)
    x = rng.integers(0, Q50[1], (2, 3, 256), dtype=np.uint64)
    key = np.stack([rng.integers(0, q, 256, dtype=np.uint64) for q in Q50])
    got = u64_numpy(ntt_mxu8.mxu8_inverse64(tables, u64_tensor(x)))
    got_d = u64_numpy(ntt_mxu8.mxu8_inverse64_mul(tables, u64_tensor(x),
                                                  tables.mul_table(u64_tensor(key))))
    for mi, q in enumerate(Q50):
        jplan = jmxu.Mxu8NttPlan64(8, q)
        np.testing.assert_array_equal(got[mi], jfrom(jmxu.mxu8_fused_inverse64(jplan, jto(x[mi]), 1)))
        want_d = jmxu.mxu8_fused_inverse64_mul(jplan, jto(x[mi]), jplan.inverse_mul_tabs(key[mi]), 1)
        np.testing.assert_array_equal(got_d[mi], jfrom(want_d))


@pytest.mark.parametrize("out_factor", [1, 2, 4])
@pytest.mark.parametrize("mul", [False, True])
def test_wrappers_on_cpu_tensors_are_the_plain_versions(mul, out_factor):
    """On CPU tensors both wrappers return their plain version's canonical
    words for each ``out_factor`` they accept, and refuse any other."""
    tables = _tables(8, 7)
    rng = np.random.default_rng(out_factor + 10 * mul)
    x = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (2, 3, 256), dtype=np.int64))
    if mul:
        mt = tables.mul_table(u64_tensor(np.stack([rng.integers(0, q, 256, dtype=np.uint64)
                                                   for q in Q50])))
        run = lambda f: ntt_mxu8.mxu8_inverse64_mul(tables, x, mt, f)
        plain = ntt_mxu8.mxu8_inverse64_mul_plain(tables, x, mt)
    else:
        run = lambda f: ntt_mxu8.mxu8_inverse64(tables, x, f)
        plain = ntt_mxu8.mxu8_inverse64_plain(tables, x)
    if out_factor == 4:
        with pytest.raises(ValueError):
            run(out_factor)
        return
    got = run(out_factor)
    assert torch.equal(got, plain)
    q = torch.tensor(tables.moduli, dtype=torch.int64).reshape(-1, 1, 1)
    assert bool(((got >= 0) & (got < q)).all())
