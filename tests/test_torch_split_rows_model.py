"""A numpy model of row 13's row halves K2 and Ki1 (``split_row_kernel`` in
``csrc/ntt_mxu8_split.cu``), held word for word against the plain versions
``ops.ntt_mxu8_split.split_k2_plain`` / ``split_ki1_plain`` on the CPU.

Each row's 128 words go through pass 2's 128-point cyclic transform (K2:
7 Cooley-Tukey stages, natural in, bit-reversed out) or inverse pass 1's
(Ki1: 7 Gentleman-Sande stages, bit-reversed in, natural out, no 1/128)
as butterflies on the root tables ``Mxu8Tables64.kernel_tables()["cyclic"]``
/ ``["cyclic_inv"]``, in the radix passes' ``[2^s + k]`` layout.

The model runs the kernel's data flow as written: the grid of moduli x
tiles of T rows (T in 4, 8, 16, 32: one warp a quad of 4 rows, a ragged
last tile reading and writing only its own rows); a lane (r, t) = lane 4t +
r holds 16 words of row r of its warp's quad; a block's shared memory (the
staged table, the inverse's one word on, and a 1 KB slice a row, 16-byte
chunk (a, b) of slice r at 8a + (a ^ b ^ 2r)) seeded with random words,
every read checked against what was written before.

- K2: each word brought to [0, 2q) as it loads (a lazy Shoup multiply by
  1); after the table's barrier pass A on the lane's two groups 2t, 2t + 1
  (words 2t + 16k and 2t + 1 + 16k, loaded as 16-byte chunks t + 8k): stage
  0, whose root is 1, as the butterfly's adds, stages 1-2 on each half with
  the staged roots; the chunks into the slice; pass B, stages 3-6 on the lane's 16
  adjacent words 16t .. 16t + 15 (chunks 8t + j) with the staged table's runs;
  canonical words back into the same chunks; chunks t + 8k stored.
- Ki1: each word times its key word (a lazy Shoup multiply; by 1 without
  the key) as it loads chunks t + 8k; pass A', stages 0-3 on words 16t ..
  16t + 15; pass B', stages 4-5 on groups 2t, 2t + 1, then stage 6 with the
  twiddle ``twi[r0_off + row // batch][c]`` folded in (its root is 1), the
  output lazy in [0, 2q).

Every word is checked inside its lazy range (q up to 2^62, so 4q < 2^64),
every output word written exactly once.  It also checks the table layout,
the pass schedule, and that each phase of every shared-memory access is
free of bank conflicts: a 16-byte access's quarter-warps (8 lanes) hit 8
distinct 16-byte bank groups, an 8-byte access's half-warps (16 lanes) 16
distinct 8-byte bank pairs, lanes on one word counted once.  Tolerance:
zero (bit-equal for K2; Ki1 below 2q and equal mod q, the lazy rule of
``ops/ntt_mxu8_split.py``).
"""

import numpy as np
import pytest

from test_torch_ntt64_model import _u64, check_words, fwd_stages, shoup, tiles
from test_torch_ntt_rt64_model import Smem
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
from primus_fhe_tpu_torch.utils.bits import reverse_lsbs

B = 128  # words a row
TQ = 136  # the staged table's quotients, words on
ROWS0 = 2 * TQ  # the rows' slices, words on
TILES = (4, 8, 16, 32)
Q50 = 1125899906826241  # bench.py's q: 7 byte planes
Q60 = 1152921504606830593  # 8 planes
Q62 = 4611686018427322369  # lazy [0, 4q) words pass 2^63
M64 = (1 << 64) - 1
LANES = np.arange(32)
T_OF, R_OF = LANES >> 2, LANES & 3  # lane 4t + r


def chunk_at(r, a, b):
    """Word of chunk (a, b) (chunk 8a + b) of row r's slice in a warp's quad
    ``w``-relative layout: slice r at ``128 r``, chunk ``8a + (a ^ b ^ 2r)``."""
    return 128 * r + 2 * (8 * a + (a ^ b ^ (2 * r)))


def inv_start(s: int) -> int:
    """The inverse table's first word of stage s."""
    return B + 1 - (B >> s)


def fwd_runs(t):
    """Words of the forward table a lane reads in pass B (FwdTable::get<4>
    at s0 = 3, hi = t): stage 3's root, then runs of 2, 4 and 8."""
    return [(8 + t, 1), (16 + 2 * t, 2), (32 + 4 * t, 4), (64 + 8 * t, 8)]


def inv_runs(t):
    """Inverse-table indices of the runs a lane reads in pass A' (stages
    0-3 of group t): stage e's 8 >> e twiddles from 129 - (128 >> e) +
    (t << (3 - e))."""
    return [(inv_start(e) + (t << (3 - e)), 8 >> e) for e in range(4)]


# -- the tables -----------------------------------------------------------


@pytest.mark.parametrize("q", [Q50, Q60, Q62])
def test_tables_layout(q):
    """``cyclic`` and ``cyclic_inv``: stage s's block k at [2^s + k] =
    om_b^brv6(k), at [129 - (128 >> s) + j] = om_b^-brv6(j), om_b a
    primitive 128th root (the m2 matrix's), quotients floor(w 2^64 / q);
    word 0 unused."""
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, [q]))
    tabs = tables.kernel_tables("cpu")
    fwd, inv = (_u64(tabs[k][0]).astype(object) for k in ("cyclic", "cyclic_inv"))
    m2 = tables.plans[0].mats["m2"].astype(object)
    om = int(m2[reverse_lsbs(1, 7), 1])
    assert pow(om, 64, q) == q - 1 and pow(om, 128, q) == 1
    om_i = pow(om, -1, q)
    for s in range(7):
        for k in range(1 << s):
            assert fwd[0][(1 << s) + k] == pow(om, reverse_lsbs(k, 6), q)
        for j in range(64 >> s):
            assert inv[0][inv_start(s) + j] == pow(om_i, reverse_lsbs(j, 6), q)
    for t in (fwd, inv):
        assert t[0][0] == t[1][0] == 0
        assert all(t[1][i] == (int(t[0][i]) << 64) // q for i in range(1, B))
    assert inv_start(6) == B - 1 and inv[0][B - 1] == 1  # stage 6's root: Ki1 folds the twiddle in


def test_pass_schedule():
    """K2: 3 + 4 stages, Ki1: 4 + 3; every stage once; the groups a pass
    gives a lane cover each row's words once (pass A / B': groups 2t, 2t + 1
    at stride 16; pass B / A': 16 adjacent words), every chunk once per
    access."""
    a_words = np.array([[2 * t + u + 16 * k for k in range(8)] for t in range(8) for u in (0, 1)])
    b_words = np.array([[16 * t + i for i in range(16)] for t in range(8)])
    for words in (a_words, b_words):
        assert sorted(words.ravel().tolist()) == list(range(B))
    # pass A at s0 = 0, R = 3: group g's slots g + 16k (csrc/ntt_passes.cuh fwd_pass)
    for g in range(16):
        assert [g + (k << 4) for k in range(8)] == a_words[g].tolist()
    # pass B at s0 = 3, R = 4 (16 adjacent words, group hi = t), A' at s0 = 0
    for t in range(8):
        assert [(t << 4) + k for k in range(16)] == b_words[t].tolist()
    for t in range(8):  # chunks t + 8k (pass A, stores) and 8t + j (pass B) of lane t
        assert [(2 * t + 16 * k) // 2 for k in range(8)] == [t + 8 * k for k in range(8)]
    stages = list(range(3)) + list(range(3, 7))
    assert stages == list(range(7))


# -- the model ------------------------------------------------------------


class Conflicts:
    """Bank-conflict check of a warp's shared-memory access: ``words (32,)``
    the word each lane reads or writes, ``width`` 8 or 16 bytes."""

    @staticmethod
    def check(words, width):
        words = np.asarray(words)
        assert words.shape == (32,)
        if width == 16:
            assert (words % 2 == 0).all()
            for ph in range(4):  # quarter-warps: 8 distinct 16-byte bank groups
                w = np.unique(words[8 * ph:8 * ph + 8])
                assert len(set(((w // 2) % 8).tolist())) == len(w)
        else:
            for ph in range(2):  # half-warps: 16 distinct 8-byte bank pairs
                w = np.unique(words[16 * ph:16 * ph + 16])
                assert len(set((w % 16).tolist())) == len(w)


def _lanes(arr):
    """Per-lane values ``(32,)`` of a ``(4 r, 8 t)`` array."""
    return arr[R_OF, T_OF]


def model_rows(tables, kind, x, tile, batch=1, r0_off=0, key=None, seed=0):
    """``split_row_kernel`` on ``x (count, rows, 128)`` (any u64 words):
    ``kind`` "k2" or "ki1" (``key (count, 2, rows / batch * 128)`` or None)
    in tiles of ``tile`` rows."""
    count, rows, _ = x.shape
    assert tile in TILES
    rng = np.random.default_rng(seed)
    tabs = {k: _u64(v) for k, v in tables.kernel_tables("cpu").items()}
    tw_all, n = tabs["tw"], tables.n
    pack = tables.ntt.mod_pack.reshape(-1, 9)
    out = np.zeros_like(x)
    writes = np.zeros(x.shape, dtype=np.int64)
    inverse = kind == "ki1"
    sh = 1 if inverse else 0  # the staged table's word i at [i + sh]
    t_idx, r_idx = np.arange(8)[None, :], np.arange(4)[:, None]  # (4 r, 8 t) arrays
    for mi in range(count):
        q, p1 = int(pack[mi, 0]), pack[mi, 7]
        two_q = np.uint64(2 * q)
        g = tabs["cyclic_inv" if inverse else "cyclic"][mi]  # (2, 128)
        for row0, cnt in tiles(rows, tile):
            sm = Smem(ROWS0 + tile * B, rng)
            loaded = []
            for w in range(tile // 4):
                rws = row0 + 4 * w + r_idx + 0 * t_idx  # (4, 8): each lane's row
                live = (4 * w + r_idx + 0 * t_idx < cnt)
                # -- load chunks t + 8k (16-byte, coalesced: 8 lanes a row's 128 bytes)
                lo, hi_ = np.zeros((8, 4, 8), np.uint64), np.zeros((8, 4, 8), np.uint64)
                for k in range(8):
                    c = t_idx + 8 * k
                    rr = np.where(live, rws, row0)
                    x0, x1 = x[mi, rr, 2 * c], x[mi, rr, 2 * c + 1]
                    if inverse and key is not None:
                        kr = rr // batch
                        kw = key.shape[-1]
                        kv, kq = key[mi, 0], key[mi, 1]
                        assert kw == rows // batch * B
                        x0 = shoup(x0, kv[kr * B + 2 * c], kq[kr * B + 2 * c], q)
                        x1 = shoup(x1, kv[kr * B + 2 * c + 1], kq[kr * B + 2 * c + 1], q)
                    else:  # AnyIn64: a lazy Shoup multiply by 1
                        x0, x1 = shoup(x0, 1, p1, q), shoup(x1, 1, p1, q)
                    lo[k], hi_[k] = np.where(live, x0, 0), np.where(live, x1, 0)
                    check_words(lo[k], 2 * q)
                    check_words(hi_[k], 2 * q)
                loaded.append((lo, hi_))
            # -- the table lands (cp.async), one barrier
            sm.write(sh + np.arange(B), g[0])
            sm.write(TQ + sh + np.arange(B), g[1])
            for w in range(tile // 4):
                lo, hi_ = loaded[w]
                base = ROWS0 + 4 * w * B
                if not inverse:  # pass A on groups 2t, 2t + 1
                    tab = sm.read(np.arange(B)), sm.read(TQ + np.arange(B))
                    for v in (lo, hi_):
                        vv = v.reshape(1, 8, 32)  # (1, 8 slots, 32 lanes), a view
                        xk, yk = vv[:, :4].copy(), vv[:, 4:].copy()  # stage 0: root 1, adds
                        with np.errstate(over="ignore"):
                            vv[:, :4], vv[:, 4:] = xk + yk, xk + two_q - yk
                        check_words(vv, 4 * q)
                        for h in range(2):  # stages 1-2 on half h (stage 1's block h)
                            fwd_stages(vv[:, 4 * h:4 * h + 4], 1, 2, np.full(32, h), *tab, q, 0,
                                       False, reg=False)
                # -- the chunks t + 8k into the slice (16-byte stores)
                for k in range(8):
                    words = base + chunk_at(r_idx, k, t_idx)
                    Conflicts.check(_lanes(words) - ROWS0, 16)
                    sm.write(words, lo[k])
                    sm.write(words + 1, hi_[k])
            for w in range(tile // 4):
                rws = row0 + 4 * w + r_idx + 0 * t_idx
                live = (4 * w + r_idx + 0 * t_idx < cnt)
                base = ROWS0 + 4 * w * B

                def slice_words(a, b):
                    return base + chunk_at(r_idx, a, b)

                # -- pass B / A': the lane's 16 adjacent words, chunks 8t + j
                u = np.zeros((16, 4, 8), np.uint64)
                for j in range(8):
                    words = slice_words(t_idx, j)
                    Conflicts.check(_lanes(words) - ROWS0, 16)
                    u[2 * j], u[2 * j + 1] = sm.read(words), sm.read(words + 1)
                runs = inv_runs(t_idx[0]) if inverse else fwd_runs(t_idx[0])
                tw = {}
                for e, (start, length) in enumerate(runs):
                    for part in (0, TQ):  # values, quotients
                        for j in range(0, length, 2 if length > 1 else 1):
                            wds = np.broadcast_to(part + sh + start + j, (4, 8))
                            if length > 1:  # 16-byte run reads
                                Conflicts.check(_lanes(wds), 16)
                            else:
                                Conflicts.check(_lanes(wds), 8)
                    tw[e] = (sm.read(sh + start[:, None] + np.arange(length)),  # (8 t, length)
                             sm.read(TQ + sh + start[:, None] + np.arange(length)))
                if not inverse:
                    vv = u.reshape(16, 32).T.reshape(4, 8, 16).transpose(0, 2, 1)  # (4, 16, 8 t)
                    for e in range(4):
                        h = 1 << (3 - e)
                        for k in range(16):
                            if k & h:
                                continue
                            jj = k >> (4 - e)
                            wv, wq = tw[e][0][:, jj][None], tw[e][1][:, jj][None]
                            xk, yk = vv[:, k].copy(), vv[:, k + h].copy()
                            tx = np.where(xk >= two_q, xk - two_q, xk)
                            ty = shoup(yk, wv, wq, q)
                            with np.errstate(over="ignore"):
                                vv[:, k], vv[:, k + h] = tx + ty, tx + two_q - ty
                            check_words(vv[:, k], 4 * q)
                            check_words(vv[:, k + h], 4 * q)
                    vv = np.where(vv >= two_q, vv - two_q, vv)  # canonical
                    vv = np.where(vv >= np.uint64(q), vv - np.uint64(q), vv)
                    u = vv.transpose(1, 0, 2)  # (16, 4, 8)
                else:
                    for e in range(4):  # Gentleman-Sande stages 0-3, pairs at 2^e
                        h = 1 << e
                        for k in range(16):
                            if k & h:
                                continue
                            jj = k >> (e + 1)
                            wv, wq = tw[e][0][:, jj][None], tw[e][1][:, jj][None]
                            _inv_bf(u, k, k + h, wv, wq, q)
                for j in range(8):  # back into the same chunks
                    words = slice_words(t_idx, j)
                    sm.write(words, u[2 * j])
                    sm.write(words + 1, u[2 * j + 1])
                # -- __syncwarp, then chunks t + 8k
                v0, v1 = np.zeros((8, 4, 8), np.uint64), np.zeros((8, 4, 8), np.uint64)
                for k in range(8):
                    words = slice_words(k, t_idx)
                    Conflicts.check(_lanes(words) - ROWS0, 16)
                    v0[k], v1[k] = sm.read(words), sm.read(words + 1)
                if inverse:  # pass B': stages 4-5 (uniform twiddles), stage 6 with the twiddle
                    r0 = r0_off + np.where(live, rws, row0) // batch  # dead lanes: row0's
                    for v in (v0, v1):
                        for e in range(2):
                            h = 1 << e
                            for k in range(8):
                                if k & h:
                                    continue
                                ti = inv_start(4 + e) + (k >> (e + 1))
                                wv, wq = sm.read(sh + ti), sm.read(TQ + sh + ti)
                                _inv_bf(v, k, k + h, wv, wq, q)
                    for u_, v in ((0, v0), (1, v1)):
                        for k in range(4):
                            cx, cy = 2 * t_idx + u_ + 16 * k, 2 * t_idx + u_ + 16 * k + 64
                            twv = tw_all[mi, 2][r0 * B + cx], tw_all[mi, 2][r0 * B + cy]
                            twq = tw_all[mi, 3][r0 * B + cx], tw_all[mi, 3][r0 * B + cy]
                            xk, yk = v[k].copy(), v[k + 4].copy()
                            s = xk + yk
                            with np.errstate(over="ignore"):
                                d = xk + two_q - yk
                            v[k] = shoup(np.where(s >= two_q, s - two_q, s), twv[0], twq[0], q)
                            v[k + 4] = shoup(d, twv[1], twq[1], q)
                            check_words(v[k], 2 * q)
                            check_words(v[k + 4], 2 * q)
                # -- 16-byte stores of chunks t + 8k, live rows only
                for k in range(8):
                    c = t_idx + 8 * k
                    for r in range(4):
                        if not live[r, 0]:
                            continue
                        row = rws[r, 0]
                        out[mi, row, 2 * c[0]] = v0[k][r]
                        out[mi, row, 2 * c[0] + 1] = v1[k][r]
                        writes[mi, row, 2 * c[0]] += 1
                        writes[mi, row, 2 * c[0] + 1] += 1
            assert tw_all.shape[-1] == n
    assert (writes == 1).all()  # every output word written exactly once, by its tile
    return out


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


def _case(moduli, log_n, rows, seed):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 64, (len(moduli), rows, B), dtype=np.uint64)
    x[:, 0, :3] = [[0, q, M64] for q in moduli]  # the word extremes
    x[:, -1, -3:] = [[M64, 2 * q - 1, 4 * q] for q in moduli]
    return tables, x


def _key_rows(tables, rows, batch, r0_off, seed):
    """The shard's key rows ``(count, 2, rows / batch * 128)`` of a random
    canonical NTT-domain operand, as ``coeff_sharded_mxu`` cuts them."""
    rng = np.random.default_rng(seed)
    n, A = tables.n, tables.A
    key = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in tables.moduli])
    key[:, :2] = [[0, q - 1] for q in tables.moduli]
    mt = tables.mul_table(u64_tensor(key))
    al = rows // batch
    return mt.reshape(-1, 2, A, B)[:, :, r0_off:r0_off + al].reshape(-1, 2, al * B).contiguous()


def _lazy_equal(got, want, moduli):
    for mi, q in enumerate(moduli):
        g = got[mi].astype(object)
        assert (g < 2 * q).all()
        np.testing.assert_array_equal((g % q).astype(np.uint64), want[mi])


@pytest.mark.parametrize("moduli", [[Q50], [Q60], [Q62]])
@pytest.mark.parametrize("tile", TILES)
def test_k2_model_matches_plain(moduli, tile):
    """K2 bit-equal to its plain version on every tile, rows 1, 3, 5 and 37
    (ragged last tiles and quads), the word extremes in."""
    tables, x = _case(moduli, 8, 37, tile)
    for rows in (1, 3, 5, 37):
        xs = x[:, :rows]
        want = _u64(split.split_k2_plain(tables, u64_tensor(xs)))
        np.testing.assert_array_equal(model_rows(tables, "k2", xs, tile, seed=rows), want)


@pytest.mark.parametrize("log_n,moduli,batch,r0_off,tile", [
    (8, [Q50], 1, 0, 4), (8, [Q60], 3, 1, 8), (10, [Q62], 3, 5, 16), (12, [Q50], 64, 30, 32),
    (12, [Q60], 1, 17, 4), (10, [Q50, Q62], 2, 2, 8)])
@pytest.mark.parametrize("keyed", [False, True])
def test_ki1_model_matches_plain(log_n, moduli, batch, r0_off, tile, keyed):
    """Ki1 below 2q and equal mod q to its plain version, with and without
    the key, at shard offsets r0_off > 0, batch 1, 2, 3 and 64, ragged
    tiles, one or two moduli, the word extremes in."""
    A = 1 << (log_n - 7)
    al = min(A - r0_off, 3 if batch == 64 else 5)
    rows = al * batch
    tables, x = _case(moduli, log_n, rows, log_n + batch)
    key = _key_rows(tables, rows, batch, r0_off, batch) if keyed else None
    want = _u64(split.split_ki1_plain(tables, u64_tensor(x), batch, r0_off, key))
    got = model_rows(tables, "ki1", x, tile, batch, r0_off, None if key is None else _u64(key))
    _lazy_equal(got, want, moduli)


def test_k2_model_two_moduli_large_batch():
    """K2 on two moduli (62 bits among them) at 128 rows (batch 64 of a D = 2
    shard at log_n 8) in tiles of 32."""
    tables, x = _case([Q50, Q62], 8, 128, 3)
    want = _u64(split.split_k2_plain(tables, u64_tensor(x)))
    np.testing.assert_array_equal(model_rows(tables, "k2", x, 32), want)
