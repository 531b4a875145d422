"""A numpy model of kernel E's schedule (``mxu8_roundtrip64_mul`` on row 10's
passes, ``csrc/ntt64.cu``'s ``ntt64_roundtrip_kernel``), held word for word
against the plain version ``ops.ntt_mxu8.mxu8_roundtrip64_mul_plain`` on the
CPU.

The model runs the kernel's data flow as written, block by block, on an
explicit tile T: the grid of moduli x tiles of T rows, a ragged last tile
reading and writing only its own rows; one shared-memory array per block
(the forward's staged table and quotients, the inverse's staged part, the
tile's swizzled rows) seeded with random bytes, every read of it checked
against what was written before; the load (any u64 word, brought to [0, 2q)
by a lazy Shoup multiply by 1) and the forward's first pass with its 7 roots
in registers; the tables landing at the first barrier; the forward's middle
passes on the staged table; the fused pass, whose group of 2^R adjacent
words is both the forward's last group (staged table, no fold) and the
inverse's first (twiddles from the global table), with the key multiply
between them; the inverse's later passes on the staged part only, the last
folding ``inv_n`` in and storing canonical words at k n/8 + g.  Every word
is checked inside its lazy range, every output word written exactly once.
It also checks the pass count, the shared-memory budget of each tile, and
that each half-warp of every 8-byte shared-memory access hits 16 distinct
words mod 16.  Tolerance: zero (bit-equal).
"""

import numpy as np
import pytest
import torch

from test_torch_ntt64_model import (
    SMEM_MAX, _half_warps, _u64, check_words, forward_passes, fwd_slots, fwd_stages,
    inv_slots, inverse_passes, log_split, remainder_stages, shoup, smem_index, staged_words,
    tiles,
)
from primus_fhe_tpu_torch.numeric.limb import u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8

Q50 = 1125899906826241  # bench.py's q: 7 byte planes
Q60 = 1152921504606830593  # phase 11's 8-plane modulus
Q62 = 4611686018427322369  # lazy [0, 4q) words pass 2^63
MODULI = {"q50": [Q50], "q60": [Q60], "q50+q62": [Q50, Q62]}
M64 = (1 << 64) - 1


def rt_smem_bytes(log_n: int, tile: int) -> int:
    """``csrc/ntt64.cu``'s ``rt_smem_bytes``: the forward's staged table (to
    n = 2^12, ``rt_staged_words``), the inverse's staged part and the tile
    (of half rows at n = 2^15, a row over 2 blocks)."""
    fwd = 1 << log_n if log_n <= 12 else 0
    return (16 * fwd + 16 * staged_words(False, log_n)
            + 8 * (tile << (log_n - log_split(log_n))))


def rt_passes(log_n: int):
    """The kernel's passes: ``("fwd", s0, R)`` but the forward's last,
    ``("fused", s0, R)`` (the forward's last pass, the key, the inverse's
    first), then ``("inv", s0, R)``."""
    fwd, inv = forward_passes(log_n), inverse_passes(log_n)
    assert fwd[-1][1] == inv[0][1] and inv[0][0] == 0
    return ([("fwd", s0, r) for s0, r in fwd[:-1]] + [("fused",) + fwd[-1]]
            + [("inv", s0, r) for s0, r in inv[1:]])


def inv_stages(v, s0, r, hi, tw, twp, lo, q, pl, fold):
    """R inverse stages on ``v (count, 2^R, groups)``, twiddle ti read at
    ``ti - lo`` of ``tw``; ``fold``: the final stage with inv_n, canonical."""
    two_q = np.uint64(2 * q)
    n = 1 << pl.log_n
    for e in range(r):
        hh = 1 << e
        start = 1 + n - (n >> (s0 + e))
        for k in range(1 << r):
            if k & hh:
                continue
            xv, yv = v[:, k].copy(), v[:, k + hh].copy()
            s = xv + yv
            tx = np.where(s >= two_q, s - two_q, s)
            with np.errstate(over="ignore"):
                d = xv + two_q - yv
            if fold and e == r - 1:
                a = shoup(tx, pl.inv_n, pl.inv_n_precon, q)
                b = shoup(d, pl.inv_n_w, pl.inv_n_w_precon, q)
                v[:, k] = np.where(a >= q, a - np.uint64(q), a)
                v[:, k + hh] = np.where(b >= q, b - np.uint64(q), b)
                check_words(v[:, k], q)
                check_words(v[:, k + hh], q)
                continue
            ti = start + (hi << (r - 1 - e)) + (k >> (e + 1)) - lo
            assert (ti >= 0).all() and (ti < len(tw)).all()
            v[:, k] = tx
            v[:, k + hh] = shoup(d, tw[ti], twp[ti], q)
            check_words(v[:, k], 2 * q)
            check_words(v[:, k + hh], 2 * q)


class Smem:
    """A block's shared memory in words, seeded with random bytes; a read of
    a word not yet written fails."""

    def __init__(self, words: int, rng):
        self.w = rng.integers(0, 1 << 64, words, dtype=np.uint64)
        self.ok = np.zeros(words, dtype=bool)

    def read(self, idx):
        assert self.ok[idx].all(), "shared memory read before it was written"
        return self.w[idx].copy()

    def write(self, idx, v):
        self.w[idx] = v
        self.ok[idx] = True


def model_roundtrip(tables: ntt_mxu8.Mxu8Tables64, x: np.ndarray, mt: np.ndarray, tile: int,
                    seed: int = 0):
    """Kernel E on ``x (count, rows, n)`` (any u64 words) and the key table
    ``mt (count, 2, n)`` in tiles of ``tile`` rows."""
    count, rows, n = x.shape
    log_n = tables.log_n
    r, m = remainder_stages(log_n), staged_words(False, log_n)
    assert 8 <= log_n <= 12 and rt_smem_bytes(log_n, tile) <= SMEM_MAX
    rng = np.random.default_rng(seed)
    out = np.zeros_like(x)
    writes = np.zeros(x.shape, dtype=np.int64)
    pack = tables.ntt.mod_pack.reshape(-1, 9)
    for mi, pl in enumerate(tables.ntt.plans):
        q, p1 = pl.q, pack[mi, 7]
        tw, twp = _u64(pl.roots), _u64(pl.roots_precon)
        itw, itwp = _u64(pl.inv_roots), _u64(pl.inv_roots_precon)
        key, keyp = mt[mi]
        for r0, cnt in tiles(rows, tile):
            sm = Smem(2 * n + 2 * m + (cnt << log_n), rng)
            FT, IT, ROWS = 0, 2 * n, 2 * n + 2 * m  # forward table | inverse part | rows
            for i, (kind, s0, rr) in enumerate(rt_passes(log_n)):
                if kind == "fwd" and s0 == 0:  # the load, reduced, and pass 1
                    slots, hi, log_t = fwd_slots(log_n, 0, 3)
                    v = shoup(x[mi, r0:r0 + cnt][:, slots], 1, p1, q)
                    check_words(v, 2 * q)
                    fwd_stages(v, 0, 3, hi, tw, twp, q, 0, False, reg=True)
                    sm.write(ROWS + smem_index(cnt, log_n, slots), v)
                    # the cp.async copies land before the first barrier
                    sm.write(FT + np.arange(n), tw)
                    sm.write(FT + n + np.arange(n), twp)
                    sm.write(IT + np.arange(m), itw[n - m:])
                    sm.write(IT + m + np.arange(m), itwp[n - m:])
                    continue
                ftab = sm.read(FT + np.arange(n)), sm.read(FT + n + np.arange(n))
                if kind == "fwd":
                    slots, hi, _ = fwd_slots(log_n, s0, rr)
                    idx = ROWS + smem_index(cnt, log_n, slots)
                    v = sm.read(idx)
                    fwd_stages(v, s0, rr, hi, *ftab, q, 0, False, reg=False)
                    sm.write(idx, v)
                elif kind == "fused":
                    slots, hi, log_t = fwd_slots(log_n, s0, rr)
                    islots, ihi, _ = inv_slots(log_n, 0, rr)
                    # one group: 2^R adjacent words, 16-byte aligned for the key's loads
                    assert log_t == 0 and (slots == islots).all() and (hi == ihi).all()
                    assert (slots[0] % (1 << rr) == 0).all() and rr == r
                    idx = ROWS + smem_index(cnt, log_n, slots)
                    v = sm.read(idx)
                    fwd_stages(v, s0, rr, hi, *ftab, q, 0, False, reg=False)  # lazy [0, 4q)
                    v = shoup(v, key[slots][None], keyp[slots][None], q)
                    check_words(v, 2 * q)
                    inv_stages(v, 0, rr, hi, itw, itwp, 0, q, pl, fold=False)
                    sm.write(idx, v)
                else:
                    last = i == len(rt_passes(log_n)) - 1
                    slots, hi, _ = inv_slots(log_n, s0, rr)
                    idx = ROWS + smem_index(cnt, log_n, slots)
                    v = sm.read(idx)
                    itab = sm.read(IT + np.arange(m)), sm.read(IT + m + np.arange(m))
                    inv_stages(v, s0, rr, hi, *itab, n - m, q, pl, fold=last)
                    if last:  # k n/8 + g: a warp's stores adjacent
                        assert (slots == np.arange(n).reshape(8, n // 8)).all()
                        out[mi, r0:r0 + cnt][:, slots] = v
                        writes[mi, r0:r0 + cnt][:, slots] += 1
                    else:
                        sm.write(idx, v)
    assert (writes == 1).all()  # every output word written exactly once, by its tile
    return out


def _case(moduli, log_n, rows, seed):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    rng = np.random.default_rng(seed)
    n = 1 << log_n
    x = rng.integers(0, 1 << 64, (len(moduli), rows, n), dtype=np.uint64)
    x[:, 0, :4] = [[0, M64, 1 << 63, q] for q in moduli]
    key = np.stack([rng.integers(0, q, n, dtype=np.uint64) for q in moduli])
    key[:, :2] = [[0, q - 1] for q in moduli]
    mt = tables.mul_table(u64_tensor(key))
    return tables, x, mt


@pytest.mark.parametrize("moduli", list(MODULI))
@pytest.mark.parametrize("log_n", range(8, 13))
def test_model_matches_plain(log_n, moduli):
    """Every row size the kernel takes, a 7-plane, an 8-plane and a pair of
    moduli (62 bits among them), rows 1, 3, T + 1 and 17 in tiles of T = 4
    (the tile at 512 rows of n = 4096), inputs over the whole u64 range."""
    tile = 4
    tables, x, mt = _case(MODULI[moduli], log_n, 17, log_n)
    assert tables.planes == (7 if moduli == "q50" else 8)
    for rows in (1, 3, tile + 1, 17):
        xs = x[:, :rows]
        want = _u64(ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, u64_tensor(xs), mt))
        got = model_roundtrip(tables, xs, _u64(mt), tile, seed=rows)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n,tile", [(8, 1), (8, 8), (9, 2), (10, 8), (11, 1), (12, 2)])
def test_model_matches_plain_other_tiles(log_n, tile):
    """The other tiles that fit, on two moduli, ragged: rows 1, T + 1, 17."""
    tables, x, mt = _case(MODULI["q50+q62"], log_n, 17, 50 + log_n + tile)
    for rows in (1, tile + 1, 17):
        xs = x[:, :rows]
        want = _u64(ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, u64_tensor(xs), mt))
        np.testing.assert_array_equal(model_roundtrip(tables, xs, _u64(mt), tile), want)


@pytest.mark.parametrize("log_n", range(8, 13))
def test_passes_and_budget(log_n):
    """2 ceil(log_n / 3) - 1 passes (7 at n = 4096, against 8 for row 10's
    two launches), each stage of each transform once; both staged tables and
    a tile of 4 rows fit at n = 4096, 8 rows fit below; the staged parts are
    whole 16-byte copies."""
    passes = rt_passes(log_n)
    assert len(passes) == 2 * -(-log_n // 3) - 1
    fwd = [s0 + e for kind, s0, r in passes if kind != "inv" for e in range(r)]
    inv = [(0 if kind == "fused" else s0) + e for kind, s0, r in passes if kind != "fwd"
           for e in range(r)]
    assert fwd == inv == list(range(log_n))
    fits = [rt_smem_bytes(log_n, t) <= SMEM_MAX for t in (1, 2, 4, 8)]
    assert fits == ([True] * 3 + [False] if log_n == 12 else [True] * 4)
    if log_n == 12:
        assert len(passes) == 7 and rt_smem_bytes(12, 4) == 200 * 1024
    n, m = 1 << log_n, staged_words(False, log_n)
    assert n % 2 == 0 and m % 2 == 0 and (n - m) % 2 == 0


@pytest.mark.parametrize("log_n", range(8, 13))
def test_shared_memory_half_warps_hit_16_words(log_n):
    """Each half-warp of each 8-byte shared-memory access of every pass (pass
    1's stores, the middle passes, the fused pass's loads and stores, the
    inverse's passes, the last one's loads), for every tile that fits, hits
    16 distinct words mod 16."""
    accesses = []
    for kind, s0, r in rt_passes(log_n):
        accesses.append((fwd_slots if kind != "inv" else inv_slots)(log_n, s0, r)[0])
    for tile in (1, 2, 4, 8):
        if rt_smem_bytes(log_n, tile) > SMEM_MAX:
            continue
        for slots in accesses:
            words = smem_index(tile, log_n, slots).transpose(1, 0, 2)  # (2^R, tile, groups)
            for hw in _half_warps(words):
                assert len(set((hw % 16).tolist())) == len(hw)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (no launch), at
    ``out_factor`` 1 and 2 alike, and refuses another factor."""
    tables, x, mt = _case(MODULI["q50+q62"], 8, 3, 7)
    want = ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, u64_tensor(x), mt)
    before = ntt_mxu8.mxu8_roundtrip64_mul.launches
    for of in (1, 2):
        assert torch.equal(ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x), mt, of), want)
    assert ntt_mxu8.mxu8_roundtrip64_mul.launches == before
    with pytest.raises(ValueError):
        ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x), mt, 4)
