"""A numpy model of row 10's schedule (``csrc/ntt64.cu`` on the passes of
``csrc/ntt_passes.cuh``), held word for word against the plain versions
``ops.ntt64.ntt64_forward_plain`` / ``ntt64_inverse_plain`` on the CPU.

The model runs the kernels' data flow as written, block by block: the grid
of moduli x tiles of T rows, a ragged last tile reading and writing only its
own rows; the pass split (the forward's last pass and the inverse's first
take the remainder, 1-3 stages; log_n <= 3 is one pass); at log_n 15 a row
over two blocks, the forward's stage 0 run as each half loads and the
inverse's last stage pairing the halves' shared memory (the half views'
index maps are the cluster kernels' at LC = 1; the kernels' own data flow
at 15-17, the stages across the slices over distributed shared memory, is
modelled in ``test_torch_ntt64_cluster.py``); the forward's first
pass reading its groups from the input with its 7 roots in registers (from
the global table at 15), its last pass storing 2^R adjacent words; the
inverse's first pass loading 2^R adjacent words through the input chain
(``in_factor`` q down to 2q) with its twiddles from the global table, its
later passes reading the staged part of the table only, the last one
folding ``inv_n`` in and storing k n/8 + g; the swizzled shared-memory rows
every pass in between reads and writes; the twiddle index of every stage
(staged, or from the global table through a half's view at 15) and the
16-byte alignment of every vector access.  Every word is checked below
2^64 and inside its lazy range (lazy words pass 2^63 at ``Q62``).  It also
checks that the passes cover every stage once, that the shared memory of
each launch fits, and that each half-warp of every 8-byte shared-memory
access hits 16 distinct words mod 16 (8-byte bank pairs), and holds the
plain versions to the JAX kernels (``pallas_forward64`` /
``pallas_inverse64`` in interpret mode) at ``bench_dcrt.py``'s two 50-bit
moduli and log_n 12.  Tolerance: zero (bit-equal).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan64, pallas_forward64, pallas_inverse64
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt64
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime

Q50 = [1125899906826241, 1125899906629633]  # bench_dcrt.py's moduli
Q62 = 4611686018427322369  # lazy [0, 4q) words pass 2^63
MODULI4 = [next_ntt_prime(50, 15), next_ntt_prime(62, 15), next_ntt_prime(61, 15),
           next_ntt_prime(40, 15)]
SMEM_MAX = 232448  # csrc/ntt64.cu
M32 = np.uint64(0xFFFFFFFF)
U32 = np.uint64(32)


def swz64(i):
    """The kernels' shared-memory word of the tile's word ``i``."""
    return i ^ ((i >> 3) & 15) ^ ((i >> 4) & 3)


def log_split(log_n: int) -> int:
    return 1 if log_n > 14 else 0


def remainder_stages(log_n: int) -> int:
    return log_n - 3 * ((log_n - 1) // 3)


def staged_words(forward: bool, log_n: int) -> int:
    if log_n <= 3 or log_split(log_n):
        return 0
    if not forward:
        return (1 << log_n) >> remainder_stages(log_n)
    return 1 << log_n if log_n <= 13 else 0


def smem_bytes(forward: bool, log_n: int, tile: int) -> int:
    if log_n <= 3:
        return 0
    return 16 * staged_words(forward, log_n) + 8 * (tile << (log_n - log_split(log_n)))


def largest_tile(forward: bool, log_n: int, want: int) -> int:
    tile = 1
    while tile < want and smem_bytes(forward, log_n, 2 * tile) <= SMEM_MAX:
        tile *= 2
    return tile


def forward_passes(log_n: int):
    """``(s0, R)`` of each forward pass: radix 8, the remainder last."""
    out, s0 = [], 0
    while s0 < log_n:
        r = min(3, log_n - s0)
        out.append((s0, r))
        s0 += r
    return out


def inverse_passes(log_n: int):
    """``(s0, R)`` of each inverse pass: the remainder first, then radix 8."""
    r0 = remainder_stages(log_n)
    return [(0, r0)] + [(s0, 3) for s0 in range(r0, log_n, 3)]


def fwd_slots(log_n, s0, r):
    """Slots ``(2^R, groups)``, the groups' ``hi`` and ``log t`` of a
    forward pass."""
    log_t = log_n - s0 - r
    g = np.arange(1 << (log_n - r))
    hi, lo = g >> log_t, g & ((1 << log_t) - 1)
    base = (hi << (log_t + r)) + lo
    return base[None, :] + (np.arange(1 << r)[:, None] << log_t), hi, log_t


def inv_slots(log_n, s0, r):
    g = np.arange(1 << (log_n - r))
    hi, lo = g >> s0, g & ((1 << s0) - 1)
    base = (hi << (s0 + r)) + lo
    return base[None, :] + (np.arange(1 << r)[:, None] << s0), hi, s0


def mulhi64(a, b):
    """The high word of the 128-bit products ``a * b`` (``__umul64hi``)."""
    a, b = np.asarray(a, dtype=np.uint64), np.asarray(b, dtype=np.uint64)
    a0, a1, b0, b1 = a & M32, a >> U32, b & M32, b >> U32
    mid = ((a0 * b0) >> U32) + ((a0 * b1) & M32) + ((a1 * b0) & M32)
    return a1 * b1 + ((a0 * b1) >> U32) + ((a1 * b0) >> U32) + (mid >> U32)


def shoup(y, w, wp, q):
    """``shoup64_lazy``: ``w y - q hi(y wp)`` mod 2^64, in [0, 2q)."""
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    with np.errstate(over="ignore"):
        return w * y - np.uint64(q) * mulhi64(y, wp)


def check_words(x, below: int):
    assert (np.asarray(x, dtype=np.uint64) < np.uint64(below)).all()


def tiles(rows: int, tile: int):
    """The row ranges of a modulus's blocks: ``ceil(rows / tile)`` tiles, the
    last one ragged."""
    return [(r0, min(tile, rows - r0)) for r0 in range(0, rows, tile)]


def smem_index(count, log_l, slots):
    """Shared-memory words ``(count, 2^R, groups)`` of a pass's slots in a
    tile of ``count`` rows of 2^log_l words."""
    return swz64((np.arange(count)[:, None, None] << log_l) + slots[None])


def fwd_twiddle(s0, hi, e, j, h, split):
    """Index of block j's root at stage e of a forward pass (s0, hi) of the
    block's (half) row: the run of 2^e roots a group reads in one access,
    in a half's view of the row's table (``HalfTable``) at a split."""
    if split:
        s0, hi = s0 + 1, hi + (h << s0)
    run = (1 << (s0 + e)) + (hi << e)
    assert (run % (1 << e) == 0).all()  # 8, 16 or 32 bytes, aligned
    return run + j


def inv_twiddle_half(ti, half, h):
    """``HalfInvTable``: twiddle ti of a half-size transform -> the row's."""
    lg = np.floor(np.log2(half - ti)).astype(np.int64)
    return ti + half - (2 << lg) + (h << lg)


def fwd_stages(v, s0, r, hi, tw, twp, q, h, split, reg):
    """R forward stages on ``v (count, 2^R, groups)``; ``reg``: pass 1's
    twiddles from registers (roots[1..7])."""
    two_q = np.uint64(2 * q)
    for e in range(r):
        hh = 1 << (r - 1 - e)
        for k in range(1 << r):
            if k & hh:
                continue
            ti = fwd_twiddle(s0, hi, e, k >> (r - e), h, split)
            assert (ti < len(tw)).all()
            if reg:
                assert (ti < 8).all()
            x, y = v[:, k], v[:, k + hh]
            tx = np.where(x >= two_q, x - two_q, x)
            ty = shoup(y, tw[ti], twp[ti], q)
            with np.errstate(over="ignore"):
                v[:, k], v[:, k + hh] = tx + ty, tx + two_q - ty
            check_words(v[:, k], 4 * q)
            check_words(v[:, k + hh], 4 * q)


def _u64(t: torch.Tensor) -> np.ndarray:
    return u64_numpy(t).astype(np.uint64)


def model_forward(tables: ntt64.NttTables64, x: np.ndarray, out_factor: int, tile: int,
                  any_words: bool = False):
    """The forward kernel on ``x (count, rows, n)`` u64 words below 4q; with
    ``any_words`` (``ntt64_forward_kernel<CANON, ANY>``, row 9's forward at
    log_n 13-15) any u64 words, each brought to [0, 2q) by a lazy Shoup
    multiply by 1 as it loads."""
    count, rows, n = x.shape
    log_n = tables.log_n
    split = log_split(log_n)
    l = log_n - split  # the block's words of a row: 2^l
    half = 1 << l
    if split:
        assert tile == 1 and smem_bytes(True, log_n, 2) > SMEM_MAX
    assert smem_bytes(True, log_n, tile) <= SMEM_MAX
    out = np.full_like(x, 0xDEADBEEF)
    passes = forward_passes(l)
    for mi, pl in enumerate(tables.plans):
        q = pl.q
        tw, twp = _u64(pl.roots), _u64(pl.roots_precon)
        for r0, cnt in tiles(rows, tile):
            src = x[mi, r0:r0 + cnt]
            if any_words:  # AnyIn64, HalfIn<true>
                src = shoup(src, 1, (1 << 64) // q, q)
                check_words(src, 2 * q)
            for h in range(1 << split):
                sm = np.zeros(cnt << l, dtype=np.uint64)  # the tile's rows, swizzled
                for i, (s0, r) in enumerate(passes):
                    first, last = i == 0, i == len(passes) - 1
                    slots, hi, log_t = fwd_slots(l, s0, r)
                    if first and split:  # stage 0 (root 1) as the half loads
                        xs, ys = src[:, slots].copy(), src[:, slots + half].copy()
                        two_q = np.uint64(2 * q)
                        tx = np.where(xs >= two_q, xs - two_q, xs)
                        ty = shoup(ys, tw[1], twp[1], q)
                        with np.errstate(over="ignore"):
                            v = tx + ty if h == 0 else tx + two_q - ty
                    elif first:
                        v = src[:, slots].copy()
                    else:
                        v = sm[smem_index(cnt, l, slots)]
                    fwd_stages(v, s0, r, hi, tw, twp, q, h, split, reg=first and not split)
                    if last:  # 2^R adjacent words a group, aligned for 16-byte stores
                        assert log_t == 0 and (slots[0] % (1 << r) == 0).all() and r >= 1
                        if out_factor == 1:
                            v = np.where(v >= 2 * q, v - np.uint64(2 * q), v)
                            v = np.where(v >= q, v - np.uint64(q), v)
                        dst = out[mi, r0:r0 + cnt]
                        dst[:, (h << l) + slots] = v
                        out[mi, r0:r0 + cnt] = dst
                    else:
                        sm[smem_index(cnt, l, slots)] = v
    assert (out != 0xDEADBEEF).all()  # every row written by exactly its tile
    return out


def model_inverse(tables: ntt64.NttTables64, x: np.ndarray, out_factor: int, in_factor: int,
                  tile: int, load: str = "chain", key=None):
    """The inverse kernel on ``x (count, rows, n)`` u64 words below
    ``in_factor`` q.  ``load`` is its first pass's load (``InLoad``): the
    input chain (``"chain"``), any u64 word times 1 (``"any"``: row 9's
    inverse at log_n 13-15) or times the key (``"key"``: kernel D there;
    ``key (count, 2, n)`` its words and Shoup quotients), a lazy Shoup
    multiply into [0, 2q) as each word loads."""
    count, rows, n = x.shape
    log_n = tables.log_n
    split = log_split(log_n)
    l = log_n - split
    half = 1 << l
    m = staged_words(False, log_n)
    if split:
        assert tile == 1 and m == 0
    assert smem_bytes(False, log_n, tile) <= SMEM_MAX
    out = np.full_like(x, 0xDEADBEEF)
    passes = inverse_passes(l)
    for mi, pl in enumerate(tables.plans):
        q = pl.q
        two_q = np.uint64(2 * q)
        tw, twp = _u64(pl.inv_roots), _u64(pl.inv_roots_precon)
        for r0, cnt in tiles(rows, tile):
            halves = []
            for h in range(1 << split):
                src = x[mi, r0:r0 + cnt, h * half:(h + 1) * half].copy()
                if load == "key":  # KeyIn64: the key at the half's slots
                    src = shoup(src, key[mi, 0, h * half:(h + 1) * half],
                                key[mi, 1, h * half:(h + 1) * half], q)
                elif load == "any":  # AnyIn64
                    src = shoup(src, 1, (1 << 64) // q, q)
                f = in_factor // 2 if load == "chain" else 1  # the input chain
                while f >= 2:
                    src = np.where(src >= np.uint64(f * q), src - np.uint64(f * q), src)
                    f //= 2
                check_words(src, 2 * q)
                sm = np.zeros(cnt << l, dtype=np.uint64)
                for i, (s0, r) in enumerate(passes):
                    first, last = i == 0, i == len(passes) - 1
                    fold = last and not split  # the final stage, inv_n folded in
                    slots, hi, _ = inv_slots(l, s0, r)
                    if first:  # 2^R adjacent words a group, aligned for 16-byte loads
                        assert s0 == 0 and (slots[0] % (1 << r) == 0).all()
                    if fold and not first:  # k n/8 + g: a warp's stores adjacent
                        assert (slots == np.arange(half).reshape(8, half // 8)).all()
                    v = src[:, slots] if first else sm[smem_index(cnt, l, slots)]
                    for e in range(r):
                        hh = 1 << e
                        start = 1 + half - (half >> (s0 + e))
                        for k in range(1 << r):
                            if k & hh:
                                continue
                            xv, yv = v[:, k].copy(), v[:, k + hh].copy()
                            if fold and e == r - 1:
                                s = xv + yv
                                tx = np.where(s >= two_q, s - two_q, s)
                                a = shoup(tx, pl.inv_n, pl.inv_n_precon, q)
                                b = shoup(xv + two_q - yv, pl.inv_n_w, pl.inv_n_w_precon, q)
                                if out_factor == 1:
                                    a = np.where(a >= q, a - np.uint64(q), a)
                                    b = np.where(b >= q, b - np.uint64(q), b)
                                v[:, k], v[:, k + hh] = a, b
                                check_words(a, out_factor * q)
                                check_words(b, out_factor * q)
                                continue
                            ti = start + (hi << (r - 1 - e)) + (k >> (e + 1))
                            if split:
                                ti = inv_twiddle_half(ti, half, h)
                            assert (ti < n - 1).all()
                            if not first and not split:  # from the staged part only
                                assert (ti >= n - m).all()
                            s = xv + yv
                            v[:, k] = np.where(s >= two_q, s - two_q, s)
                            v[:, k + hh] = shoup(xv + two_q - yv, tw[ti], twp[ti], q)
                            check_words(v[:, k], 2 * q)
                            check_words(v[:, k + hh], 2 * q)
                    if fold:
                        dst = out[mi, r0:r0 + cnt]
                        dst[:, slots] = v
                        out[mi, r0:r0 + cnt] = dst
                    else:
                        sm[smem_index(cnt, l, slots)] = v
                halves.append(sm)
            if split:  # the last stage over the cluster: x from half 0, y from half 1
                i = np.arange(half)
                xv, yv = halves[0][swz64(i)], halves[1][swz64(i)]
                s = xv + yv
                a = shoup(np.where(s >= two_q, s - two_q, s), pl.inv_n, pl.inv_n_precon, q)
                b = shoup(xv + two_q - yv, pl.inv_n_w, pl.inv_n_w_precon, q)
                if out_factor == 1:
                    a = np.where(a >= q, a - np.uint64(q), a)
                    b = np.where(b >= q, b - np.uint64(q), b)
                out[mi, r0, :half], out[mi, r0, half:] = a, b
    assert (out != 0xDEADBEEF).all()
    return out


def _inputs(moduli, rows, n, factor, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, factor * q, (rows, n), dtype=np.uint64) for q in moduli])


def _check(moduli, log_n, rows, tile, seed):
    tables = ntt64.NttTables64(log_n, moduli)
    n = 1 << log_n
    ft, it = largest_tile(True, log_n, tile), largest_tile(False, log_n, tile)
    for of in (1, 4):
        x = _inputs(moduli, rows, n, 4, seed)
        want = _u64(ntt64.ntt64_forward_plain(tables, u64_tensor(x), of))
        np.testing.assert_array_equal(model_forward(tables, x, of, ft), want)
    for in_factor in (2, 4):
        for of in (1, 2):
            x = _inputs(moduli, rows, n, in_factor, seed + in_factor + of)
            want = _u64(ntt64.ntt64_inverse_plain(tables, u64_tensor(x), of, in_factor))
            np.testing.assert_array_equal(model_inverse(tables, x, of, in_factor, it), want)


@pytest.mark.parametrize("log_n", range(1, 16))
def test_model_matches_plain_every_log_n(log_n):
    """Every row size the kernels take, 1-4 moduli (62-bit ones among
    them), 5 rows in tiles of 2 (the last ragged; one row a block where a
    second does not fit, 2 rows at n = 2^15, a row over two blocks)."""
    moduli = MODULI4[:1 + log_n % 4]
    rows = 2 if log_n == 15 else 3 if log_n >= 13 else 5
    _check(moduli, log_n, rows, 2, log_n)


@pytest.mark.parametrize("moduli,log_n,rows,tile", [
    (Q50, 12, 8, 1),  # the DCRT rotation's batch-1 forward: 16 rows, one a block
    (Q50, 12, 2, 1),  # ... and inverse
    ([Q50[0]], 12, 9, 4),  # a residue shard / phase 11's 512 rows, in tiles of 4, ragged
    ([Q62, Q50[1]], 12, 3, 2),  # lazy words past 2^63
    ([Q50[0]], 8, 7, 8),  # the four-step's sub-transforms (n = 256), a ragged tile of 8
    (MODULI4, 9, 3, 4),  # 4 moduli
    ([Q62], 14, 2, 1),  # the largest row in one block
])
def test_model_matches_plain(moduli, log_n, rows, tile):
    _check(moduli, log_n, rows, tile, log_n * 7 + rows)


@pytest.mark.parametrize("log_n", range(1, 16))
def test_passes_cover_every_stage_once(log_n):
    """The passes of a block's (half) row cover its stages once; at n = 2^15
    the forward's stage 0 (at load) and the inverse's last (over the
    cluster) complete the row's stages."""
    split = log_split(log_n)
    l = log_n - split
    fwd = [s0 + e + split for s0, r in forward_passes(l) for e in range(r)]
    inv = [s0 + e for s0, r in inverse_passes(l) for e in range(r)]
    assert [0] * split + fwd == list(range(log_n))
    assert inv + [log_n - 1] * split == list(range(log_n))
    passes = -(-l // 3)
    assert len(forward_passes(l)) == len(inverse_passes(l)) == passes
    assert forward_passes(l)[-1][1] == inverse_passes(l)[0][1] == remainder_stages(l)
    if log_n == 12:
        assert passes == 4  # 3 barriers, against 12 stages
    for s0, r in forward_passes(l):  # every pass's groups tile the row
        assert sorted(fwd_slots(l, s0, r)[0].reshape(-1)) == list(range(1 << l))
    for s0, r in inverse_passes(l):
        assert sorted(inv_slots(l, s0, r)[0].reshape(-1)) == list(range(1 << l))


@pytest.mark.parametrize("log_n", range(1, 16))
def test_launch_fits_and_twiddles_are_staged_or_global(log_n):
    """One row a block always fits; the forward stages its whole table up to
    n = 2^13 (beside 1-4 rows at n = 4096) and the inverse the last n / 2^R
    words up to 2^14, 16 bytes at a time; at 2^15 a half's view of the
    tables reaches the row's twiddles, block by block."""
    n = 1 << log_n
    for fwd in (True, False):
        assert smem_bytes(fwd, log_n, 1) <= SMEM_MAX
        m = staged_words(fwd, log_n)
        assert m % 2 == 0 and (n - m) % 2 == 0  # cp.async of 16-byte chunks
    if log_n == 12:
        assert [smem_bytes(True, 12, t) <= SMEM_MAX for t in (1, 2, 4, 8)] == [True] * 3 + [False]
        assert staged_words(False, 12) == 512
    if log_n == 15:  # HalfInvTable's closed form against the stage-by-stage count
        half = n >> 1
        for h in (0, 1):
            for s in range(log_n - 1):
                j = np.arange(half >> (s + 1))  # the half's blocks at stage s
                local = 1 + half - (half >> s) + j
                row = 1 + n - (n >> s) + h * (half >> (s + 1)) + j
                np.testing.assert_array_equal(inv_twiddle_half(local, half, h), row)
                # HalfTable: the half's stage s, block j is the row's stage
                # s + 1, block h 2^s + j (a pass at s0 = s, one stage)
                got = fwd_twiddle(s, np.arange(1 << s), 0, 0, h, True)
                np.testing.assert_array_equal(got, (2 << s) + h * (1 << s) + np.arange(1 << s))


def _half_warps(words: np.ndarray):
    """A pass's per-k words ``(2^R, count, groups)`` as the block's threads
    access them: iterations over (row, group), 16 consecutive ones a
    half-warp (a u64 access is served a half-warp at a time)."""
    flat = words.reshape(words.shape[0], -1)
    for c in range(0, flat.shape[1], 16):
        yield from flat[:, c:c + 16]


@pytest.mark.parametrize("log_n", range(4, 16))
def test_shared_memory_half_warps_hit_16_words(log_n):
    """Each half-warp of each 8-byte shared-memory access of every pass (the
    forward's first-pass stores, middle passes, last-pass loads; the
    inverse's first-pass stores, middle passes, last-pass loads; at 2^15 the
    last stage's sweep in coefficient order), for every tile that fits,
    hits 16 distinct words mod 16."""
    l = log_n - log_split(log_n)
    assert sorted(swz64(np.arange(1 << l))) == list(range(1 << l))
    accesses = [fwd_slots(l, s0, r)[0] for s0, r in forward_passes(l)]
    accesses += [inv_slots(l, s0, r)[0] for s0, r in inverse_passes(l)]
    for tile in (1, 2, 4, 8):
        if max(smem_bytes(f, log_n, tile) for f in (True, False)) > SMEM_MAX and tile > 1:
            continue
        for slots in accesses:
            words = smem_index(tile, l, slots).transpose(1, 0, 2)  # (2^R, tile, groups)
            for hw in _half_warps(words):
                assert len(set((hw % 16).tolist())) == len(hw)
    sweep = swz64(np.arange(1 << l)).reshape(-1, 16) % 16
    assert all(len(set(row.tolist())) == 16 for row in sweep)


@pytest.mark.parametrize("log_n", range(1, 16))
def test_vector_accesses_are_16_byte_aligned(log_n):
    """The device-memory groups of adjacent words (the forward's last pass,
    the inverse's first, one pass) start at a multiple of 2^R >= 2 words;
    a stage's run of roots at a multiple of its length; staged tables and
    the rows after them at multiples of 2 words (16 bytes)."""
    split = log_split(log_n)
    l = log_n - split
    s0, r = forward_passes(l)[-1]
    slots, hi, log_t = fwd_slots(l, s0, r)
    assert log_t == 0 and (slots[0] % (1 << r) == 0).all() and (1 << l) % 2 == 0
    slots, _, _ = inv_slots(l, 0, inverse_passes(l)[0][1])
    assert (slots[0] % (1 << inverse_passes(l)[0][1]) == 0).all()
    for s0, r in forward_passes(l):
        _, hi, _ = fwd_slots(l, s0, r)
        for e in range(r):
            for h in range(1 << split):
                fwd_twiddle(s0, hi, e, 0, h, split)  # asserts the run's alignment
    for fwd in (True, False):
        assert (2 * staged_words(fwd, log_n)) % 2 == 0


def test_plain_matches_pallas_at_dcrt_width():
    """The plain versions the model is held to, and the model, against the
    JAX kernels at ``bench_dcrt.py``'s two 50-bit moduli and log_n 12
    (interpret mode): the forward at ``out_factor`` 1, the inverse at 1
    from ``in_factor`` 4, bit-equal.  (The lazy factors agree mod q:
    ``tests/test_torch_ntt64.py`` at log_n 4-8.)"""
    log_n, n = 12, 1 << 12
    tables = ntt64.NttTables64(log_n, Q50)
    rng = np.random.default_rng(12)
    x = np.stack([rng.integers(0, 4 * q, (2, n), dtype=np.uint64) for q in Q50])
    y = np.stack([rng.integers(0, 4 * q, (2, n), dtype=np.uint64) for q in Q50])
    fwd = _u64(ntt64.ntt64_forward(tables, u64_tensor(x), 1))
    inv = _u64(ntt64.ntt64_inverse(tables, u64_tensor(y), 1, 4))
    np.testing.assert_array_equal(model_forward(tables, x, 1, 2), fwd)
    np.testing.assert_array_equal(model_inverse(tables, y, 1, 4, 2), inv)
    for i, q in enumerate(Q50):
        plan = PallasNttPlan64(log_n, q)
        np.testing.assert_array_equal(fwd[i], jfrom(pallas_forward64(plan, jto(x[i]), 1)))
        np.testing.assert_array_equal(inv[i], jfrom(pallas_inverse64(plan, jto(y[i]), 1, 8, 4)))
