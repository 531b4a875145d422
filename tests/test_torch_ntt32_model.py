"""A numpy model of kernels 1-2's schedule (``csrc/ntt32.cu`` on the passes
of ``csrc/ntt_passes.cuh``), held word for word against the plain
versions ``ops.ntt32.forward32_plain`` / ``inverse32_plain`` on the CPU.

The model runs the kernels' data flow as written, block by block: the grid
of primes x tiles of T rows, a ragged last tile reading and writing only
its own rows; the pass split (the forward's last pass and the inverse's
first take the remainder, 1-3 stages; log_n <= 3 is one pass); the
forward's first pass reading its groups from the input with its 7 roots in
registers, its last pass storing 2^R adjacent words; the inverse's first
pass loading 2^R adjacent words with its twiddles from the global table,
its later passes reading the staged part of the table only, the last one
folding ``inv_n`` in and storing k n/8 + g; the swizzled shared-memory rows
every pass in between reads and writes; the twiddle index of every stage
and the 16-byte alignment of every vector access.  Every word is checked
below 2^32 and inside its lazy range.  It also checks that the passes cover
every stage once and that each warp of every shared-memory access hits 32
distinct banks, and holds the plain versions to the JAX kernels
(``pallas_forward32`` / ``pallas_inverse32`` in interpret mode) at
NTRU_128's prime and log_n 10.  Tolerance: zero (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan32, pallas_forward32, pallas_inverse32
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.ops import ntt32

M32 = np.uint64(0xFFFFFFFF)
BOOL_PRIMES = (1073692673, 1073668097)  # BOOLEAN_128's convolver
NTRU_Q = 1038337  # NTRU_128's q
PRIMES4 = (1073692673, 1073668097, 1073651713, 1073643521)


def swz(i):
    """The kernels' shared-memory word of slot ``i`` (``SwzNtt``)."""
    return i ^ ((i >> 3) & 31) ^ ((i >> 5) & 3)


def remainder_stages(log_n: int) -> int:
    return log_n - 3 * ((log_n - 1) // 3)


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


def shoup(y, w, wp, q):
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    q = np.uint64(q)
    return (w * y - q * ((y * wp) >> np.uint64(32))) & M32


def check_words(x, below):
    assert (np.asarray(x) < np.uint64(below)).all()


def tiles(rows: int, tile: int):
    """The row ranges of a prime's blocks: ``ceil(rows / tile)`` tiles, the
    last one ragged."""
    return [(r0, min(tile, rows - r0)) for r0 in range(0, rows, tile)]


def gather(x, slots, direct: bool):
    """A pass's groups of ``x (count, n)``: from device memory (the rows as
    they are) or from the swizzled shared-memory rows."""
    return x[:, slots] if direct else x[:, swz(slots)]


def scatter(x, slots, v, direct: bool):
    if direct:
        x[:, slots] = v
    else:
        x[:, swz(slots)] = v


def fwd_stages(v, s0, r, hi, tw, twp, q, staged):
    """R forward stages on ``v (count, 2^R, groups)``; ``staged`` marks a
    pass whose twiddles come from the staged table (each stage's run of 2^e
    roots read in one aligned access), else pass 1's registers."""
    two_q = np.uint64(2 * q)
    for e in range(r):
        run = (1 << (s0 + e)) + (hi << e)  # stage e's 2^e roots
        assert (run % (1 << e) == 0).all() and (run + (1 << e) <= len(tw)).all()
        if not staged:
            assert s0 == 0 and (hi == 0).all() and (run + (1 << e) <= 8).all()
        h = 1 << (r - 1 - e)
        for k in range(1 << r):
            if k & h:
                continue
            ti = run + (k >> (r - e))
            x, y = v[:, k], v[:, k + h]
            tx = np.where(x >= two_q, x - two_q, x)
            ty = shoup(y, tw[ti], twp[ti], q)
            v[:, k], v[:, k + h] = tx + ty, tx + two_q - ty
            check_words(v[:, k], 4 * q)
            check_words(v[:, k + h], 4 * q)


def model_forward(tables: ntt32.NttTables32, x: np.ndarray, out_factor: int, tile: int):
    """The forward kernel on ``x (kp, rows, n)`` u64 words below 4q."""
    kp, rows, n = x.shape
    log_n = tables.log_n
    out = np.full_like(x, 0xDEADBEEF)
    passes = forward_passes(log_n)
    for pi, pl in enumerate(tables.plans):
        q = pl.q
        tw = pl.roots.numpy().astype(np.uint64)
        twp = pl.roots_precon.numpy().astype(np.uint64)
        for r0, count in tiles(rows, tile):
            src = x[pi, r0:r0 + count]
            sm = np.zeros((count, n), dtype=np.uint64)  # the tile's rows, swizzled
            for i, (s0, r) in enumerate(passes):
                first, last = i == 0, i == len(passes) - 1
                slots, hi, log_t = fwd_slots(log_n, s0, r)
                if last:  # 2^R adjacent words a group, aligned for one access
                    assert log_t == 0 and (slots[0] % (1 << r) == 0).all()
                v = gather(src if first else sm, slots, first)
                fwd_stages(v, s0, r, hi, tw, twp, q, staged=not first)
                if last:
                    if out_factor == 1:
                        v = np.where(v >= 2 * q, v - 2 * q, v)
                        v = np.where(v >= q, v - q, v)
                    dst = out[pi, r0:r0 + count]
                    scatter(dst, slots, v, True)
                    out[pi, r0:r0 + count] = dst
                else:
                    scatter(sm, slots, v, False)
    assert (out != 0xDEADBEEF).all()  # every row written by exactly its tile
    return out


def model_inverse(tables: ntt32.NttTables32, x: np.ndarray, out_factor: int, tile: int):
    """The inverse kernel on ``x (kp, rows, n)`` u64 words below 2q."""
    kp, rows, n = x.shape
    log_n = tables.log_n
    out = np.full_like(x, 0xDEADBEEF)
    passes = inverse_passes(log_n)
    staged_from = n - (n >> remainder_stages(log_n))  # the staged part: [n - m, n)
    for pi, pl in enumerate(tables.plans):
        q = pl.q
        two_q = np.uint64(2 * q)
        tw = pl.inv_roots.numpy().astype(np.uint64)
        twp = pl.inv_roots_precon.numpy().astype(np.uint64)
        for r0, count in tiles(rows, tile):
            src = x[pi, r0:r0 + count]
            sm = np.zeros((count, n), dtype=np.uint64)
            for i, (s0, r) in enumerate(passes):
                first, last = i == 0, i == len(passes) - 1
                slots, hi, _ = inv_slots(log_n, s0, r)
                if first:
                    assert s0 == 0 and (slots[0] % (1 << r) == 0).all()
                if last and not first:  # k n/8 + g: a warp's stores adjacent
                    assert (slots == np.arange(n).reshape(8, n // 8)).all()
                v = gather(src if first else sm, slots, first)
                for e in range(r):
                    h = 1 << e
                    start = 1 + n - (n >> (s0 + e))
                    for k in range(1 << r):
                        if k & h:
                            continue
                        xv, yv = v[:, k].copy(), v[:, k + h].copy()
                        if last and e == r - 1:
                            s = xv + yv
                            tx = np.where(s >= two_q, s - two_q, s)
                            a = shoup(tx, pl.inv_n, pl.inv_n_precon, q)
                            b = shoup(xv + two_q - yv, pl.inv_n_w, pl.inv_n_w_precon, q)
                            if out_factor == 1:
                                a, b = np.where(a >= q, a - q, a), np.where(b >= q, b - q, b)
                            v[:, k], v[:, k + h] = a, b
                            check_words(a, out_factor * q)
                            check_words(b, out_factor * q)
                        else:
                            ti = start + (hi << (r - 1 - e)) + (k >> (e + 1))
                            assert (ti < n - 1).all()
                            if not first:  # from the staged part only
                                assert (ti >= staged_from).all()
                            s = xv + yv
                            v[:, k] = np.where(s >= two_q, s - two_q, s)
                            v[:, k + h] = shoup(xv + two_q - yv, tw[ti], twp[ti], q)
                            check_words(v[:, k], 2 * q)
                            check_words(v[:, k + h], 2 * q)
                if last:
                    dst = out[pi, r0:r0 + count]
                    scatter(dst, slots, v, True)
                    out[pi, r0:r0 + count] = dst
                else:
                    scatter(sm, slots, v, False)
    assert (out != 0xDEADBEEF).all()
    return out


def _inputs(primes, rows, n, factor, seed):
    rng = np.random.default_rng(seed)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1, 1)
    return rng.integers(0, 1 << 62, (len(primes), rows, n), dtype=np.uint64) % (factor * q)


def _check(primes, log_n, rows, tile, seed):
    tables = ntt32.NttTables32(log_n, primes)
    n = 1 << log_n
    for of in (1, 4):
        x = _inputs(primes, rows, n, 4, seed)
        want = ntt32.forward32_plain(tables, torch.from_numpy(x.astype(np.int64)), of)
        np.testing.assert_array_equal(model_forward(tables, x, of, tile).astype(np.int64),
                                      want.numpy())
    for of in (1, 2):
        x = _inputs(primes, rows, n, 2, seed + 1)
        want = ntt32.inverse32_plain(tables, torch.from_numpy(x.astype(np.int64)), of)
        np.testing.assert_array_equal(model_inverse(tables, x, of, tile).astype(np.int64),
                                      want.numpy())


@pytest.mark.parametrize("log_n", range(1, 13))
def test_model_matches_plain_every_log_n(log_n):
    """Every row size the kernels take at the main path's widths, 3 primes,
    5 rows in tiles of 2 (the last ragged)."""
    _check(PRIMES4[:3], log_n, 5, 2, log_n)


@pytest.mark.parametrize("primes,log_n,rows,tile", [
    (BOOL_PRIMES, 11, 3, 1),  # BOOLEAN_128, batch 1 (cmux_delta, external products)
    (BOOL_PRIMES, 11, 7, 4),  # a ragged tile of 4
    ((NTRU_Q,), 10, 6, 1),  # NTRU_128's NTT-evk step, batch 1: 6 forward rows
    ((NTRU_Q,), 10, 13, 8),  # ... in tiles of 8, the last ragged
    (PRIMES4, 11, 2, 2),  # the 64-bit torus product's four primes
    (PRIMES4[:1], 9, 3, 2),
])
def test_model_matches_plain(primes, log_n, rows, tile):
    _check(primes, log_n, rows, tile, log_n * 7 + rows)


@pytest.mark.parametrize("log_n", range(1, 15))
def test_passes_cover_every_stage_once(log_n):
    fwd = [s0 + e for s0, r in forward_passes(log_n) for e in range(r)]
    inv = [s0 + e for s0, r in inverse_passes(log_n) for e in range(r)]
    assert fwd == list(range(log_n)) and inv == list(range(log_n))
    passes = -(-log_n // 3)
    assert len(forward_passes(log_n)) == len(inverse_passes(log_n)) == passes
    assert forward_passes(log_n)[-1][1] == inverse_passes(log_n)[0][1] == remainder_stages(log_n)
    if log_n <= 3:
        assert forward_passes(log_n) == inverse_passes(log_n) == [(0, log_n)]
    for s0, r in forward_passes(log_n):  # every pass's groups tile the row
        assert sorted(fwd_slots(log_n, s0, r)[0].reshape(-1)) == list(range(1 << log_n))
    for s0, r in inverse_passes(log_n):
        assert sorted(inv_slots(log_n, s0, r)[0].reshape(-1)) == list(range(1 << log_n))


def _warps(words: np.ndarray) -> np.ndarray:
    """A pass's per-k words ``(2^R, count, groups)`` as the warps access
    them: the block's threads stride over (row, group), 32 consecutive
    iterations a warp."""
    return words.reshape(words.shape[0], -1, 32)


@pytest.mark.parametrize("log_n", range(8, 15))
def test_shared_memory_accesses_are_bank_conflict_free(log_n):
    """Each warp of each shared-memory access of every pass (the forward's
    first-pass stores, middle passes, last-pass loads; the inverse's
    first-pass stores, middle passes, last-pass loads), for a tile of 2
    rows, hits 32 distinct banks."""
    n, count = 1 << log_n, 2
    assert sorted(swz(np.arange(n))) == list(range(n))
    # the kernels address slot base + k 2^ls as swz(base) ^ swz(k << ls):
    # base and k 2^ls share no bit, and swz is linear over XOR
    for slots in [fwd_slots(log_n, s0, r) for s0, r in forward_passes(log_n)] + [
            inv_slots(log_n, s0, r) for s0, r in inverse_passes(log_n)]:
        base, ks = slots[0][0], slots[0] - slots[0][0]
        assert (base[None, :] & ks == 0).all()
        np.testing.assert_array_equal(swz(slots[0]), swz(base)[None, :] ^ swz(ks))
    accesses = [fwd_slots(log_n, s0, r)[0] for s0, r in forward_passes(log_n)]
    accesses += [inv_slots(log_n, s0, r)[0] for s0, r in inverse_passes(log_n)]
    for slots in accesses:  # first passes store, last passes load, the rest both
        words = (np.arange(count)[None, :, None] * n) + swz(slots)[:, None, :]
        banks = _warps(words) % 32
        assert all(len(set(w)) == 32 for w in banks.reshape(-1, 32))


def test_plain_matches_pallas_at_ntru_width():
    """The plain versions the model is held to, against the JAX kernels at
    NTRU_128's prime and log_n 10 (interpret mode), every out_factor."""
    pn = P.NTRU_128
    q, log_n = NTRU_Q, pn.log_n
    assert log_n == 10
    tables = ntt32.NttTables32(log_n, [q])
    pp = PallasNttPlan32(log_n, q)
    rng = np.random.default_rng(10)
    x4 = rng.integers(0, 4 * q, (2, 1 << log_n), dtype=np.uint64).astype(np.uint32)
    for of in (1, 4):
        got = ntt32.forward32(tables, torch.from_numpy(x4.astype(np.int64))[None], of)[0]
        want = np.asarray(pallas_forward32(pp, jnp.asarray(x4), of, 2)).astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want)
    x2 = rng.integers(0, 2 * q, (2, 1 << log_n), dtype=np.uint64).astype(np.uint32)
    for of in (1, 2):
        got = ntt32.inverse32(tables, torch.from_numpy(x2.astype(np.int64))[None], of)[0]
        want = np.asarray(pallas_inverse32(pp, jnp.asarray(x2), of, 2)).astype(np.int64)
        np.testing.assert_array_equal(got.numpy(), want)
