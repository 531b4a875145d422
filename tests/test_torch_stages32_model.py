"""A numpy model of row 11's u32 stage kernels (``lane32_forward_kernel`` /
``lane32_inverse_kernel`` in ``csrc/ntt_stages.cu``, on ``lane_pass`` of
``csrc/ntt_passes.cuh``), held word for word against the plain versions
``ops.ntt_stages.ntt32_stages_forward_plain`` / ``ntt32_stages_inverse_plain``
on the CPU.

The u32 pair runs the u64 pair's machinery (one set of templates), so the
model is the u64 model's data flow (``run_model`` of
``test_torch_stages64_model.py``: the grid of clusters of C = 2^c blocks a
row by tiles of T rows, a ragged last tile; the forward's first c stages on
groups of C words from device memory stored into each slice's owner, the
slices' radix-8 passes with the remainder last, the inverse mirrored; every
shared-memory read behind a barrier) with the u32 pair's words
(:class:`Word32`): 4-byte words in shared memory swizzled within each row by
kernels 1-2's ``SwzNtt``, each warp of every access (32 consecutive groups
of a pass, or 32 offsets of the stages across slices) hitting 32 distinct
banks; the select form's slot reads (the forward's butterfly reads both
lanes' entries, x' = x + Shoup(y, w[x]), y' = x + 2q - Shoup(y, w[y]) with x
below 2q first; the inverse's the y lane's only, x' = x + y below 2q, y' =
Shoup(x + 2q - y, w[y])), each entry once a tile; every word in its lazy
range before each stage (below 4q forward, 2q inverse); the forward's
canonical output by two conditional subtractions at the store.  The grid
rule is the C entry's on a 132-SM card (the u64 model's ``pick_grid`` at 4
bytes a word: a block's tile at most 2^15 words, only rows of at least 2^11
words split, into slices of at least 2^8 words).  log_w runs from 1 to 16 (widths under one
radix-8 group and not multiples of 3 included), on inputs that hold the
range's extremes (0, q, 4q - 1 forward; 2q - 1 inverse), with the repo's
tables and with tables whose x and y entries differ.  Tolerance: zero
(bit-equal).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch.ops import ntt_stages as st
from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
from test_torch_ntt32_model import swz
from test_torch_stages64_model import (Tables, check_words, grid_ok, min_split, pick_grid,
                                       run_model, sub_if)

Q = 1073479681  # next_ntt_prime(30, 17): = 1 mod 2^18, roots to n = 2^17
Q29 = 536813569  # phase 15's n = 2^12 prime
M32 = np.uint64(0xFFFFFFFF)


def shoup32(y, w, wp, q):
    """``shoup_mul_lazy``: ``w y - q hi32(y wp)`` mod 2^32, in [0, 2q)."""
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    with np.errstate(over="ignore"):
        return (w * y - np.uint64(q) * ((y * wp) >> np.uint64(32))) & M32


def warps_conflict_free(words):
    """``words (..., groups)``: each run of 32 consecutive groups (a warp)
    hits 32 distinct banks (words mod 32), a word counted once."""
    g = words.shape[-1]
    for ch in np.asarray(words).reshape(-1, min(g, 32)):
        u = np.unique(ch)
        assert len(np.unique(u % 32)) == len(u), "a shared-memory bank conflict"


class Word32:
    """Row 11's u32 words for the model (see the module docstring)."""

    size = 4

    def __init__(self, forward, q, canonical=True):
        self.forward, self.q, self.canonical = forward, q, canonical

    @staticmethod
    def smem(l, rows, slots):
        return (rows << l) + swz(slots)

    @staticmethod
    def conflict_free(words):
        warps_conflict_free(words)

    def before(self, v, s):
        check_words(v, (4 if self.forward else 2) * self.q)
        return v

    def butterfly(self, v, s, k, h, entry):
        q, two_q = self.q, np.uint64(2 * self.q)
        x, y = v[..., k], v[..., k + h]
        with np.errstate(over="ignore"):
            if self.forward:
                (wx, wpx), (wy, wpy) = entry(k), entry(k + h)
                tx = sub_if(x, two_q)
                mx, my = shoup32(y, wx, wpx, q), shoup32(y, wy, wpy, q)
                v[..., k], v[..., k + h] = (tx + mx) & M32, (tx + two_q - my) & M32
            else:
                w, wp = entry(k + h)
                sxy = (x + y) & M32
                v[..., k + h] = shoup32((x + two_q - y) & M32, w, wp, q)
                v[..., k] = sub_if(sxy, two_q)

    def fix(self, v):
        if self.forward and self.canonical:
            return sub_if(sub_if(v, 2 * self.q), self.q)
        return v


def model32(forward, log_w, q, tabs, x, log_c, tile, canonical=True, seed=0):
    """The u32 stage kernel on ``x (rows, 2^log_w)`` on clusters of 2^log_c
    blocks and tiles of ``tile`` rows; returns its words."""
    return run_model(Word32(forward, q, canonical), log_w, tabs, x, log_c, tile, seed)


# -- the tests ------------------------------------------------------------------


def _tables(log_w, q, forward):
    """Shard 1's slices of the expanded tables of n = 2^(log_w + 1) over 2
    shards (the width the kernels see)."""
    log_n, width = log_w + 1, 1 << log_w
    build = cs.build_expanded_tables32 if forward else cs.build_expanded_inverse_tables32
    w, wp = build(log_n, q)
    rows = slice(1, log_n) if forward else slice(0, log_w)
    return w[rows, width:].contiguous(), wp[rows, width:].contiguous()


def _random_tables(rng, log_w, q):
    """Entries below q drawn for each (stage, lane) on their own, so the two
    entries of a pair differ, with their Shoup quotients."""
    w = rng.integers(0, q, (log_w, 1 << log_w), dtype=np.int64)
    return torch.from_numpy(w), torch.from_numpy((w << 32) // q)


def _inputs(rng, q, factor, rows, width):
    top = factor * q - 1
    x = rng.integers(0, top, (rows, width), dtype=np.int64, endpoint=True)
    ext = np.array([0, q, top, 2 * q - 1], dtype=np.int64)
    flat = x.reshape(-1)
    k = min(flat.size, 4)
    flat[:k], flat[-k:] = ext[:k], ext[::-1][:k]
    return x


def _grids(log_w):
    """The picks at 3 rows and every cluster size with a ragged tile of 2."""
    grids = {pick_grid(3, log_w, True, 4), pick_grid(3, log_w, False, 4)}
    for c in range(4):
        t = 2 if grid_ok(log_w, c, 2, 4) else 1
        if grid_ok(log_w, c, t, 4):
            grids.add((c, t))
    return sorted(grids)


def _y_lanes(log_w):
    """The inverse's y lanes: stage s pairs lanes 2^s apart."""
    s = np.arange(log_w)[:, None]
    return ((np.arange(1 << log_w)[None, :] >> s) & 1) == 1


def _plain(forward, log_w, q, w, wp, x, canonical=True):
    xt = torch.from_numpy(x)
    if forward:
        return st.ntt32_stages_forward_plain(log_w, q, w, wp, xt, 1 if canonical else 4).numpy()
    return st.ntt32_stages_inverse_plain(log_w, q, w, wp, xt).numpy()


def test_pick_grid32():
    """The rule's picks at 4 bytes a word: rows under 2^11 words stay one
    block a row (phase 15's n = 2^12 over D = 4, 8: a warp or two a block,
    where the stages across a cluster cost more than they spread); phase
    15.2's shard (8 rows of 2^11) and 2 rows of 2^14-2^16 take clusters of
    8, one row a block, both ways; a 2^16-word row never sits in one block;
    every pick fits, splits only into slices of 2^8 words and more, and
    takes no larger a tile than the rows need."""
    assert pick_grid(8, 11, True, 4) == (3, 1) and pick_grid(8, 11, False, 4) == (3, 1)
    for log_w in (9, 10):
        assert pick_grid(8, log_w, True, 4) == (0, 1) and pick_grid(8, log_w, False, 4) == (0, 1)
    for log_w in (14, 15, 16):
        assert pick_grid(2, log_w, True, 4) == (3, 1)
        assert pick_grid(2, log_w, False, 4) == (3, 1)
    assert pick_grid(1, 16, True, 4)[0] >= 1 and not grid_ok(16, 0, 1, 4)
    assert pick_grid(2, 9, True, 4) == (0, 1)
    for log_w in range(1, 17):
        for rows in (1, 2, 3, 8, 33, 256, 4096):
            for forward in (True, False):
                c, t = pick_grid(rows, log_w, forward, 4)
                assert grid_ok(log_w, c, t, 4)
                assert (t << (log_w - c)) <= 1 << 15
                assert c == 0 or (log_w - c >= min_split(forward, 4) == 8 and log_w >= 11)
                assert t == 1 or t // 2 < rows


@pytest.mark.parametrize("log_w", range(1, 17))
def test_model32_matches_plain(log_w):
    """Both kernels at every cluster size that fits, on the repo's tables
    (q = 1073479681) and on tables whose pair entries differ (q =
    536813569), canonical and lazy forward output in turn, 3 rows (a ragged
    tile), the range's extremes; the forward reads every lane's entry once
    a tile, the inverse only the y lanes' entries."""
    rng = np.random.default_rng(100 + log_w)
    width = 1 << log_w
    for q, tables in ((Q, "repo"), (Q29, "random")):
        for forward in (True, False):
            w, wp = (_tables(log_w, q, forward) if tables == "repo"
                     else _random_tables(rng, log_w, q))
            for i, (c, t) in enumerate(_grids(log_w)):
                canonical = i % 2 == 0
                x = _inputs(rng, q, 4 if forward else 2, 3, width)
                tabs = Tables(w, wp)
                got = model32(forward, log_w, q, tabs, x.astype(np.uint64), c, t, canonical,
                              seed=i)
                want = _plain(forward, log_w, q, w, wp, x, canonical)
                np.testing.assert_array_equal(got.astype(np.int64), want,
                                              err_msg=f"{tables} fwd {forward} grid {c, t}")
                reads = tabs.reads
                if forward:
                    assert (reads == -(-3 // t)).all(), "an entry not read once a tile"
                else:
                    yl = _y_lanes(log_w)
                    assert (reads[~yl] == 0).all(), "an x lane's entry read"
                    assert (reads[yl] == -(-3 // t)).all(), "a y lane's entry not read once a tile"


@pytest.mark.parametrize("rows,log_w", [(8, 11), (8, 14), (2, 14), (2, 15), (2, 16)])
def test_model32_at_the_picked_grids(rows, log_w):
    """Phase 15.2's shard (8 rows of 2^11), the large ring's shards (2 rows
    of 2^14, 2^15, 2^16 words: n = 2^16 over D = 4, 2 and n = 2^17 over D =
    2) and 8 rows of 2^14, on the grid the rule picks, with tables whose
    pair entries differ."""
    rng = np.random.default_rng(rows + log_w)
    for forward in (True, False):
        c, t = pick_grid(rows, log_w, forward, 4)
        w, wp = _random_tables(rng, log_w, Q)
        x = _inputs(rng, Q, 4 if forward else 2, rows, 1 << log_w)
        got = model32(forward, log_w, Q, Tables(w, wp), x.astype(np.uint64), c, t)
        np.testing.assert_array_equal(got.astype(np.int64), _plain(forward, log_w, Q, w, wp, x))


def test_random_tables_tell_the_slots_apart():
    """With tables whose pair entries differ, a kernel that read the other
    lane's entry would give other words: the forward with the x entry
    serving both lanes, and the inverse with the x lane's entry, both
    differ from the plain versions."""
    rng = np.random.default_rng(7)
    log_w = 6
    w, wp = _random_tables(rng, log_w, Q)
    for forward in (True, False):
        x = _inputs(rng, Q, 4 if forward else 2, 2, 1 << log_w)
        want = _plain(forward, log_w, Q, w, wp, x)
        word = Word32(forward, Q)
        wrong = word.butterfly

        def x_entry(v, s, k, h, entry, wrong=wrong):
            wrong(v, s, k, h, lambda slot: entry(k))

        word.butterfly = x_entry
        got = run_model(word, log_w, Tables(w, wp), x.astype(np.uint64), 0, 1)
        assert not np.array_equal(got.astype(np.int64), want)
