"""A numpy model of row 11's u64 stage kernels (``stages64_forward_kernel`` /
``stages64_inverse_kernel`` in ``csrc/ntt_stages.cu``, on ``lane_pass`` of
``csrc/ntt_passes.cuh``), held word for word against the plain versions
``ops.ntt_stages.ntt64_stages_forward_plain`` / ``ntt64_stages_inverse_plain``
on the CPU.

The model runs the kernels' data flow as written: the grid of clusters of C
= 2^c blocks a row by tiles of T rows (a ragged last tile loading and
storing only its own rows), block r of a cluster holding slice r (lanes r
2^l .. (r + 1) 2^l - 1, l = log_w - c) of each row of its tile in shared
memory at ``swz64(row 2^l + slot)``; the forward's first c stages on groups
of C words (offset j of every slice, block r taking the offsets of its
share) loaded from device memory and stored into each slice's owner over
distributed shared memory, then the stages within a slice as radix-8
passes (the remainder last, the first from device memory where c = 0, the
last storing 2^R adjacent words through the output chain); the inverse
mirrored (the first pass, the remainder, from device memory; the last c
stages on groups gathered from the C slices and stored to device memory
through the output chain).  Each block's shared memory is seeded with
random words, and every read is checked against a write from an earlier barrier epoch (a
block barrier before each pass, a cluster barrier around the stages across
slices).  Every butterfly is row 11's: the forward deferred (approximate
Shoup, x + m, x + 4q - m) or exact (x below 2q, exact Shoup), the inverse's
x + y and approximate Shoup of x + c q - y with the cut of both words to 2q
before a stage where 2 c q >= 2^64; every word is checked inside its lazy
range before each stage (unsigned, q up to 2^62).  Only x lanes' table
entries are read, each once a tile.  Each half-warp of every 8-byte
shared-memory access (16 consecutive groups of a pass, or offsets of the
stages across slices) hits 16 distinct words mod 16.  The C entry's grid
rule (``pick_grid``) is a model here, on a card of 132 SMs whose one-wave
capacity is estimated, not asked of the occupancy API: its picks are what
the model expects, and the card test ``test_stage_kernels_match_plain``
holds the card's own pick to the same split floor and tile rule.  log_w runs from 1 to
16, widths under one radix-8 group and not multiples of 3 included, on
inputs holding the range's extremes (0, q, the top word).  Tolerance: zero
(bit-equal).
"""

import numpy as np
import pytest

from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt_stages as st
from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
from test_torch_ntt64_model import shoup, swz64
from test_torch_ntt_rt64_model import Smem

Q62 = 4611686018425815041  # phase 15's q: exact Shoup, lazy words past 2^63
Q50 = 1125899902124033  # = 1 mod 2^19: the forward defers up to log_w 16
M32 = np.uint64(0xFFFFFFFF)
U32 = np.uint64(32)
TILE_BYTES = 1 << 17  # a block's tile: T rows x 2^l words, at most 128 KB
MIN_SPLIT_BYTES = 1 << 10  # slices of >= 1 KB inverse, 2 KB forward
SMS, SMEM_MAX, THREADS = 132, 232448, 256


# -- the C entry's rules ---------------------------------------------------------
# (over the word size: 8 bytes for the u64 pair, 4 for the u32 pair)


def grid_ok(log_w, c, tile, size=8):
    l = log_w - c
    return 0 <= c <= 3 and l >= max(1, c) and 1 <= tile <= 8 and (tile << l) * size <= TILE_BYTES


def min_split(forward, size=8):
    """The least slice's log a split row takes: 2^7 u64 words inverse, 2^8
    forward; 2^8 u32 words both ways."""
    return 8 if size == 4 else (MIN_SPLIT_BYTES // size).bit_length() - 1 + forward


def threads(l):
    groups = 1 << (l - (l - 3 * ((l - 1) // 3))) if l > 3 else 1
    return min(max(groups, 32), THREADS)


def wave_blocks(log_w, c, tile, size=8):
    """A model of the card's one-wave capacity (the C entry asks the
    occupancy API): blocks an SM holds by shared memory and threads."""
    l = log_w - c
    per_sm = min(SMEM_MAX // (size * (tile << l)), 2048 // threads(l), 32)
    return SMS * per_sm // (1 << c) << c


def pick_grid(rows, log_w, forward=True, size=8):
    """A model of the C entry's ``pick_grid`` (the card's pick can differ
    where its occupancy differs from :func:`wave_blocks`): the fewest waves, for the forward the fewest phases
    (passes, and the stages across the cluster as one), the most SMs busy,
    the largest tile, the smallest cluster; a split row's slices at least
    2 KB forward, 1 KB inverse; the u32 pair (``size`` 4) splits only rows
    of at least 2^11 words, into slices of at least 2^8 words."""
    best = None
    for c in range(4):
        if c > 0 and (log_w - c < min_split(forward, size) or (size == 4 and log_w < 11)):
            break
        for i in range(4):
            t = 1 << i
            if not grid_ok(log_w, c, t, size) or (i > 0 and t // 2 >= rows):
                break
            held = wave_blocks(log_w, c, t, size)
            if held <= 0:
                continue
            grid = -(-rows // t) << c
            phases = (log_w - c + 2) // 3 + (c > 0) if forward else 0
            key = (-(-grid // held), phases, -min(grid, SMS), -t, c)
            if best is None or key < best[0]:
                best = (key, c, t)
    return best[1], best[2]


def test_pick_grid():
    """The model's picks: phase 15's shard (2 rows of 2^14) and the JAX tile (8 rows) take
    clusters of 8, one row a block; 2^15 and 2^16 words split into slices
    that fit; a forward split that adds a phase without saving one is not
    taken (2^9 words stay one block a row; the inverse's costlier passes
    split them over 4 blocks); every pick fits and splits only into slices
    of 2^8 words and more forward, 2^7 inverse."""
    assert pick_grid(2, 14) == (3, 1) and pick_grid(8, 14) == (3, 1)
    assert pick_grid(2, 15) == (3, 1) and pick_grid(1, 16)[0] >= 2
    assert pick_grid(2, 11) == (3, 1)
    assert pick_grid(1, 7) == (0, 1) and pick_grid(2, 9) == (0, 1)
    assert pick_grid(2, 9, forward=False) == (2, 1) and pick_grid(2, 7, forward=False) == (0, 1)
    assert pick_grid(2, 14, forward=False) == (3, 1)
    for log_w in range(1, 17):
        for rows in (1, 2, 3, 8, 33, 256, 4096):
            for forward in (True, False):
                c, t = pick_grid(rows, log_w, forward)
                assert grid_ok(log_w, c, t)
                assert c == 0 or log_w - c >= 7 + forward
                assert t == 1 or t // 2 < rows


# -- row 11's butterflies ----------------------------------------------------------


def shoup_approx(y, w, wp, q):
    """``shoup64_approx``: the quotient without the low cross products'
    carries, up to 2 under."""
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    ylo, yhi, plo, phi = y & M32, y >> U32, wp & M32, wp >> U32
    with np.errstate(over="ignore"):
        q_hat = yhi * phi + ((ylo * phi) >> U32) + ((yhi * plo) >> U32)
        return w * y - np.uint64(q) * q_hat


def sub_if(v, m):
    m = np.uint64(m)
    return np.where(v >= m, v - m, v)


def chain_down(v, q, frm, to):
    for j in range(frm - 1, to - 1, -1):
        v = sub_if(v, q << j)
    return v


def check_words(v, bound):
    if bound < 1 << 64:
        assert (np.asarray(v, dtype=np.uint64) < np.uint64(bound)).all()


class Tables:
    """A (log_w, 2^log_w) table and its quotients, counting each entry's
    reads."""

    def __init__(self, w, wp):
        self.w, self.wp = u64_numpy(w), u64_numpy(wp)
        self.reads = np.zeros(self.w.shape, dtype=np.int64)

    def get(self, stage, lanes):
        np.add.at(self.reads, (stage, lanes), 1)
        return self.w[stage, lanes], self.wp[stage, lanes]


def inverse_schedule(q, log_c, stages):
    """Per stage: (the bound's log before its cut or 0 for none, c q after
    it); and the final bound's log (InvBf64, the C entry's log_out)."""
    out = []
    for _ in range(stages):
        cut = log_c >= 63 or q >= (1 << 63) >> log_c
        out.append((log_c if cut else 0, q << (1 if cut else log_c)))
        log_c = max((1 if cut else log_c) + 1, 2)
    return out, log_c


class Word64:
    """Row 11's u64 words for the model: an 8-byte word, swz64 on the tile's
    word (each half-warp of an access hits 16 distinct words mod 16), the
    butterflies of ``FwdBf64`` / ``InvBf64`` with the x lane's entry, the
    lazy range before each stage, the output chains."""

    size = 8

    def __init__(self, forward, log_w, q, factor):
        self.forward, self.q, self.factor = forward, q, factor
        self.defer = forward and (4 + 4 * log_w) * q < 1 << 64
        self.sched, self.log_out = inverse_schedule(q, (factor - 1).bit_length(), log_w)
        self.log_chain = (4 + 4 * log_w - 1).bit_length()

    @staticmethod
    def smem(l, rows, slots):
        """The shared-memory word of ``slots`` of the tile's ``rows``."""
        return swz64((rows << l) + slots)

    @staticmethod
    def conflict_free(words):
        half_warps_conflict_free(words)

    def before(self, v, s):
        """The words before stage ``s``: checked in range (the inverse's cut
        first)."""
        q = self.q
        if self.forward:
            check_words(v, (4 + 4 * s) * q if self.defer else 4 * q)
            return v
        cut, cq = self.sched[s]
        if cut:
            v = chain_down(v, q, cut, 1)
        check_words(v, cq)
        return v

    def butterfly(self, v, s, k, h, entry):
        """Stage ``s``'s butterfly on slots ``k``, ``k + h``; ``entry(slot)``
        reads a slot's table entry."""
        q, two_q, four_q = self.q, np.uint64(2 * self.q), np.uint64(4 * self.q)
        w, wp = entry(k)
        x, y = v[..., k], v[..., k + h]
        with np.errstate(over="ignore"):
            if self.forward and self.defer:
                m = shoup_approx(y, w, wp, q)
                v[..., k], v[..., k + h] = x + m, x + (four_q - m)
            elif self.forward:
                tx = sub_if(x, two_q)
                m = shoup(y, w, wp, q)
                v[..., k], v[..., k + h] = tx + m, tx + (two_q - m)
            else:
                cq = np.uint64(self.sched[s][1])
                v[..., k], v[..., k + h] = x + y, shoup_approx(x + cq - y, w, wp, q)

    def fix(self, v):
        q = self.q
        if not self.forward:
            return chain_down(v, q, self.log_out, 1)
        if self.defer:
            v = chain_down(v, q, self.log_chain, 2)
        if self.factor <= 2:
            v = sub_if(v, 2 * q)
        return sub_if(v, q) if self.factor == 1 else v


def run_stages(v, word, r, lanes_of, stage0, tab):
    """R stages on groups ``v (..., 2^R)`` (slot k of a group in the last
    axis): forward pairs k, k + 2^(R-1-e), inverse k, k + 2^e; a slot's
    table entry at lane ``lanes_of(slot)`` (broadcast over the groups), the
    word's butterfly; the words' lazy range checked before each stage."""
    for e in range(r):
        s = stage0 + e
        h = 1 << (r - 1 - e) if word.forward else 1 << e
        v = word.before(v, s)
        for k in range(1 << r):
            if not k & h:
                word.butterfly(v, s, k, h, lambda slot, s=s: tab.get(s, lanes_of(slot)))
    return v


def pass_split(l, forward):
    """``(s0, R)`` of the passes within a slice: radix 8, the remainder last
    (the forward) or first (the inverse)."""
    if forward:
        return [(s0, min(3, l - s0)) for s0 in range(0, l, 3)]
    r = l - 3 * ((l - 1) // 3)
    return [(0, r)] + [(s0, 3) for s0 in range(r, l, 3)]


def group_slots(l, s0, r, forward):
    """Slots ``(groups, 2^R)`` of a pass (``group_base``) and their stride's
    log ``ls``."""
    ls = l - s0 - r if forward else s0
    g = np.arange(1 << (l - r))
    base = ((g >> ls) << (ls + r)) + (g & ((1 << ls) - 1))
    return base[:, None] + (np.arange(1 << r)[None, :] << ls), ls


def half_warps_conflict_free(words):
    """``words (..., groups)``: each run of 16 consecutive groups (a
    half-warp) hits 16 distinct words mod 16, a word counted once."""
    g = words.shape[-1]
    if g < 16:
        chunks = words.reshape(-1, g)
    else:
        chunks = words.reshape(-1, 16)
    for ch in chunks:
        u = np.unique(ch)
        assert len(np.unique(u % 16)) == len(u)


def model(forward, log_w, q, tabs, x, log_c, tile, factor, seed=0):
    """The u64 stage kernel on ``x (rows, 2^log_w)`` (u64 words) with the
    per-lane tables ``tabs`` (:class:`Tables`) on clusters of 2^log_c blocks
    and tiles of ``tile`` rows; ``factor`` is the forward's out_factor or
    the inverse's in_factor."""
    return run_model(Word64(forward, log_w, q, factor), log_w, tabs, x, log_c, tile, seed)


def run_model(word, log_w, tabs, x, log_c, tile, seed=0):
    """A stage kernel of ``word``'s type (:class:`Word64`, or the u32 pair's)
    on ``x (rows, 2^log_w)``: the kernels' data flow, one machinery for both
    word types."""
    forward = word.forward
    assert grid_ok(log_w, log_c, tile, word.size)
    rows = x.shape[0]
    rng = np.random.default_rng(seed)
    C, l = 1 << log_c, log_w - log_c
    L = 1 << l
    out = np.zeros_like(x)
    writes = np.zeros(x.shape, dtype=np.int64)
    blk = np.arange(C)[:, None, None]  # block of the cluster (slice)

    def store(row0, cnt, cols, v):
        """Words ``v (cnt, ..., cols' shape)`` to the output rows."""
        rr = row0 + np.arange(cnt).reshape((cnt,) + (1,) * cols.ndim)
        out[rr, cols] = word.fix(v)
        np.add.at(writes, (np.broadcast_to(rr, v.shape), np.broadcast_to(cols, v.shape)), 1)

    for row0 in range(0, rows, tile):
        cnt = min(tile, rows - row0)
        sm = [Smem(tile * L, rng) for _ in range(C)]
        written = [np.full(tile * L, -1) for _ in range(C)]
        epoch = [0]

        def sm_read(b, idx):
            idx = np.asarray(idx)
            assert (written[b][idx] < epoch[0]).all(), "a read not behind a barrier"
            return sm[b].read(idx)

        def sm_write(b, idx, v):
            sm[b].write(idx, v)
            written[b][idx] = epoch[0]

        rloc = np.arange(cnt)[:, None, None]  # a tile's row

        def cross(v_in, stage0):
            """The c stages across slices on offsets j = 0 .. L-1 (every
            block's share), ``v_in (cnt, L, C)``."""
            j = np.arange(L)
            word.conflict_free(word.smem(l, rloc[:, :, 0], j[None, :]))
            return run_stages(v_in, word, log_c, lambda k: j + (k << l), stage0, tabs)

        passes = pass_split(l, forward)
        if forward and log_c:  # the stages across slices, at load
            epoch[0] += 1  # every block of the cluster has started
            j = np.arange(L)[None, :, None]
            k = np.arange(C)[None, None, :]
            v = x[row0 + rloc, j + (k << l)].copy()  # (cnt, L, C)
            v = cross(v, 0)
            for b in range(C):
                sm_write(b, word.smem(l, rloc[:, :, 0], np.arange(L)[None, :]).ravel(),
                         v[:, :, b].ravel())
            epoch[0] += 1  # the cluster barrier before the slices' passes

        stage_off = log_c if forward else 0
        for i, (s0, r) in enumerate(passes):
            slots, _ = group_slots(l, s0, r, forward)  # (groups, 2^R)
            first, last = i == 0, i == len(passes) - 1
            from_global = first and (not forward or log_c == 0)
            to_global = last and (forward or log_c == 0)
            if not from_global and not first:
                epoch[0] += 1  # the block barrier before the pass
            words = word.smem(l, rloc, slots[None])  # (cnt, groups, 2^R)
            for kk in range(1 << r):
                word.conflict_free(words[:, :, kk])
            if from_global:
                v = np.stack([x[row0 + rloc, b * L + slots[None]] for b in range(C)])
            else:
                v = np.stack([sm_read(b, words) for b in range(C)])
            v = run_stages(v, word, r, lambda k: blk * L + slots[:, k], stage_off + s0, tabs)
            if to_global:
                for b in range(C):
                    store(row0, cnt, b * L + slots, v[b])
            else:
                for b in range(C):
                    sm_write(b, words.ravel(), v[b].ravel())

        if not forward and log_c:  # the stages across slices, gathered, to device memory
            epoch[0] += 1  # the cluster barrier: every slice's own stages are done
            j = np.arange(L)[None, :]
            v = np.stack([sm_read(b, word.smem(l, rloc[:, :, 0], j)) for b in range(C)], -1)
            v = cross(v, l)
            k = np.arange(C)[None, None, :]
            store(row0, cnt, np.arange(L)[:, None] + (k[0] << l), v)
    assert (writes == 1).all(), "every output word written exactly once"
    return out


# -- the tests ------------------------------------------------------------------


def _tables(log_w, q, forward):
    """Shard 1's slices of the expanded tables of n = 2^(log_w + 1) over 2
    shards (the width the kernels see)."""
    log_n, width = log_w + 1, 1 << log_w
    build = cs.build_expanded_tables64 if forward else cs.build_expanded_inverse_tables64
    w, wp = build(log_n, q)
    rows = slice(1, log_n) if forward else slice(0, log_w)
    return w[rows, width:].contiguous(), wp[rows, width:].contiguous()


def _inputs(rng, q, factor, rows, width):
    top = min(factor * q, 1 << 64) - 1
    x = rng.integers(0, top, (rows, width), dtype=np.uint64, endpoint=True)
    ext = np.array([0, q, top, q - 1], dtype=np.uint64)
    flat = x.reshape(-1)
    k = min(flat.size, 4)
    flat[:k], flat[-k:] = ext[:k], ext[::-1][:k]
    return x


def _grids(log_w):
    """The picks at 3 rows and every cluster size with a ragged tile of 2."""
    grids = {pick_grid(3, log_w), pick_grid(3, log_w, forward=False)}
    for c in range(4):
        t = 2 if grid_ok(log_w, c, 2) else 1
        if grid_ok(log_w, c, t):
            grids.add((c, t))
    return sorted(grids)


def _x_lanes(log_w, forward):
    s = np.arange(log_w)[:, None]
    lane = np.arange(1 << log_w)[None, :]
    bit = (log_w - 1 - s) if forward else s
    return ((lane >> bit) & 1) == 0


@pytest.mark.parametrize("log_w", range(1, 17))
def test_model_matches_plain(log_w):
    """Both kernels at every cluster size that fits, the deferring and the
    exact-Shoup q, out_factor 1 / 2 / 4 and in_factor 2 / 4 / 8 in turn,
    3 rows (a ragged tile), only x-lane entries read, once a tile."""
    rng = np.random.default_rng(log_w)
    width = 1 << log_w
    for q in (Q62, Q50):
        for forward in (True, False):
            w, wp = _tables(log_w, q, forward)
            factors = (1, 2, 4) if forward else ((2, 4, 8) if 8 * q < 1 << 63 else (2, 4))
            for i, (c, t) in enumerate(_grids(log_w)):
                factor = factors[i % len(factors)]
                x = _inputs(rng, q, 4 if forward else factor, 3, width)
                tabs = Tables(w, wp)
                got = model(forward, log_w, q, tabs, x, c, t, factor, seed=i)
                plain = st.ntt64_stages_forward_plain if forward else st.ntt64_stages_inverse_plain
                want = u64_numpy(plain(log_w, q, w, wp, u64_tensor(x), factor))
                np.testing.assert_array_equal(got, want, err_msg=f"q {q} fwd {forward} grid {c, t}")
                xl = _x_lanes(log_w, forward)
                assert (tabs.reads[~xl] == 0).all(), "a y lane's entry read"
                assert (tabs.reads[xl] == -(-3 // t)).all(), "an x lane's entry not read once a tile"


@pytest.mark.parametrize("rows,log_w", [(2, 14), (8, 14), (2, 15), (1, 16)])
def test_model_at_the_picked_grids(rows, log_w):
    """Phase 15's shards (2 rows of 2^14 and 2^15 words), the JAX tile (8
    rows) and a 512 KB row, on the grid the rule picks, exact Shoup."""
    rng = np.random.default_rng(rows + log_w)
    for forward, factor in ((True, 1), (False, 2)):
        c, t = pick_grid(rows, log_w, forward)
        w, wp = _tables(log_w, Q62, forward)
        x = _inputs(rng, Q62, 4 if forward else 2, rows, 1 << log_w)
        got = model(forward, log_w, Q62, Tables(w, wp), x, c, t, factor)
        plain = st.ntt64_stages_forward_plain if forward else st.ntt64_stages_inverse_plain
        np.testing.assert_array_equal(got, u64_numpy(plain(log_w, Q62, w, wp, u64_tensor(x),
                                                           factor)))


def test_pass_split_and_slots():
    """The passes cover every stage of a slice once (radix 8, the remainder
    last forward, first inverse), and a forward or inverse pass's groups
    cover every slot once."""
    for l in range(1, 15):
        for forward in (True, False):
            split = pass_split(l, forward)
            assert [s for s0, r in split for s in range(s0, s0 + r)] == list(range(l))
            assert all(1 <= r <= 3 for _, r in split)
            assert all(r == 3 for _, r in (split[:-1] if forward else split[1:]))
        for forward in (True, False):
            for s0, r in pass_split(l, forward):
                slots, ls = group_slots(l, s0, r, forward)
                assert sorted(slots.ravel().tolist()) == list(range(1 << l))
                # stage s0 + e pairs slots 2^(l-1-s) apart forward, 2^s inverse
                e = 0
                h = (1 << (r - 1 - e)) if forward else 1 << e
                gap = slots[:, h] - slots[:, 0]
                assert (gap == (1 << (l - 1 - s0) if forward else 1 << s0)).all()


def test_inverse_schedule_matches_plain_bound():
    """The per-stage cut and the final bound equal the plain version's
    loop (2 c q >= 2^64 cuts to 2, then c = max(2c, 4))."""
    for q in (Q62, Q50, 12289):
        for in_factor in (2, 4, 8, 64):
            sched, log_out = inverse_schedule(q, (in_factor - 1).bit_length(), 16)
            c = in_factor
            for cut, cq in sched:
                want_cut = 2 * c * q >= 1 << 64
                assert bool(cut) == want_cut and (not cut or 1 << cut == c)
                c = 2 if want_cut else c
                assert cq == c * q
                c = max(2 * c, 4)
            assert 1 << log_out == c
