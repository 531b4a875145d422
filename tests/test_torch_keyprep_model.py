"""A numpy model of kernel C, ``mxu8_forward32`` (``mxu8_forward32_kernel``
in ``csrc/ntt32.cu``, on the passes of ``csrc/ntt_passes.cuh``), held word
for word against its plain version ``ops.ntt_mxu8.mxu8_forward32_plain``
on the CPU.

The model runs the kernel's schedule as written: the C entry's pick of the
tile T and the persistent grid (``c_pick``, on a 132-SM card whose blocks
an SM holds come from the shared memory a block asks for, at most 4:
``resident``); each
block's contiguous range of (prime, tile) items, every item done exactly
once over the blocks; the ring of three slots, with one thread's bulk
load of tile i+1 issued only after the store that last read its slot has
read it (``cp.async.bulk.wait_group.read 1``) and each slot's mbarrier
waited on at the parity of its use; the prime's table staged again where
a block's range crosses into the next prime.  Its data flow is the
kernel's: the bulk copy of a tile's natural rows into its slot, the first
pass from the slot into the swizzled work tile (roots in registers), the
middle passes there, the last pass's canonical words back into the slot
in natural order, the bulk store from it; a ragged last tile moves only
its own rows; every swizzled address as the kernel forms it, at(base) ^
at(k 2^ls) (``SwzRowsC``), equal to the slot's own.  The slot accesses are checked bank by bank: the first
pass's loads (32 adjacent words a warp) and the last pass's 8- or 16-byte
stores (an 8-word group's halves in the lane's order), each quarter-warp
of a 16-byte access or half-warp of an 8-byte one on 32 distinct banks.
Row counts 1, 7, 12 and 769 (every pick: one tile a block, several, a
block's range across two primes), log_n 8-12.  Tolerance: zero
(bit-equal).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch.ops import cmux_mxu, ntt_mxu8
from test_torch_ntt32_model import check_words, forward_passes, fwd_slots, fwd_stages, swz

SLOTS = 3  # C_SLOTS
SMEM_MAX = 232448  # a block's shared-memory cap (SMEM_MAX)
SMEM_SM = 233472  # a Hopper SM's shared memory for blocks (228 KB), 1 KB reserved a block
BOOL_PRIMES = (1073692673, 1073668097)  # BOOLEAN_128's convolver
NTRU_Q = 1038337  # NTRU_128's q


def c_smem_bytes(log_n: int, tile: int) -> int:
    """``c_smem_bytes``: barriers, the table and quotients, work tile, slots."""
    return 128 + 4 * ((2 << log_n) + ((1 + SLOTS) * tile << log_n))


def resident(log_n: int, tile: int) -> int:
    """Blocks an SM holds (the card's occupancy query, modelled): as many as
    its shared memory takes, at most 4 (the card's query gave 5 where a
    block asks for 41 KB, 4200 rows of 1024 at T = 2; the picks at the
    paths' shapes are the same)."""
    smem = c_smem_bytes(log_n, tile)
    return 0 if smem > SMEM_MAX else min(4, SMEM_SM // (smem + 1024))


def c_pick(kp: int, rows: int, log_n: int, sms: int = 132, held=resident):
    """``c_pick``: ``(T, grid)``."""
    t0 = 1 if log_n >= 12 else 8 if log_n <= 9 else 1 << (12 - log_n)
    t = 1
    while t < t0:
        items = kp * -(-rows // t)
        if held(log_n, 2 * t) == 0 or items <= sms * held(log_n, t):
            break
        t *= 2
    items = kp * -(-rows // t)
    return t, min(items, sms * held(log_n, t))


def block_items(items: int, grid: int):
    """Block b's contiguous items ``[b items / grid, (b+1) items / grid)``."""
    return [range(b * items // grid, (b + 1) * items // grid) for b in range(grid)]


class Ring:
    """One block's ring of slots as thread 0 drives it: the bulk loads into
    a slot, each slot's mbarrier phases, the bulk store groups and what
    ``wait_group.read`` lets through.  Asserts that a load never lands in a
    slot whose store has not read it, and that each wait is on the parity
    of the phase its own load completes."""

    def __init__(self):
        self.loads = [0] * SLOTS  # loads issued into each slot
        self.owner = [None] * SLOTS  # the tile a slot holds
        self.stores = []  # committed store groups, oldest first: tile indices
        self.read = set()  # tiles whose store has read its slot

    def load(self, i: int):
        s = i % SLOTS
        prev = self.owner[s]
        assert prev is None or prev in self.read, f"tile {i} loads over tile {prev}'s store"
        self.owner[s] = i
        self.loads[s] += 1

    def wait_read(self, pending: int):
        """``cp.async.bulk.wait_group.read pending``."""
        done = self.stores[:len(self.stores) - pending] if pending else self.stores
        self.read.update(done)

    def wait_full(self, i: int, parity: int):
        s = i % SLOTS
        use = i // SLOTS
        assert self.owner[s] == i and self.loads[s] == use + 1, "waits on another tile's load"
        assert parity == use & 1, "waits on the wrong phase"

    def store(self, i: int):
        self.stores.append(i)


def run_schedule(kp: int, rows: int, log_n: int, sms: int = 132, held=resident, on_tile=None):
    """The kernel's grid and every block's loop (thread 0's ring), calling
    ``on_tile(block, i, item, slot)`` where the block runs tile i's passes;
    returns ``(T, grid, items done in order, tables staged)``."""
    t, grid = c_pick(kp, rows, log_n, sms, held)
    tiles = -(-rows // t)
    items = kp * tiles
    done, staged = [], 0
    for b, rng in enumerate(block_items(items, grid)):
        ring, pi = Ring(), None
        if len(rng):
            ring.load(0)
        for i, item in enumerate(rng):
            if item // tiles != pi:
                pi = item // tiles
                staged += 1
            if i + 1 < len(rng):
                ring.wait_read(1)
                ring.load(i + 1)
            ring.wait_full(i, (i // SLOTS) & 1)
            if on_tile is not None:
                on_tile(b, i, item, i % SLOTS)
            ring.store(i)
            done.append(item)
        ring.wait_read(0)
    return t, grid, done, staged


def model_c(plan, x: np.ndarray, sms: int = 132, held=resident) -> np.ndarray:
    """Kernel C on canonical ``x (kp, rows, n)`` u64 words: the output rows
    (bit-reversed, canonical) as the bulk stores leave them."""
    tables = plan.ntt
    kp, rows, n = x.shape
    log_n = tables.log_n
    out = np.full_like(x, 0xDEADBEEF)
    passes = forward_passes(log_n)
    t = c_pick(kp, rows, log_n, sms, held)[0]
    tiles = -(-rows // t)
    slots = {}

    def on_tile(b, i, item, s):
        pi, r0 = item // tiles, item % tiles * t
        count = min(t, rows - r0)
        pl = tables.plans[pi]
        q = pl.q
        tw = pl.roots.numpy().astype(np.uint64)
        twp = pl.roots_precon.numpy().astype(np.uint64)
        slot = slots.setdefault((b, s), np.zeros((t, n), dtype=np.uint64))
        slot[:count] = x[pi, r0:r0 + count]  # the bulk load: natural rows
        work = np.zeros((count, n), dtype=np.uint64)  # swizzled
        for k, (s0, r) in enumerate(passes):
            idx, hi, log_t = fwd_slots(log_n, s0, r)
            base, kc = idx[0], idx - idx[0]  # SwzRowsC: at(base) ^ at(k << ls)
            assert (swz(base)[None, :] ^ swz(kc) == swz(idx)).all()
            v = slot[:count][:, idx] if k == 0 else work[:, swz(idx)]
            fwd_stages(v, s0, r, hi, tw, twp, q, staged=k > 0)
            if k < len(passes) - 1:
                work[:, swz(idx)] = v
                continue
            assert log_t == 0 and (idx[0] % (1 << r) == 0).all()  # 2^R adjacent words
            v = np.where(v >= 2 * q, v - 2 * q, v)
            v = np.where(v >= q, v - q, v)
            check_words(v, q)
            slot[:count][:, idx] = v  # natural order, back into the slot
        assert (out[pi, r0:r0 + count] == 0xDEADBEEF).all()
        out[pi, r0:r0 + count] = slot[:count]  # the bulk store

    run_schedule(kp, rows, log_n, sms, held, on_tile)
    assert (out != 0xDEADBEEF).all()
    return out


def _inputs(primes, rows, n, seed):
    rng = np.random.default_rng(seed)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1, 1)
    return rng.integers(0, 1 << 62, (len(primes), rows, n), dtype=np.uint64) % q


def check_model(primes, log_n, rows, seed, **kw):
    plan = cmux_mxu.CmuxMxuPlan(log_n, primes)
    x = _inputs(primes, rows, plan.n, seed)
    want = ntt_mxu8.mxu8_forward32_plain(plan, torch.from_numpy(x.astype(np.int64)))
    got = model_c(plan, x, **kw)
    np.testing.assert_array_equal(got.astype(np.int64), want.reshape(got.shape).numpy())


def test_pick():
    """The picks at the key preparations' and ``chip_smoke.py``'s shapes:
    BOOLEAN_128's 2 x 12 rows one tile a block on 24 blocks; 2 x 768 and
    the whole key (2 x 7560) two rows a tile on a wave of 2 blocks an SM;
    NTRU_128's evk (1 x 4200, n = 1024) four rows a tile; tiles of 512
    groups a pass (two a thread) only where the rows need more than one
    wave of smaller ones."""
    assert c_pick(2, 12, 11) == (1, 24)
    assert c_pick(2, 768, 11) == (2, 264)
    assert c_pick(2, 7560, 11) == (2, 264)
    assert c_pick(1, 4200, 10) == (4, 396)
    assert c_pick(1, 6, 10) == (1, 6)
    assert c_pick(2, 7, 8) == (1, 14)
    assert c_pick(2, 769, 8) == (4, 386)
    assert c_pick(2, 5000, 8) == (8, 528)
    assert c_pick(4, 9000, 12) == (1, 264)  # 96 KB a block: 2 an SM
    for log_n in range(8, 13):  # every tile the rule can pick fits
        for t in (1, 2, 4, 8)[:max(1, 13 - log_n)]:
            assert c_smem_bytes(log_n, t) % 16 == 0 and resident(log_n, t) > 0


@pytest.mark.parametrize("kp,rows,log_n", [(1, 1, 11), (2, 7, 11), (2, 12, 11), (2, 769, 11),
                                           (2, 769, 8), (1, 4200, 10), (2, 7560, 11),
                                           (4, 769, 12), (3, 12, 9)])
@pytest.mark.parametrize("sms", [132, 3])
def test_schedule_does_every_item_once(kp, rows, log_n, sms):
    """Every (prime, tile) exactly once over the persistent blocks, each
    block's range contiguous (one table staged, two where the range
    crosses a prime); the ring's invariants (``Ring``) hold throughout."""
    t, grid, done, staged = run_schedule(kp, rows, log_n, sms)
    items = kp * -(-rows // t)
    assert sorted(done) == list(range(items)) and grid <= items
    spans = [r for r in block_items(items, grid) if len(r)]
    assert len(spans) == grid and sum(len(r) for r in spans) == items
    crossings = sum(len({i // -(-rows // t) for i in r}) - 1 for r in spans)
    assert staged == grid + crossings and crossings <= min(kp - 1, grid - 1)


def _banks(words, width):
    """Each phase of a warp's ``width``-word accesses (8 lanes of 16 bytes,
    16 of 8 bytes, 32 of 4) on 32 distinct banks."""
    lanes = 32 // width
    for ph in np.asarray(words).reshape(-1, lanes):
        banks = ((ph[:, None] + np.arange(width)[None, :]) % 32).reshape(-1)
        assert len(set(banks.tolist())) == 32, "a shared-memory bank conflict"


@pytest.mark.parametrize("log_n", range(8, 13))
def test_slot_accesses_are_bank_conflict_free(log_n):
    """The first pass's loads from the slot's natural rows (each k of a
    warp's 32 groups: 32 adjacent words) and the last pass's stores into
    it, at a tile of 2 rows: 8 words a group as two 16-byte stores, the half
    ``(base >> 5) & 1`` first (``StageOut``); 4 words one 16-byte store, 2
    one 8-byte store."""
    n, count = 1 << log_n, 2
    idx = fwd_slots(log_n, 0, 3)[0]  # pass 1: (8, groups)
    words = np.arange(count)[None, :, None] * n + idx[:, None, :]
    for k in range(8):
        _banks(words[k].reshape(-1), 1)
    s0, r = forward_passes(log_n)[-1]
    base = fwd_slots(log_n, s0, r)[0][0]  # the groups' first slot
    its = (np.arange(count)[:, None] * n + base[None, :]).reshape(-1)  # a thread's group
    if r == 3:
        h = (base >> 5) & 1
        first = (np.arange(count)[:, None] * n + base[None, :] + 4 * h[None, :]).reshape(-1)
        second = (np.arange(count)[:, None] * n + base[None, :] + 4 * (1 - h)[None, :]).reshape(-1)
        _banks(first, 4)
        _banks(second, 4)
        with pytest.raises(AssertionError):  # the plain order would conflict two ways
            _banks(its, 4)
    else:
        _banks(its, 1 << r)


@pytest.mark.parametrize("primes,log_n,rows,sms", [
    (BOOL_PRIMES, 11, 1, 132),
    (BOOL_PRIMES, 11, 7, 3),  # 14 tiles over 3 blocks: ranges of 4-5, one across both primes
    (BOOL_PRIMES, 11, 12, 132),  # chip_smoke's batch 1: 24 blocks of one tile
    (BOOL_PRIMES, 8, 769, 132),  # tiles of 4, the last ragged (1 row)
    (BOOL_PRIMES, 9, 12, 1),  # one block, every tile through the ring (tiles of 4)
    ((NTRU_Q,), 10, 7, 2),  # NTRU_128's q: tiles of 2, the last ragged
    (BOOL_PRIMES[:1], 12, 7, 2),
])
def test_model_matches_plain(primes, log_n, rows, sms):
    check_model(primes, log_n, rows, log_n * 100 + rows, sms=sms)
