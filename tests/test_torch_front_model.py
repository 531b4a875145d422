"""A numpy model of kernel G, ``cmux_front`` (``cmux_front_kernel`` in
``csrc/cmux_front.cu``), held word for word against its plain version
``ops.cmux_front.cmux_front_plain`` and the JAX ``pallas_cmux_front``
(interpret mode) on the CPU.

The model runs the kernel's index map on flat word memory, as the launch
sees it: the mode ``front_pick`` picks (a coefficient a thread below 4
words a row or for a source off 16-byte alignment, else groups of 4 words),
a flat grid of T threads a block, a thread a group (its one degree, at
its row's ciphertext ``ciphertext_of``: row / k1 as a multiply), and for
a group of 4 words c .. c+3: the shared window read ``rotated4`` (two aligned 16-byte
loads at e - e mod 4 and 4 words on, mod 2n, each with one sign, a
row-uniform shift e mod 4) less the group's own 16-byte load, four carry
chains side by side (``digit_step`` on the ``BasisConsts`` host pack), and
for each level the 4 digits lifted mod each prime (``lift_signed``: a
32-bit Barrett on the ``PrimeSet`` host pack) into one 16-byte store at ((pi rows + row) L + l) n
+ c.  Each access is checked for 16-byte alignment and to stay inside its
row, and each (row, group) to be done exactly once at ragged row counts.
Tolerance: zero (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.ops.cmux_pallas import pallas_cmux_front
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_front
from primus_fhe_tpu_torch.ops.cmux_fused import _basis_pack

M32 = 0xFFFFFFFF
WORDS, GROUPS = 0, 1  # cmux_front_kernel<KP, GROUPS>
THREADS = 128  # kFrontThreads


def front_pick(rows, log_n, aligned):
    """``front_pick``: (mode, threads a block, blocks) for ``rows`` rows of
    2^log_n words."""
    mode = GROUPS if log_n >= 2 and aligned else WORDS
    items = rows << (log_n - 2 if mode == GROUPS else log_n)
    return mode, THREADS, -(-items // THREADS)


def degree_mod(d, n):
    """``degree_mod``: C's truncating ``%`` then the sign fix."""
    d = np.fmod(np.asarray(d, dtype=np.int64), 2 * n)
    return np.where(d < 0, d + 2 * n, d)


def k1_magic(k1):
    """The C entry's ``k1_m, k1_s1, k1_s2`` for ``ciphertext_of``."""
    l = (k1 - 1).bit_length()
    return (((1 << l) - k1) << 32) // k1 + 1, min(l, 1), max(l - 1, 0)


def ciphertext_of(row, k1):
    """``ciphertext_of``: ``row // k1`` as a high-word multiply, a
    subtraction, an add and two shifts on 32-bit words."""
    m, s1, s2 = k1_magic(k1)
    assert m < 1 << 32
    row = np.asarray(row, dtype=np.int64)
    t = (row * m) >> 32
    return (t + ((row - t) >> s1)) >> s2


def thread_items(rows, shift, t, blocks):
    """The flat grid's items ``blockIdx.x T + threadIdx.x`` (groups, or
    coefficients), the threads past the last left out."""
    b, th = np.meshgrid(np.arange(blocks), np.arange(t), indexing="ij")
    it = (b * t + th).reshape(-1)
    return it[it < rows << shift]


def rotated4(mem, base, c, d, n):
    """``rotated4``: words c .. c+3 of the row at ``base`` times X^d
    (arrays of groups), from two aligned 16-byte loads."""
    e = c - d
    e = np.where(e < 0, e + 2 * n, e)
    sh, e0 = e & 3, e - (e & 3)
    assert (sh == sh[..., :1]).all() if sh.ndim > 1 else True
    e1 = np.where(e0 + 4 < 2 * n, e0 + 4, e0 + 4 - 2 * n)
    w = []
    for ei in (e0, e1):
        at = base + np.where(ei >= n, ei - n, ei)
        assert (at % 4 == 0).all() and (at - base + 4 <= n).all()  # aligned, inside the row
        x = mem[at[..., None] + np.arange(4)]
        w.append(np.where((ei >= n)[..., None], (-x) & M32, x))
    win = np.concatenate(w, axis=-1)
    return np.take_along_axis(win, sh[..., None] + np.arange(4), axis=-1)


def rotated_at(mem, base, c, d, n):
    """``rotated_at``: coefficient c of the row at ``base`` times X^d."""
    e = c - d
    e = np.where(e < 0, e + 2 * n, e)
    src = mem[base + np.where(e >= n, e - n, e)]
    return np.where(e >= n, (-src) & M32, src)


def digit_step(v, pack, level, carry):
    """``digit_step`` on ``BasisConsts`` (the first 7 words of the pack)."""
    _, log_basis, drop, bm1, cmask, mmb, _ = (int(x) for x in pack[:7])
    temp = ((v >> (drop + level * log_basis)) & bm1) + carry
    nxt = ((temp & cmask) != 0).astype(np.int64)
    sgn = np.where(temp > bm1, 0, (temp + mmb) & M32)
    return np.where(nxt == 1, sgn, temp), nxt


def lift_signed(x, q):
    """``lift_signed`` on the ``PrimeSet`` pack's ``q, floor(2^64 / q)``:
    |v| of the centered value v = (int32)x, Barrett on 32-bit words with
    m = floor(2^32 / q) (the high word of the pack's ratio), one
    conditional subtraction, q - r for v < 0."""
    m = int(cmux_front._lift_pack((q,))[6]) >> 32
    neg = x >> 31 == 1
    a = np.where(neg, (-x) & M32, x)  # |v|, at most 2^31
    r = (a - ((a * m) >> 32) * q) & M32
    assert (r < 2 * q).all()  # the quotient at most one short
    r = np.where(r >= q, r - q, r)
    return np.where(neg & (r != 0), q - r, r)


def model_front(mem, off, bsz, k1, log_n, degrees, basis, primes, threads=None):
    """Kernel G on flat word memory ``mem`` (u32 words in int64, rows from
    word ``off``): returns the ``(kp, bsz, k1, L, n)`` output read from its
    own flat memory, and the launch ``(mode, T, blocks)``; ``threads`` a
    block size in place of the rule's (as ``--front --grids`` sets it)."""
    n, rows, kp = 1 << log_n, bsz * k1, len(primes)
    pack = _basis_pack(basis)
    level = int(pack[0])
    out = np.full(kp * rows * level * n, -1, dtype=np.int64)
    mode, t, blocks = front_pick(rows, log_n, off % 4 == 0)
    if threads is not None:
        t, blocks = threads, -(-blocks * t // threads)
    deg = degree_mod(degrees, n)
    if mode == WORDS:
        it = thread_items(rows, log_n, t, blocks)
        row, c = it >> log_n, it & (n - 1)
        base = off + row * n
        diff = (rotated_at(mem, base, c, deg[ciphertext_of(row, k1)], n) - mem[base + c]) & M32
        carry = ((diff & int(pack[6])) != 0).astype(np.int64)
        for lvl in range(level):
            digit, carry = digit_step(diff, pack, lvl, carry)
            for pi, q in enumerate(primes):
                out[((pi * rows + row) * level + lvl) * n + c] = lift_signed(digit, q)
    else:
        it = thread_items(rows, log_n - 2, t, blocks)
        row, c = it >> (log_n - 2), (it & ((n >> 2) - 1)) << 2
        seen = np.zeros(rows * n // 4, dtype=np.int64)
        np.add.at(seen, row * (n // 4) + c // 4, 1)
        assert (seen == 1).all()  # every (row, group) exactly once
        base = off + row * n
        assert (base % 4 == 0).all()
        own = mem[(base + c)[:, None] + np.arange(4)]
        diff = (rotated4(mem, base, c, deg[ciphertext_of(row, k1)], n) - own) & M32  # (groups, 4)
        carry = ((diff & int(pack[6])) != 0).astype(np.int64)
        for lvl in range(level):
            digit, carry = digit_step(diff, pack, lvl, carry)
            for pi, q in enumerate(primes):
                at = ((pi * rows + row) * level + lvl) * n + c
                assert (at % 4 == 0).all() and (c + 4 <= n).all()  # 16 bytes, inside its row
                out[at[:, None] + np.arange(4)] = lift_signed(digit, q)
    assert (out >= 0).all()
    return out.reshape(kp, bsz, k1, level, n), (mode, t, blocks)


def _degrees(rng, bsz, n):
    d = rng.integers(-4 * n, 4 * n + 1, bsz)
    d[:3] = [-4 * n, 4 * n, 2 * n - 1][:bsz]
    return d


@pytest.mark.parametrize("log_n", [5, 6])
@pytest.mark.parametrize("log_basis,level", [(8, 3), (1, 12)])
def test_model_matches_plain_and_pallas(log_n, log_basis, level):
    """Both modes of the model (a source on 16 bytes and one 4 bytes off),
    the wrapper on the CPU (the plain version, int64 and int32 storage) and
    ``pallas_cmux_front`` in interpret mode give the same words (the
    convolver's two primes at n = 32, its first alone at n = 64)."""
    n, bsz, k1 = 1 << log_n, 3, 2
    primes = tuple(tfhe.make_convolver(log_n, level, 1, log_basis).primes)[:7 - log_n]
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    rng = np.random.default_rng(10 * log_n + level)
    mem = rng.integers(0, 1 << 32, bsz * k1 * n + 4, dtype=np.int64)
    deg = _degrees(rng, bsz, n)
    acc = mem[:bsz * k1 * n].reshape(bsz, k1, n)
    want = np.asarray(pallas_cmux_front(
        jnp.asarray(acc.astype(np.uint32)), jnp.asarray(deg.astype(np.int32)),
        JaxBasis(None, log_basis, reverse_length=level), primes, n)).astype(np.int64)
    plain = cmux_front.cmux_front(torch.from_numpy(acc), torch.from_numpy(deg), basis, primes)
    np.testing.assert_array_equal(plain.numpy(), want)
    plain32 = cmux_front.cmux_front(torch.from_numpy(acc).to(torch.int32), torch.from_numpy(deg),
                                    basis, primes)
    np.testing.assert_array_equal(plain32.numpy().astype(np.int64) & M32, want)
    got, launch = model_front(mem, 0, bsz, k1, log_n, deg, basis, primes)
    assert launch[0] == GROUPS
    np.testing.assert_array_equal(got, want)
    shifted = np.concatenate([mem[-1:], mem[:-1]])  # the rows from word 1: 4 bytes off
    got, launch = model_front(shifted, 1, bsz, k1, log_n, deg, basis, primes)
    assert launch[0] == WORDS
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [1, 3, 7, 129])
@pytest.mark.parametrize("log_n,threads", [
    (2, None),  # one group a row: 128 rows a block
    (5, None),  # 8 groups a row: 16 rows a block
    (11, None),  # 512 groups a row: a block a quarter row
    (11, 32),  # the block sizes --front --grids sets
    (8, 512),
    (1, None),  # a coefficient a thread
])
def test_blocks_cover_each_group_once(rows, log_n, threads):
    """Every (row, group) done exactly once, every window load and store
    aligned and inside its row, and the words equal to the plain
    version's, at ragged row counts (``model_front`` asserts the map; 2
    primes, the 2^8 x 3 gadget)."""
    n = 1 << log_n
    bsz, k1 = (rows, 1) if rows % 2 else (rows // 2, 2)
    primes = (1073692673, 12289)
    basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    rng = np.random.default_rng(rows * 17 + log_n)
    mem = rng.integers(0, 1 << 32, rows * n, dtype=np.int64)
    deg = _degrees(rng, bsz, n)
    got, (mode, t, blocks) = model_front(mem, 0, bsz, k1, log_n, deg, basis, primes, threads)
    assert mode == (WORDS if log_n < 2 else GROUPS) and t == (threads or THREADS)
    want = cmux_front.cmux_front_plain(torch.from_numpy(mem.reshape(bsz, k1, n)),
                                       torch.from_numpy(deg), basis, primes)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("log_n", [2, 3, 6])
def test_window_helper(log_n):
    """``rotated4`` at every group of a row and every degree in [-4n, 4n]
    (across the wrap and the sign flip) equals the plain rotation."""
    from primus_fhe_tpu_torch.ops.rotate import rotate_plain

    n = 1 << log_n
    row = np.random.default_rng(log_n).integers(0, 1 << 32, n, dtype=np.int64)
    degs = np.arange(-4 * n, 4 * n + 1)
    c = np.arange(0, n, 4)
    d = degree_mod(degs, n)
    got = rotated4(row, np.zeros((len(degs), 1), dtype=np.int64), c[None, :], d[:, None], n)
    want = rotate_plain(torch.from_numpy(np.broadcast_to(row, (len(degs), n)).copy()),
                        torch.from_numpy(degs)).numpy()
    np.testing.assert_array_equal(got.reshape(len(degs), n), want)


@pytest.mark.parametrize("log_basis,level", [(8, 3), (1, 12), (8, 4), (7, 3)])
def test_four_carry_chains(log_basis, level):
    """The four carry chains of a group, side by side on the host pack,
    equal the basis's own signed decomposition, edge words included (0,
    2^31, 2^32 - 1, words at a digit's carry boundary)."""
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    pack = _basis_pack(basis)
    rng = np.random.default_rng(log_basis * 31 + level)
    drop = int(pack[2])
    edges = [0, 1 << 31, M32, (1 << 31) - 1, 1 << drop, (1 << drop) - 1 if drop else 7,
             ((1 << (log_basis - 1)) << drop) & M32, M32 ^ ((1 << drop) - 1)]
    v = np.concatenate([np.array(edges, dtype=np.int64),
                        rng.integers(0, 1 << 32, 4 * 63, dtype=np.int64)]).reshape(-1, 4)
    carry = ((v & int(pack[6])) != 0).astype(np.int64)
    digits = []
    for lvl in range(level):
        digit, carry = digit_step(v, pack, lvl, carry)
        digits.append(digit)
    want = basis.decompose(torch.from_numpy(v)).numpy()  # (L, groups, 4)
    np.testing.assert_array_equal(np.stack(digits), want)


@pytest.mark.parametrize("k1", [1, 2, 3, 4, 5, 7, 8, 9, 1000, (1 << 30) - 3])
def test_ciphertext_of_is_row_over_k1(k1):
    """``ciphertext_of`` equals ``row // k1`` on edge rows (0, multiples of
    k1 and their neighbours, 2^30 - 1, 2^31 - 1) and random 31-bit rows."""
    rng = np.random.default_rng(k1 % 997)
    edges = [r for r in (0, 1, k1 - 1, k1, k1 + 1, 5 * k1 - 1, 5 * k1, (1 << 30) - 1,
                         (1 << 31) - 1) if r < 1 << 31]
    row = np.concatenate([np.array(edges, dtype=np.int64),
                          rng.integers(0, 1 << 31, 20000, dtype=np.int64)])
    np.testing.assert_array_equal(ciphertext_of(row, k1), row // k1)


@pytest.mark.parametrize("q", [3, 12289, 1038337, 1073479681, 1073692673, (1 << 30) - 35])
def test_signed_lift_on_every_word_kind(q):
    """``lift_signed`` equals the centered value taken mod q (what
    ``lift_mod_p`` computes) on edge words (0, 1, 2^31 - 1, 2^31, 2^31 + 1,
    2^32 - 1, multiples of q and their negatives) and random words of the
    whole u32 range."""
    rng = np.random.default_rng(q % 1000)
    edges = [0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, M32, q, q - 1, q + 1, 2 * q,
             (-q) & M32, (-2 * q) & M32, (-(q - 1)) & M32, ((1 << 31) // q) * q]
    x = np.concatenate([np.array(edges, dtype=np.int64),
                        rng.integers(0, 1 << 32, 4096, dtype=np.int64)])
    centered = np.where(x >= 1 << 31, x - (1 << 32), x)
    np.testing.assert_array_equal(lift_signed(x, q), centered % q)


def test_launch_rule_at_the_main_path():
    """Phase 13's 64 x 2 rows of 2048 make 65,536 threads of one group,
    batch 1 eight blocks, 1024 x 2 rows 8192; rows of 2 words, or a source
    off 16 bytes, a coefficient a thread."""
    assert front_pick(128, 11, True) == (GROUPS, 128, 512)
    assert front_pick(2, 11, True) == (GROUPS, 128, 8)
    assert front_pick(2048, 11, True) == (GROUPS, 128, 8192)
    assert front_pick(4, 1, True) == (WORDS, 128, 1)
    assert front_pick(128, 11, False) == (WORDS, 128, 2048)
