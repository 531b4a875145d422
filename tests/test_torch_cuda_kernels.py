"""Kernels 1-4, A-G and the four u64 NTT kernels against their plain PyTorch
versions on a CUDA card, at shapes ``chip_smoke.py`` does not reach: kernels
1-2 at N from 2 (one pass) to 16384, 1-4 primes, 1 to 384 rows a prime and a
ragged last tile of rows, and int32 storage; the
one-launch CMux step (kernels 3-4) at N 32-4096, the 2^1 x 12 gadget, k=2
(clusters of 6 blocks), batches 1, 3, 64, 65 and in place; for the int8 kernels log_n 8-12,
k=1 and 2, L 2-4, 1- and 2-byte digits, 2-4 primes, batches that leave
partial clusters (kernels A and B), and NTRU moduli of 20 and 30 bits;
for the u64 butterfly kernels log_n 1-15 (one pass at 1-3, a row over two
blocks at 15), 1-4 moduli, 1 to 512 rows a modulus and a ragged last tile,
for the u64 kernels 50- to 62-bit moduli (lazy words past 2^63),
both input chains of the inverse, 7 and 8 byte planes on inputs past 2^63,
the tiled ``mxu8_forward64`` at rows 1, 2, R - 1, R, R + 1, 16, 64, 256 and
257 (clusters of 1, 2, 4 and 8 slices) and on a residue shard's tables,
the tiled ``mxu8_inverse64`` and kernel D at the same rows, the inverse on
a shard's tables and under ``ntt_large``'s mxu8 route,
and a small DCRT rotation on both routes against the CPU; kernels D and E
(the fused key multiply and round trip) at every log_n 8-12, 7 and 8 planes
(moduli up to 2^62), two moduli and E's ragged tiles, E also against
``mxu8_forward64`` then D and the butterfly route, and the four-step at
2^16 on both routes; row 9's four functions at log_n 13-15 on row 10's
passes (any u64 words, two moduli) and their refusal of log_n 16;
kernel C at log_n 8-12, 1-4 primes, 1 to 769 rows a prime and over the
key preparations' 2 x 7560 and 4200 rows (and its refusal of log_n 7 and
13); a BOOLEAN_128 bootstrap on the MXU key against the CPU; kernel F on
broadcast, contiguous and strided rows into new rows and ``out=`` views at
log_n 1-17; kernels F and G at N 32-2048, degrees of any sign, both
gadgets, and ``cmux_delta`` against kernels 3-4; kernel G at log_n 1-3,
11, 12, 16 and 17, 1-4 primes, L = 3 and 12, int32 and int64 storage and a
source off 16-byte alignment, its launch rule and its ptxas figures (no
stack, no spill); the four stage kernels of the
coefficient-sharded NTT at log_n 9-18 over 2-8 shards (u32, 50- and 62-bit
u64, every ``out_factor`` and both ``in_factor``s, the input range's extreme
words; the u64 pair at log_w 15-17 on batches 1, 3, 8), row 13's split
kernels at log_n 8-14 (7 and 8 planes) and its sharded transforms and
product at log_n 13-14 over 2 and 4 shards against row 10, its refusal of
log_n 7 and 15 before any launch, and a (2, 2)
``LocalMesh`` DCRT rotation on both routes against the single-card one;
at TOY size the circuit bootstrap, ``ggsw_to_ntt``, ``leveled_mux``, the
GLWE and packing key switches and the prime-q phases against the CPU.
Tolerance: zero (bit-equal).

The kernels have no CPU mode, so every test here needs the card and skips
without one.  On the card (the root conftest imports JAX, which that
machine lacks, hence ``--noconftest``)::

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda_kernels.py
"""

import dataclasses

import pytest
import torch

from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot.blind_rotate import blind_rotate, bootstrap
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.boot import ntru_gates
from primus_fhe_tpu_torch.boot.ntru_blind_rotate import NtruContext
from primus_fhe_tpu_torch.ops import (cmux_front, cmux_fused, cmux_mxu, ntru_cmux_mxu, ntt32,
                                      ntt64, ntt_mxu8, rotate)
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32
from primus_fhe_tpu_torch.utils.primes import next_ntt_prime, ntt_prime_chain

pytestmark = pytest.mark.cuda

PRIMES3 = [1073692673, 1073668097, 1073651713]  # 30-bit NTT primes, = 1 mod 2^13


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _residues(gen, primes, shape, factor, dev):
    q = torch.tensor(primes, dtype=torch.int64, device=dev).reshape((-1,) + (1,) * len(shape))
    r = torch.randint(0, 1 << 40, (len(primes),) + tuple(shape), generator=gen, device=dev)
    return r % (factor * q)


PRIMES4 = PRIMES3 + [1073643521]
PRIMES_2E15 = [1073643521, 1073479681]  # = 1 mod 2^15: log_n 13-14
Q32_17 = 1073479681  # next_ntt_prime(30, 17): = 1 mod 2^18, the u32 large ring's q
Q32_18 = 1056440321  # next_ntt_prime(30, 18): = 1 mod 2^19, n = 2^18 (log_w 17 over 2 shards)
BOOL_PRIMES = [1073692673, 1073668097]  # BOOLEAN_128's convolver
NTRU_Q = [1038337]  # NTRU_128's q, = 1 mod 2^11


def _ragged_rows(tables, start):
    """The first row count from ``start`` on that the launch (on this card)
    cuts into tiles of more than one row with a ragged last tile."""
    for rows in range(start, start + 2048):
        tile = ntt32.launch_tile(tables, rows)
        if tile > 1 and rows % tile:
            return rows
    raise AssertionError("no ragged tile within 2048 row counts")


@pytest.mark.parametrize("log_n,primes,rows", [
    pytest.param(1, PRIMES3, (3, 2)), pytest.param(2, PRIMES3, (3, 2)),
    pytest.param(3, PRIMES3, (3, 2)), pytest.param(4, PRIMES3, (3, 2)),
    pytest.param(5, PRIMES3, (3, 2), id="5"), pytest.param(8, PRIMES3, (3, 2), id="8"),
    pytest.param(11, PRIMES3, (3, 2), id="11"), pytest.param(12, PRIMES3, (3, 2), id="12"),
    pytest.param(10, NTRU_Q, (1,)), pytest.param(10, NTRU_Q, (6,)),
    pytest.param(10, NTRU_Q, (384,)), pytest.param(10, NTRU_Q, (64,)),
    pytest.param(11, BOOL_PRIMES, (2,)), pytest.param(11, BOOL_PRIMES, (128,)),
    pytest.param(11, BOOL_PRIMES, "ragged"), pytest.param(10, NTRU_Q, "ragged"),
    pytest.param(11, PRIMES4, (2,)), pytest.param(12, PRIMES4, (3,)),
    pytest.param(13, PRIMES_2E15[:1], (3,)), pytest.param(14, PRIMES_2E15, (2,)),
])
def test_ntt_kernels_match_plain(dev, log_n, primes, rows):
    """Kernels 1-2 against the plain versions, every ``out_factor``: one
    pass (log_n 1-3) and 2-5 passes, the NTRU_128 and BOOLEAN_128 shapes of
    the blind rotations at batch 1 and 64, a ragged last tile, 4 primes and
    log_n 13-14; int64 words and int32 storage; the round trip."""
    tables = ntt32.NttTables32(log_n, primes)
    gen = torch.Generator(device=dev).manual_seed(log_n)
    n = 1 << log_n
    if rows == "ragged":
        rows = (_ragged_rows(tables, 129),)
    kp = len(primes)
    x = _residues(gen, primes, rows + (n,), 4, dev)
    for out_factor in (1, 4):
        want = ntt32.forward32_plain(tables, x, out_factor)
        assert torch.equal(ntt32.forward32(tables, x, out_factor), want)
        got32 = ntt32.forward32(tables, x.to(torch.int32), out_factor)
        assert got32.dtype == torch.int32
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    y = _residues(gen, primes, rows + (n,), 2, dev)
    for out_factor in (1, 2):
        want = ntt32.inverse32_plain(tables, y, out_factor)
        assert torch.equal(ntt32.inverse32(tables, y, out_factor), want)
        got32 = ntt32.inverse32(tables, y.to(torch.int32), out_factor)
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    q = torch.tensor(primes, device=dev).reshape((kp,) + (1,) * (len(rows) + 1))
    roundtrip = ntt32.inverse32(tables, ntt32.forward32(tables, y % q))
    assert torch.equal(roundtrip, y % q)


def test_ntt_kernels_refuse_rows_past_the_card(dev):
    """log_n 27 (past the four-step's 26) raises a ValueError naming the
    limit on the card, before any launch, the tables' own check first (a
    view of one word a row stands in for the row)."""
    tables = ntt32.NttTables32(18, [next_ntt_prime(30, 18)])
    tables.log_n, tables.n = 27, 1 << 27  # the wrapper's check alone
    x = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev).expand(1, 1, 1 << 27)
    before = ntt32.forward32.launches, ntt32.inverse32.launches
    with pytest.raises(ValueError, match="log_n up to 26"):
        ntt32.forward32(tables, x)
    with pytest.raises(ValueError, match="log_n up to 26"):
        ntt32.inverse32(tables, x)
    assert (ntt32.forward32.launches, ntt32.inverse32.launches) == before


@pytest.mark.parametrize("log_n", [18, 20])
def test_four_step_kernels_match_plain(dev, log_n):
    """The four-step past 2^17: kernels 1-2 (kp 3, 1 and 5 rows, every
    out_factor and in place), row 10 and row 9's four functions (2 moduli),
    each with the column launches its C entry issues counted on their own,
    bit-equal to the plain versions."""
    from primus_fhe_tpu_torch.ops import ntt_columns

    tables = TorusConvolver32(log_n, 60).ntt
    gen = torch.Generator(device=dev).manual_seed(log_n)
    cols = (ntt_columns.columns_forward, ntt_columns.columns_inverse)
    for rows in (1, 5):
        x4 = _residues(gen, tables.primes, (rows, 1 << log_n), 4, dev)
        x2 = _residues(gen, tables.primes, (rows, 1 << log_n), 2, dev)
        c0 = [fn.launches for fn in cols]
        for of in (1, 4):
            assert torch.equal(ntt32.forward32(tables, x4, of),
                               ntt32.forward32_plain(tables, x4, of))
        y = x4.to(torch.int32)
        ntt32.forward32(tables, y, 4, out=y)
        assert torch.equal(y.to(torch.int64) & 0xFFFFFFFF, ntt32.forward32_plain(tables, x4, 4))
        for of in (1, 2):
            assert torch.equal(ntt32.inverse32(tables, x2, of),
                               ntt32.inverse32_plain(tables, x2, of))
        assert [fn.launches - b for fn, b in zip(cols, c0)] == [3, 2]
    moduli = [next_ntt_prime(50, log_n), next_ntt_prime(62, log_n)]
    big = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    x = torch.randint(-(1 << 63), (1 << 63) - 1, (2, 3, 1 << log_n), generator=gen, device=dev)
    mt = big.mul_table(torch.stack([torch.randint(0, q, (1 << log_n,), generator=gen, device=dev)
                                    for q in moduli]))
    for name, args, want in (("mxu8_forward64", (), [1, 0]), ("mxu8_inverse64", (), [0, 1]),
                             ("mxu8_inverse64_mul", (mt,), [0, 1]),
                             ("mxu8_roundtrip64_mul", (mt,), [1, 1])):
        fn, plain = getattr(ntt_mxu8, name), getattr(ntt_mxu8, name + "_plain")
        c0 = [f.launches for f in cols]
        assert torch.equal(fn(big, x, *args), plain(big, x, *args)), name
        assert [f.launches - b for f, b in zip(cols, c0)] == want, name  # the entry's columns
    xr = torch.stack([x[i] % q for i, q in enumerate(moduli)])
    assert torch.equal(ntt64.ntt64_forward(big.ntt, xr, 4), ntt64.ntt64_forward_plain(big.ntt, xr, 4))
    assert torch.equal(ntt64.ntt64_inverse(big.ntt, xr % torch.tensor(moduli, device=dev).reshape(
        2, 1, 1)), ntt64.ntt64_inverse_plain(big.ntt, xr % torch.tensor(moduli, device=dev)
                                             .reshape(2, 1, 1)))


PRIMES_2E17 = [next_ntt_prime(30, 17)]  # = 1 mod 2^18: rings to 2^17
PRIMES_2E17 += [next_ntt_prime(30, 17, PRIMES_2E17[0])]
PRIMES_2E17 += [next_ntt_prime(30, 17, PRIMES_2E17[1])]


@pytest.mark.parametrize("log_n", [15, 16, 17])
@pytest.mark.parametrize("kp", [2, 3])
@pytest.mark.parametrize("rows", [1, 16])
def test_ntt_kernels_split_rows_match_plain(dev, log_n, kp, rows):
    """Kernels 1-2 at log_n 15-17, a row over a cluster of 2, 4 or 8 blocks:
    every ``out_factor`` against the plain versions, the input range's
    extreme words, int32 storage written in place (``out=`` the input),
    the round trip."""
    primes = PRIMES_2E17[:kp]
    tables = ntt32.NttTables32(log_n, primes)
    gen = torch.Generator(device=dev).manual_seed(log_n * 10 + kp + rows)
    n = 1 << log_n
    q = torch.tensor(primes, device=dev).reshape(kp, 1, 1)
    x = _residues(gen, primes, (rows, n), 4, dev)
    x[:, 0, :4] = torch.stack([torch.zeros_like(q[:, 0, 0]), 4 * q[:, 0, 0] - 1,
                               q[:, 0, 0], 2 * q[:, 0, 0]], -1)
    for out_factor in (1, 4):
        want = ntt32.forward32_plain(tables, x, out_factor)
        assert torch.equal(ntt32.forward32(tables, x, out_factor), want)
        x32 = x.to(torch.int32)
        assert ntt32.forward32(tables, x32, out_factor, out=x32) is x32
        assert torch.equal(x32.to(torch.int64) & 0xFFFFFFFF, want)
    y = x % (2 * q)
    for out_factor in (1, 2):
        want = ntt32.inverse32_plain(tables, y, out_factor)
        assert torch.equal(ntt32.inverse32(tables, y, out_factor), want)
        got32 = ntt32.inverse32(tables, y.to(torch.int32), out_factor)
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    assert torch.equal(ntt32.inverse32(tables, ntt32.forward32(tables, x % q)), x % q)
    assert ntt32.launch_tile(tables, rows) == 1


# (log_n, log_basis, level, k, bound_bits or None): the staged route's
# shapes of chip_smoke.py phase 21.2 and BOOLEAN_128's gadget at 2^13
STAGED_SHAPES = [(15, 7, 3, 1, None), (16, 7, 3, 1, 60), (10, 7, 3, 2, 60), (10, 1, 20, 1, None),
                 (13, 7, 3, 1, None), (4, 8, 3, 3, None), (17, 7, 3, 1, None)]


def _staged_setup(dev, log_n, log_basis, level, k, bound, bsz, seed):
    conv = (TorusConvolver32(log_n, bound) if bound
            else tfhe.make_convolver(log_n, level, k, log_basis))
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 1 << log_n
    acc = torch.randint(0, 1 << 32, (bsz, k + 1, n), generator=gen, device=dev)
    key = _residues(gen, conv.primes, (k + 1, level, k + 1, n), 1, dev)
    return conv, basis, gen, acc, key


@pytest.mark.parametrize("log_n,log_basis,level,k,bound", STAGED_SHAPES)
def test_cmux_stage2_kernel_matches_plain(dev, log_n, log_basis, level, k, bound):
    """Kernel H alone against ``cmux_stage2_plain`` on lazy ``[0, 4p)``
    digits (the extreme words 0 and 4p - 1 included), batch 1 and 3, into a
    new tensor and in place; ``cmux_stage1`` (kernels G and 1) against
    ``cmux_stage1_plain``."""
    for bsz in (1, 3):
        conv, basis, gen, acc, key = _staged_setup(dev, log_n, log_basis, level, k, bound, bsz,
                                                   log_n + 31 * level + bsz)
        assert cmux_fused.step_route(conv.count, k + 1, level, log_n) == "staged" or log_n < 12
        f = _residues(gen, conv.primes, (bsz * (k + 1), level, 1 << log_n), 4, dev)
        q = torch.tensor(conv.primes, device=dev)
        f[:, 0, 0, :2] = torch.stack([torch.zeros_like(q), 4 * q - 1], -1)
        want = cmux_fused.cmux_stage2_plain(conv, f, key, acc)
        before = cmux_fused.cmux_stage2.launches
        assert torch.equal(cmux_fused.cmux_stage2(conv, f, key, acc), want)
        acc32 = acc.to(torch.int32)
        out = cmux_fused.cmux_stage2(conv, f.to(torch.int32), key.to(torch.int32), acc32,
                                     out=acc32)
        assert out is acc32 and torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, want)
        assert cmux_fused.cmux_stage2.launches - before == 2
        degrees = torch.randint(-4 << log_n, 4 << log_n, (bsz,), generator=gen, device=dev)
        want1 = cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees)
        assert torch.equal(cmux_fused.cmux_stage1(conv, basis, acc, degrees), want1)


@pytest.mark.parametrize("log_n,log_basis,level,k,bound", STAGED_SHAPES[:4])
def test_staged_cmux_steps_match_plain(dev, log_n, log_basis, level, k, bound):
    """The staged route (kernel G, kernel 1, kernel H: three launches a
    step, no fused launch) over 4 consecutive steps at batch 2, the
    accumulator updated in place, against the plain step on the same CUDA
    tensors."""
    conv, basis, gen, acc, key = _staged_setup(dev, log_n, log_basis, level, k, bound, 2,
                                               log_n * 7 + level)
    plan = cmux_fused.CmuxStepPlan(conv, basis, k + 1, dev)
    assert plan.route == "staged"
    acc32, key32 = acc.to(torch.int32), key.to(torch.int32)
    counted = (cmux_front.cmux_front, ntt32.forward32, cmux_fused.cmux_stage2,
               cmux_fused.fused_cmux_step)
    before = [fn.launches for fn in counted]
    for step in range(4):
        degrees = torch.randint(0, 2 << log_n, (2,), generator=gen, device=dev, dtype=torch.int32)
        acc = cmux_fused.cmux_stage2_plain(
            conv, cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees), key, acc)
        assert plan(acc32, degrees, key32, out=acc32) is acc32
        assert torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, acc), step
    assert [fn.launches - b for fn, b in zip(counted, before)] == [4, 4, 4, 0]


def test_staged_route_limits_and_fused_shapes(dev):
    """BOOLEAN_128 and the shapes the card ran before keep the fused
    kernel; past kp 4, L 32 or log_n 17 the plan raises before any
    launch; kernel H's launch at batch 1 spreads a row over the most slices
    a cluster of 16 blocks holds (4 at log_n 16 over 3 primes, 8 at log_n
    15 over 2)."""
    for p in (P.BOOLEAN_128, P.BOOLEAN_TFHE_LIB, P.TOY):
        conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
        basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
        assert cmux_fused.CmuxStepPlan(conv, basis, p.glwe_dim + 1, dev).route == "fused"
    conv = tfhe.make_convolver(18, 3, 1, 1)  # past 2^17: staged, kernel H split in two
    plan = cmux_fused.CmuxStepPlan(conv, ApproxSignedBasis32(None, 1, reverse_length=3), 2, dev)
    assert plan.route == "staged" and plan._stage2.split
    with pytest.raises(ValueError, match="log_n 4-26"):
        cmux_fused.step_route(3, 2, 3, 27)
    with pytest.raises(ValueError, match="1-32"):  # no torus basis has 33 levels
        cmux_fused.step_route(2, 2, 33, 10)
    blocks, threads, smem, held = cmux_fused.launch_grid(TorusConvolver32(16, 60), 2, 1)
    assert (blocks, threads, smem) == (4, 512, 1 << 16) and held >= 1  # 2^14-word slices
    wide = tfhe.make_convolver(15, 3, 1, 7)  # chip_smoke.py phase 21's ring, kp 2
    assert cmux_fused.launch_grid(wide, 2, 1)[:3] == (8, 512, 4 * (3 * 4096 + 2048))


def _slices_at_batch1(kp: int, log_n: int, min_log: int) -> int:
    """The blocks a row ``pick_slices`` gives a batch whose clusters the
    card holds in one wave at every candidate: the most, kp C <= 16 and
    slices of 2^min_log words or more (at least the 2^15-word floor's)."""
    lo = max(0, log_n - 15)
    lc = lo
    while kp << (lc + 1) <= 16 and log_n - lc - 1 >= min_log:
        lc += 1
    return 1 << lc


def _check_slice_grid(grid, kp: int, log_n: int, min_log: int, acc_words) -> None:
    """A launch of kernel H or J: 2^lc blocks a row, kp 2^lc <= 16, its
    threads, and its shared words: the slice, and up to 2^13 words a slice
    also the slice's twiddles and quotients and ``acc_words(2^l)`` of
    acc."""
    blocks, threads, smem, held = grid
    lc = blocks.bit_length() - 1
    l, nl = log_n - lc, 1 << (log_n - lc)
    assert blocks == 1 << lc and kp * blocks <= 16 and held >= 1
    assert threads == min(max(nl >> 2, 32), 512)
    assert smem == 4 * (3 * nl + acc_words(nl) if l <= 13 else nl)
    assert l <= 15 and (l >= min_log or lc == max(0, log_n - 15))


@pytest.mark.parametrize("log_n", [12, 13, 14, 15, 16, 17])
@pytest.mark.parametrize("bits", [20, 30, 60, 90])  # kp 1, 2, 3, 4
def test_cmux_stage2_over_slices_matches_plain(dev, log_n, bits):
    """Kernel H at the slices a row its launch picks (``launch_grid``: a
    cluster of kp C <= 16 blocks, slices of 2^11-2^15 words; at batch 1
    the most slices that allows), k1 2, L 3, batch 1 and 16, against
    ``cmux_stage2_plain``: int64 words into a new tensor, int32 storage in
    place."""
    conv = TorusConvolver32(log_n, bits)
    kp, k1, level, n = conv.count, 2, 3, 1 << log_n
    assert kp == {20: 1, 30: 2, 60: 3, 90: 4}[bits]
    gen = torch.Generator(device=dev).manual_seed(log_n * 11 + bits)
    key = _residues(gen, conv.primes, (k1, level, k1, n), 1, dev)
    for bsz in (1, 16):
        grid = cmux_fused.launch_grid(conv, k1, bsz)
        _check_slice_grid(grid, kp, log_n, 11, lambda nl: -(-nl // kp))
        if bsz == 1:
            assert grid[0] == _slices_at_batch1(kp, log_n, 11), grid
        f = _residues(gen, conv.primes, (bsz * k1, level, n), 4, dev)
        q = torch.tensor(conv.primes, device=dev)
        f[:, 0, 0, :2] = torch.stack([torch.zeros_like(q), 4 * q - 1], -1)
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=gen, device=dev)
        want = cmux_fused.cmux_stage2_plain(conv, f, key, acc)
        before = cmux_fused.cmux_stage2.launches
        assert torch.equal(cmux_fused.cmux_stage2(conv, f, key, acc), want), (bsz, grid)
        acc32 = acc.to(torch.int32)
        out = cmux_fused.cmux_stage2(conv, f.to(torch.int32), key.to(torch.int32), acc32,
                                     out=acc32)
        assert out is acc32 and torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, want)
        assert cmux_fused.cmux_stage2.launches - before == 2


@pytest.mark.parametrize("bsz", [1, 3, 64, 65])
@pytest.mark.parametrize(
    "log_n,log_basis,level,k",
    [(5, 8, 3, 1), (8, 1, 12, 1), (11, 7, 3, 1), (8, 8, 2, 2), (12, 7, 2, 2)],
)
def test_cmux_kernels_match_plain(dev, log_n, log_basis, level, k, bsz):
    """The one-launch step (BOOLEAN_128 is (11, 7, 3, 1); k = 2 runs
    clusters of 6 blocks) against the plain composition, degrees 0, 7, n,
    2n - 1 first, then any sign; int64 words, int32 storage, and the plan
    updating the accumulator in place."""
    n = 1 << log_n
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(log_n * 100 + log_basis + bsz)
    acc = torch.randint(0, 1 << 32, (bsz, k + 1, n), generator=gen, device=dev)
    extra = torch.randint(-4 * n, 4 * n, (max(bsz - 4, 0),), generator=gen, device=dev)
    degrees = torch.cat([torch.tensor([7, 0, n, 2 * n - 1], device=dev)[:bsz], extra])
    degrees = degrees.to(torch.int32)
    key = _residues(gen, conv.primes, (k + 1, level, k + 1, n), 1, dev)
    want = cmux_fused.cmux_stage2_plain(
        conv, cmux_fused.cmux_stage1_plain(conv, basis, acc, degrees), key, acc)
    before = cmux_fused.fused_cmux_step.launches
    assert torch.equal(cmux_fused.fused_cmux_step(conv, basis, acc, degrees, key), want)
    acc32, key32 = acc.to(torch.int32), key.to(torch.int32)
    step = cmux_fused.fused_cmux_step(conv, basis, acc32, degrees, key32)
    assert step.dtype == torch.int32
    assert torch.equal(step.to(torch.int64) & 0xFFFFFFFF, want)
    plan = cmux_fused.CmuxStepPlan(conv, basis, k + 1, dev)
    assert plan(acc32, degrees, key32, out=acc32) is acc32
    assert torch.equal(acc32.to(torch.int64) & 0xFFFFFFFF, want)
    assert cmux_fused.fused_cmux_step.launches - before == 3


def test_launch_counts_and_toy_bootstrap(dev):
    """A TOY bootstrap on the card equals the CPU one on the same keys and
    launches the CMux step kernel once per key slice."""
    gen = torch.Generator(device=dev).manual_seed(7)
    ctx = P.make_context(P.TOY, dev, gen)
    cts = ctx.encrypt(torch.tensor([0, 1, 1], device=dev), gen)
    tp = torch.full((ctx.params.n,), 1 << 29, dtype=torch.int64, device=dev)
    before = cmux_fused.fused_cmux_step.launches
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, ctx.params.log_n)
    assert cmux_fused.fused_cmux_step.launches - before == ctx.params.lwe_dim
    cpu = bootstrap(ctx.conv, ctx.basis, ctx.bsk.cpu(), cts.cpu(), tp.cpu(), ctx.params.log_n)
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("log_n,kp", [(8, 1), (9, 2), (10, 3), (11, 2)]
                         + [(log_n, kp) for log_n in range(8, 13) for kp in (1, 2)
                            if (log_n, kp) not in ((9, 2), (11, 2))] + [(12, 4)])
def test_mxu8_forward_matches_plain(dev, log_n, kp):
    """Kernel C at log_n 8-12 and 1-4 primes on 1, 5, 7, 12, 769 and 7560
    rows a prime (one tile a block, several tiles a block through the ring,
    a ragged last tile, a block's range across two primes), int64 words
    and int32 storage, the row and grid the launch picks."""
    plan = cmux_mxu.CmuxMxuPlan(log_n, PRIMES4[:kp])
    gen = torch.Generator(device=dev).manual_seed(log_n)
    for rows in (1, 5, 7, 12, 769, 7560):
        x = _residues(gen, PRIMES4[:kp], (rows, 1 << log_n), 1, dev)
        want = ntt_mxu8.mxu8_forward32_plain(plan, x)
        assert torch.equal(ntt_mxu8.mxu8_forward32(plan, x), want), rows
        got32 = ntt_mxu8.mxu8_forward32(plan, x.to(torch.int32))
        assert got32.dtype == torch.int32
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want), rows
        tile, grid = ntt_mxu8.launch_grid(plan, rows)
        assert tile >= 1 and 1 <= grid <= kp * -(-rows // tile)


def test_mxu8_forward_at_the_key_preparations(dev):
    """Kernel C over BOOLEAN_128's whole bootstrap key (2 x 7560 rows of
    2048) and NTRU_128's evk (4200 rows of 1024), and the packs
    ``prepare_mxu_bsk`` / ``prepare_mxu_evk`` make on the card equal the
    ones made on the CPU from the same words."""
    gen = torch.Generator(device=dev).manual_seed(7560)
    conv = tfhe.make_convolver(11, 3, 1, 7)
    plan = cmux_mxu.plan_for(conv)
    x = _residues(gen, conv.primes, (7560, 2048), 1, dev)
    assert torch.equal(ntt_mxu8.mxu8_forward32(plan, x.to(torch.int32)).to(torch.int64)
                       & 0xFFFFFFFF, ntt_mxu8.mxu8_forward32_plain(plan, x))
    nplan = ntru_cmux_mxu.get_ntru_plan(10, NTRU_Q[0])
    y = _residues(gen, NTRU_Q, (4200, 1024), 1, dev)
    assert torch.equal(ntt_mxu8.mxu8_forward32(nplan, y), ntt_mxu8.mxu8_forward32_plain(nplan, y))
    ggsw = torch.randint(0, 1 << 32, (8, 2, 3, 2, 2048), generator=gen, device=dev)
    for got, want in zip(cmux_mxu.prepare_mxu_bsk(conv, ggsw),
                         cmux_mxu.prepare_mxu_bsk(conv, ggsw.cpu())):
        assert torch.equal(got.cpu(), want)
    nctx = NtruContext(10, NTRU_Q[0], 3, 6)
    evk = torch.randint(0, NTRU_Q[0], (8, 6, 1024), generator=gen, device=dev)
    for got, want in zip(ntru_cmux_mxu.prepare_mxu_evk(nctx, evk),
                         ntru_cmux_mxu.prepare_mxu_evk(nctx, evk.cpu())):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("log_n", [7, 27])
def test_mxu8_forward_refuses_log_n_outside_8_to_12(dev, log_n):
    """The wrapper takes log_n 8-26 (kernel C to 12, kernel 1 at 13-26):
    the plan refuses 7 and 27 (no 30-bit NTT prime there: ``ValueError``),
    before any launch of either kernel."""
    before = (ntt_mxu8.mxu8_forward32.launches, ntt32.forward32.launches)
    with pytest.raises(ValueError, match="log_n"):
        plan = cmux_mxu.CmuxMxuPlan(log_n, (next_ntt_prime(30, log_n),))
        ntt_mxu8.mxu8_forward32(plan, torch.zeros((1, 3, 1 << log_n), dtype=torch.int32,
                                                  device=dev))
    assert (ntt_mxu8.mxu8_forward32.launches, ntt32.forward32.launches) == before


@pytest.mark.parametrize("log_n", [13, 14, 15, 16, 17])
def test_mxu8_forward_route_past_kernel_c(dev, log_n):
    """``mxu8_forward32`` at log_n 13-17 (kp 2, 1 and 16 rows a prime):
    kernel 1 at out_factor 1, one launch, no kernel C launch, the plain
    version's words (int64 and int32 storage)."""
    primes = tuple(TorusConvolver32(log_n, 56).primes)
    plan = cmux_mxu.CmuxMxuPlan(log_n, primes)
    gen = torch.Generator(device=dev).manual_seed(log_n)
    for rows in (1, 16):
        x = _residues(gen, primes, (rows, 1 << log_n), 1, dev)
        want = ntt_mxu8.mxu8_forward32_plain(plan, x)
        before = (ntt_mxu8.mxu8_forward32.launches, ntt32.forward32.launches)
        assert torch.equal(ntt_mxu8.mxu8_forward32(plan, x), want), rows
        got32 = ntt_mxu8.mxu8_forward32(plan, x.to(torch.int32))
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want), rows
        assert (ntt_mxu8.mxu8_forward32.launches - before[0],
                ntt32.forward32.launches - before[1]) == (0, 2)
    assert plan._per_prime is None


def test_mxu_step_route_on_a_grid(dev):
    """``mxu_step_route`` on the card (kernel A's C entry answering) over kp
    1, 2, 4, k1 1-4, L 1-8, 12, 20 and 32, log_n 8-17 and 1- and 2-byte
    digits: kernel A only at log_n 8-12 and, where it holds at some L, at
    every smaller L too (its plan grows with L); elsewhere ``step_route``'s
    answer, and log_n 27 raises before any launch; the named shapes;
    ``ntru_step_route`` on kernel B's answers."""
    levels = list(range(1, 9)) + [12, 20, 32]
    for log_n in range(8, 18):
        for kp in (1, 2, 4):
            for k1 in range(1, 5):
                for dp in (1, 2):
                    routes = [cmux_mxu.mxu_step_route(kp, k1, level, log_n, dp)
                              for level in levels]
                    held = [r == "mxu" for r in routes]
                    assert held == sorted(held, reverse=True), (kp, k1, log_n, dp)
                    assert log_n <= 12 or not any(held)
                    for level, r in zip(levels, routes):
                        assert r == "mxu" or r == cmux_fused.step_route(kp, k1, level, log_n)
    assert cmux_mxu.mxu_step_route(2, 2, 3, 11, 1) == "mxu"  # BOOLEAN_128
    assert cmux_mxu.mxu_step_route(2, 2, 3, 12, 1) == "fused"  # its gadget at N = 4096
    assert cmux_mxu.mxu_step_route(2, 2, 3, 15, 1) == "staged"
    assert cmux_mxu.mxu_step_route(2, 2, 3, 18, 1) == "staged"  # the split H past 2^17
    with pytest.raises(ValueError, match="log_n 4-26"):
        cmux_mxu.mxu_step_route(2, 2, 3, 27, 1)
    assert [ntru_cmux_mxu.ntru_step_route(*s) for s in
            ((6, 10, 1), (16, 10, 1), (20, 10, 1), (6, 12, 1), (6, 13, 1))] == [
        "mxu", "mxu", "staged", "staged", "staged"]


@pytest.mark.parametrize("log_n,route", [(12, "fused"), (15, "staged")])
def test_mxu_key_past_kernel_a_matches_cpu(dev, log_n, route):
    """``blind_rotate`` on an MXU pack made by ``prepare_mxu_bsk`` with
    BOOLEAN_128's gadget (k = 1, 2^7 x 3) where kernel A refuses the shape:
    at N = 4096 (k1 L = 6, a plan past 227 KB) the fused step, at N = 2^15
    kernels G, 1 and H, once a key slice each, on the pack's values and no
    kernel A launch; the words equal the CPU's rotation on the same pack
    (kernel A's plain version), at batch 2 over 3 key slices."""
    n_lwe, k1, level = 3, 2, 3
    n = 1 << log_n
    conv = tfhe.make_convolver(log_n, level, 1, 7)
    basis = ApproxSignedBasis32(None, 7, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(log_n + 24)
    ggsw = torch.randint(0, 1 << 32, (n_lwe, k1, level, k1, n), generator=gen, device=dev)
    pack = cmux_mxu.prepare_mxu_bsk(conv, ggsw)
    assert cmux_mxu.mxu_step_route(conv.count, k1, level, log_n, 1) == route
    sw = torch.randint(0, 2 * n, (2, n_lwe + 1), generator=gen, device=dev, dtype=torch.int32)
    tp = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev)
    counted = (cmux_mxu.mxu_cmux_step, cmux_fused.fused_cmux_step, cmux_front.cmux_front,
               ntt32.forward32, cmux_fused.cmux_stage2)
    before = [fn.launches for fn in counted]
    got = blind_rotate(conv, basis, pack, sw, tp)
    staged = n_lwe if route == "staged" else 0
    assert [fn.launches - b for fn, b in zip(counted, before)] == [
        0, n_lwe - staged, staged, staged, staged]
    want = blind_rotate(conv, basis, tuple(x.cpu() for x in pack), sw.cpu(), tp.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("log_n,q_bits,log_basis,level", [(10, 20, 3, 6), (13, 20, 3, 6),
                                                          (16, 30, 10, 3), (9, 20, 1, 16)])
def test_ntru_digits_kernel_matches_plain(dev, log_n, q_bits, log_basis, level):
    """Kernel I against ``ntru_digits_plain`` at batch 1 and 3, the words
    0, q - 1, q // 2 and the wrap threshold included, into a new tensor
    (int64 and int32 storage) and into ``out``."""
    n, q = 1 << log_n, next_ntt_prime(q_bits, log_n)
    basis = ApproxSignedBasis32(q, log_basis, level)
    gen = torch.Generator(device=dev).manual_seed(log_n + q_bits)
    for bsz in (1, 3):
        acc = torch.randint(0, q, (bsz, n), generator=gen, device=dev)
        acc[0, :4] = torch.tensor([0, q - 1, q // 2, basis.wrap_threshold or 1])
        want = ntru_cmux_mxu.ntru_digits_plain(basis, acc)
        before = ntru_cmux_mxu.ntru_digits.launches
        assert torch.equal(ntru_cmux_mxu.ntru_digits(basis, acc), want)
        out = torch.empty((level, bsz, n), dtype=torch.int32, device=dev)
        assert ntru_cmux_mxu.ntru_digits(basis, acc.to(torch.int32), out=out) is out
        assert torch.equal(out.to(torch.int64), want)
        assert ntru_cmux_mxu.ntru_digits.launches - before == 2


@pytest.mark.parametrize("log_n,q_bits,level", [(10, 20, 6), (13, 20, 6), (15, 30, 3),
                                                (16, 30, 3), (8, 20, 20)])
def test_ntru_stage2_kernel_matches_plain(dev, log_n, q_bits, level):
    """Kernel J against ``ntru_stage2_plain`` on lazy ``[0, 4q)`` digits
    (0 and 4q - 1 included) at batch 1 and 5, degrees 0, 2n - 1, n and any
    sign, into a new tensor and in place (a row over 4-16 blocks at log_n
    12-16); its launch rule."""
    n, q = 1 << log_n, next_ntt_prime(q_bits, log_n)
    tables = ntt32.NttTables32(log_n, (q,))
    gen = torch.Generator(device=dev).manual_seed(log_n * 5 + level)
    evk = torch.randint(0, q, (level, n), generator=gen, device=dev)
    for bsz in (1, 5):
        f = torch.randint(0, 4 * q, (level, bsz, n), generator=gen, device=dev)
        f[0, 0, :2] = torch.tensor([0, 4 * q - 1])
        acc = torch.randint(0, q, (bsz, n), generator=gen, device=dev)
        degrees = torch.randint(-4 * n, 4 * n, (bsz,), generator=gen, device=dev)
        degrees[:3] = torch.tensor([0, 2 * n - 1, n])[:bsz]
        want = ntru_cmux_mxu.ntru_stage2_plain(tables, f, evk, acc, degrees)
        before = ntru_cmux_mxu.ntru_stage2.launches
        assert torch.equal(ntru_cmux_mxu.ntru_stage2(tables, f, evk, acc, degrees), want)
        acc32 = acc.to(torch.int32)
        out = ntru_cmux_mxu.ntru_stage2(tables, f.to(torch.int32), evk.to(torch.int32), acc32,
                                        degrees, out=acc32)
        assert out is acc32 and torch.equal(acc32.to(torch.int64), want)
        assert ntru_cmux_mxu.ntru_stage2.launches - before == 2
    for bsz in (1, 5):
        grid = ntru_cmux_mxu.launch_grid(log_n, bsz)
        _check_slice_grid(grid, 1, log_n, 10, lambda nl: nl)
        assert grid[0] == _slices_at_batch1(1, log_n, 10), grid


@pytest.mark.parametrize("log_n", [12, 13, 14, 15, 16, 17])
def test_ntru_stage2_over_slices_matches_plain(dev, log_n):
    """Kernel J at the slices a row its launch picks (``launch_grid``: C <=
    16 blocks, slices of 2^10-2^15 words; at batch 1 the most that allows:
    4 at log_n 12, 8 at 13), NTRU_128's L 6 on a 30-bit q, batch 1 and 16,
    degrees 0, n, 2n - 1 and any sign, against ``ntru_stage2_plain``: int64
    words into a new tensor, int32 storage in place."""
    n, q, level = 1 << log_n, next_ntt_prime(30, log_n), 6
    tables = ntt32.NttTables32(log_n, (q,))
    gen = torch.Generator(device=dev).manual_seed(log_n * 13)
    evk = torch.randint(0, q, (level, n), generator=gen, device=dev)
    for bsz in (1, 16):
        grid = ntru_cmux_mxu.launch_grid(log_n, bsz)
        _check_slice_grid(grid, 1, log_n, 10, lambda nl: nl)
        if bsz == 1:
            assert grid[0] == _slices_at_batch1(1, log_n, 10), grid
        f = torch.randint(0, 4 * q, (level, bsz, n), generator=gen, device=dev)
        f[0, 0, :2] = torch.tensor([0, 4 * q - 1])
        acc = torch.randint(0, q, (bsz, n), generator=gen, device=dev)
        degrees = torch.randint(-4 * n, 4 * n, (bsz,), generator=gen, device=dev)
        degrees[:3] = torch.tensor([n // 2 + 3, n, 2 * n - 1])[:bsz]
        want = ntru_cmux_mxu.ntru_stage2_plain(tables, f, evk, acc, degrees)
        before = ntru_cmux_mxu.ntru_stage2.launches
        assert torch.equal(ntru_cmux_mxu.ntru_stage2(tables, f, evk, acc, degrees), want)
        acc32 = acc.to(torch.int32)
        out = ntru_cmux_mxu.ntru_stage2(tables, f.to(torch.int32), evk.to(torch.int32), acc32,
                                        degrees, out=acc32)
        assert out is acc32 and torch.equal(acc32.to(torch.int64), want)
        assert ntru_cmux_mxu.ntru_stage2.launches - before == 2


@pytest.mark.parametrize("log_n", [10, 12, 13, 14, 16, 17])
def test_ntru_stage2_digits_match_plain(dev, log_n):
    """Kernel J with its digit output over ``f`` at the slices its launch
    picks (batch 1: C = 1 at log_n 10, 4 at 12, 8 at 13, 16 at 14 and 16;
    batch 16 beside), NTRU_128's gadget mod a 20-bit q (and 2^10 x 3 mod a
    30-bit q at 16): the accumulator and the digits (``ntru_digits_plain``
    of the output) equal ``ntru_stage2_plain``'s, one launch a call."""
    q_bits, log_basis, level = (30, 10, 3) if log_n == 16 else (20, 3, 6)
    n, q = 1 << log_n, next_ntt_prime(q_bits, log_n)
    tables = ntt32.NttTables32(log_n, (q,))
    basis = ApproxSignedBasis32(q, log_basis, level)
    gen = torch.Generator(device=dev).manual_seed(log_n * 17)
    evk = torch.randint(0, q, (level, n), generator=gen, device=dev)
    for bsz in (1, 16):
        grid = ntru_cmux_mxu.launch_grid(log_n, bsz)
        if bsz == 1:
            assert grid[0] == _slices_at_batch1(1, log_n, 10), grid
        f = torch.randint(0, 4 * q, (level, bsz, n), generator=gen, device=dev)
        acc = torch.randint(0, q, (bsz, n), generator=gen, device=dev)
        degrees = torch.randint(-4 * n, 4 * n, (bsz,), generator=gen, device=dev)
        want, want_digits = ntru_cmux_mxu.ntru_stage2_plain(tables, f, evk, acc, degrees, basis)
        f32, acc32 = f.to(torch.int32), acc.to(torch.int32)
        before = ntru_cmux_mxu.ntru_stage2.launches
        out = ntru_cmux_mxu.ntru_stage2(tables, f32, evk.to(torch.int32), acc32, degrees,
                                        out=acc32, basis=basis)
        assert ntru_cmux_mxu.ntru_stage2.launches - before == 1
        assert out is acc32 and torch.equal(acc32.to(torch.int64), want), bsz
        assert torch.equal(f32.to(torch.int64), want_digits), bsz


def test_ntru_staged_steps_match_plain(dev):
    """``NtruStepPlan`` at N = 2^13 (NTRU_128's gadget) over 3 steps at
    batch 2 on an evk row made by ``prepare_mxu_evk`` (kernel 1's route):
    kernel I once (the first step; J writes the next step's digits),
    kernels 1 and J three launches each, no kernel B, the accumulator in
    place, the plain step's words; a new accumulator starts with kernel I
    again; NTRU_128 keeps kernel B."""
    log_n = 13
    n, q = 1 << log_n, next_ntt_prime(20, log_n)
    ctx = NtruContext(log_n, q, 3, 6)
    gen = torch.Generator(device=dev).manual_seed(13)
    coeff = torch.randint(0, q, (1, 6, n), generator=gen, device=dev)
    kv, kpre = ntru_cmux_mxu.prepare_mxu_evk(ctx, coeff)
    step = ntru_cmux_mxu.NtruStepPlan(ctx, dev)
    assert step.route == "staged" and not step.reads_precons
    plan = ntru_cmux_mxu.get_ntru_plan(log_n, q)
    acc = torch.randint(0, q, (2, n), generator=gen, device=dev)
    acc32, kv32 = acc.to(torch.int32), kv[0].to(torch.int32).contiguous()
    counted = (ntru_cmux_mxu.ntru_digits, ntt32.forward32, ntru_cmux_mxu.ntru_stage2,
               ntru_cmux_mxu.ntru_cmux_step)
    before = [fn.launches for fn in counted]
    for i in range(3):
        degrees = torch.randint(0, 2 * n, (2,), generator=gen, device=dev, dtype=torch.int32)
        acc = ntru_cmux_mxu.ntru_cmux_step_plain(plan, ctx.basis, acc, degrees, kv[0])
        assert step(acc32, degrees, kv32, None) is acc32
        assert torch.equal(acc32.to(torch.int64), acc), i
    assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 3, 3, 0]
    other = acc32.clone()
    degrees = torch.randint(0, 2 * n, (2,), generator=gen, device=dev, dtype=torch.int32)
    want = ntru_cmux_mxu.ntru_cmux_step_plain(plan, ctx.basis, acc, degrees, kv[0])
    assert torch.equal(step(other, degrees, kv32, None).to(torch.int64), want)
    assert ntru_cmux_mxu.ntru_digits.launches - before[0] == 2
    nctx, _ = P.make_ntru_context(P.NTRU_128)
    assert ntru_cmux_mxu.NtruStepPlan(nctx, dev).route == "mxu"


def _cluster_batches(kp):
    """Batches 1, C - 1, C + 1, 64 and 65 of kernels A/B (C = 8 // kp
    ciphertexts a cluster where the card holds enough clusters): whole,
    partial and single clusters."""
    c = 8 // kp
    return sorted({1, max(c - 1, 1), c + 1, 64, 65})


@pytest.mark.parametrize(
    "log_n,log_basis,level,k,bound",
    [(8, 8, 2, 1, None), (9, 10, 2, 2, None), (10, 4, 4, 1, None), (11, 7, 3, 1, None),
     (11, 7, 3, 2, None), (12, 7, 2, 1, None), (12, 10, 2, 1, None), (12, 8, 1, 2, None),
     (10, 7, 3, 1, 75), (9, 8, 2, 1, 100)],
)
def test_mxu_cmux_step_matches_plain(dev, log_n, log_basis, level, k, bound):
    """Kernel A at log_n 8-12, k = 1, 2, 1- and 2-byte digits, 2-4 primes
    (``bound`` picks 3 or 4), every batch of :func:`_cluster_batches`."""
    n, k1 = 1 << log_n, k + 1
    conv = (tfhe.make_convolver(log_n, level, k, log_basis) if bound is None
            else TorusConvolver32(log_n, bound))
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    plan = cmux_mxu.plan_for(conv)
    gen = torch.Generator(device=dev).manual_seed(log_n * 10 + k)
    ggsw = torch.randint(0, 1 << 32, (1, k1, level, k1, n), generator=gen, device=dev)
    kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, ggsw)
    for bsz in _cluster_batches(conv.count):
        acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=gen, device=dev)
        degrees = torch.randint(0, 2 * n, (bsz,), generator=gen, device=dev, dtype=torch.int32)
        degrees[:2] = torch.tensor([0, 2 * n - 1])[:bsz]
        want = cmux_mxu.mxu_cmux_step_plain(conv, basis, acc, degrees, kv[0])
        got = cmux_mxu.mxu_cmux_step(plan, basis, conv, acc, degrees, kv[0], kpre[0])
        assert torch.equal(got, want), f"batch {bsz}"
        got32 = cmux_mxu.mxu_cmux_step(plan, basis, conv, acc.to(torch.int32), degrees,
                                       kv[0], kpre[0])
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want), f"batch {bsz}, int32"


@pytest.mark.parametrize("log_n,q_bits,log_basis,level", [(10, 20, 3, 6), (8, 30, 10, 3),
                                                          (11, 22, 4, 4), (9, 20, 1, 16)])
def test_ntru_cmux_step_matches_plain(dev, log_n, q_bits, log_basis, level):
    """Kernel B at every batch of :func:`_cluster_batches` (C = 8)."""
    n, q = 1 << log_n, next_ntt_prime(q_bits, log_n)
    plan = ntru_cmux_mxu.get_ntru_plan(log_n, q)
    basis = ApproxSignedBasis32(q, log_basis, level)
    gen = torch.Generator(device=dev).manual_seed(q_bits)
    coeff = torch.randint(0, q, (1, level, n), generator=gen, device=dev)
    kv, kpre = ntru_cmux_mxu.prepare_mxu_evk(NtruContext(log_n, q, log_basis, level), coeff)
    for bsz in _cluster_batches(1):
        acc = torch.randint(0, q, (bsz, n), generator=gen, device=dev)
        acc[0, :3] = torch.tensor([0, q - 1, basis.wrap_threshold or 1])
        degrees = torch.randint(0, 2 * n, (bsz,), generator=gen, device=dev, dtype=torch.int32)
        degrees[:2] = torch.tensor([0, 2 * n - 1])[:bsz]
        want = ntru_cmux_mxu.ntru_cmux_step_plain(plan, basis, acc, degrees, kv[0])
        got = ntru_cmux_mxu.ntru_cmux_step(plan, basis, acc, degrees, kv[0], kpre[0])
        assert torch.equal(got, want), f"batch {bsz}"


def test_mxu_bootstrap_and_ntru_gate(dev):
    """A small MXU-route TFHE bootstrap and an NTRU NAND on the card equal
    their CPU runs on the same keys; kernels A and B launch once per key
    slice, kernel B on both NTRU evk forms."""
    p = dataclasses.replace(P.TOY, log_n=8, lwe_dim=6)
    gen = torch.Generator(device=dev).manual_seed(8)
    ctx = P.make_context(p, dev, gen, bsk_kind="mxu")
    cts = ctx.encrypt(torch.tensor([0, 1, 1], device=dev), gen)
    tp = torch.full((p.n,), 1 << 29, dtype=torch.int64, device=dev)
    before = cmux_mxu.mxu_cmux_step.launches
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, cts, tp, p.log_n)
    assert cmux_mxu.mxu_cmux_step.launches - before == p.lwe_dim
    cpu_bsk = tuple(x.cpu() for x in ctx.bsk)
    assert torch.equal(out.cpu(), bootstrap(ctx.conv, ctx.basis, cpu_bsk, cts.cpu(), tp.cpu(),
                                            p.log_n))

    keys = P.make_ntru_keys(dataclasses.replace(P.NTRU_128, log_n=8, lwe_dim=8, lwe_sigma=4.0),
                            dev, gen)
    ca, cb = keys.encrypt([0, 0, 1, 1], gen), keys.encrypt([0, 1, 0, 1], gen)
    before = ntru_cmux_mxu.ntru_cmux_step.launches
    got = ntru_gates.ntru_nand(keys.ctx, keys.evk_mxu, keys.ksk, keys.ks_basis, ca, cb)
    assert ntru_cmux_mxu.ntru_cmux_step.launches - before == keys.params.lwe_dim
    before = (ntru_cmux_mxu.ntru_cmux_step.launches, ntt32.forward32.launches,
              ntt32.inverse32.launches)
    ntt = ntru_gates.ntru_nand(keys.ctx, keys.evk, keys.ksk, keys.ks_basis, ca, cb)
    # the NTT evk on kernel B too, with no launch of kernels 1-2
    assert (ntru_cmux_mxu.ntru_cmux_step.launches - before[0], ntt32.forward32.launches - before[1],
            ntt32.inverse32.launches - before[2]) == (keys.params.lwe_dim, 0, 0)
    assert torch.equal(got, ntt)
    cpu = ntru_gates.ntru_nand(keys.ctx, tuple(x.cpu() for x in keys.evk_mxu), keys.ksk.cpu(),
                               keys.ks_basis, ca.cpu(), cb.cpu())
    assert torch.equal(got.cpu(), cpu)
    assert keys.decrypt(got).int().tolist() == [1, 1, 1, 0]


def test_boolean128_mxu_bootstrap_matches_plain(dev):
    """A whole BOOLEAN_128 bootstrap on the MXU key (kernel C in key
    preparation, kernel F at the start, kernel A a step) equals the plain
    versions' on the CPU, and the NAND truth table holds; the start is one
    launch of F."""
    from primus_fhe_tpu_torch.boot import gates

    p = P.BOOLEAN_128
    gen = torch.Generator(device=dev).manual_seed(128)
    ctx = P.make_context(p, dev, gen, bsk_kind="mxu")
    ca, cb = ctx.encrypt(torch.tensor([0, 0, 1, 1], device=dev), gen), ctx.encrypt(
        torch.tensor([0, 1, 0, 1], device=dev), gen)
    nand = gates.nand_gate(ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, ca, cb, p.log_n)
    assert ctx.decrypt(nand).int().tolist() == [1, 1, 1, 0]
    tp = torch.full((p.n,), gates.TRUE_MU, dtype=torch.int64, device=dev)
    before = rotate.rotate.launches
    out = bootstrap(ctx.conv, ctx.basis, ctx.bsk, ca[:1], tp, p.log_n)
    assert rotate.rotate.launches == before + 1
    cpu = bootstrap(ctx.conv, ctx.basis, tuple(x.cpu() for x in ctx.bsk), ca[:1].cpu(),
                    tp.cpu(), p.log_n)
    assert torch.equal(out.cpu(), cpu)


Q50 = [1125899906826241, 1125899906629633]  # the DCRT benchmark's moduli
Q60 = 1152921504606830593  # the reference's 60-bit golden prime


def _u64_words(gen, shape, dev):
    """Uniform u64 words (int64 bit patterns), about half of them past 2^63."""
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev)
    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=dev)
    return (hi << 32) | lo


def _below(gen, moduli, shape, factor, dev):
    """Words in ``[0, factor * q_i)`` (any factor * q below 2^64)."""
    from primus_fhe_tpu_torch.numeric.limb import mul_hi_u64

    return torch.stack([mul_hi_u64(_u64_words(gen, shape, dev), factor * q) for q in moduli])


Q62 = [next_ntt_prime(62, 15), next_ntt_prime(61, 15)]  # lazy [0, 4q) words past 2^63


def _ragged_rows64(tables, start):
    """The first row count from ``start`` on that both u64 butterfly
    launches (on this card) cut into tiles of more than one row with a
    ragged last tile."""
    for rows in range(start, start + 2048):
        tiles = [ntt64.launch_tile(tables, rows, fwd) for fwd in (True, False)]
        if all(t > 1 and rows % t for t in tiles):
            return rows
    raise AssertionError("no ragged tile within 2048 row counts")


@pytest.mark.parametrize("log_n,moduli,rows", [
    (1, Q50, 3), (2, [Q60], 3), (3, Q50 + [Q60], 3), (4, Q50, 3), (8, Q50 + [Q60], 3),
    (12, Q50, 1), (12, Q50, 8), (12, Q50, 128), (12, [Q50[0]], 512), (12, [Q50[0]], "ragged"),
    (12, [Q60, next_ntt_prime(62, 14)], 3), (12, Q50 + Q62, 5), (13, [Q62[0], Q50[1]], 3),
    (14, [next_ntt_prime(61, 14)], 3), (15, [next_ntt_prime(61, 15), next_ntt_prime(50, 15)], 3),
    (15, [next_ntt_prime(50, 15)] + Q62 + [next_ntt_prime(40, 15)], 2),
    (16, [next_ntt_prime(62, 16), next_ntt_prime(50, 16)], 3),
    (17, [next_ntt_prime(62, 17), next_ntt_prime(50, 17)], 2),
    (17, [next_ntt_prime(62, 17)] + ntt_prime_chain(50, 17, 4), 1),
])
def test_ntt64_kernels_match_plain(dev, log_n, moduli, rows):
    """Row 10 against the plain versions, every ``out_factor`` and both
    input chains: one pass (log_n 1-3), 2-5 passes, a row over a cluster of
    2, 4 or 8 blocks (15-17); at log_n 12 (the DCRT path) 1, 8, 128 and 512
    rows a modulus and a ragged last tile; 1-5 moduli, 62-bit ones with
    lazy words past 2^63."""
    tables = ntt64.NttTables64(log_n, moduli)
    if rows == "ragged":
        rows = _ragged_rows64(tables, 257)
    gen = torch.Generator(device=dev).manual_seed(log_n * 1000 + rows)
    n = 1 << log_n
    x = _below(gen, moduli, (rows, n), 4, dev)
    for out_factor in (1, 4):
        want = ntt64.ntt64_forward_plain(tables, x, out_factor)
        assert torch.equal(ntt64.ntt64_forward(tables, x, out_factor), want)
    for in_factor in (2, 4):
        y = _below(gen, moduli, (rows, n), in_factor, dev)
        for out_factor in (1, 2):
            want = ntt64.ntt64_inverse_plain(tables, y, out_factor, in_factor)
            assert torch.equal(ntt64.ntt64_inverse(tables, y, out_factor, in_factor), want)


@pytest.mark.parametrize("log_n,moduli", [(8, Q50), (10, [Q60]), (12, Q50), (12, [Q50[0], Q60])])
def test_mxu8_64_kernels_match_plain(dev, log_n, moduli):
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    assert tables.planes == (7 if max(moduli) < 1 << 53 else 8)
    gen = torch.Generator(device=dev).manual_seed(log_n + len(moduli))
    for rows in (1, 5):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        assert torch.equal(ntt_mxu8.mxu8_forward64(tables, x), ntt_mxu8.mxu8_forward64_plain(tables, x))
        assert torch.equal(ntt_mxu8.mxu8_inverse64(tables, x), ntt_mxu8.mxu8_inverse64_plain(tables, x))


@pytest.mark.parametrize("log_n,moduli", [
    (8, Q50), (9, [Q60]), (10, Q50 + [Q60]), (11, [next_ntt_prime(62, 14)]), (12, Q50),
    (12, [Q50[0], Q60]),
])
def test_mxu8_forward64_tiles_match_plain(dev, log_n, moduli):
    """The tiled forward kernel at rows 1, 2, R - 1, R, R + 1, 16, 64, 256
    and 257 a modulus (R = 128 / A, the largest tile), inputs over the whole
    u64 range, on the launch's own grid.  At log_n 12 on two moduli an H100
    picks clusters of 2 blocks at 1-4 and 64 rows, 4 at 5, 8 at 16 and 1 at
    256 and 257 (``GRIDS`` in ``test_torch_ntt_mxu8_fwd_model.py``)."""
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    assert tables.planes == (7 if max(moduli) < 1 << 53 else 8)
    gen = torch.Generator(device=dev).manual_seed(100 + log_n)
    r_max = 128 // tables.A
    for rows in sorted({1, 2, r_max - 1, r_max, r_max + 1, 16, 64, 256, 257} - {0}):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        want = ntt_mxu8.mxu8_forward64_plain(tables, x)
        assert torch.equal(ntt_mxu8.mxu8_forward64(tables, x), want), rows


def test_mxu8_forward64_on_a_shard_matches_plain(dev):
    """Row 12: the forward kernel on a residue shard's tables (one modulus,
    ``stack_dyn_plans``) at the sharded rotation's shape, 64 rows."""
    from primus_fhe_tpu_torch.ops.ntt_mxu8_dyn import stack_dyn_plans
    from primus_fhe_tpu_torch.transforms import dcrt as td

    plan = td.build_dcrt_plan64(12, Q50)
    gen = torch.Generator(device=dev).manual_seed(64)
    for sp in stack_dyn_plans(plan, 2):
        x = _u64_words(gen, (1, 64, 4096), dev)
        assert torch.equal(ntt_mxu8.mxu8_forward64(sp.mxu, x),
                           ntt_mxu8.mxu8_forward64_plain(sp.mxu, x))


@pytest.mark.parametrize("log_n,moduli", [
    (8, Q50), (9, [Q60]), (10, Q50 + [Q60]), (11, [next_ntt_prime(62, 14)]), (12, Q50),
    (12, [Q50[0], Q60]),
])
def test_mxu8_inverse64_tiles_match_plain(dev, log_n, moduli):
    """The tiled inverse kernel and kernel D at rows 1, 2, R - 1, R, R + 1,
    16, 64, 256 and 257 a modulus (R = 128 / A, the largest tile), inputs
    over the whole u64 range, on the launch's own grid.  At log_n 12 on two
    moduli an H100 picks (1, 8) at 1 and 2 rows, (2, 8) at 3-5, (4, 8) at
    16, (4, 4) at 64 and (4, 2) at 256 and 257."""
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    assert tables.planes == (7 if max(moduli) < 1 << 53 else 8)
    gen = torch.Generator(device=dev).manual_seed(200 + log_n)
    mt = tables.mul_table(_below(gen, moduli, (1 << log_n,), 1, dev))
    r_max = 128 // tables.A
    for rows in sorted({1, 2, r_max - 1, r_max, r_max + 1, 16, 64, 256, 257} - {0}):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        want = ntt_mxu8.mxu8_inverse64_plain(tables, x)
        assert torch.equal(ntt_mxu8.mxu8_inverse64(tables, x), want), rows
        want = ntt_mxu8.mxu8_inverse64_mul_plain(tables, x, mt)
        assert torch.equal(ntt_mxu8.mxu8_inverse64_mul(tables, x, mt), want), rows


def test_mxu8_inverse64_on_a_shard_matches_plain(dev):
    """Row 12: the inverse kernel on a residue shard's tables (one modulus,
    ``stack_dyn_plans``) at the sharded rotation's shape, 16 rows, and at
    64."""
    from primus_fhe_tpu_torch.ops.ntt_mxu8_dyn import stack_dyn_plans
    from primus_fhe_tpu_torch.transforms import dcrt as td

    plan = td.build_dcrt_plan64(12, Q50)
    gen = torch.Generator(device=dev).manual_seed(65)
    for sp in stack_dyn_plans(plan, 2):
        assert "wi1s" in sp.mxu.kernel_tables(dev)
        for rows in (16, 64):
            x = _u64_words(gen, (1, rows, 4096), dev)
            assert torch.equal(ntt_mxu8.mxu8_inverse64(sp.mxu, x),
                               ntt_mxu8.mxu8_inverse64_plain(sp.mxu, x)), rows


def test_large_ntt_mxu8_inverse_matches_butterfly(dev):
    """``ntt_large``'s mxu8 route (its inverse sub-transforms on the tiled
    kernel) against the butterfly route on the same canonical NTT-domain
    words."""
    from primus_fhe_tpu_torch.transforms import ntt_large

    q = next_ntt_prime(62, 16)
    plan = ntt_large.LargeNttPlan64(16, q)
    gen = torch.Generator(device=dev).manual_seed(17)
    y = _below(gen, [q], (2, 1 << 16), 1, dev)[0]
    ntt_mxu8.mxu8_inverse64.launches = 0
    got = ntt_large.large_inverse64(plan, y, 1, "mxu8")
    assert ntt_mxu8.mxu8_inverse64.launches == 2
    assert torch.equal(got, ntt_large.large_inverse64(plan, y, 1, "butterfly"))


def test_dcrt_rotation_routes_and_cpu_agree(dev):
    """A DCRT rotation at log_n=8 (n_lwe=3, batch 2) on the MXU route, the
    butterfly route and the CPU plain versions: the same words; each route
    launches only its own kernels, once per transform call."""
    from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64

    log_n, n_lwe, bsz = 8, 3, 2
    n = 1 << log_n
    base = RNSBase64(Q50)
    basis = BigUintApproxSignedBasis(base, 25)
    plan = build_dcrt_plan64(log_n, Q50)
    gen = torch.Generator(device=dev).manual_seed(11)
    bsk = _below(gen, Q50, (n_lwe, 2, basis.decompose_length, 2, n), 1, dev).movedim(0, 3)
    acc = _below(gen, Q50, (bsz, 2, n), 1, dev).transpose(0, 1).contiguous()
    lwe = torch.randint(0, 2 * n, (bsz, n_lwe + 1), generator=gen, device=dev)
    kernels = (ntt64.ntt64_forward, ntt64.ntt64_inverse, ntt_mxu8.mxu8_forward64,
               ntt_mxu8.mxu8_inverse64)
    outs = {}
    for route in ("auto", "butterfly"):
        for k in kernels:
            k.launches = 0
        outs[route] = dcrt_blind_rotate_batched(plan, basis, base, bsk.contiguous(), lwe, acc,
                                                route=route)
        fwd, inv = (kernels[2], kernels[3]) if route == "auto" else (kernels[0], kernels[1])
        assert fwd.launches == n_lwe and inv.launches == n_lwe
        assert sum(k.launches for k in kernels) == 2 * n_lwe
    cpu = dcrt_blind_rotate_batched(plan, basis, base, bsk.cpu().contiguous(), lwe.cpu(), acc.cpu())
    assert torch.equal(outs["auto"], outs["butterfly"])
    assert torch.equal(outs["auto"].cpu(), cpu)


def _ragged_rows_rt(tables, start):
    """The first row count from ``start`` on that kernel E's launch (on this
    card) cuts into tiles of more than one row with a ragged last tile."""
    for rows in range(start, start + 8192):
        tile = ntt_mxu8.roundtrip_tile(tables, rows)
        if tile > 1 and rows % tile:
            return rows
    raise AssertionError("no ragged tile within 8192 row counts")


@pytest.mark.parametrize("log_n", [13, 14, 15, 16, 17])
def test_row9_on_row10_passes_matches_plain(dev, log_n):
    """Row 9's four functions at log_n 13-17 (``mxu8_forward64``,
    ``mxu8_inverse64``, D and E on row 10's passes, ``csrc/ntt64.cu``; a row
    over a cluster at 15-17): any u64 words (the extremes among them) over a
    62-bit and a 50-bit modulus, 1, 3 and 17 rows, against the plain
    versions, one launch a call counted on the wrapper called; past 17 a
    ``ValueError`` before any launch, on row 10's wrappers too."""
    moduli = [next_ntt_prime(62, log_n), next_ntt_prime(50, log_n)]
    n = 1 << log_n
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    gen = torch.Generator(device=dev).manual_seed(log_n * 31)
    key = torch.stack([torch.randint(0, q, (n,), generator=gen, device=dev) for q in moduli])
    mt = tables.mul_table(key)
    fns = (("mxu8_forward64", ()), ("mxu8_inverse64", ()), ("mxu8_inverse64_mul", (mt,)),
           ("mxu8_roundtrip64_mul", (mt,)))
    for rows in (1, 3, 17):
        x = torch.randint(-(1 << 63), (1 << 63) - 1, (2, rows, n), generator=gen, device=dev)
        x[:, 0, :3] = torch.tensor([0, -1, -(1 << 63)])
        for name, args in fns:
            fn, plain = getattr(ntt_mxu8, name), getattr(ntt_mxu8, name + "_plain")
            before = fn.launches
            assert torch.equal(fn(tables, x, *args), plain(tables, x, *args)), (name, rows)
            assert fn.launches - before == 1, name
    big = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(18, [next_ntt_prime(50, 18)]))
    zeros = torch.zeros((1, 1, 1 << 18), dtype=torch.int64, device=dev)
    before = [fn.launches for fn in (ntt_mxu8.mxu8_forward64, ntt64.ntt64_forward)]
    assert torch.equal(ntt_mxu8.mxu8_forward64(big, zeros), zeros)  # past 2^17: the four-step
    assert torch.equal(ntt64.ntt64_forward(big.ntt, zeros), zeros)
    assert [fn.launches - b for fn, b in zip((ntt_mxu8.mxu8_forward64, ntt64.ntt64_forward),
                                             before)] == [1, 1]


@pytest.mark.parametrize("log_n,moduli", [
    (8, Q50), (9, [Q60]), (10, [Q62[0]]), (11, [Q50[0], Q60]), (12, Q50), (12, [Q62[0], Q50[1]]),
])
def test_mxu8_64_mul_kernels_match_plain(dev, log_n, moduli):
    """Kernel D and kernel E against their plain versions; E also against
    ``mxu8_forward64`` then D and against the butterfly route (row 10's
    kernels around a torch Shoup multiply, on the reduced input), at rows 1,
    5, 33 and at row counts around a tile edge of E's launch (the first
    ragged tile of more than one row, one below and one above it)."""
    from primus_fhe_tpu_torch.modular.factor import ShoupFactor64, factor_mul_lazy64
    from primus_fhe_tpu_torch.numeric.limb import u64_tensor

    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    gen = torch.Generator(device=dev).manual_seed(100 + log_n)
    mt = tables.mul_table(_below(gen, moduli, (1 << log_n,), 1, dev))
    ragged = _ragged_rows_rt(tables, 1)
    q = u64_tensor(moduli, dev).reshape(-1, 1, 1)
    key = ShoupFactor64(mt[:, 0, None], mt[:, 1, None])
    for rows in (1, 5, 33, ragged - 1, ragged, ragged + 1):
        x = _u64_words(gen, (len(moduli), rows, 1 << log_n), dev)
        assert torch.equal(ntt_mxu8.mxu8_inverse64_mul(tables, x, mt),
                           ntt_mxu8.mxu8_inverse64_mul_plain(tables, x, mt))
        rt = ntt_mxu8.mxu8_roundtrip64_mul(tables, x, mt)
        assert torch.equal(rt, ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, x, mt)), rows
        fwd = ntt_mxu8.mxu8_forward64(tables, x)
        assert torch.equal(rt, ntt_mxu8.mxu8_inverse64_mul(tables, fwd, mt)), rows
        xr = ntt_mxu8.reduce_any64(x, moduli)
        bf = ntt64.ntt64_inverse(tables.ntt, factor_mul_lazy64(
            ntt64.ntt64_forward(tables.ntt, xr, 4), key, q))
        assert torch.equal(rt, bf), rows
        assert torch.equal(ntt_mxu8.mxu8_roundtrip64_mul(tables, x, mt, 2), rt)


@pytest.mark.parametrize("log_n", [16, 17])
@pytest.mark.parametrize("count", [5, 6])
def test_u64_cluster_rings_over_groups_of_moduli_match_plain(dev, log_n, count):
    """Row 10's forward and inverse and row 9's four functions at log_n 16
    and 17 (a row over a cluster of 4 and 8 blocks) on 5 and 6 moduli: two
    launches a call (moduli 0-3, then the rest), each against its plain
    version; 50-bit moduli and, at 6, a 62-bit one last."""
    moduli = ntt_prime_chain(50, log_n, count)
    if count == 6:
        moduli[-1] = next_ntt_prime(62, log_n)
    n = 1 << log_n
    gen = torch.Generator(device=dev).manual_seed(log_n * 10 + count)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(log_n, moduli))
    mt = tables.mul_table(_below(gen, moduli, (n,), 1, dev))
    x, y = _below(gen, moduli, (2, n), 4, dev), _below(gen, moduli, (2, n), 2, dev)
    w = _u64_words(gen, (count, 2, n), dev)
    calls = [
        (ntt64.ntt64_forward, lambda: ntt64.ntt64_forward(tables.ntt, x, 4),
         lambda: ntt64.ntt64_forward_plain(tables.ntt, x, 4)),
        (ntt64.ntt64_inverse, lambda: ntt64.ntt64_inverse(tables.ntt, y),
         lambda: ntt64.ntt64_inverse_plain(tables.ntt, y)),
    ] + [(getattr(ntt_mxu8, name), lambda name=name, a=a: getattr(ntt_mxu8, name)(tables, w, *a),
          lambda name=name, a=a: getattr(ntt_mxu8, name + "_plain")(tables, w, *a))
         for name, a in (("mxu8_forward64", ()), ("mxu8_inverse64", ()),
                         ("mxu8_inverse64_mul", (mt,)), ("mxu8_roundtrip64_mul", (mt,)))]
    for fn, kern, plain in calls:
        before = fn.launches
        assert torch.equal(kern(), plain()), fn.__name__
        assert fn.launches - before == 2, fn.__name__


@pytest.mark.parametrize("count", [5, 6])
def test_u64_kernels_over_groups_of_moduli_match_plain(dev, count):
    """Every u64 wrapper that takes a modulus list on 5 and 6 moduli (two
    launches a call: moduli 0-3, then the rest): row 10 at log_n 12 and
    15, rows 9 and 12, kernels D and E and row 13's four halves at log_n 12
    (D = 1, batch 2) against their plain versions, K1 and Ki1 by the lazy
    rule; 50-bit moduli and, at 6, a 62-bit one last (8 planes)."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.utils.primes import ntt_prime_chain

    moduli = ntt_prime_chain(50, 15, count)
    if count == 6:
        moduli[-1] = Q62[0]
    gen = torch.Generator(device=dev).manual_seed(count)
    counted = (ntt64.ntt64_forward, ntt64.ntt64_inverse, ntt_mxu8.mxu8_forward64,
               ntt_mxu8.mxu8_inverse64, ntt_mxu8.mxu8_inverse64_mul,
               ntt_mxu8.mxu8_roundtrip64_mul, split.split_k1, split.split_k2, split.split_ki1,
               split.split_ki2)
    for log_n in (12, 15):
        n = 1 << log_n
        tables = ntt64.NttTables64(log_n, moduli)
        x, y = _below(gen, moduli, (3, n), 4, dev), _below(gen, moduli, (3, n), 2, dev)
        before = ntt64.ntt64_forward.launches, ntt64.ntt64_inverse.launches
        assert torch.equal(ntt64.ntt64_forward(tables, x, 4),
                           ntt64.ntt64_forward_plain(tables, x, 4))
        assert torch.equal(ntt64.ntt64_inverse(tables, y), ntt64.ntt64_inverse_plain(tables, y))
        assert (ntt64.ntt64_forward.launches - before[0],
                ntt64.ntt64_inverse.launches - before[1]) == (2, 2)
    n, batch = 1 << 12, 2
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(12, moduli))
    mt = tables.mul_table(_below(gen, moduli, (n,), 1, dev))
    w = _u64_words(gen, (count, 5, n), dev)
    lanes = _u64_words(gen, (count, tables.A, tables.B * batch), dev)
    rows = _u64_words(gen, (count, tables.A * batch, tables.B), dev)
    before = [fn.launches for fn in counted[2:]]
    assert torch.equal(ntt_mxu8.mxu8_forward64(tables, w), ntt_mxu8.mxu8_forward64_plain(tables, w))
    assert torch.equal(ntt_mxu8.mxu8_inverse64(tables, w), ntt_mxu8.mxu8_inverse64_plain(tables, w))
    assert torch.equal(ntt_mxu8.mxu8_inverse64_mul(tables, w, mt),
                       ntt_mxu8.mxu8_inverse64_mul_plain(tables, w, mt))
    assert torch.equal(ntt_mxu8.mxu8_roundtrip64_mul(tables, w, mt),
                       ntt_mxu8.mxu8_roundtrip64_mul_plain(tables, w, mt))
    lazy = [(split.split_k1(tables, lanes, batch), split.split_k1_plain(tables, lanes, batch, 0)),
            (split.split_ki1(tables, rows, batch, 0, mt),
             split.split_ki1_plain(tables, rows, batch, 0, mt))]
    for got, plain in lazy:
        for i, q in enumerate(moduli):
            _lazy_equal(got[i:i + 1], plain[i:i + 1], q)
    assert torch.equal(split.split_k2(tables, rows), split.split_k2_plain(tables, rows))
    assert torch.equal(split.split_ki2(tables, lanes), split.split_ki2_plain(tables, lanes))
    assert [fn.launches - b for fn, b in zip(counted[2:], before)] == [2] * 8


def test_large_ntt_routes_match_plain(dev):
    from primus_fhe_tpu_torch.transforms import ntt_large
    from primus_fhe_tpu_torch.transforms.ntt import forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan64

    q = next_ntt_prime(62, 16)
    plan = ntt_large.LargeNttPlan64(16, q)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = _below(gen, [q], (2, 1 << 16), 1, dev)[0]
    want = forward64(build_plan64(16, q, dev), x)
    for route in ("mxu8", "butterfly"):
        f = ntt_large.large_forward64(plan, x, 1, route)
        assert torch.equal(f, want), route
        assert torch.equal(ntt_large.large_inverse64(plan, ntt_large.large_forward64(
            plan, x, 4, route), 1, route), x), route


@pytest.mark.parametrize("log_n,k1", [(5, 2), (10, 1), (11, 2), (11, 3)])
def test_rotate_kernel_matches_plain(dev, log_n, k1):
    n = 1 << log_n
    gen = torch.Generator(device=dev).manual_seed(log_n + k1)
    v = torch.randint(0, 1 << 32, (6, k1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 1, n, 2 * n - 1, -5, 7 * n + 3], dtype=torch.int64, device=dev)
    for subtract in (False, True):
        want = rotate.rotate_plain(v, degrees, subtract)
        assert torch.equal(rotate.rotate(v, degrees, subtract), want)
        got32 = rotate.rotate(v.to(torch.int32), degrees, subtract)
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
    flat = torch.randint(0, 1 << 32, (3, n), generator=gen, device=dev)
    assert torch.equal(rotate.rotate(flat, degrees[:3]), rotate.rotate_plain(flat, degrees[:3]))


@pytest.mark.parametrize("log_n", range(1, 18))
def test_rotate_views_match_plain(dev, log_n):
    """Kernel F on a broadcast row (``expand``, a row stride of 0),
    contiguous rows and rows of a wider tensor (row strides on and off 16
    bytes), into new rows and into ``out=`` views (``acc[:, -1, :]``),
    with and without the subtraction, degrees of either sign up to 4n; no
    input is copied."""
    n = 1 << log_n
    bsz, k1 = (6, 2) if log_n <= 12 else (2, 2)
    gen = torch.Generator(device=dev).manual_seed(100 + log_n)
    degrees = torch.randint(-4 * n, 4 * n + 1, (bsz,), generator=gen, device=dev)
    degrees[:2] = torch.tensor([-4 * n, 4 * n - 1])
    row = torch.randint(0, 1 << 32, (n,), generator=gen, device=dev).to(torch.int32)
    wide = torch.randint(0, 1 << 32, (bsz, k1, n + 8), generator=gen, device=dev)
    odd = torch.randint(0, 1 << 32, (bsz, k1, n + 3), generator=gen, device=dev)
    wide32 = wide.to(torch.int32)
    sources = [row.expand(bsz, n), row.expand(bsz, k1, n), wide32[..., :n],
               wide32[..., 4:4 + n], odd.to(torch.int32)[..., :n], wide[..., :n]]
    for src in sources:
        for sub in (False, True):
            want = rotate.rotate_plain(src.to(torch.int64) & 0xFFFFFFFF, degrees, sub)
            assert torch.equal(rotate.rotate(src, degrees, sub).to(torch.int64) & 0xFFFFFFFF,
                               want)
            # into every other row of an accumulator: acc[:, -1, :] for (bsz, n)
            acc = torch.zeros(src.shape[:-1] + (2, n), dtype=torch.int32, device=dev)
            view = acc[..., 1, :]
            assert rotate.rotate(src, degrees, sub, out=view) is view
            assert torch.equal(view.to(torch.int64) & 0xFFFFFFFF, want)
            assert not acc[..., 0, :].any()


@pytest.mark.parametrize("log_n,log_basis,level,k", [(5, 8, 3, 1), (8, 1, 12, 1), (11, 7, 3, 1),
                                                     (9, 8, 2, 2)])
def test_cmux_front_and_delta_match_plain(dev, log_n, log_basis, level, k):
    n, k1 = 1 << log_n, k + 1
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    gen = torch.Generator(device=dev).manual_seed(log_n * 7 + level)
    acc = torch.randint(0, 1 << 32, (5, k1, n), generator=gen, device=dev)
    degrees = torch.tensor([0, 3, n, 2 * n - 1, -9], dtype=torch.int32, device=dev)
    want = cmux_front.cmux_front_plain(acc, degrees, basis, conv.primes)
    assert torch.equal(cmux_front.cmux_front(acc, degrees, basis, conv.primes), want)
    key = _residues(gen, conv.primes, (k1, level, k1, n), 1, dev)
    delta = tfhe.cmux_delta(conv, basis, acc, degrees, key)
    step = cmux_fused.fused_cmux_step(conv, basis, acc, degrees, key)
    assert torch.equal((acc + delta) & 0xFFFFFFFF, step)
    cpu = tfhe.cmux_delta(conv, basis, acc.cpu(), degrees.cpu(), key.cpu())
    assert torch.equal(delta.cpu(), cpu)


@pytest.mark.parametrize("log_n", [1, 2, 3, 11, 12, 16, 17])
@pytest.mark.parametrize("kp", [1, 2, 3, 4])
def test_cmux_front_kernel_matches_plain(dev, log_n, kp):
    """Kernel G's groups (log_n >= 2, a source on 16 bytes) and its
    coefficient-a-thread path (log_n 1, a source 4 bytes off alignment)
    against the plain version: 1-4 primes passed directly, k1 = kp rows a
    ciphertext, the 2^8 x 3 and 2^1 x 12 gadgets, int64 and int32 storage,
    degrees of either sign in [-4n, 4n]."""
    n = 1 << log_n
    primes = PRIMES4[:kp]
    bsz, k1 = (5 if log_n <= 12 else 2), kp
    gen = torch.Generator(device=dev).manual_seed(300 + 8 * log_n + kp)
    acc = torch.randint(0, 1 << 32, (bsz, k1, n), generator=gen, device=dev)
    degrees = torch.randint(-4 * n, 4 * n + 1, (bsz,), generator=gen, device=dev,
                            dtype=torch.int32)
    degrees[:2] = torch.tensor([-4 * n, 4 * n], dtype=torch.int32)
    flat = torch.empty(acc.numel() + 1, dtype=torch.int32, device=dev)
    off = flat[1:].view(bsz, k1, n)
    off.copy_(acc.to(torch.int32))
    assert off.data_ptr() % 16 == 4
    for log_basis, level in ((8, 3), (1, 12)):
        basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
        want = cmux_front.cmux_front_plain(acc, degrees, basis, primes)
        assert want.shape == (kp, bsz, k1, level, n)
        assert torch.equal(cmux_front.cmux_front(acc, degrees, basis, primes), want)
        got32 = cmux_front.cmux_front(acc.to(torch.int32), degrees, basis, primes)
        assert got32.dtype == torch.int32
        assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)
        got_off = cmux_front.cmux_front(off, degrees, basis, primes)
        assert torch.equal(got_off.to(torch.int64) & 0xFFFFFFFF, want)


def test_rotate_and_front_refuse_rows_past_the_cap(dev):
    """Kernels F and G take rows of up to 2^29 words, the cap the library
    reports (``FG_MAX_LOG_N``: every index of a row in an int); a row of
    2^30 (a view of one word) raises a ValueError naming it, before any
    launch; rows of 2^18 run."""
    from primus_fhe_tpu_torch.ops import build

    assert build.library().pft_rotate_max_log_n() == 29
    acc = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev).expand(1, 1, 1 << 30)
    degrees = torch.zeros((1,), dtype=torch.int32, device=dev)
    basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    before = (rotate.rotate.launches, cmux_front.cmux_front.launches)
    with pytest.raises(ValueError, match=r"rows of up to 2\^29 words"):
        rotate.rotate(acc, degrees)
    with pytest.raises(ValueError, match=r"rows of up to 2\^29 words"):
        cmux_front.cmux_front(acc, degrees, basis, PRIMES4[:1])
    assert (rotate.rotate.launches, cmux_front.cmux_front.launches) == before
    row = torch.arange(1 << 18, device=dev).reshape(1, 1, -1)
    assert torch.equal(rotate.rotate(row, degrees + 5), rotate.rotate_plain(row, degrees + 5))


def test_cmux_front_launch_rule_and_ptxas(dev):
    """Kernel G's launch rule (``front_pick``) at the main path's shapes, and
    ptxas's figures for every instance: no stack frame, no spill."""
    from primus_fhe_tpu_torch.ops import build

    assert cmux_front.launch_grid(128, 11) == (1, 128, 512)  # phase 13's 64 x 2 rows
    assert cmux_front.launch_grid(2, 11) == (1, 128, 8)  # batch 1
    assert cmux_front.launch_grid(2048, 11) == (1, 128, 8192)
    assert cmux_front.launch_grid(128, 11, aligned=False) == (0, 128, 2048)
    assert cmux_front.launch_grid(5, 1) == (0, 128, 1)
    figures = {k: v for k, v in build.ptxas_figures(build.build()[2]).items()
               if "cmux_front_kernel" in k}
    assert len(figures) == 8, figures  # kp 1-4, groups or words
    for name, f in figures.items():
        assert f["stack"] == f["spill_stores"] == f["spill_loads"] == 0, (name, f)


def _with_extremes(x, q, factor):
    """``x`` with the input range's extremes (0, q, 2q - 1 and the top word
    below ``factor q``) at the start of its first row and the end of its
    last."""
    from primus_fhe_tpu_torch.numeric.limb import u64_tensor

    top = min(factor * q, 1 << 64) - 1
    vals = u64_tensor([0, q, 2 * q - 1, top]).to(x.device)
    x = x.clone()
    x[0, :4], x[-1, -4:] = vals, vals.flip(0)
    return x


@pytest.mark.parametrize("log_n,d,batches", [(12, 2, (2,)), (12, 8, (2,)), (16, 4, (2,)),
                                             (9, 4, (2,)), (16, 2, (1, 3, 8)),
                                             (17, 2, (1, 3, 8)), (18, 2, (1, 3))])
def test_stage_kernels_match_plain(dev, log_n, d, batches):
    """The four stage kernels on shard 1's table slices: u32 at q = 536813569
    (phase 15's n = 2^12) and, at n = 2^16 and 2^17 (log_w 14-16, a row over
    a cluster), q = 1073479681 on batches 1, 3 and 8, on the repo's tables
    and on tables whose pair entries differ (the select form reads both
    lanes' entries forward, the y lane's inverse), int64 and int32 storage;
    u64 on the 62-bit q = 4611686018425815041 (exact Shoup) and a 50-bit q
    (deferred, approximate Shoup); lazy outputs too, the input range's
    extreme words, and at log_w 15-16 batches 1, 3 and 8.  The grid the card
    picks (``launch_grid``) keeps the C entry's rule: a block's tile within
    128 KB, no larger than the rows need, a u64 row split only into slices
    of at least 2^8 words forward and 2^7 inverse, a u32 row only at 2^11
    words and more, into slices of at least 2^8 words."""
    from primus_fhe_tpu_torch.numeric.limb import narrow_u32, widen_u32
    from primus_fhe_tpu_torch.ops import ntt_stages as st
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs

    gen = torch.Generator(device=dev).manual_seed(log_n + d)
    log_d = d.bit_length() - 1
    log_w, width = log_n - log_d, (1 << log_n) // d
    cols = slice(width, 2 * width)

    def grid_keeps_the_rule(q, rows, bits):
        for forward in (True, False):  # the card's own pick, held to the C entry's rule
            c, tile = st.launch_grid(log_w, q, rows, forward, bits)
            l = log_w - (c.bit_length() - 1)
            assert c in (1, 2, 4, 8) and tile in (1, 2, 4, 8)
            assert (tile << l) * bits // 8 <= 1 << 17  # a block's tile fits its shared memory
            assert tile == 1 or tile // 2 < rows  # no larger than the rows need
            if bits == 64:  # slices of >= 2 KB forward, 1 KB inverse
                assert c == 1 or l >= 7 + forward
            else:  # rows of >= 2^11 words into slices of >= 2^8
                assert c == 1 or (l >= 8 and log_w >= 11)

    if log_n <= 12 or log_n >= 16:
        q = 536813569 if log_n <= 12 else Q32_17 if log_n <= 17 else Q32_18
        repo = tuple(t[log_d:, cols].to(dev) for t in cs.build_expanded_tables32(log_n, q)) + \
            tuple(t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables32(log_n, q))
        drawn = [torch.randint(0, q, (log_w, width), generator=gen, device=dev) for _ in range(2)]
        drawn = (drawn[0], (drawn[0] << 32) // q, drawn[1], (drawn[1] << 32) // q)
        for rows in (8,) if log_n <= 12 else (1, 3, 8):
            grid_keeps_the_rule(q, rows, 32)
            for w, p, wi, pi in (repo, drawn):
                x = _with_extremes(torch.randint(0, 4 * q, (rows, width), generator=gen,
                                                 device=dev), q, 4)
                for of in (1, 4):
                    want = st.ntt32_stages_forward_plain(log_w, q, w, p, x, of)
                    assert torch.equal(st.ntt32_stages_forward(log_w, q, w, p, x, of), want)
                    got32 = st.ntt32_stages_forward(log_w, q, narrow_u32(w), narrow_u32(p),
                                                    narrow_u32(x), of)
                    assert got32.dtype == torch.int32 and torch.equal(widen_u32(got32), want)
                y = _with_extremes(torch.randint(0, 2 * q, (rows, width), generator=gen,
                                                 device=dev), q, 2)
                want = st.ntt32_stages_inverse_plain(log_w, q, wi, pi, y)
                assert torch.equal(st.ntt32_stages_inverse(log_w, q, wi, pi, y), want)
                got32 = st.ntt32_stages_inverse(log_w, q, wi, pi, narrow_u32(y))
                assert got32.dtype == torch.int32 and torch.equal(widen_u32(got32), want)
    for q in (4611686018425815041, next_ntt_prime(50, log_n)):
        w, p = (t[log_d:, cols].to(dev) for t in cs.build_expanded_tables64(log_n, q))
        wi, pi = (t[:log_w, cols].to(dev) for t in cs.build_expanded_inverse_tables64(log_n, q))
        for rows in batches:
            grid_keeps_the_rule(q, rows, 64)
            x = _with_extremes(_below(gen, [q], (rows, width), 4, dev)[0], q, 4)
            for of in (1, 2, 4):
                assert torch.equal(st.ntt64_stages_forward(log_w, q, w, p, x, of),
                                   st.ntt64_stages_forward_plain(log_w, q, w, p, x, of))
            for in_factor in (2, 4):
                y = _with_extremes(_below(gen, [q], (rows, width), in_factor, dev)[0], q,
                                   in_factor)
                assert torch.equal(st.ntt64_stages_inverse(log_w, q, wi, pi, y, in_factor),
                                   st.ntt64_stages_inverse_plain(log_w, q, wi, pi, y, in_factor))


@pytest.mark.parametrize("log_n,d", [(16, 2), (16, 4), (17, 2), (18, 2)])
def test_coeff_sharded32_large_ring_matches_plain(dev, log_n, d):
    """The u32 coefficient-sharded NTT at n = 2^16 over D = 2, 4 and n = 2^17
    over D = 2 (shards of 2^14-2^16 words, a row over a cluster) on a
    ``LocalMesh``, q = 1073479681: the forward equals the plain
    ``transforms.ntt.forward32`` (kernels 1-2 take log_n <= 14), the round
    trip returns the input, each u32 stage kernel launched once a shard a
    transform."""
    from primus_fhe_tpu_torch.ops import ntt_stages as st
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard
    from primus_fhe_tpu_torch.parallel import coeff_sharded as cs
    from primus_fhe_tpu_torch.transforms.ntt import forward32
    from primus_fhe_tpu_torch.transforms.plan import build_plan32

    q, spec = Q32_17 if log_n <= 17 else Q32_18, (None, "residue")
    gen = torch.Generator(device=dev).manual_seed(log_n * d)
    x = torch.randint(0, q, (2, 1 << log_n), generator=gen, device=dev)
    mesh = LocalMesh(d, 1, dev)
    kernels = (st.ntt32_stages_forward, st.ntt32_stages_inverse)
    before = [k.launches for k in kernels]
    f = cs.coeff_sharded_forward32(mesh, "residue", log_n, q, shard(mesh, x, spec))
    assert torch.equal(unshard(mesh, f, spec), forward32(build_plan32(log_n, q, dev), x))
    back = cs.coeff_sharded_inverse32(mesh, "residue", log_n, q, f)
    assert torch.equal(unshard(mesh, back, spec), x)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [d, d]


def test_stage_kernels_refuse_log_w_past_16(dev):
    """On the card the four stage kernels take log_w <= 17 (16 before: the
    name keeps the old cap): at log_w 18 each raises ValueError before any
    launch, and no launch count moves."""
    from primus_fhe_tpu_torch.ops import ntt_stages as st

    kernels = (st.ntt32_stages_forward, st.ntt32_stages_inverse, st.ntt64_stages_forward,
               st.ntt64_stages_inverse)
    before = [k.launches for k in kernels]
    tab = torch.zeros((18, 1 << 18), dtype=torch.int64, device=dev)
    x = torch.zeros((1, 1 << 18), dtype=torch.int64, device=dev)
    for k, q in zip(kernels, (Q32_17, Q32_17, Q62[0], Q62[0])):
        with pytest.raises(ValueError, match="log_w <= 17"):
            k(18, q, tab, tab, x)
        with pytest.raises(ValueError, match="log_w <= 17"):
            k(18, q, tab.to(torch.int32), tab.to(torch.int32), x.to(torch.int32)) \
                if k in kernels[:2] else k(18, q, tab, tab, x)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before


Q14 = next_ntt_prime(50, 14)  # = 1 mod 2^15: row 13 at log_n 14, 7 planes


@pytest.mark.parametrize("log_n,q", [(13, Q50[0]), (14, Q14)])
@pytest.mark.parametrize("d", [2, 4])
def test_sharded_mxu_at_log_n_13_and_14_on_the_card(dev, log_n, q, d):
    """Row 13 at log_n 13 and 14 (A = 64, 128, which the JAX
    ``ShardedMxuPlan64`` takes) over D shards of a ``LocalMesh``: the sharded
    forward equals row 10's ``ntt64_forward``, the round trip returns the
    input, and the keyed product equals row 10's route (``ntt64_forward``,
    the lazy Shoup multiply by the key, ``ntt64_inverse``); each split
    kernel launched once a shard a transform."""
    from primus_fhe_tpu_torch.modular.factor import ShoupFactor64, factor_mul_lazy64
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm

    plan = csm.get_sharded_plan(log_n, q)
    tables, n = plan.tables, 1 << log_n
    mesh = LocalMesh(d, 1, dev)
    coeff, ntt = (None, "residue", None), ("residue", None, None)
    gen = torch.Generator(device=dev).manual_seed(log_n + d)
    x = _below(gen, [q], (8, n), 1, dev)[0]
    mt = tables.mul_table(_below(gen, [q], (n,), 1, dev)[0][None])
    kernels = (split.split_k1, split.split_k2, split.split_ki1, split.split_ki2)
    for k in kernels:
        k.launches = 0
    f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q,
                                  shard(mesh, csm.to_coeff_layout(x, plan.A, plan.B), coeff))
    want = ntt64.ntt64_forward(tables.ntt, x[None])
    assert torch.equal(csm.ntt_layout_to_flat(unshard(mesh, f, ntt)), want[0])
    back = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, back, coeff)), x)
    prod = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)
    qt = torch.tensor([q], dtype=torch.int64, device=dev).reshape(1, 1, 1)
    keyed = factor_mul_lazy64(want, ShoupFactor64(mt[:, 0, None], mt[:, 1, None]), qt)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, prod, coeff)),
                       ntt64.ntt64_inverse(tables.ntt, keyed)[0])
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [d, d, 2 * d, 2 * d]


def test_split_kernels_refuse_log_n_past_the_range(dev):
    """Row 13 on the card takes 8 <= log_n <= 14: at log_n 7 and 15 the four
    split kernels raise ValueError before any launch."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.ops.ntt_mxu8 import Mxu8Tables64

    kernels = (split.split_k1, split.split_k2, split.split_ki1, split.split_ki2)
    before = [k.launches for k in kernels]
    for log_n in (7, 15):
        tables = Mxu8Tables64(ntt64.NttTables64(log_n, [Q62[0]]))
        lanes = torch.zeros((1, tables.A, 128), dtype=torch.int64, device=dev)
        rows = torch.zeros((1, 1, 128), dtype=torch.int64, device=dev)
        for call in (lambda: split.split_k1(tables, lanes, 1), lambda: split.split_k2(tables, rows),
                     lambda: split.split_ki1(tables, rows, 1), lambda: split.split_ki2(tables, lanes)):
            with pytest.raises(ValueError, match="8 <= log_n <= 14"):
                call()
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == before


def test_local_mesh_rotation_and_coeff_sharded_match_single_card(dev):
    """A (residue 2, batch 2) LocalMesh rotation step on the card equals the
    single-card ``dcrt_blind_rotate_batched`` on both routes, with one
    inverse and one forward launch a shard a step; the coefficient-sharded
    u64 round trip at n = 2^12 over 4 shards equals the input."""
    from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu_torch.parallel import (LocalMesh, coeff_sharded_forward64,
                                               coeff_sharded_inverse64, make_sharded_blind_rotation,
                                               shard, shard_rotation_inputs, unshard)
    from primus_fhe_tpu_torch.parallel.sharded_rotation import ACC_SPEC
    from primus_fhe_tpu_torch.rns import RNSBase64
    from primus_fhe_tpu_torch.transforms.dcrt import build_dcrt_plan64
    from primus_fhe_tpu_torch.transforms.ntt import forward64
    from primus_fhe_tpu_torch.transforms.plan import build_plan64

    log_n, n_lwe, bsz = 10, 3, 4
    n = 1 << log_n
    base = RNSBase64(Q50)
    basis = BigUintApproxSignedBasis(base, 25)
    plan = build_dcrt_plan64(log_n, Q50)
    gen = torch.Generator(device=dev).manual_seed(12)
    bsk = _below(gen, Q50, (n_lwe, 2, basis.decompose_length, 2, n), 1, dev).movedim(0, 3)
    acc = _below(gen, Q50, (bsz, 2, n), 1, dev).transpose(0, 1).contiguous()
    lwe = torch.randint(0, 2 * n, (bsz, n_lwe + 1), generator=gen, device=dev)
    mesh = LocalMesh(2, 2, dev)
    for route, fwd, inv in (("auto", ntt_mxu8.mxu8_forward64, ntt_mxu8.mxu8_inverse64),
                            ("butterfly", ntt64.ntt64_forward, ntt64.ntt64_inverse)):
        want = dcrt_blind_rotate_batched(plan, basis, base, bsk.contiguous(), lwe, acc, route=route)
        fn = make_sharded_blind_rotation(mesh, "residue", "batch", basis, plan, base, route)
        args = shard_rotation_inputs(mesh, "residue", "batch", bsk.contiguous(), lwe, acc)
        fwd.launches = inv.launches = 0
        got = unshard(mesh, fn(*args), ACC_SPEC)
        assert fwd.launches == inv.launches == mesh.size * n_lwe
        assert torch.equal(got, want)
    q = 4611686018425815041
    x = _below(gen, [q], (2, 1 << 12), 1, dev)[0]
    cmesh = LocalMesh(4, 1, dev)
    f = coeff_sharded_forward64(cmesh, "residue", 12, q, shard(cmesh, x, (None, "residue")))
    assert torch.equal(unshard(cmesh, f, (None, "residue")), forward64(build_plan64(12, q, dev), x))
    back = coeff_sharded_inverse64(cmesh, "residue", 12, q, f)
    assert torch.equal(unshard(cmesh, back, (None, "residue")), x)


def _lazy_equal(got, plain, q):
    """The lazy-word rule: ``got`` below 2q and equal to ``plain`` mod q."""
    from primus_fhe_tpu_torch.modular.modops import reduce_once64

    assert bool((got >= 0).all() and (got < 2 * q).all())
    assert torch.equal(reduce_once64(got, q), plain)


def _word_extremes(x, q):
    """``x`` with its first words set to 0, q - 1, q, 2q, 4q - 1 and 2^64 - 1
    (int64 bit patterns), where it holds that many."""
    flat = x.view(-1)
    vals = [0, q - 1, q, 2 * q, 4 * q - 1, (1 << 64) - 1]
    vals = [v - (1 << 64) if v >= 1 << 63 else v for v in vals][:flat.numel()]
    flat[:len(vals)] = torch.tensor(vals, dtype=torch.int64, device=x.device)
    return x


@pytest.mark.parametrize("log_n,q,batches", [
    (8, Q50[0], (1, 3, 64)), (12, Q50[1], (1, 3, 64)), (8, Q60, (1, 3, 64)),
    (12, Q60, (1, 3, 64)), (12, Q50[0], (512,)), (13, Q50[0], (1, 3, 64)), (13, Q60, (1, 3)),
    (14, Q14, (1, 3, 64)), (14, Q62[0], (1, 3))])
def test_split_kernels_match_plain(dev, log_n, q, batches):
    """Row 13's K1, K2, Ki1 (with and without the key) and Ki2 on shard
    ``d - 1`` of D = 1, 2, 4 (where D divides A = n / 128), at each batch
    (1 and 3 give ragged lane and row counts; 512 at log_n 12 is phase 16's
    product, 8192 rows at D = 2; log_n 13 and 14 split a lane over 2 and 4
    threads), 7 and 8 planes, the word extremes 0, q, 2q, 4q - 1 and 2^64 -
    1 in: K2 and Ki2 bit-equal to their plain versions, K1 and Ki1 by the
    lazy rule; each launch counted once."""
    from primus_fhe_tpu_torch.ops import ntt_mxu8_split as split
    from primus_fhe_tpu_torch.parallel.coeff_sharded_mxu import get_sharded_plan

    plan = get_sharded_plan(log_n, q)
    tables, A, B = plan.tables, plan.A, plan.B
    gen = torch.Generator(device=dev).manual_seed(log_n + q % 97)
    mt = tables.mul_table(_below(gen, [q], (1 << log_n,), 1, dev)[0][None])
    for d in (1, 2, 4):
        if A % d:
            continue
        k0_off, r0_off = plan.offsets(d, d - 1)
        for batch in batches:
            lanes = _word_extremes(_u64_words(gen, (1, A, B // d * batch), dev), q)
            rows = _word_extremes(_u64_words(gen, (1, A // d * batch, B), dev), q)
            key = mt.reshape(1, 2, A, B)[:, :, r0_off:r0_off + A // d].reshape(1, 2, -1)
            key = key.contiguous()
            for fn in (split.split_k1, split.split_k2, split.split_ki1, split.split_ki2):
                fn.launches = 0
            _lazy_equal(split.split_k1(tables, lanes, batch, k0_off),
                        split.split_k1_plain(tables, lanes, batch, k0_off), q)
            assert torch.equal(split.split_k2(tables, rows), split.split_k2_plain(tables, rows))
            for k in (None, key):
                _lazy_equal(split.split_ki1(tables, rows, batch, r0_off, k),
                            split.split_ki1_plain(tables, rows, batch, r0_off, k), q)
            assert torch.equal(split.split_ki2(tables, lanes), split.split_ki2_plain(tables, lanes))
            assert (split.split_k1.launches, split.split_k2.launches, split.split_ki1.launches,
                    split.split_ki2.launches) == (1, 1, 2, 1)


@pytest.mark.parametrize("log_n,q,d", [(10, Q60, 8), (12, Q50[0], 4)])
def test_coeff_sharded_mxu_matches_fused(dev, log_n, q, d):
    """The sharded forward and keyed inverse on a LocalMesh equal
    ``mxu8_forward64`` and kernel D; the plain inverse round-trips."""
    from primus_fhe_tpu_torch.parallel import coeff_sharded_mxu as csm
    from primus_fhe_tpu_torch.parallel import LocalMesh, shard, unshard

    plan = csm.get_sharded_plan(log_n, q)
    gen = torch.Generator(device=dev).manual_seed(d)
    x = _below(gen, [q], (16, 1 << log_n), 1, dev)[0]
    mt = plan.tables.mul_table(_below(gen, [q], (1 << log_n,), 1, dev)[0][None])
    mesh = LocalMesh(d, 1, dev)
    coeff, ntt = (None, "residue", None), ("residue", None, None)
    f = csm.sharded_mxu_forward64(mesh, "residue", log_n, q,
                                  shard(mesh, csm.to_coeff_layout(x, plan.A, plan.B), coeff))
    want = ntt_mxu8.mxu8_forward64(plan.tables, x[None])[0]
    assert torch.equal(csm.ntt_layout_to_flat(unshard(mesh, f, ntt)), want)
    back = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, back, coeff)), x)
    prod = csm.sharded_mxu_inverse64(mesh, "residue", log_n, q, f, mul_tab=mt)
    assert torch.equal(csm.from_coeff_layout(unshard(mesh, prod, coeff)),
                       ntt_mxu8.mxu8_inverse64_mul(plan.tables, want[None], mt)[0])


def test_dcrt32_sharded_product_and_torus64(dev):
    """The 32-bit DCRT transforms (five primes: two launches), the sharded
    external product on a (2, 2) LocalMesh and the 64-bit torus product on
    the card equal their CPU runs."""
    from primus_fhe_tpu_torch.decompose import ApproxSignedBasis64
    from primus_fhe_tpu_torch.lattice import tfhe64
    from primus_fhe_tpu_torch.parallel import LocalMesh, sharded, unshard
    from primus_fhe_tpu_torch.transforms import dcrt

    gen = torch.Generator(device=dev).manual_seed(32)
    plan = dcrt.build_dcrt_plan32(10, PRIMES3 + [1073453057, 1073442817])
    x = _residues(gen, plan.moduli, (3, 1 << 10), 4, dev)
    for of in (1, 4):
        assert torch.equal(dcrt.dcrt_forward32(plan, x, of).cpu(),
                           dcrt.dcrt_forward32(plan, x.cpu(), of))
    y = _residues(gen, plan.moduli, (3, 1 << 10), 2, dev)
    assert torch.equal(dcrt.dcrt_inverse32(plan, y).cpu(), dcrt.dcrt_inverse32(plan, y.cpu()))
    conv = tfhe.make_convolver(10, 3, 1, 7)
    basis = ApproxSignedBasis32(None, 7, reverse_length=3)
    glwe = torch.randint(0, 1 << 32, (4, 2, 1 << 10), generator=gen, device=dev)
    key = _residues(gen, conv.primes, (2, 3, 2, 1 << 10), 1, dev)
    mesh = LocalMesh(2, 2, dev)
    g, k = sharded.shard_external_product_inputs(mesh, glwe, key)
    got = unshard(mesh, sharded.sharded_external_product(conv, basis, g, k, mesh),
                  sharded.glwe_spec(3))
    assert torch.equal(got, tfhe.external_product(conv, basis, glwe, key))
    b64 = ApproxSignedBasis64(None, 16, reverse_length=4)
    c64 = tfhe64.make_convolver64(10, 4, 1, 16)
    ggsw = _u64_words(gen, (2, 4, 2, 1 << 10), dev)
    glwe64 = _u64_words(gen, (3, 2, 1 << 10), dev)
    out = tfhe64.external_product64(c64, b64, glwe64, tfhe64.ggsw_to_ntt64(c64, ggsw))
    cpu = tfhe64.external_product64(c64, b64, glwe64.cpu(), tfhe64.ggsw_to_ntt64(c64, ggsw.cpu()))
    assert torch.equal(out.cpu(), cpu)


def test_circuit_bootstrap_mux_and_key_switches_match_cpu(dev):
    """At TOY size (N = 32, n_lwe = 8, the PBS gadget 2^8 x 3): the
    circuit bootstrap (2^8 x 2, private switches 2^8 x 3), ``ggsw_to_ntt``
    and ``leveled_mux``, ``glwe_key_switch`` (k 2 -> 1) and ``pack_lwes`` on
    CUDA tensors (kernels 1-4 and F, the torch MAC) equal the same calls on
    the CPU, word for word; so do the prime-q RLWE phase and GLWE phase
    (kernels 1-2 on one prime)."""
    from primus_fhe_tpu_torch.boot import circuit_bootstrap as cb
    from primus_fhe_tpu_torch.boot.blind_rotate import make_bootstrap_key
    from primus_fhe_tpu_torch.boot.gates import leveled_mux
    from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian, sample_binary
    from primus_fhe_tpu_torch.lattice import glev, glwe_keyswitch, rlwe
    from primus_fhe_tpu_torch.modular.modulus import barrett32

    p = P.TOY
    n = p.n
    gen = torch.Generator(device=dev).manual_seed(21)
    words = lambda *shape: torch.randint(0, 1 << 32, shape, generator=gen, device=dev)  # noqa: E731
    conv = tfhe.make_convolver(p.log_n, 3, 2, 8)
    basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    basis_cb = ApproxSignedBasis32(None, 8, reverse_length=2)
    gauss = DiscreteGaussian(3.2)
    lwe_s = sample_binary(gen, (p.lwe_dim,))
    glwe_s = sample_binary(gen, (1, n))
    bsk = make_bootstrap_key(lwe_s, glwe_s, basis, gauss, conv, gen)
    minus_x = torch.zeros(n, dtype=torch.int64, device=dev)
    minus_x[0] = 0xFFFFFFFF
    ksks = [cb.make_private_functional_ksk(f, glwe_s.reshape(-1), glwe_s, basis, gauss, conv, gen)
            for f in (glwe_s[0], minus_x)]
    ct = words(p.lwe_dim + 1)
    ggsw = cb.circuit_bootstrap(conv, basis, bsk, conv, basis_cb, basis, ksks, ct, p.log_n)
    ggsw_cpu = cb.circuit_bootstrap(conv, basis, bsk.cpu(), conv, basis_cb, basis,
                                    [k.cpu() for k in ksks], ct.cpu(), p.log_n)
    assert torch.equal(ggsw.cpu(), ggsw_cpu)
    ggsw_ntt = tfhe.ggsw_to_ntt(conv, ggsw)
    assert torch.equal(ggsw_ntt.cpu(), tfhe.ggsw_to_ntt(conv, ggsw_cpu))
    cx, cy = words(3, 2, n), words(3, 2, n)
    assert torch.equal(leveled_mux(conv, basis_cb, ggsw_ntt, cx, cy).cpu(),
                       leveled_mux(conv, basis_cb, ggsw_ntt.cpu(), cx.cpu(), cy.cpu()))
    s_in = sample_binary(gen, (2, n))
    ksk = glwe_keyswitch.make_glwe_keyswitch_key(s_in, glwe_s, basis, gauss, conv, gen)
    glwe_in = words(4, 3, n)
    assert torch.equal(glwe_keyswitch.glwe_key_switch(conv, basis, glwe_in, ksk).cpu(),
                       glwe_keyswitch.glwe_key_switch(conv, basis, glwe_in.cpu(), ksk.cpu()))
    pksk = glwe_keyswitch.make_packing_keyswitch_key(lwe_s, glwe_s, basis, gauss, conv, gen)
    lwes = words(n - 3, p.lwe_dim + 1)
    assert torch.equal(glwe_keyswitch.pack_lwes(conv, basis, lwes, pksk).cpu(),
                       glwe_keyswitch.pack_lwes(conv, basis, lwes.cpu(), pksk.cpu()))
    q = conv.primes[0]
    tables, m = ntt32.NttTables32(p.log_n, (q,)), barrett32(q)
    s_ntt = ntt32.forward32(tables, sample_binary(gen, (1, 2, n)))[0]
    c = torch.randint(0, q, (5, 3, n), generator=gen, device=dev)
    assert torch.equal(glev.glwe_phase32(c, s_ntt, tables, m.map(lambda x: x.to(dev))).cpu(),
                       glev.glwe_phase32(c.cpu(), s_ntt.cpu(), tables, m))
    assert torch.equal(rlwe.phase32(c[:, :2], s_ntt[0], tables, m.map(lambda x: x.to(dev))).cpu(),
                       rlwe.phase32(c[:, :2].cpu(), s_ntt[0].cpu(), tables, m))


@pytest.mark.parametrize("kp", [5, 8])
def test_cmux_front_over_four_primes(dev, kp):
    """Kernel G over more primes than a launch takes: one launch a group of
    at most 4 primes, each into its slice of the one output, equal to the
    plain version (int64 and int32 storage)."""
    primes = [next_ntt_prime(30, 11)]
    while len(primes) < kp:
        primes.append(next_ntt_prime(30, 11, primes[-1]))
    gen = torch.Generator(device=dev).manual_seed(500 + kp)
    acc = torch.randint(0, 1 << 32, (6, 2, 2048), generator=gen, device=dev)
    degrees = torch.randint(-8192, 8193, (6,), generator=gen, device=dev, dtype=torch.int32)
    basis = ApproxSignedBasis32(None, 7, reverse_length=3)
    want = cmux_front.cmux_front_plain(acc, degrees, basis, primes)
    before = cmux_front.cmux_front.launches
    got = cmux_front.cmux_front(acc, degrees, basis, primes)
    torch.cuda.synchronize()
    assert cmux_front.cmux_front.launches - before == -(-kp // cmux_front.GROUP_PRIMES)
    assert torch.equal(got, want)
    got32 = cmux_front.cmux_front(acc.to(torch.int32), degrees, basis, primes)
    assert torch.equal(got32.to(torch.int64) & 0xFFFFFFFF, want)


def test_load_keys_and_tracked_gates_on_the_card(tmp_path):
    """A TOY context made on the CPU, saved, and loaded onto the card by
    ``load_keys``'s default device: the same words; tracked NAND, AND and OR
    on the card (the fused CMux step once a key slice, kernel F once a gate)
    give the CPU context's words and variances on the same inputs; an
    inflated variance is refused before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from primus_fhe_tpu_torch import noise, tracked

    p = P.TOY
    ctx = P.make_context(p, "cpu", torch.Generator().manual_seed(22), bsk_kind="ntt")
    P.save_keys(tmp_path / "keys.npz", ctx)
    card = P.load_keys(tmp_path / "keys.npz")
    assert card.device.type == "cuda"
    for name in ("bsk", "ksk", "lwe_secret", "glwe_secret"):
        assert torch.equal(getattr(card, name).cpu(), getattr(ctx, name)), name
    g = torch.Generator().manual_seed(23)
    a = tracked.encrypt_bit(ctx, g, torch.tensor([0, 0, 1, 1]))
    b = tracked.encrypt_bit(ctx, g, torch.tensor([0, 1, 0, 1]))
    on_card = lambda t: tracked.TrackedLwe(t.ct.to(card.device), t.noise)  # noqa: E731
    for kind in ("nand", "and", "or"):
        steps, rots = cmux_fused.fused_cmux_step.launches, rotate.rotate.launches
        got = tracked.gate(card, kind, on_card(a), on_card(b))
        torch.cuda.synchronize()
        assert cmux_fused.fused_cmux_step.launches - steps == p.lwe_dim
        assert rotate.rotate.launches - rots == 1
        want = tracked.gate(ctx, kind, a, b)
        assert torch.equal(got.ct.cpu(), want.ct) and got.noise == want.noise
    bad = tracked.TrackedLwe(on_card(a).ct, noise.NoiseEstimate(2.0**58))
    steps = cmux_fused.fused_cmux_step.launches
    with pytest.raises(ValueError, match="unsafe"):
        tracked.gate(card, "nand", bad, bad)
    assert cmux_fused.fused_cmux_step.launches == steps
