"""A numpy model of the one-launch CMux step kernel (``csrc/cmux_fused.cu``),
held bit-equal to the plain composition ``cmux_stage2_plain(
cmux_stage1_plain(...))`` on the CPU.

The model runs the kernel's schedule as written, every block of a cluster
at once: the host pack read at the C entry's offsets; pass 1 fused with the
rotate-diff, the carry chain and the lift; the radix-8 forward passes and
the inverse passes (slot maps, twiddle indices, the final ``inv_n`` stage);
the swizzled shared-memory layout through which every pass reads and
writes; the MAC with one Barrett reduction per sum; the (prime, row) ->
(prime, component) ownership: each block pushes its partial of component j
into block (prime, j)'s inbox, whose first inverse pass adds the k1 rows;
the CRT split of a component over its kp owners, each pushing its residues
of a coefficient to the owner of that coefficient.  Every word is checked below 2^32 and inside its lazy range.  The
shapes are the card tests' four and BOOLEAN_128's, with degrees 0, 7, n and
2n - 1.  Tolerance: zero (bit-equal).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_fused

M32 = np.uint64(0xFFFFFFFF)

# (log_n, log_basis, level, k): tests/test_torch_cuda_kernels.py's CMux shapes
CARD_SHAPES = [(5, 8, 3, 1), (8, 1, 12, 1), (11, 7, 3, 1), (8, 8, 2, 2)]
BOOL = P.BOOLEAN_128
SHAPES = CARD_SHAPES + [(BOOL.log_n, BOOL.log_basis, BOOL.level, BOOL.glwe_dim), (12, 7, 2, 2)]


def swz(i):
    """Shared-memory word of slot ``i`` (``swz`` in the kernel)."""
    return i ^ ((i >> 3) & 31)


def first_radix(log_n: int) -> int:
    """Stages of forward pass 1 (``r0``): the other passes take 3 each."""
    return (log_n - 1) % 3 + 1


def forward_passes(log_n: int):
    """``(s0, R)`` of each forward pass, in order."""
    r0 = first_radix(log_n)
    return [(0, r0)] + [(s0, 3) for s0 in range(r0, log_n, 3)]


def inverse_passes(log_n: int):
    """``(s0, R, last)`` of each inverse pass: radix 8 from stage 0, the
    remainder last; ``last`` marks the pass holding the final stage."""
    out = []
    for s0 in range(0, log_n, 3):
        r = min(3, log_n - s0)
        out.append((s0, r, s0 + r == log_n))
    return out


def fwd_slots(log_n, s0, r):
    """Slots ``(2^R, groups)`` and the groups' ``hi`` of a forward pass."""
    log_tl = log_n - s0 - r
    g = np.arange(1 << (log_n - r))
    hi, lo = g >> log_tl, g & ((1 << log_tl) - 1)
    base = (hi << (log_tl + r)) + lo
    return base[None, :] + (np.arange(1 << r)[:, None] << log_tl), hi


def inv_slots(log_n, s0, r):
    g = np.arange(1 << (log_n - r))
    hi, lo = g >> s0, g & ((1 << s0) - 1)
    base = (hi << (s0 + r)) + lo
    return base[None, :] + (np.arange(1 << r)[:, None] << s0), hi


def shoup(y, w, wp, q):
    """``w*y - q*floor(y*wp / 2^32)`` mod 2^32, in ``[0, 2q)``."""
    y, w, wp, q = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp, q))
    return (w * y - q * ((y * wp) >> np.uint64(32))) & M32


def reduce_once(x, q):
    return np.where(x >= q, x - q, x)


def check_words(x, below):
    assert (np.asarray(x) < np.asarray(below, dtype=np.uint64)).all()


class Pack:
    """The host pack read at the C entry's offsets (``pft_cmux_step``)."""

    def __init__(self, h):
        h = [int(v) for v in h]
        self.kp, self.k1, self.log_n = h[0], h[1], h[2]
        kp = self.kp
        pr = [h[7 + 7 * i: 14 + 7 * i] for i in range(kp)]
        self.q = np.array([p[0] for p in pr], dtype=np.uint64)
        self.inv_n, self.inv_n_p, self.inv_n_w, self.inv_n_w_p = (
            np.array([p[i] for p in pr], dtype=np.uint64) for i in (1, 2, 3, 4))
        self.wrap_c = np.array([p[5] for p in pr], dtype=np.uint64)
        self.ratio = [p[6] for p in pr]
        c = h[7 + 7 * kp:]
        self.iw = [c[4 * i] for i in range(kp)]
        self.ipq = [c[4 * i + 1] for i in range(kp)]
        self.afix = [c[4 * i + 2] for i in range(kp)]
        self.pmod = [c[4 * i + 3] for i in range(kp)]
        self.pmt = c[4 * kp]
        (self.level, self.log_basis, self.drop, self.bm1, self.cmask, self.mmb,
         self.init_mask) = h[8 + 11 * kp: 15 + 11 * kp]
        assert len(h) == 15 + 11 * kp


def digit_chain(diff, pk: Pack):
    """The signed digits of every level, one carry chain (``digit_step``)."""
    carry = ((diff & np.uint64(pk.init_mask)) != 0).astype(np.uint64)
    out = []
    for lv in range(pk.level):
        shift = np.uint64(pk.drop + lv * pk.log_basis)
        temp = ((diff >> shift) & np.uint64(pk.bm1)) + carry
        nxt = ((temp & np.uint64(pk.cmask)) != 0).astype(np.uint64)
        sgn = np.where(temp > pk.bm1, np.uint64(0), (temp + np.uint64(pk.mmb)) & M32)
        carry = nxt
        out.append(np.where(nxt != 0, sgn, temp))
    return out


def lift(x, pk: Pack):
    """Centered lift of torus words ``(..., n)`` -> ``(..., kp, n)`` mod p."""
    q = pk.q[:, None]
    r = x[..., None, :] % q
    wc = pk.wrap_c[:, None]
    neg = (x[..., None, :] >> np.uint64(31)) != 0
    return np.where(neg, np.where(r < wc, r + q - wc, r - wc), r)


def fwd_stages(v, hi, s0, r, tw, twp, q):
    """R forward stages on ``v (..., kp, rows, 2^R, groups)``; tables
    ``(kp, n)``; ``q (kp,)``."""
    q = q[:, None, None]
    two_q = 2 * q
    for e in range(r):
        h = 1 << (r - 1 - e)
        for k in range(1 << r):
            if k & h:
                continue
            ti = (1 << (s0 + e)) + (hi << e) + (k >> (r - e))
            w, wp = tw[:, ti][:, None, :], twp[:, ti][:, None, :]
            x, y = v[..., k, :], v[..., k + h, :]
            tx = np.where(x >= two_q, x - two_q, x)
            ty = shoup(y, w, wp, q)
            v[..., k, :] = tx + ty
            v[..., k + h, :] = tx + two_q - ty
            check_words(v[..., k, :], 4 * q)
            check_words(v[..., k + h, :], 4 * q)


def inv_stages(v, hi, s0, r, last, itw, itwp, pk: Pack, n):
    """R inverse stages on ``v (..., kp, k1, 2^R, groups)``."""
    q = pk.q[:, None, None]
    two_q = 2 * q
    for e in range(r):
        h = 1 << e
        start = 1 + n - (n >> (s0 + e))
        for k in range(1 << r):
            if k & h:
                continue
            x, y = v[..., k, :].copy(), v[..., k + h, :].copy()
            if last and e == r - 1:
                s = x + y
                tx = np.where(s >= two_q, s - two_q, s)
                v[..., k, :] = reduce_once(shoup(tx, pk.inv_n[:, None, None],
                                                 pk.inv_n_p[:, None, None], q), q)
                v[..., k + h, :] = reduce_once(shoup(x + two_q - y, pk.inv_n_w[:, None, None],
                                                     pk.inv_n_w_p[:, None, None], q), q)
                check_words(v[..., k, :], q)
                check_words(v[..., k + h, :], q)
            else:
                ti = start + (hi << (r - 1 - e)) + (k >> (e + 1))
                s = x + y
                v[..., k, :] = np.where(s >= two_q, s - two_q, s)
                v[..., k + h, :] = shoup(x + two_q - y, itw[:, ti][:, None, :],
                                         itwp[:, ti][:, None, :], q)
                check_words(v[..., k, :], two_q)
                check_words(v[..., k + h, :], two_q)


def barrett_wide(s, ratio, q):
    """One Barrett reduction of u64 sums (exact, Python ints), canonical."""
    flat = [int(v) for v in s.reshape(-1)]
    out = []
    for v in flat:
        r = (v - ((v * ratio) >> 64) * q) & 0xFFFFFFFF
        assert r < 2 * q
        out.append(r - q if r >= q else r)
    return np.array(out, dtype=np.uint64).reshape(s.shape)


def model_step(conv, basis, acc, degrees, key):
    """The kernel's step on numpy u64 words: ``acc (B, k1, n)``, ``degrees
    (B,)``, ``key (kp, k1, L, k1, n)`` canonical -> ``(B, k1, n)``."""
    bsz, k1, n = acc.shape
    pk = Pack(cmux_fused.step_pack(conv, basis, k1))
    kp, log_n, L = pk.kp, pk.log_n, pk.level
    assert (pk.k1, 1 << log_n, L) == (k1, n, key.shape[2])
    assert L * (int(pk.q.max()) - 1) ** 2 < 1 << 64  # the MAC's u64 sum
    tabs = [np.stack([getattr(pl, name).numpy().astype(np.uint64) for pl in conv.ntt.plans])
            for name in ("roots", "roots_precon", "inv_roots", "inv_roots_precon")]
    tw, twp, itw, itwp = tabs
    q = pk.q
    # the digit rows of every block (b, pi, r): L rows of n words
    sm = np.zeros((bsz, kp, k1, L, n), dtype=np.uint64)
    assert len(np.unique(swz(np.arange(n)))) == n and swz(np.arange(n)).max() < n

    # 1. rotate-diff, digits of every level, lift, forward pass 1
    d = (degrees.astype(np.int64) % (2 * n))[:, None]
    c = np.arange(n)[None, :]
    e = c - d
    e = np.where(e < 0, e + 2 * n, e)
    src = np.take_along_axis(acc, np.broadcast_to(np.where(e >= n, e - n, e)[:, None, :],
                                                  acc.shape), axis=2)
    rot = np.where((e >= n)[:, None, :], (np.uint64(1 << 32) - src) & M32, src)
    diff = (rot - acc) & M32  # (B, k1, n)
    s0, r0 = forward_passes(log_n)[0]
    slots, hi = fwd_slots(log_n, s0, r0)
    assert (hi == 0).all()
    small = pk.log_basis <= 30 and (1 << (pk.log_basis - 1)) < int(q.min())
    for lv, dig in enumerate(digit_chain(diff, pk)):
        lifted = lift(dig, pk)  # (B, k1, kp, n)
        if small:  # the kernel's short lift: |digit| <= 2^(log_basis - 1) < q
            qd = q[:, None]
            short = np.where(dig[..., None, :] >> np.uint64(31) != 0,
                             (dig[..., None, :] + qd) & M32, dig[..., None, :])
            np.testing.assert_array_equal(short, lifted)
        v = lifted.transpose(0, 2, 1, 3)[..., slots]  # (B, kp, k1, 2^R, groups)
        fwd_stages(v, hi, s0, r0, tw, twp, q)
        sm[:, :, :, lv][..., swz(slots)] = v

    # 2. the radix-8 forward passes over all L transforms
    for s0, r in forward_passes(log_n)[1:]:
        slots, hi = fwd_slots(log_n, s0, r)
        v = sm[:, :, :, :L][..., swz(slots)]  # (B, kp, k1, L, 8, groups), a copy
        fwd_stages(v.reshape(bsz, kp, k1 * L, 8, -1), hi, s0, r, tw, twp, q)  # in place
        sm[:, :, :, :L][..., swz(slots)] = v

    # 3. MAC: partial[j] = sum_l f_l * key[pi, r, l, j], one reduction a sum,
    #    pushed to row r of block (pi, j)'s partials inbox
    f = sm[:, :, :, :L][..., swz(np.arange(n))]  # (B, kp, k1, L, n)
    check_words(f, 4 * q[None, :, None, None, None])
    qb = q[None, :, None, None, None]
    f = reduce_once(reduce_once(f, 2 * qb), qb)
    s = np.einsum("bprln,prljn->bprjn", f, key.astype(np.uint64))  # exact: below 2^64
    part = np.stack([barrett_wide(s[:, i], pk.ratio[i], int(q[i])) for i in range(kp)], axis=1)
    inbox = np.zeros((bsz, kp, k1, k1, n), dtype=np.uint64)  # (b, pi, owner, sender, word)
    for sender in range(k1):
        for owner in range(k1):
            inbox[:, :, owner, sender][..., swz(np.arange(n))] = part[:, :, sender, owner]

    # 4. block (pi, r) owns component r: its first inverse pass adds the k1
    #    inbox rows in order, the inverse NTT runs in inbox row 0
    qo = q[None, :, None, None, None]
    own = inbox[:, :, :, 0].copy()  # (B, kp, k1, n)
    for s0, r, last in inverse_passes(log_n):
        slots, hi = inv_slots(log_n, s0, r)
        v = own[..., swz(slots)]
        if s0 == 0:
            assert not last
            for rr in range(1, k1):
                v = reduce_once(v + inbox[:, :, :, rr][..., swz(slots)], qo)
            check_words(v, qo)
        inv_stages(v, hi, s0, r, last, itw, itwp, pk, n)
        own[..., swz(slots)] = v

    # 5. each owner (pi, r) pushes y = residue * (P/p_pi)^-1 of every
    #    coefficient to row pi of the CRT inbox of the block (pd, r) whose
    #    chunk holds it; 6. that block's CRT and the wrapping add
    chunk = -(-n // kp)
    crt_in = np.zeros((bsz, kp, k1, kp, n), dtype=np.uint64)  # (b, receiver, r, sender, c)
    covered = np.zeros(n, dtype=int)
    for pd in range(kp):
        cs = np.arange(pd * chunk, min(n, (pd + 1) * chunk))
        covered[cs] += 1
        for i in range(kp):
            qi = np.uint64(pk.q[i])
            crt_in[:, pd, :, i][..., cs] = reduce_once(
                shoup(own[:, i][..., swz(cs)], pk.iw[i], pk.ipq[i], qi), qi)
    assert (covered == 1).all()
    out = np.zeros_like(acc)
    for pd in range(kp):
        cs = np.arange(pd * chunk, min(n, (pd + 1) * chunk))
        fix = np.zeros((bsz, k1, len(cs)), dtype=np.uint64)
        over = np.zeros_like(fix)
        total = np.zeros_like(fix)
        for i in range(kp):
            y = crt_in[:, pd, :, i][..., cs]
            nf = fix + y * np.uint64(pk.afix[i])  # mod 2^64
            over += (nf < fix).astype(np.uint64)
            fix = nf
            total = (total + y * np.uint64(pk.pmod[i])) & M32
        alpha = (over + (fix >> np.uint64(63))) & M32
        out[..., cs] = (acc[..., cs] + total - alpha * np.uint64(pk.pmt)) & M32
    return out


def _inputs(conv, log_n, level, k, seed):
    n, k1 = 1 << log_n, k + 1
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << 32, (4, k1, n), dtype=np.uint64)
    degrees = np.array([0, 7, n, 2 * n - 1], dtype=np.int32)
    q = np.array(conv.primes, dtype=np.uint64).reshape(-1, 1, 1, 1, 1)
    key = rng.integers(0, 1 << 62, (conv.count, k1, level, k1, n), dtype=np.uint64) % q
    return acc, degrees, key


@pytest.mark.parametrize("log_n,log_basis,level,k", SHAPES)
def test_step_model_matches_plain(log_n, log_basis, level, k):
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    acc, degrees, key = _inputs(conv, log_n, level, k, log_n * 31 + level)
    got = model_step(conv, basis, acc, degrees, key)
    a = torch.from_numpy(acc.astype(np.int64))
    want = cmux_fused.cmux_stage2_plain(
        conv, cmux_fused.cmux_stage1_plain(conv, basis, a, torch.from_numpy(degrees)),
        torch.from_numpy(key.astype(np.int64)), a)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


@pytest.mark.parametrize("log_n", range(4, 13))
def test_passes_cover_every_stage_once(log_n):
    fwd = [s0 + e for s0, r in forward_passes(log_n) for e in range(r)]
    inv = [s0 + e for s0, r, _ in inverse_passes(log_n) for e in range(r)]
    assert fwd == list(range(log_n)) and inv == list(range(log_n))
    lasts = [last for *_, last in inverse_passes(log_n)]
    assert lasts == [False] * (len(lasts) - 1) + [True]
    assert inverse_passes(log_n)[0] == (0, 3, False)  # adds the partials; never the last
    for s0, r in forward_passes(log_n):  # every pass's groups tile the row
        slots, _ = fwd_slots(log_n, s0, r)
        assert sorted(slots.reshape(-1)) == list(range(1 << log_n))
    for s0, r, _ in inverse_passes(log_n):
        slots, _ = inv_slots(log_n, s0, r)
        assert sorted(slots.reshape(-1)) == list(range(1 << log_n))


@pytest.mark.parametrize("log_n", range(8, 13))
def test_radix8_passes_and_sweeps_are_bank_conflict_free(log_n):
    """Each warp (32 consecutive groups) of a radix-8 pass, at each of its 8
    loads or stores, and each warp of a coefficient-order sweep (MAC, CRT)
    hits 32 distinct banks of the swizzled rows."""
    def distinct_banks(words):  # (..., 32)
        return all(len(set(w % 32)) == 32 for w in words.reshape(-1, 32))

    passes = [fwd_slots(log_n, s0, r)[0] for s0, r in forward_passes(log_n) if r == 3]
    passes += [inv_slots(log_n, s0, r)[0] for s0, r, _ in inverse_passes(log_n) if r == 3]
    for slots in passes:
        assert distinct_banks(swz(slots))
    assert distinct_banks(swz(np.arange(1 << log_n)))


@pytest.mark.parametrize("log_n,log_basis,level,k", [(8, 8, 2, 4), (8, 1, 17, 1), (12, 1, 12, 1)])
def test_plan_refuses_shapes_the_kernel_does_not_take(log_n, log_basis, level, k):
    """A cluster over 8 blocks, more than 16 levels (the MAC's u64 sum) or
    more than 227 KB of shared memory a block: shapes the one-launch
    kernel does not take, which the card's route sends to the staged
    kernels (kernel G, kernel 1, kernel H) before any launch."""
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    assert cmux_fused.step_route(conv.count, k + 1, basis.decompose_length, log_n) == "staged"
