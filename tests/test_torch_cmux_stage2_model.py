"""A numpy model of kernel H (``csrc/cmux_stage2.cu``, the stand-alone
``cmux_stage2``), held word for word against ``ops.cmux_fused.
cmux_stage2_plain`` on the CPU.

The model runs the kernel's schedule as written, every block of every
cluster: the host pack read at the C entry's offsets; the grid of ``B k1``
clusters of ``kp C`` blocks (block (prime i, slice s) at rank ``i C + s``,
a row over C = 2^lc slices: 1 and 2 as the first design picked them at
log_n 15 and 16, 4 and 8 as ``pick_slices`` picks them now at a small
batch); the MAC (``slice_mac``): a group of 4 words a thread, each row's
16-byte loads on 16 bytes, rows in runs of ``MAC_DEPTH`` whose loads past
the last row are read and not summed, the flat indices into ``f`` and the
key, its digits brought into ``[0, p)``, its 64-bit sums reduced by the
kernel's Barrett estimate after every 16 products (each sum checked below
2^64 before every add); the swizzled slice in shared memory; the inverse
passes (at C > 1 the slice's passes on ``SliceInvTable``, then the last lc
stages across the slices, ``cross_inverse``), each output times
``(P/p_i)^-1`` mod ``p_i``; the CRT split, block (i, s) taking ``[i chunk,
(i+1) chunk)`` of slice s and reading the kp residues from the blocks (.,
s); the wrapping add.  Shapes: the widened ring of ``chip_smoke.py`` phase
21 (n = 2^15, kp 2, k = 1, L = 3), n = 2^16 over 3 primes, k = 2 over 3
primes and a 2^1 x 20 gadget at n = 2^10 (40 products a sum), and at n =
2^11-2^12 and 2^17 the row over C = 4 and 8 slices (cross_inverse at lc 2
and 3; clusters of 8-16 blocks), digits at the extremes of ``[0, 4p)``.
Tolerance: zero (bit-equal).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_fused
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

M32 = np.uint64(0xFFFFFFFF)
M64 = (1 << 64) - 1
MAC_RUN = 16  # MAC_RUN in csrc/ntt_split.cuh
MAC_DEPTH = 4  # MAC_DEPTH there
SLICE_MAX_LOG = 15  # H_SLICE_MAX_LOG


def swz(i):
    """``SwzNtt::at``."""
    return i ^ ((i >> 3) & 31) ^ ((i >> 5) & 3)


def mulhi64(a, b):
    """``__umul64hi`` of uint64 arrays, by 32-bit limbs."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    s32 = np.uint64(32)
    a0, a1, b0, b1 = a & M32, a >> s32, b & M32, b >> s32
    mid = ((a0 * b0) >> s32) + (a1 * b0 & M32) + (a0 * b1 & M32)
    return a1 * b1 + ((a1 * b0) >> s32) + ((a0 * b1) >> s32) + (mid >> s32)


def barrett_lazy_wide(v, ratio, q):
    """``barrett_lazy_wide``: v mod q in [0, 2q) for any v < 2^64."""
    q_hat = mulhi64(v, np.uint64(ratio)) & M32
    r = ((v & M32) - q_hat * np.uint64(q)) & M32
    assert (r < 2 * q).all()
    return r


def reduce_once(x, q):
    return np.where(x >= np.uint64(q), x - np.uint64(q), x)


def shoup(y, w, wp, q):
    y, w, wp = (np.asarray(v, dtype=np.uint64) for v in (y, w, wp))
    return (w * y - np.uint64(q) * ((y * wp) >> np.uint64(32))) & M32


def inv_bf(x, y, w, wp, q):
    two_q = np.uint64(2 * q)
    s = x + y
    return np.where(s >= two_q, s - two_q, s), shoup(x + two_q - y, w, wp, q)


def remainder_stages(log_n: int) -> int:
    return log_n - 3 * ((log_n - 1) // 3)


def inv_pass(v, s0, r, slots_hi, l, table, pl, last):
    """One inverse pass of R stages on ``v[k]`` (the group's 2^R words),
    ``table(ti)`` the twiddle of the slice's index ``ti``; the final stage
    folds inv_n in, canonical."""
    q, two_q = pl.q, np.uint64(2 * pl.q)
    for e in range(r):
        h = 1 << e
        start = 1 + (1 << l) - ((1 << l) >> (s0 + e))
        for k in range(1 << r):
            if k & h:
                continue
            if last and e == r - 1:
                xv, yv = v[k], v[k + h]
                s = xv + yv
                tx = np.where(s >= two_q, s - two_q, s)
                v[k] = reduce_once(shoup(tx, pl.inv_n, pl.inv_n_precon, q), q)
                v[k + h] = reduce_once(shoup(xv + two_q - yv, pl.inv_n_w, pl.inv_n_w_precon, q), q)
            else:
                w, wp = table(start + (slots_hi << (r - 1 - e)) + (k >> (e + 1)))
                v[k], v[k + h] = inv_bf(v[k], v[k + h], w, wp, q)
                assert (v[k] < two_q).all() and (v[k + h] < two_q).all()
    return v


def slice_mac(ff, fb, fs, kf, kb, ks, rows, nl, q, ratio):
    """``slice_mac`` on flat words: the 2^l canonical sums of the slice
    whose row t of digits starts at ``fb + t fs`` and of key at ``kb + t
    ks``; the threads' groups of 4 words side by side."""
    c = np.arange(nl)
    assert nl % 4 == 0 and fb % 4 == 0 == fs % 4 == kb % 4 == ks % 4  # 16-byte loads
    acc_s = np.zeros(nl, dtype=np.uint64)
    run = 0
    for t0 in range(0, rows, MAC_DEPTH):
        loads = []
        for d in range(MAC_DEPTH):
            t = min(t0 + d, rows - 1)  # past the last row: read, not summed
            loads.append((ff[fb + t * fs + c], kf[kb + t * ks + c]))
        for d, (fv, kv) in enumerate(loads):
            if t0 + d >= rows:
                continue
            assert (fv < 4 * q).all() and (kv < q).all()
            prod = reduce_once(reduce_once(fv, 2 * q), q) * kv
            assert (acc_s.astype(object) + prod.astype(object) <= M64).all()
            acc_s = acc_s + prod
            run += 1
            if run == MAC_RUN:
                acc_s, run = barrett_lazy_wide(acc_s, ratio, q), 0
    return reduce_once(barrett_lazy_wide(acc_s, ratio, q), q)


def cross_inverse(sm_rows, l, log_n, lc, tw, twp, pl):
    """``cross_inverse<lc, canonical>`` over the C slices ``sm_rows (C,
    2^l)`` of one row: block s takes groups ``[s per, (s+1) per)``, gathers
    word j of every slice, runs the last lc stages on the row's table and
    hands back the C words (returned as ``(C, 2^l)``)."""
    C = 1 << lc
    per = 1 << (l - lc)
    out = np.zeros_like(sm_rows)
    written = np.zeros(sm_rows.shape, dtype=np.int64)
    for s in range(C):
        js = np.arange(s * per, (s + 1) * per)
        v = inv_pass([sm_rows[k, swz(js)] for k in range(C)], l, lc, np.zeros_like(js), log_n,
                     lambda ti: (tw[ti], twp[ti]), pl, True)
        for k in range(C):
            out[k, swz(js)] = v[k]
            written[k, swz(js)] += 1
    assert (written == 1).all()  # every word of every slice by one group of one block
    return out


def inverse_slice(sm, l, table, pl, passes, last_pass: bool):
    """The passes over one slice's swizzled rows ``sm (2^l,)`` in place."""
    for i, (s0, r) in enumerate(passes):
        g = np.arange(1 << (l - r))
        hi, lo = g >> s0, g & ((1 << s0) - 1)
        base = (hi << (s0 + r)) + lo
        slots = base[None, :] + (np.arange(1 << r)[:, None] << s0)
        v = [sm[swz(slots[k])] for k in range(1 << r)]
        v = inv_pass(v, s0, r, hi, l, table, pl, last_pass and i == len(passes) - 1)
        for k in range(1 << r):
            sm[swz(slots[k])] = v[k]


def model_stage2(conv, f, key, acc, lc=None):
    """Kernel H on flat uint64 words: ``f (kp, B k1, L, n)`` below 4p, ``key
    (kp, k1, L, k1, n)``, ``acc (B, k1, n)``, a row over 2^lc slices (by
    default the fewest a slice of 2^15 words allows); the host pack as the C
    entry reads it."""
    bsz, k1, n = acc.shape
    level = key.shape[2]
    h = cmux_fused.stage2_pack(conv, k1, level, (11, 12))
    kp, hk1, L, log_n = (int(x) for x in h[:4])
    assert (kp, hk1, L, tuple(h[4:6])) == (conv.count, k1, level, (11, 12))
    primes = [int(h[6 + 7 * i]) for i in range(kp)]
    ratios = [int(h[6 + 7 * i + 6]) for i in range(kp)]
    crt = h[6 + 7 * kp:]
    iw, ipq = crt[0:4 * kp:4], crt[1:4 * kp:4]
    afix, pmod, pmt = crt[2:4 * kp:4], crt[3:4 * kp:4], np.uint64(crt[4 * kp])
    assert primes == conv.primes
    lc = max(0, log_n - SLICE_MAX_LOG) if lc is None else lc
    C, l = 1 << lc, log_n - lc
    nl = 1 << l
    assert kp * C <= 16 and lc <= l
    ff, kf = f.reshape(-1), key.reshape(-1)
    out = acc.reshape(-1).copy()
    written = np.zeros(out.shape, dtype=np.int64)
    for bj in range(bsz * k1):  # a cluster
        b, j = divmod(bj, k1)
        sm = np.zeros((kp, C, nl), dtype=np.uint64)
        for rank in range(kp * C):
            pi, s = rank >> lc, rank & (C - 1)
            q, lane0 = primes[pi], s << l
            # row t = r L + lv: f[pi, b k1 + r, lv] and key[pi, r, lv, j] (its row t k1 + j)
            fb = (((pi * bsz * k1 + b * k1) * L) << log_n) + lane0
            kb = (((pi * k1 * L * k1) + j) << log_n) + lane0
            c = np.arange(nl)
            sm[pi, s, swz(c)] = slice_mac(ff, fb, n, kf, kb, k1 * n, k1 * L, nl, q, ratios[pi])
        for pi in range(kp):  # the inverse
            pl = conv.ntt.plans[pi]
            q = pl.q
            tw = pl.inv_roots.numpy().astype(np.uint64)
            twp = pl.inv_roots_precon.numpy().astype(np.uint64)
            r0 = remainder_stages(l)
            passes = [(0, r0)] + [(s0, 3) for s0 in range(r0, l, 3)]
            if lc == 0:
                inverse_slice(sm[pi, 0], l, lambda ti: (tw[ti], twp[ti]), pl, passes, True)
                sm[pi, 0] = reduce_once(shoup(sm[pi, 0], iw[pi], ipq[pi], q), q)
                continue
            for s in range(C):  # SliceInvTable
                def table(ti, s=s):
                    ls = np.frexp(((1 << l) - ti).astype(np.float64))[1]
                    jj = ti - 1 - (1 << l) + (1 << ls)
                    gi = 1 + n - (1 << (log_n - l + ls)) + (s << (ls - 1)) + jj
                    return tw[gi], twp[gi]
                inverse_slice(sm[pi, s], l, table, pl, passes, False)
            sm[pi] = reduce_once(shoup(cross_inverse(sm[pi], l, log_n, lc, tw, twp, pl),
                                       iw[pi], ipq[pi], q), q)
        for rank in range(kp * C):  # the CRT split
            pi, s = rank >> lc, rank & (C - 1)
            chunk = -(-nl // kp)
            c = np.arange(pi * chunk, min(nl, (pi + 1) * chunk))
            y = [sm[i, s, swz(c)] for i in range(kp)]
            fix = np.zeros(c.shape, dtype=np.uint64)
            over = np.zeros(c.shape, dtype=np.uint64)
            total = np.zeros(c.shape, dtype=np.uint64)
            for i in range(kp):
                nf = fix + y[i] * np.uint64(afix[i])
                over += (nf < fix).astype(np.uint64)
                fix = nf
                total = (total + y[i] * np.uint64(pmod[i])) & M32
            alpha = (over + (fix >> np.uint64(63))) & M32
            row = bj * n + (s << l) + c
            out[row] = (out[row] + total - alpha * pmt) & M32
            written[row] += 1
    assert (written == 1).all()  # every coefficient by exactly one block
    return out.reshape(acc.shape)


# (log_n, k, log_basis, level, bound_bits, batch)
SHAPES = [(15, 1, 7, 3, None, 1), (16, 1, 7, 3, 60, 1), (10, 2, 7, 3, 60, 2),
          (10, 1, 1, 20, None, 2), (4, 3, 8, 3, 60, 2)]
# (log_n, k, log_basis, level, bound_bits, batch, lc): a row over C = 4 and
# 8 slices, kp 2 (BOOLEAN_128's gadget, clusters of 8 and 16 blocks), kp 3
# with k = 2 (12 blocks), kp 4 (16 blocks) and the 2^1 x 20 gadget
SLICED = [(12, 1, 7, 3, None, 1, 2), (12, 1, 7, 3, None, 2, 3), (11, 2, 7, 3, 60, 1, 2),
          (12, 1, 7, 3, 90, 1, 2), (11, 1, 1, 20, None, 1, 3),
          # n = 2^17: BOOLEAN_128's gadget over its 3 primes, the one pick
          # pick_slices has there (C = 4: slices of 2^15 words, 12 blocks)
          (17, 1, 7, 3, None, 1, 2)]


@pytest.mark.parametrize("log_n,k,log_basis,level,bound,bsz", SHAPES)
def test_model_matches_plain(log_n, k, log_basis, level, bound, bsz):
    _check_model(log_n, k, log_basis, level, bound, bsz, None)


@pytest.mark.parametrize("log_n,k,log_basis,level,bound,bsz,lc", SLICED)
def test_model_over_slices_matches_plain(log_n, k, log_basis, level, bound, bsz, lc):
    _check_model(log_n, k, log_basis, level, bound, bsz, lc)


def _check_model(log_n, k, log_basis, level, bound, bsz, lc):
    conv = (TorusConvolver32(log_n, bound) if bound
            else tfhe.make_convolver(log_n, level, k, log_basis))
    n, kp = 1 << log_n, conv.count
    rng = np.random.default_rng(log_n * 10 + level)
    q = np.array(conv.primes, dtype=np.uint64).reshape(-1, 1, 1, 1)
    f = rng.integers(0, 1 << 62, (kp, bsz * (k + 1), level, n), dtype=np.uint64) % (4 * q)
    f[:, :, :, :2] = np.concatenate([4 * q - 1, np.zeros_like(q)], axis=-1)
    key = rng.integers(0, 1 << 62, (kp, k + 1, level, k + 1, n), dtype=np.uint64) % q[..., None]
    key[..., :1] = q[..., None] - 1
    acc = rng.integers(0, 1 << 32, (bsz, k + 1, n), dtype=np.uint64)
    want = cmux_fused.cmux_stage2_plain(conv, *(torch.from_numpy(x.astype(np.int64))
                                                for x in (f, key, acc)))
    np.testing.assert_array_equal(model_stage2(conv, f, key, acc, lc).astype(np.int64),
                                  want.numpy())


def test_mac_runs_stay_below_2_64():
    """16 products of canonical 30-bit residues and a remainder below 2p
    sum below 2^64 (so any L sums exactly); 17 may not."""
    p = (1 << 30) - 1
    assert 16 * (p - 1) ** 2 + 2 * p < 1 << 64 < 17 * (p - 1) ** 2
