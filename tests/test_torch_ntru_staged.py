"""The NTRU staged step (kernels I and J, ``ops/ntru_cmux_mxu.py``,
``csrc/ntru_stage.cu``) on the CPU.

- ``ntru_step_route``: kernel B wherever its C entry takes the shape
  (NTRU_128; the entry's answers from a fake library), the staged route
  past it (log_n 13-16, a plan past 227 KB), a ``ValueError`` past both
  (log_n 18, L = 33, 3 digit planes);
- kernel I's plain version then kernel 1's, then kernel J's (the staged
  functions on CPU tensors, and ``NtruStepPlan`` on the CPU) equal JAX
  ``ntru_cmux_step_nat`` (Pallas in interpret mode) at log_n 8-10, for the
  NGS gadget mod a 20-bit q and 2-byte digits mod a 30-bit q;
- a short rotation on JAX-made keys (``from_jax_ntru_context``) step by
  step through the staged functions equals the JAX rotation;
- a numpy model of kernel J's schedule (the host pack at the C entry's
  offsets, the grid of ciphertexts and slices, a row over C = 1, 2 (as the
  first design picked them) and 4, 8 (as ``pick_slices`` picks them at a
  small batch) slices, the MAC's 16-byte groups, flat indices and reduction
  runs (``slice_mac``), the swizzled slice, the inverse passes and the last
  lc stages across the slices (``cross_inverse``), the rotation's sources
  read from whichever slice holds them, every output word written once)
  equals ``ntru_stage2_plain``; with its digit output over ``f`` at C = 1,
  4, 8, 16 (each word of ``f`` read by one block alone and rewritten once
  by it after its MAC) the digits equal ``ntru_digits_plain`` of the
  output; and a model of kernel I's 16-byte groups equals
  ``ntru_digits_plain``.

Tolerance: zero (bit-equal words).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu import params as jparams
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.ops import ntru_cmux_mxu as jncm
from primus_fhe_tpu.utils.primes import next_ntt_prime
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nb
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.ops import ntru_cmux_mxu as nm
from primus_fhe_tpu_torch.ops.ntt32 import NttTables32
from test_torch_cmux_stage2_model import (cross_inverse, inverse_slice, reduce_once,
                                          remainder_stages, slice_mac, swz)
from test_torch_mxu_staged import fake_card  # noqa: F401  (a fixture)

jnb = importlib.import_module("primus_fhe_tpu.boot.ntru_blind_rotate")

SLICE_MAX_LOG = 15  # J_SLICE_MAX_LOG


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("level,log_n,dp,rc,want", [
    (6, 10, 1, 0, "mxu"),  # NTRU_128
    (3, 12, 1, 0, "mxu"),  # 188,480 bytes a block
    (6, 12, 1, 1, "staged"),  # 6 rows of 4096 words: a plan past 227 KB
    (16, 10, 1, 0, "mxu"), (20, 10, 1, 1, "staged"),  # 221,216 and 262,176 bytes a block
    (6, 13, 1, None, "staged"), (6, 14, 1, None, "staged"), (6, 15, 2, None, "staged"),
    (32, 16, 1, None, "staged"), (6, 17, 1, None, "staged"),  # NTRU_128's gadget at 2^17
])
def test_route(fake_card, level, log_n, dp, rc, want):
    """Kernel B's answers (``rc``: 0 holds, 1 refused) come from a fake
    library here and from the card in ``chip_smoke.py`` phase 22.1; at
    log_n 13-26 the card is not asked."""
    lib = fake_card(2 if rc is None else rc)
    assert nm.ntru_step_route(level, log_n, dp) == want
    assert lib.asked == ([] if rc is None else [(1, 1, 1, log_n, dp, level, 1)])


@pytest.mark.parametrize("level,log_n,dp,match", [
    (6, 27, 1, "log_n"), (33, 13, 1, "L = 33"), (6, 13, 3, "digit planes"), (6, 7, 1, "log_n"),
])
def test_route_refuses(level, log_n, dp, match):
    with pytest.raises(ValueError, match=match):
        nm.ntru_step_route(level, log_n, dp)


def test_route_refuses_a_basis_past_2_15():
    with pytest.raises(ValueError, match="2\\^15"):
        nm.NtruStepPlan(nb.NtruContext(13, next_ntt_prime(30, 13), 16, 1), "cpu")


# (log_n, q_bits, log_basis, level, batch)
JAX_SHAPES = [(8, 20, 3, 6, 4), (9, 20, 3, 6, 1), (10, 30, 10, 3, 2)]


@pytest.mark.parametrize("log_n,q_bits,log_basis,level,bsz", JAX_SHAPES)
def test_staged_step_matches_jax(log_n, q_bits, log_basis, level, bsz):
    n = 1 << log_n
    q = next_ntt_prime(q_bits, log_n)
    jctx = jnb.NtruContext(log_n, q, log_basis, level)
    ctx = nb.NtruContext(log_n, q, log_basis, level)
    rng = np.random.default_rng(log_n * 100 + q_bits + bsz)
    acc = rng.integers(0, q, (bsz, n), dtype=np.int64)
    acc[0, :3] = [0, q - 1, q // 2]
    degrees = np.array([0, 1, n, 2 * n - 1][:bsz] if bsz > 1 else [n + 5], dtype=np.int32)
    evk_coeff = rng.integers(0, q, (1, level, n), dtype=np.int64)
    jkv, jkpre = (x[0] for x in jncm.prepare_mxu_evk(jctx, jnp.asarray(evk_coeff, jnp.uint32)))
    want = jncm.ntru_cmux_step_nat(jncm.get_ntru_plan(log_n, q), jctx.basis,
                                   jnp.asarray(acc.reshape(bsz, -1, 128), jnp.uint32),
                                   jnp.asarray(degrees), jkv, jkpre, level)
    want = _np(want).reshape(bsz, n)
    kv = _t(jkv)
    f = nm.ntru_stage1(ctx.ntt, ctx.basis, _t(acc))
    assert f.shape == (level, bsz, n) and int(f.max()) < 4 * q
    got = nm.ntru_stage2(ctx.ntt, f, kv.reshape(level, n), _t(acc), torch.from_numpy(degrees))
    np.testing.assert_array_equal(got.numpy(), want)
    step = nm.NtruStepPlan(ctx, "cpu")
    got32 = step(_t(acc).to(torch.int32), torch.from_numpy(degrees), kv.to(torch.int32), None)
    np.testing.assert_array_equal((got32.to(torch.int64) & 0xFFFFFFFF).numpy(), want)


def test_staged_rotation_on_jax_keys():
    """A rotation of 4 key slices at N = 256 on JAX-made keys, step by step
    through kernel I's, kernel 1's and kernel J's plain versions, equals
    the JAX rotation on the NTT evk."""
    params = dataclasses.replace(jparams.NTRU_128, log_n=8, lwe_dim=4, lwe_sigma=4.0)
    n, q = params.n, params.q
    jctx, jks = jparams.make_ntru_context(params)
    kk = jax.random.split(jax.random.PRNGKey(24), 4)
    sk = jnb.ntru_keygen(kk[0], jctx)
    s = (jax.random.bits(kk[1], (params.lwe_dim,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    gauss = JaxGaussian(params.sigma)
    evk = jnb.make_ntru_bootstrap_key(kk[2], jctx, sk, s, gauss)
    evk_mxu = jnb.make_ntru_bootstrap_key_mxu(kk[2], jctx, sk, s, gauss)
    ksk = jnb.make_ntru_keyswitch_key(kk[3], jctx, sk, s, jks, JaxGaussian(params.lwe_sigma))
    keys = P.from_jax_ntru_context(params, np.asarray(sk.f), tuple(np.asarray(x) for x in evk_mxu),
                                   np.asarray(ksk), np.asarray(s), device="cpu")
    lwe = np.random.default_rng(12).integers(0, 2 * n, (3, params.lwe_dim + 1)).astype(np.int32)
    want = _np(jnb.ntru_blind_rotate(jctx, evk, jnp.asarray(lwe), jnb.ntru_test_polynomial(
        n, q, jctx.delta)))
    ctx = keys.ctx
    sw = torch.from_numpy(lwe).to(torch.int64)
    acc = nb.poly_rotate32(nb.ntru_test_polynomial(n, q, ctx.delta).expand(3, n),
                           -sw[:, params.lwe_dim], q)
    vals = keys.evk_mxu[0]
    for i in range(params.lwe_dim):
        f = nm.ntru_stage1(ctx.ntt, ctx.basis, acc)
        acc = nm.ntru_stage2(ctx.ntt, f, vals[i].reshape(params.level, n), acc, sw[:, i])
    np.testing.assert_array_equal(acc.numpy(), want)
    got = nb.ntru_blind_rotate(ctx, keys.evk_mxu, torch.from_numpy(lwe), nb.ntru_test_polynomial(
        n, q, ctx.delta))
    np.testing.assert_array_equal(got.numpy(), want)


# -- numpy models of kernels I and J -----------------------------------------


def chain_digits(pack, v):
    """The digit chain (``chain_start``, then ``digit_step`` a level) on
    canonical uint64 words ``v``, from the basis pack's words: ``(L,
    words)``."""
    level, lb, drop, bm1, cmask, mmb, init = (int(x) for x in pack[:7])
    wrap, adj = int(pack[7]), int(pack[8])
    if wrap:
        v = np.where(v >= wrap, (v + adj) & np.uint64(0xFFFFFFFF), v)
    carry = ((v & np.uint64(init)) != 0).astype(np.uint64)
    out = np.zeros((level,) + v.shape, dtype=np.uint64)
    for lv in range(level):
        temp = ((v >> np.uint64(drop + lv * lb)) & np.uint64(bm1)) + carry
        nxt = ((temp & np.uint64(cmask)) != 0).astype(np.uint64)
        sgn = np.where(temp > bm1, np.uint64(0), (temp + np.uint64(mmb)) & np.uint64(0xFFFFFFFF))
        carry = nxt
        out[lv] = np.where(nxt == 1, sgn, temp)
    return out


def model_digits(basis, acc):
    """Kernel I on flat uint64 words: each thread's group of 4 adjacent
    words, the chain, level l's 4 digits stored at group it + l (words / 4)
    of the output."""
    pack = nm._basis_pack(basis)
    level = int(pack[0])
    words = acc.reshape(-1).astype(np.uint64)
    groups = words.size // 4
    out = np.zeros((level, words.size), dtype=np.uint64)
    written = np.zeros(level * words.size, dtype=np.int64)
    for it in range(groups):
        d = chain_digits(pack, words[4 * it:4 * it + 4])
        for lv in range(level):
            o = (it + lv * groups) * 4  # group it + l (words / 4), 16 bytes
            out.reshape(-1)[o:o + 4] = d[lv]
            written[o:o + 4] += 1
    assert (written == 1).all()
    return out.reshape((level,) + acc.shape)


def model_stage2(tables, f, evk, acc, degrees, lc=None, basis=None):
    """Kernel J on flat uint64 words: ``f (L, B, n)`` below 4q, ``evk (L,
    n)``, ``acc (B, n)``, ``degrees (B,)``, a row over 2^lc slices (by
    default the fewest a slice of 2^15 words allows); the host pack as the
    C entry reads it.  With ``basis`` the digits of each output word go
    over ``f`` (updated in place), by the thread that writes the word, and
    the model proves that each word of ``f`` is read by one block alone, in
    its MAC, and written once, by that block, after its MAC."""
    bsz, n = acc.shape
    level = evk.shape[0]
    h = nm.stage2_pack(tables, level, (11, 12), basis)
    L, log_n = int(h[0]), int(h[1])
    assert (L, tuple(h[2:4])) == (level, (11, 12))
    if basis is not None:  # the C entry's check, and the chain's pack
        assert int(h[11]) == L and int(h[20]) == int(h[4])
        chain = h[11:21]
    q, ratio = int(h[4]), int(h[4 + 6])
    pl = tables.plans[0]
    assert q == pl.q
    lc = max(0, log_n - SLICE_MAX_LOG) if lc is None else lc
    C, l = 1 << lc, log_n - lc
    assert C <= 16 and lc <= l
    nl = 1 << l
    plane = bsz << log_n
    ff, kf = f.reshape(-1), evk.reshape(-1)
    out = acc.reshape(-1).copy()
    written = np.zeros(out.shape, dtype=np.int64)
    reader = np.full(ff.shape, -1, dtype=np.int64)  # the block that read f's word
    f_written = np.zeros(ff.shape, dtype=np.int64)
    mac_done = set()
    tw = pl.inv_roots.numpy().astype(np.uint64)
    twp = pl.inv_roots_precon.numpy().astype(np.uint64)
    r0 = remainder_stages(l)
    passes = [(0, r0)] + [(s0, 3) for s0 in range(r0, l, 3)]
    for b in range(bsz):  # a cluster of C blocks
        sm = np.zeros((C, nl), dtype=np.uint64)
        for s in range(C):  # row lv: f[lv, b] and evk[lv]
            lane0 = s << l
            base = (b << log_n) + lane0
            read = (base + np.arange(L)[:, None] * plane + np.arange(nl)).reshape(-1)
            assert (reader[read] == -1).all()  # no other block read these words
            reader[read] = b * C + s
            sm[s, swz(np.arange(nl))] = slice_mac(ff, base, plane, kf, lane0, n, L, nl, q, ratio)
            mac_done.add(b * C + s)
        if lc == 0:
            inverse_slice(sm[0], l, lambda ti: (tw[ti], twp[ti]), pl, passes, True)
        else:
            for s in range(C):  # SliceInvTable
                def table(ti, s=s):
                    ls = np.frexp(((1 << l) - ti).astype(np.float64))[1]
                    jj = ti - 1 - (1 << l) + (1 << ls)
                    gi = 1 + n - (1 << (log_n - l + ls)) + (s << (ls - 1)) + jj
                    return tw[gi], twp[gi]
                inverse_slice(sm[s], l, table, pl, passes, False)
            sm = cross_inverse(sm, l, log_n, lc, tw, twp, pl)
        d = int(degrees[b]) % (2 * n)
        for s in range(C):  # the rotation: sources from any slice
            c = np.arange(nl)
            g = (s << l) + c
            e = g - d
            e = np.where(e < 0, e + 2 * n, e)
            neg = e >= n
            src = np.where(neg, e - n, e)
            r = sm[src >> l, swz(src & (nl - 1))]
            r = np.where(neg & (r != 0), np.uint64(q) - r, r)
            own = sm[s, swz(c)]
            t = np.where(r >= own, r - own, r + np.uint64(q) - own)
            row = b * n + g
            out[row] = reduce_once(out[row] + t, q)
            written[row] += 1
            if basis is not None:  # each word's digits, level lv at row + lv plane
                at = row[None, :] + np.arange(L)[:, None] * plane
                assert b * C + s in mac_done and (reader[at] == b * C + s).all()
                ff[at] = chain_digits(chain, out[row])
                f_written[at] += 1
    assert (written == 1).all()  # every word by exactly one thread of one block
    if basis is not None:
        assert (f_written == 1).all()  # f's every word, once, by the block that read it
    return out.reshape(acc.shape)


# (log_n, q_bits, log_basis, level, batch): NTRU_128's gadget at phase 22's
# ring, a row over two slices at 2^16, a 30-bit q with 2-byte digits, and
# L = 20 (a reduction inside a run)
MODEL_SHAPES = [(13, 20, 3, 6, 2), (16, 30, 10, 3, 1), (10, 30, 10, 3, 2), (9, 20, 1, 20, 2)]
# (log_n, q_bits, log_basis, level, batch, lc): NTRU_128's gadget over C =
# 4 and 8 slices (the pick at 2^13 keeps 2^10 words a slice), 2-byte digits
# mod a 30-bit q over 8, L = 20 over 4
MODEL_SLICED = [(12, 20, 3, 6, 2, 2), (12, 20, 3, 6, 1, 3), (11, 30, 10, 3, 2, 3),
                (10, 20, 1, 20, 1, 2),
                (17, 20, 3, 6, 1, 3)]  # NTRU_128's gadget at 2^17 over C = 8 (batch 16's pick)


@pytest.mark.parametrize("log_n,q_bits,log_basis,level,bsz", MODEL_SHAPES)
def test_model_j_matches_plain(log_n, q_bits, log_basis, level, bsz):
    _check_model_j(log_n, q_bits, level, bsz, None)


@pytest.mark.parametrize("log_n,q_bits,log_basis,level,bsz,lc", MODEL_SLICED)
def test_model_j_over_slices_matches_plain(log_n, q_bits, log_basis, level, bsz, lc):
    _check_model_j(log_n, q_bits, level, bsz, lc)


def _check_model_j(log_n, q_bits, level, bsz, lc):
    n = 1 << log_n
    q = next_ntt_prime(q_bits, log_n)
    tables = NttTables32(log_n, (q,))
    rng = np.random.default_rng(log_n * 7 + level)
    f = rng.integers(0, 4 * q, (level, bsz, n), dtype=np.uint64)
    f[:, :, :2] = [4 * q - 1, 0]
    evk = rng.integers(0, q, (level, n), dtype=np.uint64)
    evk[:, 0] = q - 1
    acc = rng.integers(0, q, (bsz, n), dtype=np.uint64)
    degrees = np.array([n + 3, 2 * n - 1][:bsz] if bsz > 1 else [n // 2 + 1], dtype=np.int64)
    want = nm.ntru_stage2_plain(tables, *(torch.from_numpy(x.astype(np.int64))
                                          for x in (f, evk, acc, degrees)))
    got = model_stage2(tables, f, evk, acc, degrees, lc)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())


# (log_n, q_bits, log_basis, level, batch, lc): J with its digits over f at
# C = 1, 4, 8 and 16 slices a row
MODEL_DIGITS = [(10, 20, 3, 6, 2, 0), (12, 30, 10, 3, 2, 2), (13, 20, 3, 6, 1, 3),
                (14, 20, 3, 6, 1, 4),
                (17, 20, 3, 6, 1, 4)]  # NTRU_128's gadget at 2^17 over C = 16 (batch 1's pick)


@pytest.mark.parametrize("log_n,q_bits,log_basis,level,bsz,lc", MODEL_DIGITS)
def test_model_j_digits_over_f(log_n, q_bits, log_basis, level, bsz, lc):
    """J's numpy model with the digit output written over ``f`` in place:
    every word of ``f`` read by one block alone and rewritten once by it,
    after its MAC (asserted inside the model); the accumulator equals
    ``ntru_stage2_plain``'s and the digits ``ntru_digits_plain`` of it, and
    the CPU wrapper's digits over its ``f`` are the same words."""
    n = 1 << log_n
    q = next_ntt_prime(q_bits, log_n)
    tables = NttTables32(log_n, (q,))
    basis = ApproxSignedBasis32(q, log_basis, level)
    rng = np.random.default_rng(log_n * 11 + lc)
    f = rng.integers(0, 4 * q, (level, bsz, n), dtype=np.uint64)
    evk = rng.integers(0, q, (level, n), dtype=np.uint64)
    acc = rng.integers(0, q, (bsz, n), dtype=np.uint64)
    acc[0, :2] = [q - 1, basis.wrap_threshold or 1]
    degrees = np.array([n + 3, 2 * n - 1][:bsz], dtype=np.int64)
    ins = [torch.from_numpy(x.astype(np.int64)) for x in (f, evk, acc, degrees)]
    want, want_digits = nm.ntru_stage2_plain(tables, *ins, basis)
    assert torch.equal(want_digits, nm.ntru_digits_plain(basis, want))
    ff = f.copy()
    got = model_stage2(tables, ff, evk, acc, degrees, lc, basis)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
    np.testing.assert_array_equal(ff.astype(np.int64), want_digits.numpy())
    f32 = ins[0].to(torch.int32)
    out = nm.ntru_stage2(tables, f32, ins[1], ins[2].to(torch.int32), ins[3], basis=basis)
    assert torch.equal(out.to(torch.int64), want)
    assert torch.equal(f32.to(torch.int64), want_digits)


@pytest.mark.parametrize("q_bits,log_basis,level", [(20, 3, 6), (30, 10, 3), (20, 1, 16)])
def test_model_i_matches_plain(q_bits, log_basis, level):
    q = next_ntt_prime(q_bits, 13)
    basis = ApproxSignedBasis32(q, log_basis, level)
    rng = np.random.default_rng(q_bits + level)
    acc = rng.integers(0, q, (2, 256), dtype=np.int64)
    acc[0, :4] = [0, q - 1, q // 2, basis.wrap_threshold or 1]
    want = nm.ntru_digits_plain(basis, torch.from_numpy(acc))
    got = model_digits(basis, acc)
    np.testing.assert_array_equal(got.astype(np.int64), want.numpy())
    assert int(want.max()) < q
