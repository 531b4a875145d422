"""Port vs reference: the byte-radix (MXU) family of the TFHE path.

- ``four_step_matrices`` and the kept ``CmuxMxuPlan`` tables equal the JAX
  package's at log_n=8 (30-bit primes), log_n=11 (BOOLEAN_128's primes) and
  log_n=10 (NTRU_128's q = 1038337);
- a numpy model of the CUDA kernels' data flow (``csrc/cmux_mxu.cu``: the
  kernel-layout plane matrices, u8/s8 operand bytes, the same indexing;
  kernel C in ``csrc/ntt32.cu``: ``test_torch_keyprep_model.model_c``)
  equals the plain versions, so the tables the card reads are right before
  any card runs them;
- kernel C's plain version equals JAX ``mxu8_fused_forward64`` (``.lo``),
  ``prepare_mxu_bsk`` equals JAX (values and precons), and
  ``mxu_cmux_step`` equals JAX ``mxu_cmux_step_nat`` at batch 4 and 1
  (JAX's batch 1 is padded to 2 and cut: ``[:1]``) with degrees 0, 1, N,
  2N-1 (Pallas in interpret mode);
- a TFHE gate on a JAX ``bsk_kind="mxu"`` context through
  ``from_jax_context`` equals the JAX gate.

Tolerance: zero (bit-equal words) throughout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu import params as jparams
from primus_fhe_tpu.boot import gates as jgates
from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.numeric.limb import U64
from primus_fhe_tpu.ops import cmux_mxu as jcm
from primus_fhe_tpu.ops import mxu_common as jmc
from primus_fhe_tpu.ops.ntt_mxu8 import Mxu8NttPlan64, mxu8_fused_forward64
from primus_fhe_tpu.utils.primes import next_ntt_prime
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot import gates
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_mxu, mxu_common, ntt_mxu8
from primus_fhe_tpu_torch.ops.ntru_cmux_mxu import get_ntru_plan, ntru_cmux_step_plain
from test_torch_keyprep_model import model_c

LOG_N = 8
N = 1 << LOG_N
K1, LB, LV = 2, 8, 2  # k=1, 2^8 x 2 gadget (the JAX MXU tests' shape)
Q_NTRU = 1038337


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def setup():
    basis = ApproxSignedBasis32(None, LB, reverse_length=LV)
    conv = tfhe.make_convolver(LOG_N, LV, K1 - 1, LB)
    jbasis = JaxBasis(None, LB, reverse_length=LV)
    jconv = jtfhe.make_convolver(LOG_N, LV, K1 - 1, LB)
    assert conv.primes == list(jconv.primes)
    return basis, conv, jbasis, jconv


def _primes_boolean():
    return tuple(tfhe.make_convolver(11, 3, 1, 7).primes)


@pytest.mark.parametrize("log_n,which", [(8, "p30"), (11, "boolean"), (10, "ntru")])
def test_four_step_matrices_match_reference(log_n, which):
    primes = {"p30": (next_ntt_prime(30, 8),), "boolean": _primes_boolean(),
              "ntru": (Q_NTRU,)}[which]
    for p in primes:
        h1 = log_n - 7
        got = mxu_common.four_step_matrices(log_n, p, h1, h1)
        want = jmc.four_step_matrices(log_n, p, h1, h1)
        assert got.keys() == want.keys()
        for key, val in want.items():
            if isinstance(val, int):
                assert got[key] == val, key
            else:
                np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("log_n,which", [(8, "p30"), (11, "boolean"), (10, "ntru")])
def test_plan_tables_match_reference(log_n, which):
    if which == "ntru":
        got, want = get_ntru_plan(log_n, Q_NTRU), jcm.CmuxMxuPlan(log_n, (Q_NTRU,))
        want.fold_inverse_scale(Q_NTRU)
    else:
        primes = (next_ntt_prime(30, 8), next_ntt_prime(30, 8, next_ntt_prime(30, 8))) \
            if which == "p30" else _primes_boolean()
        product = int(np.prod([int(p) for p in primes], dtype=object))
        got = cmux_mxu.get_plan(log_n, primes, product)
        want = jcm.get_plan(log_n, primes, product)
        assert got.crt_consts(product) == want.crt_consts(product)
    assert (got.A, got.B, got.primes) == (want.A, want.B, want.primes)
    for mine, ref in zip(got.per_prime, want.per_prime):
        for key in ("w1d", "w2f", "w1mf", "w2m", "t", "tp", "ti", "tip"):
            np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)


# -- a numpy model of the CUDA kernels ---------------------------------------


def _planes(a_bytes, w, np_, n_real, q):
    """``mm_planes`` + ``reduce_planes`` of csrc/mxu8.cuh: operand bytes
    ``(m, kb)`` against the kernel-layout matrix ``(4 * np_, kb)``."""
    d = a_bytes.astype(np.int64) @ w.astype(np.int64).T  # (m, 4 * np_)
    d = d.reshape(-1, 4, np_)[:, :, :n_real]
    return (d * (1 << (8 * np.arange(4)))[None, :, None]).sum(1) % q


def _bytes(words, kb):
    """u32 words ``(m, k)`` -> their little-endian bytes ``(m, kb)``."""
    b = np.ascontiguousarray(words.astype(np.uint32)).view(np.uint8).reshape(words.shape[0], -1)
    out = np.zeros((b.shape[0], kb), dtype=np.uint8)
    out[:, : b.shape[1]] = b
    return out


def _model_forward(plan, tabs, pi, digits, q, dp=1):
    """Forward four-step of kernel A/B's digit polys (``digits (R, n)``
    signed, ``dp`` bytes a digit): NTT values ``(R, n)`` in natural
    order."""
    A, B = plan.A, plan.B
    R = digits.shape[0]
    x = digits.reshape(R, A, B).transpose(0, 2, 1)  # [(row, k0)][k1]
    w1 = tabs[f"w1_{dp}"][pi]
    s0 = x.astype(np.int8)
    planes = [s0, ((x - s0.astype(np.int64)) >> 8).astype(np.int8)][:dp]
    op = np.zeros((R * B, w1.shape[1]), dtype=np.int8)
    op[:, : A * dp] = np.stack(planes, -1).reshape(R * B, A * dp)
    np1 = w1.shape[0] // 4
    X = _planes(op, w1, np1, A, q).reshape(R, B, A).transpose(0, 2, 1)  # [row][r0][k0]
    tw, twp = tabs["tw"][pi][0].reshape(A, B), tabs["tw"][pi][1].reshape(A, B)
    Y = (X * tw - q * ((X * twp) >> 32)) & 0xFFFFFFFF  # lazy Shoup, [0, 2q)
    w2 = tabs["w2"][pi]
    return _planes(_bytes(Y.reshape(R * A, B), 4 * B), w2, B, B, q).reshape(R, plan.n)


def _model_inverse(plan, tabs, pi, vals, q):
    """Inverse four-step of kernels A/B: canonical ``vals (R, n)`` ->
    canonical ``(R, n)``, the folded scale included."""
    A, B = plan.A, plan.B
    R = vals.shape[0]
    Z = _planes(_bytes(vals.reshape(R * A, B), 4 * B), tabs["wi1"][pi], B, B, q).reshape(R, A, B)
    twi, twip = tabs["tw"][pi][2].reshape(A, B), tabs["tw"][pi][3].reshape(A, B)
    Zt = ((Z * twi - q * ((Z * twip) >> 32)) & 0xFFFFFFFF).transpose(0, 2, 1)  # [(j, k0)][r0]
    wi2 = tabs["wi2"][pi]
    y = _planes(_bytes(Zt.reshape(R * B, A), wi2.shape[1]), wi2, wi2.shape[0] // 4, A, q)
    return y.reshape(R, B, A).transpose(0, 2, 1).reshape(R, plan.n)


@pytest.mark.parametrize("log_n", [8, 10])
def test_kernel_model_forward_matches_plain(setup, log_n):
    """Kernel C's data flow (``model_c``: persistent tiles on kernel 1's
    passes) equals its plain version, and kernels A/B's inverse four-step
    on the kernel tables takes its words back."""
    conv = tfhe.make_convolver(log_n, LV, 1, LB)
    plan = cmux_mxu.plan_for(conv)
    tabs = {k: v.numpy().astype(np.int64) if v.dtype != torch.int8 else v.numpy()
            for k, v in plan.kernel_tables("cpu").items()}
    tabs["tw"] = tabs["tw"] & 0xFFFFFFFF
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, p, (3, plan.n), dtype=np.int64) for p in conv.primes])
    want = ntt_mxu8.mxu8_forward32_plain(plan, _t(x)).reshape(x.shape).numpy()
    fwd = model_c(plan, x.astype(np.uint64)).astype(np.int64)
    np.testing.assert_array_equal(fwd, want)
    for pi, p in enumerate(conv.primes):
        rows, got = x[pi], fwd[pi]
        back = _model_inverse(plan, tabs, pi, got, p)  # inverse carries (P/p)^-1
        c = pow((conv.product // p) % p, -1, p)
        np.testing.assert_array_equal(back, rows * c % p)


@pytest.mark.parametrize("log_n,log_basis,level,k", [(8, 8, 2, 1), (11, 7, 3, 1), (8, 10, 2, 2)])
def test_kernel_model_cmux_matches_plain(log_n, log_basis, level, k):
    """Kernel A's data flow (digits, 4 passes, MAC, CRT, add) equals the
    plain step, for 1- and 2-byte digits."""
    n = 1 << log_n
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    conv = tfhe.make_convolver(log_n, level, k, log_basis)
    plan = cmux_mxu.plan_for(conv)
    dp = cmux_mxu.digit_planes(basis)
    tabs = {kk: v.numpy().astype(np.int64) if v.dtype != torch.int8 else v.numpy()
            for kk, v in plan.kernel_tables("cpu").items()}
    tabs["tw"] = tabs["tw"] & 0xFFFFFFFF
    rng = np.random.default_rng(log_n + log_basis)
    bsz, k1 = 2, k + 1
    acc = rng.integers(0, 1 << 32, (bsz, k1, n), dtype=np.int64)
    degrees = np.array([3, 2 * n - 1])
    ggsw = torch.from_numpy(rng.integers(0, 1 << 32, (1, k1, level, k1, n), dtype=np.int64))
    kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, ggsw)
    want = cmux_mxu.mxu_cmux_step(plan, basis, conv, _t(acc), torch.tensor(degrees), kv[0], kpre[0])
    kvn = kv[0].reshape(len(conv.primes), k1, level, k1, n).numpy()
    out = np.empty_like(acc)
    for b in range(bsz):
        idx = (np.arange(n) - degrees[b]) % (2 * n)
        rotated = np.where(idx >= n, (-acc[b][:, idx % n]) & 0xFFFFFFFF, acc[b][:, idx % n])
        diff = (rotated - acc[b]) & 0xFFFFFFFF
        digits = basis.decompose(_t(diff)).numpy()  # (L, k1, n)
        digits = digits.transpose(1, 0, 2).reshape(k1 * level, n)
        digits = np.where(digits >= 1 << 31, digits - (1 << 32), digits)  # as int32
        ys = []
        for pi, p in enumerate(conv.primes):
            F = _model_forward(plan, tabs, pi, digits, p, dp=dp)
            F = F.reshape(k1, level, n)
            mac = np.stack([sum(F[r, l] * kvn[pi, r, l, j] % p for r in range(k1)
                                for l in range(level)) % p for j in range(k1)])
            ys.append(_model_inverse(plan, tabs, pi, mac, p))
        y = np.stack(ys).astype(object)
        total = sum(y[i] * (conv.product // p) for i, p in enumerate(conv.primes))
        v = np.array([[int(t) % conv.product for t in row] for row in total], dtype=object)
        v = np.where(v > conv.product // 2, v - conv.product, v)
        out[b] = ((acc[b].astype(object) + v) % (1 << 32)).astype(np.int64)
    np.testing.assert_array_equal(out, want.numpy())


# -- plain versions vs JAX ----------------------------------------------------


def test_mxu8_forward_plain_matches_jax(setup):
    _, conv, _, _ = setup
    plan = cmux_mxu.plan_for(conv)
    rng = np.random.default_rng(5)
    vals = np.stack([rng.integers(0, p, (3, N), dtype=np.int64) for p in conv.primes])
    got = ntt_mxu8.mxu8_forward32(plan, _t(vals))
    for i, p in enumerate(conv.primes):
        mplan = Mxu8NttPlan64(LOG_N, p, h1=LOG_N - 7)
        v = jnp.asarray(vals[i].astype(np.uint32))
        want = np.asarray(mxu8_fused_forward64(mplan, U64(v, jnp.zeros_like(v)), 1).lo)
        np.testing.assert_array_equal(got[i].reshape(3, N).numpy(), want.astype(np.int64))


def test_prepare_mxu_bsk_matches_jax(setup):
    _, conv, _, jconv = setup
    rng = np.random.default_rng(6)
    ggsw = rng.integers(0, 1 << 32, (2, K1, LV, K1, N), dtype=np.uint64).astype(np.uint32)
    kv, kpre = cmux_mxu.prepare_mxu_bsk(conv, _t(ggsw))
    jkv, jkpre = jcm.prepare_mxu_bsk(jconv, jnp.asarray(ggsw))
    assert kv.is_contiguous() and kpre.is_contiguous()
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv).astype(np.int64))
    np.testing.assert_array_equal(kpre.numpy(), np.asarray(jkpre).astype(np.int64))


@pytest.mark.parametrize("bsz", [4, 1])
def test_mxu_cmux_step_matches_jax(setup, bsz):
    basis, conv, jbasis, jconv = setup
    rng = np.random.default_rng(10 + bsz)
    acc = rng.integers(0, 1 << 32, (bsz, K1, N), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([0, 1, N, 2 * N - 1][:bsz] if bsz > 1 else [N - 3], dtype=np.int32)
    ggsw = rng.integers(0, 1 << 32, (1, K1, LV, K1, N), dtype=np.int64)
    # the key pack of both sides: prepare_mxu_bsk equals JAX's (tested above)
    kv, kpre = (x[0] for x in cmux_mxu.prepare_mxu_bsk(conv, _t(ggsw)))
    jplan = jcm.get_plan(LOG_N, tuple(jconv.primes), jconv.product)
    want = jcm.mxu_cmux_step_nat(
        jplan, jbasis, jplan.crt_consts(jconv.product),
        jnp.asarray(acc).reshape(bsz, K1, jplan.A, jplan.B), jnp.asarray(degrees),
        jnp.asarray(kv.numpy().astype(np.uint32)), jnp.asarray(kpre.numpy().astype(np.uint32)),
        K1, LV,
    )
    want = np.asarray(want).reshape(bsz, K1, N).astype(np.int64)
    plan = cmux_mxu.plan_for(conv)
    got = cmux_mxu.mxu_cmux_step(plan, basis, conv, _t(acc), torch.from_numpy(degrees), kv, kpre)
    np.testing.assert_array_equal(got.numpy(), want)
    got32 = cmux_mxu.mxu_cmux_step(plan, basis, conv, _t(acc).to(torch.int32),
                                   torch.from_numpy(degrees), kv, kpre)
    assert got32.dtype == torch.int32
    np.testing.assert_array_equal((got32.to(torch.int64) & 0xFFFFFFFF).numpy(), want)


def test_tfhe_gate_on_jax_mxu_context():
    """A JAX ``bsk_kind="mxu"`` context carried into the port: the port's
    MXU-route NAND equals the JAX NAND (its NTT route on the same GGSW
    material and key-switch key, bit-equal to its MXU route)."""
    p = dataclasses.replace(jparams.TOY, log_n=8, lwe_dim=6)
    key = jax.random.PRNGKey(4)
    jmxu = jparams.make_context(key, p, bsk_kind="mxu")
    jntt = jparams.make_context(key, p, bsk_kind="ntt")
    ctx = P.from_jax_context(p, tuple(np.asarray(x) for x in jmxu.bsk), np.asarray(jmxu.ksk),
                             np.asarray(jmxu.lwe_secret), np.asarray(jmxu.glwe_secret),
                             device="cpu")
    assert isinstance(ctx.bsk, tuple) and ctx.bsk[0].shape == tuple(jmxu.bsk[0].shape)
    rng = np.random.default_rng(8)
    s = np.asarray(jmxu.lwe_secret).astype(np.int64)

    def enc(bits):
        a = rng.integers(0, 1 << 32, (len(bits), p.lwe_dim), dtype=np.int64)
        mu = np.where(np.asarray(bits) == 1, jgates.TRUE_MU, jgates.FALSE_MU)
        return ((np.concatenate([a, (a @ s + mu)[:, None]], 1)) & 0xFFFFFFFF).astype(np.uint32)

    c1, c2 = enc([0, 0, 1, 1]), enc([0, 1, 0, 1])
    want = np.asarray(jgates.nand_gate(jntt.conv, jntt.basis, jntt.bsk, jntt.ksk, jntt.ks_basis,
                                       jnp.asarray(c1), jnp.asarray(c2), p.log_n))
    got = gates.nand_gate(ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, _t(c1), _t(c2),
                          p.log_n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert ctx.decrypt(got).tolist() == [True, True, True, False]


def test_make_context_mxu_matches_ntt_route():
    """``make_context(..., bsk_kind="mxu")`` holds the GGSW material of the
    ``"ntt"`` context made from the same seed: bootstraps agree word for
    word; ``"auto"`` is ``"ntt"``; ``"mxu"`` refuses log_n < 8."""
    from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap

    p = dataclasses.replace(P.TOY, log_n=8, lwe_dim=5)
    mxu = P.make_context(p, "cpu", torch.Generator().manual_seed(3), bsk_kind="mxu")
    ntt = P.make_context(p, "cpu", torch.Generator().manual_seed(3), bsk_kind="ntt")
    auto = P.make_context(p, "cpu", torch.Generator().manual_seed(3))
    assert isinstance(mxu.bsk, tuple) and torch.equal(auto.bsk, ntt.bsk)
    assert torch.equal(mxu.ksk, ntt.ksk)
    cts = ntt.encrypt(torch.tensor([0, 1, 1]), torch.Generator().manual_seed(4))
    tp = torch.full((p.n,), gates.TRUE_MU, dtype=torch.int64)
    a = bootstrap(ntt.conv, ntt.basis, ntt.bsk, cts, tp, p.log_n)
    b = bootstrap(mxu.conv, mxu.basis, mxu.bsk, cts, tp, p.log_n)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        P.make_context(P.TOY, "cpu", torch.Generator().manual_seed(3), bsk_kind="mxu")


def test_ntru_plan_kernel_model_step_matches_plain():
    """Kernel B's data flow (mod-q digits, MAC, inverse, rotation) on the
    kernel tables equals the plain step, at NTRU_128's q and gadget."""
    log_n, n = 10, 1 << 10
    plan = get_ntru_plan(log_n, Q_NTRU)
    basis = ApproxSignedBasis32(Q_NTRU, 3, 6)
    tabs = {k: v.numpy().astype(np.int64) if v.dtype != torch.int8 else v.numpy()
            for k, v in plan.kernel_tables("cpu").items()}
    tabs["tw"] = tabs["tw"] & 0xFFFFFFFF
    rng = np.random.default_rng(12)
    acc = rng.integers(0, Q_NTRU, (2, n), dtype=np.int64)
    degrees = np.array([1, 2 * n - 5])
    kv = ntt_mxu8.mxu8_forward32_plain(plan, _t(rng.integers(0, Q_NTRU, (1, 6, n))))[0].numpy()
    want = ntru_cmux_step_plain(plan, basis, _t(acc), torch.from_numpy(degrees), _t(kv))
    q = Q_NTRU
    for b in range(2):
        d = basis.decompose(_t(acc[b])).numpy()  # (L, n) canonical mod q
        signed = np.where(d > basis.basis_minus_one, d - q, d)
        F = _model_forward(plan, tabs, 0, signed, q, dp=1)
        mac = sum(F[l] * kv[l].reshape(n) % q for l in range(6)) % q
        delta = _model_inverse(plan, tabs, 0, mac[None], q)[0]
        idx = (np.arange(n) - degrees[b]) % (2 * n)
        src = delta[idx % n]
        rot = np.where((idx >= n) & (src != 0), q - src, src)
        got = (acc[b] + rot - delta) % q
        np.testing.assert_array_equal(got, want[b].numpy())
