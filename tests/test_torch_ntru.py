"""Port vs reference: the NTRU_128 gate family at a small ring (N=256,
q = next_ntt_prime(20, 8), NTRU_128's gadgets 2^3 x 6 and 2^1 x 16, n_lwe=8).

- ``ntru_cmux_step`` (plain version on the CPU) equals JAX
  ``ntru_cmux_step_nat`` (Pallas in interpret mode) at batch 4 with degrees
  0, 1, N, 2N-1 and at batch 1 (JAX pads to 2: ``[:1]``), for the NGS
  gadget mod a 20-bit q and for 2-byte digits mod a 30-bit q;
- ``prepare_mxu_evk`` equals JAX (values and precons);
- ``poly_rotate32``, ``modulus_switch_q``, ``extract_lwe_ntru``,
  ``lwe_phase_q``, the ``lattice/ntru`` products and ``ntru_key_switch``
  equal JAX on JAX-made keys;
- a full ``ntru_blind_rotate`` on both evk forms (NTT evk, MXU evk) equals
  the JAX rotation, and NAND/AND/OR/NOT on JAX-made keys through
  ``from_jax_ntru_context`` equal the JAX gates; both forms run through
  ``NtruStepPlan``, a call a key slice;
- the port's own keys (``make_ntru_keys``) decrypt through every gate.

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
from primus_fhe_tpu.boot import ntru_gates as jng
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import ntru as jntru
from primus_fhe_tpu.ops import ntru_cmux_mxu as jncm
from primus_fhe_tpu.poly.poly import poly_rotate32 as jrotate
from primus_fhe_tpu.utils.primes import next_ntt_prime
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nb
from primus_fhe_tpu_torch.boot import ntru_gates as ng
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import ntru as pntru
from primus_fhe_tpu_torch.modular.modulus import barrett32_int
from primus_fhe_tpu_torch.ops import ntru_cmux_mxu
from primus_fhe_tpu_torch.poly import poly_rotate32

jnb = importlib.import_module("primus_fhe_tpu.boot.ntru_blind_rotate")

PARAMS = dataclasses.replace(jparams.NTRU_128, log_n=8, lwe_dim=8, lwe_sigma=4.0)
N = 1 << PARAMS.log_n
Q = PARAMS.q


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def keys():
    """JAX-made NTRU keys (NTT and MXU evk from one key) and the port's
    view of them."""
    jctx, jks = jparams.make_ntru_context(PARAMS)
    kk = jax.random.split(jax.random.PRNGKey(21), 4)
    sk = jnb.ntru_keygen(kk[0], jctx)
    s = (jax.random.bits(kk[1], (PARAMS.lwe_dim,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    gauss = JaxGaussian(PARAMS.sigma)
    evk = jnb.make_ntru_bootstrap_key(kk[2], jctx, sk, s, gauss)
    evk_mxu = jnb.make_ntru_bootstrap_key_mxu(kk[2], jctx, sk, s, gauss)
    ksk = jnb.make_ntru_keyswitch_key(kk[3], jctx, sk, s, jks, JaxGaussian(PARAMS.lwe_sigma))
    port = P.from_jax_ntru_context(PARAMS, np.asarray(sk.f), np.asarray(evk), np.asarray(ksk),
                                   np.asarray(s), device="cpu")
    port_mxu = P.from_jax_ntru_context(PARAMS, np.asarray(sk.f),
                                       tuple(np.asarray(x) for x in evk_mxu), np.asarray(ksk),
                                       np.asarray(s), device="cpu")
    return dict(jctx=jctx, jks=jks, sk=sk, s=s, evk=evk, evk_mxu=evk_mxu, ksk=ksk, port=port,
                port_mxu=port_mxu)


@pytest.mark.parametrize("q_bits,log_basis,level,bsz", [(20, 3, 6, 4), (20, 3, 6, 1),
                                                        (30, 10, 3, 4)])
def test_ntru_cmux_step_matches_jax(q_bits, log_basis, level, bsz):
    q = next_ntt_prime(q_bits, 8)
    jctx = jnb.NtruContext(8, q, log_basis, level)
    basis = ApproxSignedBasis32(q, log_basis, level)
    rng = np.random.default_rng(q_bits + bsz)
    acc = rng.integers(0, q, (bsz, N), dtype=np.int64)
    degrees = np.array([0, 1, N, 2 * N - 1][:bsz] if bsz > 1 else [N + 5], dtype=np.int32)
    evk_coeff = rng.integers(0, q, (1, level, N), dtype=np.int64)
    # the evk row of both sides: prepare_mxu_evk equals JAX's (tested below)
    kv, kpre = (x[0] for x in ntru_cmux_mxu.prepare_mxu_evk(nb.NtruContext(8, q, log_basis, level),
                                                            _t(evk_coeff)))
    jplan = jncm.get_ntru_plan(8, q)
    want = jncm.ntru_cmux_step_nat(
        jplan, jctx.basis, jnp.asarray(acc.reshape(bsz, 2, 128), jnp.uint32), jnp.asarray(degrees),
        jnp.asarray(kv.numpy(), jnp.uint32), jnp.asarray(kpre.numpy(), jnp.uint32), level)
    plan = ntru_cmux_mxu.get_ntru_plan(8, q)
    got = ntru_cmux_mxu.ntru_cmux_step(plan, basis, _t(acc), torch.from_numpy(degrees), kv, kpre)
    np.testing.assert_array_equal(got.numpy(), _np(want).reshape(bsz, N))


def test_prepare_mxu_evk_matches_jax(keys):
    coeff = np.random.default_rng(3).integers(0, Q, (3, PARAMS.level, N), dtype=np.int64)
    jv, jp = jncm.prepare_mxu_evk(keys["jctx"], jnp.asarray(coeff.astype(np.uint32)))
    v, p = ntru_cmux_mxu.prepare_mxu_evk(keys["port"].ctx, _t(coeff))
    np.testing.assert_array_equal(v.numpy(), _np(jv))
    np.testing.assert_array_equal(p.numpy(), _np(jp))


def test_ntru_primitives_match_jax(keys):
    jctx, ctx = keys["jctx"], keys["port"].ctx
    rng = np.random.default_rng(4)
    a = rng.integers(0, Q, (3, N), dtype=np.int64)
    deg = np.array([-7, 0, 2 * N - 1], dtype=np.int32)
    np.testing.assert_array_equal(
        poly_rotate32(_t(a), torch.from_numpy(deg), Q).numpy(),
        _np(jrotate(jnp.asarray(a, jnp.uint32), jnp.asarray(deg), Q)))
    x = rng.integers(0, Q, (5, 9), dtype=np.int64)
    x[0, :4] = [0, Q - 1, Q // 2, Q // 2 + 1]
    np.testing.assert_array_equal(
        nb.modulus_switch_q(_t(x), ctx, 9).numpy(),
        _np(jnb.modulus_switch_q(jnp.asarray(x, jnp.uint32), jctx, 9)))
    np.testing.assert_array_equal(nb.extract_lwe_ntru(_t(a), Q).numpy(),
                                  _np(jnb.extract_lwe_ntru(jnp.asarray(a, jnp.uint32), Q)))
    f = keys["sk"].f
    np.testing.assert_array_equal(
        nb.lwe_phase_q(_t(a), _t(f), barrett32_int(Q)).numpy(),
        _np(jnb.lwe_phase_q(jnp.asarray(a, jnp.uint32), f, jctx.m)))
    # lattice/ntru products and the secret's NTT forms
    port_sk = keys["port"].sk
    np.testing.assert_array_equal(port_sk.f_ntt.numpy(), _np(keys["sk"].f_ntt))
    np.testing.assert_array_equal(port_sk.f_inv_ntt.numpy(), _np(keys["sk"].f_inv_ntt))
    ja = jnp.asarray(a, jnp.uint32)
    np.testing.assert_array_equal(
        pntru.ntru_phase(_t(a), port_sk.f_ntt, ctx.ntt, ctx.m).numpy(),
        _np(jntru.ntru_phase(ja, keys["sk"].f_ntt, jctx.plan, jctx.m)))
    np.testing.assert_array_equal(pntru.mul_scalar(_t(a), 12345, ctx.m).numpy(),
                                  _np(jntru.mul_scalar(ja, 12345, jctx.m)))
    np.testing.assert_array_equal(pntru.from_ntt(pntru.to_ntt(_t(a), ctx.ntt), ctx.ntt).numpy(), a)


def test_ntru_key_switch_matches_jax(keys):
    jctx, port = keys["jctx"], keys["port"]
    lwe = np.random.default_rng(5).integers(0, Q, (3, N + 1), dtype=np.int64)
    want = jnb.ntru_key_switch(jctx, jnp.asarray(lwe, jnp.uint32), keys["ksk"], keys["jks"])
    got = nb.ntru_key_switch(port.ctx, _t(lwe), port.ksk, port.ks_basis)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.fixture
def step_calls(monkeypatch):
    """Counts the calls of ``NtruStepPlan`` (one a CMux step of a rotation,
    whichever evk form it runs on)."""
    calls = []
    plan_call = ntru_cmux_mxu.NtruStepPlan.__call__

    def counted(self, acc, degrees, kv, kpre):
        calls.append(tuple(kv.shape))
        return plan_call(self, acc, degrees, kv, kpre)

    monkeypatch.setattr(ntru_cmux_mxu.NtruStepPlan, "__call__", counted)
    return calls


def test_ntru_blind_rotate_both_routes_match_jax(keys, step_calls):
    """Both evk forms run one ``NtruStepPlan`` loop, a step a key slice:
    the NTT evk on its ``(L, N)`` rows, the MXU pack on its ``(L, A,
    128)`` rows."""
    jctx, port, port_mxu = keys["jctx"], keys["port"], keys["port_mxu"]
    lwe = np.random.default_rng(11).integers(0, 2 * N, (2, PARAMS.lwe_dim + 1)).astype(np.int32)
    tp = jnb.ntru_test_polynomial(N, Q, jctx.delta)
    want = _np(jnb.ntru_blind_rotate(jctx, keys["evk"], jnp.asarray(lwe), tp))
    tpt = nb.ntru_test_polynomial(N, Q, port.ctx.delta)
    got_ntt = nb.ntru_blind_rotate(port.ctx, port.evk, torch.from_numpy(lwe), tpt)
    assert step_calls == [(PARAMS.level, N)] * PARAMS.lwe_dim
    got_mxu = nb.ntru_blind_rotate(port.ctx, port_mxu.evk_mxu, torch.from_numpy(lwe), tpt)
    assert step_calls[PARAMS.lwe_dim:] == [(PARAMS.level, N // 128, 128)] * PARAMS.lwe_dim
    np.testing.assert_array_equal(got_ntt.numpy(), want)
    np.testing.assert_array_equal(got_mxu.numpy(), want)


def _jax_enc(keys, bits, seed):
    rng = np.random.default_rng(seed)
    s = np.asarray(keys["s"]).astype(np.int64)
    a = rng.integers(0, Q, (len(bits), PARAMS.lwe_dim), dtype=np.int64)
    t = (Q - 1) // 8
    mu = np.where(np.asarray(bits) == 1, t, Q - t)
    e = rng.integers(-3, 4, len(bits))
    return np.concatenate([a, ((a @ s + mu + e) % Q)[:, None]], 1)


@pytest.mark.parametrize("name", ["ntru_nand", "ntru_and", "ntru_or"])
def test_ntru_gates_match_jax(keys, name, step_calls):
    jctx, port, port_mxu = keys["jctx"], keys["port"], keys["port_mxu"]
    c1, c2 = _jax_enc(keys, [0, 0, 1, 1], 1), _jax_enc(keys, [0, 1, 0, 1], 2)
    if name == "ntru_nand":  # and NOT, composed: NAND(NOT a, NOT b) = OR(a, b)
        c1n = _np(jng.ntru_not(jctx, jnp.asarray(c1, jnp.uint32)))
        np.testing.assert_array_equal(ng.ntru_not(port.ctx, _t(c1)).numpy(), c1n)
        c1 = c1n
    want = _np(getattr(jng, name)(jctx, keys["evk"], keys["ksk"], keys["jks"],
                                  jnp.asarray(c1, jnp.uint32), jnp.asarray(c2, jnp.uint32)))
    got = getattr(ng, name)(port.ctx, port.evk, port.ksk, port.ks_basis, _t(c1), _t(c2))
    assert step_calls == [(PARAMS.level, N)] * PARAMS.lwe_dim  # through NtruStepPlan
    got_mxu = getattr(ng, name)(port.ctx, port_mxu.evk_mxu, port.ksk, port.ks_basis, _t(c1),
                                _t(c2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_mxu.numpy(), want)
    a, b = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    if name == "ntru_nand":
        a = 1 - a
    truth = {"ntru_nand": 1 - (a & b), "ntru_and": a & b, "ntru_or": a | b}[name]
    assert port.decrypt(got).int().tolist() == truth.tolist()


def test_port_ntru_keys_gates():
    """``make_ntru_keys`` on a torch generator: both evk forms hold the same
    NGS material, and the gates decrypt with the key switch included."""
    gen = torch.Generator().manual_seed(5)
    k = P.make_ntru_keys(PARAMS, "cpu", gen)
    f = k.sk.f
    assert set(((f - torch.nn.functional.one_hot(torch.tensor(0), N)) % Q).unique().tolist()) \
        <= {0, 8, Q - 8}
    ca, cb = k.encrypt([0, 0, 1, 1], gen), k.encrypt([0, 1, 0, 1], gen)
    out = ng.ntru_nand(k.ctx, k.evk, k.ksk, k.ks_basis, ca, cb)
    assert torch.equal(out, ng.ntru_nand(k.ctx, k.evk_mxu, k.ksk, k.ks_basis, ca, cb))
    assert k.decrypt(out).int().tolist() == [1, 1, 1, 0]
    assert k.decrypt(ng.ntru_not(k.ctx, out)).int().tolist() == [0, 0, 0, 1]
    err = (k.phase(out).abs() - (Q - 1) // 8).abs()
    assert int(err.max()) < (Q - 1) // 16


def test_ntru_bootstrap_keys_share_ngs_material():
    """``make_ntru_bootstrap_key`` and ``make_ntru_bootstrap_key_mxu`` from
    the same generator state hold the same NGS rows: the MXU values are
    the NTT key viewed (A, 128), the precons its exact Shoup quotients."""
    ctx = P.make_ntru_context(PARAMS)[0]
    sk = nb.ntru_keygen(torch.Generator().manual_seed(6), ctx)
    bits = torch.tensor([0, 1, 1])
    gauss = nb.DiscreteGaussian(PARAMS.sigma)
    ntt = nb.make_ntru_bootstrap_key(torch.Generator().manual_seed(7), ctx, sk, bits, gauss)
    vals, pre = nb.make_ntru_bootstrap_key_mxu(torch.Generator().manual_seed(7), ctx, sk, bits,
                                               gauss)
    assert ntt.shape == (3, PARAMS.level, N)
    assert torch.equal(vals.reshape(ntt.shape), ntt)
    assert torch.equal(pre, (vals << 32) // Q)
