"""The port's prime-q layer against the JAX package, on the cases of
``tests/test_lattice_extra.py`` (q = 536813569, N = 32): LWE helpers
(``lattice/lwe.py``), the 32-bit NTT helpers (``transforms/ntt.py``), RLWE
phase and extraction (``lattice/rlwe.py``), GLev / GGSW phases
(``lattice/glev.py``), the coefficient-domain polynomial ops
(``poly/poly.py``, u32 and u64 words) and the host copy of
``distr/stats.py``.

Deterministic functions equal the JAX's word for word on the same inputs
(tolerance: zero); the port's one-prime ``NttTables32`` give the same
NTT-domain words as the JAX's ``NttPlan32``, so a JAX-made ``secret_ntt``
serves the port.  Functions that draw randomness (``torch.Generator``) are
checked by decryption: every phase within the sampler's bound.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.distr import stats as jstats
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import glev as jglev
from primus_fhe_tpu.lattice import lwe as jlwe
from primus_fhe_tpu.lattice import rlwe as jrlwe
from primus_fhe_tpu.modular import barrett32 as jbarrett32
from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
from primus_fhe_tpu.poly import poly as jpoly
from primus_fhe_tpu.transforms import ntt as jntt
from primus_fhe_tpu.transforms.plan import build_plan32 as jbuild_plan32
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.distr import stats
from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian
from primus_fhe_tpu_torch.lattice import glev, lwe, rlwe
from primus_fhe_tpu_torch.modular.modulus import barrett32
from primus_fhe_tpu_torch.ops import ntt32
from primus_fhe_tpu_torch.poly import poly
from primus_fhe_tpu_torch.transforms import ntt
from primus_fhe_tpu_torch.transforms.plan import build_plan32

Q = 536813569
LOG_N = 5
N = 1 << LOG_N
Q64 = 1125899906826241
BOUND = int(np.ceil(3.2 * 10)) + 1  # the CDT sampler's largest |e| at sigma 3.2
rng = random.Random(31415)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _q_dist(x, y):
    d = (np.asarray(x).astype(np.int64) - np.asarray(y).astype(np.int64)) % Q
    return np.minimum(d, Q - d)


def _words(shape, bound=Q):
    return np.array([rng.randrange(bound) for _ in range(int(np.prod(shape)))],
                    dtype=np.uint64).reshape(shape)


@pytest.fixture(scope="module")
def q_ctx():
    """The JAX plan and a JAX-made secret in its NTT form, and the port's
    one-prime tables."""
    plan = jbuild_plan32(LOG_N, Q)
    secret = (jax.random.bits(jax.random.PRNGKey(77), (2, N), dtype=jnp.uint32) & 1).astype(
        jnp.uint32)
    secret_ntt = jntt.forward32(plan, secret)
    return plan, jbarrett32(Q), secret, secret_ntt, ntt32.NttTables32(LOG_N, (Q,)), barrett32(Q)


@pytest.mark.parametrize("log_n,q", [(4, Q), (5, Q), (11, 1073692673)])
def test_ntt_tables_give_the_jax_plan_words(log_n, q):
    """Kernels 1-2's tables (their plain versions here) and the JAX plan:
    the same forward and inverse words, lazy inputs included."""
    n = 1 << log_n
    x = _words((3, n), 4 * q).astype(np.uint32)
    y = _words((3, n), 2 * q).astype(np.uint32)
    tables = ntt32.NttTables32(log_n, (q,))
    plan = jbuild_plan32(log_n, q)
    _eq(ntt32.forward32(tables, _t(x)[None])[0], jntt.forward32(plan, jnp.asarray(x)))
    _eq(ntt32.inverse32(tables, _t(y)[None])[0], jntt.inverse32(plan, jnp.asarray(y)))


def test_ntt32_helpers_match_jax(q_ctx):
    plan, jm, *_ = q_ctx
    pplan, m = build_plan32(LOG_N, Q), barrett32(Q)
    a, b = _words((2, N)), _words((2, N))
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    _eq(ntt.pointwise_mul32(m, _t(a), _t(b)), jntt.pointwise_mul32(jm, ja, jb))
    _eq(ntt.negacyclic_mul32(pplan, m, _t(a), _t(b)), jntt.negacyclic_mul32(plan, jm, ja, jb))
    for d in (0, 1, 5, N - 1, N, 2 * N - 1, -3):
        for neg in (False, True):
            _eq(ntt.monomial32(pplan, d, neg), jntt.monomial32(plan, jnp.int32(d), neg))
    degs = np.array([[3], [-7]])
    _eq(ntt.monomial32(pplan, _t(degs)), jntt.monomial32(plan, jnp.asarray(degs, jnp.int32)))


def test_lwe_helpers_match_jax():
    n = 16
    m, jm = barrett32(Q), jbarrett32(Q)
    x, y = _words((3, n + 1)), _words((3, n + 1))
    secret = _words((n,), 2)
    jx, jy = jnp.asarray(x.astype(np.uint32)), jnp.asarray(y.astype(np.uint32))
    js = jnp.asarray(secret.astype(np.uint32))
    _eq(lwe.a(_t(x), n), jlwe.a(jx, n))
    _eq(lwe.b(_t(x), n), jlwe.b(jx, n))
    _eq(lwe.phase32(_t(x), _t(secret), m), jlwe.phase32(jx, js, jm))
    _eq(lwe.add32(_t(x), _t(y), Q), jlwe.add32(jx, jy, jnp.uint32(Q)))
    tx = _words((3, n + 4), 1 << 32)
    ty = _words((3, n + 4), 1 << 32)
    jtx, jty = jnp.asarray(tx.astype(np.uint32)), jnp.asarray(ty.astype(np.uint32))
    _eq(lwe.add_torus(_t(tx), _t(ty)), jlwe.add_torus(jtx, jty))
    _eq(lwe.sub_torus(_t(tx), _t(ty)), jlwe.sub_torus(jtx, jty))
    # a ternary secret: -1 is the word 2^32 - 1
    tern = np.array([rng.choice([0, 1, 0xFFFFFFFF]) for _ in range(n)], dtype=np.uint64)
    jt = jnp.asarray(tern.astype(np.uint32))
    _eq(lwe.phase_torus32(_t(tx[:, : n + 1]), _t(tern)), jlwe.phase_torus32(jtx[:, : n + 1], jt))
    _eq(lwe.multi_msg_phase_torus32(_t(tx), _t(tern), 4),
        jlwe.multi_msg_phase_torus32(jtx, jt, 4))


def test_rlwe_phase_and_extraction_match_jax(q_ctx):
    plan, jm, secret, secret_ntt, tables, m = q_ctx
    msg = jnp.asarray(_words((N,), 64).astype(np.uint32))
    ct = jrlwe.encrypt32(jax.random.PRNGKey(78), msg, secret_ntt[0], JaxGaussian(3.2), plan, jm,
                         Q)
    pct, ps = _t(ct), _t(secret_ntt[0])
    qj = jnp.uint32(Q)
    _eq(rlwe.phase32(pct, ps, tables, m), jrlwe.phase32(ct, secret_ntt[0], plan, jm))
    _eq(rlwe.extract_lwe32(pct, Q), jrlwe.extract_lwe32(ct, qj))
    for index in (0, 1, 3, N // 2, N - 1):
        want = jrlwe.extract_lwe_with_index32(ct, index, qj)
        _eq(rlwe.extract_lwe_with_index32(pct, index, Q), want)
        _eq(rlwe.extract_lwe_with_index32(pct, torch.tensor(index), Q), want)
    _eq(rlwe.extract_first_few_lwe32(pct, 4, Q), jrlwe.extract_first_few_lwe32(ct, 4, qj))
    _eq(rlwe.mul_ntt_polynomial32(pct, _t(secret_ntt[1]), tables, m),
        jrlwe.mul_ntt_polynomial32(ct, secret_ntt[1], plan, jm))
    cts = _words((3, 2, N))
    jcts = jnp.asarray(cts.astype(np.uint32))
    idx = [1, 5, N - 2]
    batched = rlwe.extract_lwe_with_index32(_t(cts), torch.tensor(idx), Q)
    for r, index in enumerate(idx):
        _eq(batched[r], jrlwe.extract_lwe_with_index32(jcts[r], index, qj))
    # the extracted sample decrypts to the coefficient (the JAX test's check)
    p3 = lwe.phase32(rlwe.extract_lwe_with_index32(pct, 3, Q), _t(secret[0]), m)
    assert _q_dist(p3, msg[3]) < BOUND


def test_rlwe_own_encryption_decrypts(q_ctx):
    _, _, secret, secret_ntt, tables, m = q_ctx
    gen = torch.Generator().manual_seed(5)
    msg = _t(_words((N,), 64))
    ct = rlwe.encrypt32(msg, _t(secret_ntt[0]), DiscreteGaussian(3.2), tables, m, Q, gen)
    assert ct.shape == (2, N) and int(ct.max()) < Q
    assert _q_dist(rlwe.phase32(ct, _t(secret_ntt[0]), tables, m), msg).max() < BOUND
    zero = rlwe.generate_random_zero_sample32(_t(secret_ntt[0]), DiscreteGaussian(3.2), tables,
                                              m, Q, gen)
    assert _q_dist(rlwe.phase32(zero, _t(secret_ntt[0]), tables, m), 0).max() < BOUND
    p0 = lwe.phase32(rlwe.extract_lwe32(ct, Q), _t(secret[0]), m)
    assert _q_dist(p0, msg[0]) < BOUND


def test_glev_and_ggsw_phases_match_jax(q_ctx):
    plan, jm, _, secret_ntt, tables, m = q_ctx
    basis = JaxBasis(Q, 6, reverse_length=3)
    msg = jnp.asarray(_words((N,), 64).astype(np.uint32))
    gauss = JaxGaussian(3.2)
    glev_ct = jglev.glev_encrypt32(jax.random.PRNGKey(21), msg, secret_ntt, basis, gauss, plan,
                                   jm, Q)
    _eq(glev.glwe_phase32(_t(glev_ct), _t(secret_ntt), tables, m),
        jnp.stack([jglev.glwe_phase32(glev_ct[lvl], secret_ntt, plan, jm) for lvl in range(3)]))
    ggsw = jglev.rgsw_encrypt32(jax.random.PRNGKey(22), msg, secret_ntt[:1], basis, gauss, plan,
                                jm, Q)
    for r in range(2):
        for lvl in range(3):
            _eq(glev.glwe_phase32(_t(ggsw[r, lvl]), _t(secret_ntt[:1]), tables, m),
                jglev.glwe_phase32(ggsw[r, lvl], secret_ntt[:1], plan, jm))


@pytest.mark.parametrize("k", [1, 2])
def test_own_glev_and_ggsw_decrypt(q_ctx, k):
    _, _, secret, secret_ntt, tables, m = q_ctx
    basis = ApproxSignedBasis32(Q, 6, reverse_length=3)
    gen = torch.Generator().manual_seed(10 + k)
    gauss = DiscreteGaussian(3.2)
    msg = _t(_words((N,), 64))
    s_ntt, s = _t(secret_ntt[:k]), _t(secret[:k])
    scal = [sc % Q for sc in basis.scalars]
    make_glev = glev.rlev_encrypt32 if k == 1 else glev.glev_encrypt32
    make_ggsw = glev.rgsw_encrypt32 if k == 1 else glev.ggsw_encrypt32
    glev_ct = make_glev(msg, s_ntt, basis, gauss, tables, m, Q, gen)
    assert glev_ct.shape == (3, k + 1, N)
    for lvl in range(3):
        want = msg * scal[lvl] % Q
        assert _q_dist(glev.glwe_phase32(glev_ct[lvl], s_ntt, tables, m), want).max() < BOUND
    ggsw = make_ggsw(msg, s_ntt, basis, gauss, tables, m, Q, gen)
    assert ggsw.shape == (k + 1, 3, k + 1, N)
    for r in range(k + 1):
        for lvl in range(3):
            # row r carries m * scal at component r: the phase is m * scal
            # times -s_r for a mask row and times 1 for the body row
            carrier = msg * scal[lvl] % Q
            if r < k:
                carrier = (Q - poly.poly_naive_mul32(carrier, s[r], m)) % Q
            ph = glev.glwe_phase32(ggsw[r, lvl], s_ntt, tables, m)
            assert _q_dist(ph, carrier).max() < BOUND, (r, lvl)
    with pytest.raises(ValueError):
        (glev.rlev_encrypt32 if k == 2 else glev.rgsw_encrypt32)(
            msg, _t(secret_ntt), basis, gauss, tables, m, Q, gen)


def test_poly32_ops_match_jax():
    m, jm = barrett32(Q), jbarrett32(Q)
    a, b = _words((2, N)), _words((2, N))
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    qj = jnp.uint32(Q)
    _eq(poly.poly_add32(_t(a), _t(b), Q), jpoly.poly_add32(ja, jb, qj))
    _eq(poly.poly_sub32(_t(a), _t(b), Q), jpoly.poly_sub32(ja, jb, qj))
    _eq(poly.poly_neg32(_t(a), Q), jpoly.poly_neg32(ja, qj))
    _eq(poly.poly_mul_scalar32(_t(a), 12345, m), jpoly.poly_mul_scalar32(ja, 12345, jm))
    for d in (0, 1, 5, N - 1, N, 2 * N - 1, -9):
        want = jpoly.poly_mul_monomial32(ja, jnp.int32(d), qj)
        _eq(poly.poly_mul_monomial32(_t(a), d, Q), want)
        _eq(poly.poly_rotate32(_t(a), torch.tensor(d), Q), jpoly.poly_rotate32(ja, d, qj))
    degs = [3, -40]
    _eq(poly.poly_rotate32(_t(a), torch.tensor(degs), Q),
        jpoly.poly_rotate32(ja, jnp.asarray(degs, jnp.int32), qj))
    _eq(poly.poly_evaluate32(_t(a), 12345, m), jpoly.poly_evaluate32(ja, jnp.uint32(12345), jm))
    _eq(poly.poly_naive_mul32(_t(a), _t(b), m), jpoly.poly_naive_mul32(ja, jb, jm))


def test_poly64_ops_match_jax():
    a, b = _words((2, 16), Q64), _words((2, 16), Q64)
    ja, jb, jq = to_u64_pair(a), to_u64_pair(b), to_u64_pair(np.uint64(Q64))

    def eq64(got, want):
        np.testing.assert_array_equal(got.numpy(), from_u64_pair(want).astype(np.int64))

    eq64(poly.poly_add64(_t(a), _t(b), Q64), jpoly.poly_add64(ja, jb, jq))
    eq64(poly.poly_sub64(_t(a), _t(b), Q64), jpoly.poly_sub64(ja, jb, jq))
    eq64(poly.poly_neg64(_t(a), Q64), jpoly.poly_neg64(ja, jq))
    for d in (0, 3, 16, 31, -5):
        eq64(poly.poly_mul_monomial64(_t(a), d, Q64),
             jpoly.poly_mul_monomial64(ja, jnp.int32(d), jq))
        eq64(poly.poly_rotate64(_t(a), torch.tensor(d), Q64), jpoly.poly_rotate64(ja, d, jq))


def test_stats_copy_matches_jax():
    s = DiscreteGaussian(3.2).sample_signed(torch.Generator().manual_seed(6), (5000,)).numpy()
    assert stats.sample_moments(s) == jstats.sample_moments(s)
    np.testing.assert_array_equal(stats.discrete_gaussian_pmf(3.2, 20),
                                  jstats.discrete_gaussian_pmf(3.2, 20))
    assert stats.max_cdf_distance(s, 3.2, 20) == jstats.max_cdf_distance(s, 3.2, 20)
    assert stats.chi2_statistic(s, 3.2, 20) == jstats.chi2_statistic(s, 3.2, 20)
    assert stats.max_cdf_distance(s, 3.2, 20) < 0.03

