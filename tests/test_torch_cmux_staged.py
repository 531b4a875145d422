"""The staged CMux route's CPU side: the route rule, the plain step at the
shapes the card now sends to kernel H, and a 4-bit programmable bootstrap.

1. ``ops.cmux_fused.step_route`` on the named profiles (fused), on the
   shapes ``chip_smoke.py`` phase 21 runs (staged) and past the card's
   limits (a ``ValueError`` naming the limit).
2. The JAX ``cmux_stage1`` / ``cmux_stage2`` and ``fused_cmux_step`` (Pallas
   in interpret mode) against the port's ``cmux_stage1`` / ``cmux_stage2``
   (their plain versions on CPU tensors) and the CPU ``CmuxStepPlan``, at n
   = 32 with k = 2 over 3 primes and k = 3 over 3 primes (and, in
   ``test_torch_cmux_staged_gadget.py``, a 2^1 x 20 gadget): shapes the
   one-launch kernel does not hold.
3. A 4-bit programmable bootstrap at TOY's ring (N = 32, n_lwe 8) with
   ``lut_test_polynomial`` of f(m) = 3m + 1 mod 16 on a JAX-made key: the
   port's outputs equal the JAX ``bootstrap``'s word for word, and the
   noiseless inputs decrypt to f(m) under the GLWE key.

Tolerance: zero (bit-equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot import bootstrap as jax_bootstrap
from primus_fhe_tpu.boot import make_bootstrap_key as jax_make_bsk
from primus_fhe_tpu.boot.blind_rotate import lut_test_polynomial as jax_lut
from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.ops import cmux_fused as jfused
from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan32
from primus_fhe_tpu.transforms.torus import TorusConvolver32 as JaxConvolver32
from primus_fhe_tpu_torch import params as P
from primus_fhe_tpu_torch.boot.blind_rotate import bootstrap, lut_test_polynomial
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.lattice.lwe import phase_torus32
from primus_fhe_tpu_torch.ops import cmux_fused
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("kp,k1,level,log_n,route", [
    (2, 2, 3, 11, "fused"),  # BOOLEAN_128
    (2, 2, 3, 10, "fused"),  # BOOLEAN_TFHE_LIB
    (2, 2, 3, 5, "fused"),  # TOY
    (2, 2, 12, 8, "fused"),  # the card tests' 2^1 x 12 gadget
    (2, 3, 2, 12, "fused"),  # k = 2 at N = 4096, L = 2
    (2, 2, 3, 15, "staged"),  # the widened ring of phase 21
    (3, 2, 3, 16, "staged"),
    (2, 2, 3, 17, "staged"),  # N = 2^17: slices of 2^14-2^15 words, C = 4 or 8
    (3, 2, 3, 17, "staged"),
    (3, 3, 3, 10, "staged"),  # k = 2 over 3 primes: a cluster of 9
    (2, 2, 20, 10, "staged"),  # the 2^1 x 20 gadget: L > 16
    (2, 2, 8, 12, "fused"),  # L = 8 at N = 4096: 224 KB
    (2, 2, 9, 12, "staged"),  # L = 9 at N = 4096: past 227 KB
    (2, 2, 3, 13, "staged"),
    (2, 5, 2, 8, "staged"),  # k = 4: k1 > 4
    (4, 2, 32, 4, "staged"),
])
def test_step_route(kp, k1, level, log_n, route):
    assert cmux_fused.step_route(kp, k1, level, log_n) == route


@pytest.mark.parametrize("kp,k1,level,log_n,limit", [
    (2, 2, 3, 27, "log_n 4-26"), (2, 2, 3, 3, "log_n 4-26"), (5, 2, 3, 10, "1-4"),
    (2, 2, 33, 10, "1-32"),
])
def test_step_route_refuses_past_the_card(kp, k1, level, log_n, limit):
    with pytest.raises(ValueError, match=limit):
        cmux_fused.step_route(kp, k1, level, log_n)


LOG_N = 5
N = 1 << LOG_N
# (k, log_basis, level, bound_bits): k = 2 over 3 primes, k = 3 over 3
# primes (the 2^1 x 20 gadget is test_torch_cmux_staged_gadget.py's: its
# interpret-mode stages take ~40 s to trace, so it runs on another worker)
STAGED = [(2, 7, 3, 60), (3, 8, 2, 60)]


def staged_case(k: int, log_basis: int, level: int, bound):
    """Both packages' convolvers and bases (bound_bits None: make_convolver's)
    and random inputs at n = 32."""
    if bound is None:
        conv = tfhe.make_convolver(LOG_N, level, k, log_basis)
        jconv = jtfhe.make_convolver(LOG_N, level, k, log_basis)
    else:
        conv, jconv = TorusConvolver32(LOG_N, bound), JaxConvolver32(LOG_N, bound)
    assert list(jconv.primes) == conv.primes
    jconv.pallas_plans = [PallasNttPlan32(LOG_N, p) for p in jconv.primes]  # interpret mode
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    jbasis = JaxBasis(None, log_basis, reverse_length=level)
    rng = np.random.default_rng(k * 100 + level)
    q = np.array(conv.primes, dtype=np.uint64).reshape(-1, 1, 1, 1, 1)
    key = (rng.integers(0, 1 << 62, (conv.count, k + 1, level, k + 1, N), dtype=np.uint64)
           % q).astype(np.uint32)
    acc = rng.integers(0, 1 << 32, (3, k + 1, N), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([0, 7, 2 * N - 3], dtype=np.int32)
    return k, level, conv, jconv, basis, jbasis, key, acc, degrees


@pytest.fixture(scope="module", params=STAGED, ids=["k2_kp3", "k3_kp3"])
def staged(request):
    return staged_case(*request.param)


def test_staged_shapes_route_to_kernel_h(staged):
    k, level, conv = staged[:3]
    assert cmux_fused.step_route(conv.count, k + 1, level, conv.log_n) == "staged"


def test_stages_and_step_match_jax(staged):
    check_stages_and_step(staged)


def check_stages_and_step(staged):
    """The port's two stages and its CPU step plan against the JAX Pallas
    stages and ``fused_cmux_step`` (interpret mode), word for word."""
    k, level, conv, jconv, basis, jbasis, key, acc, degrees = staged
    w_all, p_all, iw_all, ip_all, crt = jfused._fused_tables(jconv)
    f = jfused.cmux_stage1(jnp.asarray(acc), jnp.asarray(degrees), w_all, p_all, jbasis,
                           tuple(jconv.primes), LOG_N, 64)
    got1 = cmux_fused.cmux_stage1(conv, basis, _t(acc), torch.from_numpy(degrees))
    np.testing.assert_array_equal(got1.numpy(), _np(f))
    want = jfused.cmux_stage2(f, jnp.asarray(key), jnp.asarray(acc), iw_all, ip_all,
                              tuple(jconv.primes), LOG_N, level, crt, 32)
    got2 = cmux_fused.cmux_stage2(conv, got1, _t(key), _t(acc))
    np.testing.assert_array_equal(got2.numpy(), _np(want))
    step = jfused.fused_cmux_step(jconv, jbasis, jnp.asarray(acc), jnp.asarray(degrees),
                                  jnp.asarray(key))
    np.testing.assert_array_equal(_np(step), _np(want))
    plan = cmux_fused.CmuxStepPlan(conv, basis, k + 1, "cpu")
    acc32 = _t(acc).to(torch.int32)
    out = plan(acc32, torch.from_numpy(degrees), _t(key).to(torch.int32), out=acc32)
    assert out is acc32
    np.testing.assert_array_equal(out.numpy().astype(np.int64) & 0xFFFFFFFF, _np(want))


MSG_BITS = 4


def test_programmable_bootstrap_4bit_matches_jax():
    """TOY's ring: 16 ciphertexts of m 2^27 (the padding bit clear), one a
    4-bit message, under JAX-made keys; the port's bootstrap equals the
    JAX's on random masks, and on trivial ones decrypts to f(m) under the
    GLWE key."""
    p = P.TOY
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    jbasis = JaxBasis(None, p.log_basis, reverse_length=p.level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    jconv = jtfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(23), 4)
    lwe_s = (jax.random.bits(k1, (p.lwe_dim,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    glwe_s = (jax.random.bits(k2, (p.glwe_dim, p.n), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    jbsk = jax_make_bsk(k3, lwe_s, glwe_s, jbasis, JaxGaussian(p.glwe_sigma), jconv)
    bsk = _t(jbsk)
    delta = 1 << (32 - MSG_BITS - 1)
    table = np.array([((3 * m + 1) % 16) * delta for m in range(16)], dtype=np.uint32)
    jtp = jax_lut(table, p.log_n, MSG_BITS)
    tp = lut_test_polynomial(table, p.log_n, MSG_BITS)
    np.testing.assert_array_equal(tp.numpy(), _np(jtp))
    mu = np.arange(16, dtype=np.uint64) * delta
    a = jax.random.bits(k4, (16, p.lwe_dim), dtype=jnp.uint32)
    b = jnp.sum(a * lwe_s, axis=-1, dtype=jnp.uint32) + jnp.asarray(mu.astype(np.uint32))
    for cts in (jnp.concatenate([a, b[:, None]], axis=-1),  # random masks
                jnp.asarray(np.concatenate([np.zeros((16, p.lwe_dim), np.uint32),
                                            mu.astype(np.uint32)[:, None]], axis=-1))):
        want = jax_bootstrap(jconv, jbasis, jbsk, cts, jtp, p.log_n)
        got = bootstrap(conv, basis, bsk, _t(cts), tp, p.log_n)
        np.testing.assert_array_equal(got.numpy(), _np(want))
    ph = phase_torus32(got, _t(glwe_s).reshape(-1))
    decoded = ((ph + delta // 2) // delta) % 32
    np.testing.assert_array_equal(decoded.numpy(), (3 * np.arange(16) + 1) % 16)
