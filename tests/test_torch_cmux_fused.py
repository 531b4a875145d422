"""Port vs reference: the plain versions of kernels 3 and 4 (the fused CMux
stages, ``ops.cmux_fused`` on CPU tensors) against the JAX Pallas kernels
``cmux_stage1``/``cmux_stage2`` in interpret mode, and the fused step
against the JAX composed path.  Tolerance: zero (bit-equal, including the
lazy ``[0, 4p)`` stage-1 output)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot.blind_rotate import _rotate_glwe
from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.ops import cmux_fused as jfused
from primus_fhe_tpu.ops.ntt_pallas import PallasNttPlan32
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.ops import cmux_fused, rotate

LOG_N = 8
N = 1 << LOG_N
K = 1
LOG_BASIS = 8
LEVEL = 2
DEGREES = [0, 7, 2 * N - 3]


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def setup():
    jbasis = JaxBasis(None, LOG_BASIS, reverse_length=LEVEL)
    jconv = jtfhe.make_convolver(LOG_N, LEVEL, K, LOG_BASIS)
    # force the Pallas plans off-TPU: interpret mode runs them on the CPU
    jconv.pallas_plans = [PallasNttPlan32(LOG_N, p) for p in jconv.primes]
    rng = np.random.default_rng(42)
    key_coeff = rng.integers(0, 1 << 32, (K + 1, LEVEL, K + 1, N), dtype=np.uint64)
    key_ntt = np.asarray(jtfhe.ggsw_to_ntt(jconv, jnp.asarray(key_coeff.astype(np.uint32))))
    acc = rng.integers(0, 1 << 32, (3, K + 1, N), dtype=np.uint64).astype(np.uint32)
    basis = ApproxSignedBasis32(None, LOG_BASIS, reverse_length=LEVEL)
    conv = tfhe.make_convolver(LOG_N, LEVEL, K, LOG_BASIS)
    return jbasis, jconv, basis, conv, key_ntt, acc


def test_stage1_matches_pallas(setup):
    jbasis, jconv, basis, conv, _, acc = setup
    w_all, p_all, _, _, _ = jfused._fused_tables(jconv)
    want = jfused.cmux_stage1(
        jnp.asarray(acc), jnp.asarray(DEGREES, jnp.int32), w_all, p_all, jbasis,
        tuple(jconv.primes), LOG_N, 64,
    )
    got = cmux_fused.cmux_stage1(conv, basis, _t(acc), torch.tensor(DEGREES, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_stage2_matches_pallas(setup):
    jbasis, jconv, basis, conv, key_ntt, acc = setup
    w_all, p_all, iw_all, ip_all, crt = jfused._fused_tables(jconv)
    f = jfused.cmux_stage1(
        jnp.asarray(acc), jnp.asarray(DEGREES, jnp.int32), w_all, p_all, jbasis,
        tuple(jconv.primes), LOG_N, 64,
    )
    want = jfused.cmux_stage2(
        f, jnp.asarray(key_ntt), jnp.asarray(acc), iw_all, ip_all, tuple(jconv.primes),
        LOG_N, LEVEL, crt, 32,
    )
    got = cmux_fused.cmux_stage2(conv, _t(f), _t(key_ntt), _t(acc))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_fused_step_matches_composed(setup):
    jbasis, jconv, basis, conv, key_ntt, acc = setup
    got = cmux_fused.fused_cmux_step(
        conv, basis, _t(acc), torch.tensor(DEGREES, dtype=torch.int32), _t(key_ntt)
    ).numpy()
    # composed reference (jconv.use_pallas is False off-TPU: jnp transforms)
    for i, d in enumerate(DEGREES):
        rotated = _rotate_glwe(jnp.asarray(acc[i]), jnp.int32(d), N)
        delta = jtfhe.external_product(jconv, jbasis, rotated - jnp.asarray(acc[i]), jnp.asarray(key_ntt))
        np.testing.assert_array_equal(got[i], _np(jnp.asarray(acc[i]) + delta))


def test_external_product_matches_reference(setup):
    jbasis, jconv, basis, conv, key_ntt, acc = setup
    got = tfhe.external_product(conv, basis, _t(acc), _t(key_ntt))
    want = jtfhe.external_product(jconv, jbasis, jnp.asarray(acc), jnp.asarray(key_ntt))
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_rotation_matches_reference():
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 32, (4, 2, 64), dtype=np.uint64).astype(np.uint32)
    degrees = [0, 7, 64, 127]
    got = rotate.rotate(_t(v), torch.tensor(degrees)).numpy()
    for i, d in enumerate(degrees):
        np.testing.assert_array_equal(got[i], _np(_rotate_glwe(jnp.asarray(v[i]), jnp.int32(d), 64)))
