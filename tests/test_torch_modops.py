"""Port vs reference: u32 limb helpers, Barrett/Shoup records and the 32-bit
modular ops.  Same numpy inputs through both packages; tolerance: zero
(bit-equal integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.modular import factor as jfactor
from primus_fhe_tpu.modular import modops as jm
from primus_fhe_tpu.modular import modulus as jmod
from primus_fhe_tpu.numeric import limb as jlimb
from primus_fhe_tpu_torch.modular import factor as tfactor
from primus_fhe_tpu_torch.modular import modops as tm
from primus_fhe_tpu_torch.modular import modulus as tmod
from primus_fhe_tpu_torch.numeric import limb as tlimb

PRIMES = [536813569, 1073692673, (1 << 31) - 1]
EDGES = np.array([0, 1, 2, 0xFFFF, 0x10000, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint64)


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _words(rng, n=4096):
    """Random u32 words with the edge values in front."""
    return np.concatenate([EDGES.astype(np.uint32), _u32(rng, n)])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _eq(port, ref):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref).astype(np.int64))


def test_mulhi_and_mul_wide_u32():
    rng = np.random.default_rng(1)
    a = _words(rng)
    b = np.roll(_words(rng), 3)
    lo, hi = tlimb.mul_wide_u32(_t(a), _t(b))
    jlo, jhi = jlimb.mul_wide_u32(jnp.asarray(a), jnp.asarray(b))
    _eq(lo, jlo)
    _eq(hi, jhi)
    _eq(tlimb.mulhi_u32(_t(a), _t(b)), jlimb.mulhi_u32(jnp.asarray(a), jnp.asarray(b)))


def test_narrow_widen_roundtrip():
    w = _t(EDGES.astype(np.uint32))
    n = tlimb.narrow_u32(w)
    assert n.dtype == torch.int32
    assert torch.equal(tlimb.widen_u32(n), w)


@pytest.mark.parametrize("q", PRIMES)
def test_barrett_record_and_reduce(q):
    rng = np.random.default_rng(q % 1000)
    m = tmod.barrett32(q)
    jmm = jmod.barrett32(q)
    for got, want in zip(m, jmm):
        _eq(got, want)
    v = _words(rng)
    _eq(tm.barrett_lazy_reduce32(_t(v), m), jm.barrett_lazy_reduce32(jnp.asarray(v), jmm))
    lo, hi = _words(rng), np.roll(_words(rng), 5)
    _eq(
        tm.barrett_lazy_reduce_wide32(_t(lo), _t(hi), m),
        jm.barrett_lazy_reduce_wide32(jnp.asarray(lo), jnp.asarray(hi), jmm),
    )


@pytest.mark.parametrize("q", PRIMES)
def test_mul_add_sub_neg(q):
    rng = np.random.default_rng(q % 997)
    m, jmm = tmod.barrett32(q), jmod.barrett32(q)
    a = rng.integers(0, q, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, q, 4096, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, q - 1]
    b[:3] = [q - 1, 0, q - 1]
    ta, tb, ja, jb = _t(a), _t(b), jnp.asarray(a), jnp.asarray(b)
    _eq(tm.mul32(ta, tb, m), jm.mul32(ja, jb, jmm))
    _eq(tm.lazy_mul32(ta, tb, m), jm.lazy_mul32(ja, jb, jmm))
    _eq(tm.add32(ta, tb, q), jm.add32(ja, jb, jnp.uint32(q)))
    _eq(tm.sub32(ta, tb, q), jm.sub32(ja, jb, jnp.uint32(q)))
    _eq(tm.neg32(ta, q), jm.neg32(ja, jnp.uint32(q)))
    x2 = (a.astype(np.uint64) + b).astype(np.uint32)  # < 2q
    _eq(tm.reduce_once32(_t(x2), q), jm.reduce_once32(jnp.asarray(x2), jnp.uint32(q)))
    x4 = rng.integers(0, 4 * q if 4 * q < 1 << 32 else 1 << 32, 4096, dtype=np.uint64)
    x4 = x4.astype(np.uint32)
    _eq(tm.reduce_twice32(_t(x4), q), jm.reduce_twice32(jnp.asarray(x4), jnp.uint32(q)))


@pytest.mark.parametrize("q", PRIMES)
def test_sum_mod32(q):
    rng = np.random.default_rng(q % 991)
    t = rng.integers(0, q, (7, 3, 128), dtype=np.uint64).astype(np.uint32)
    m, jmm = tmod.barrett32(q), jmod.barrett32(q)
    for dim in (0, -1):
        _eq(tm.sum_mod32(_t(t), m, dim=dim), jm.sum_mod32(jnp.asarray(t), jmm, axis=dim))


@pytest.mark.parametrize("q", PRIMES)
def test_shoup_factor(q):
    rng = np.random.default_rng(q % 983)
    w = rng.integers(0, q, 64, dtype=np.uint64)
    f = tfactor.shoup32(w, q)
    jf = jfactor.shoup32(w, np.uint64(q))
    _eq(f.value, jf.value)
    _eq(f.quotient, jf.quotient)
    y = _u32(rng, (16, 64))
    _eq(
        tfactor.factor_mul_lazy32(_t(y), f, q),
        jfactor.factor_mul_lazy32(jnp.asarray(y), jf, jnp.uint32(q)),
    )
    y2 = rng.integers(0, 2 * q, (16, 64), dtype=np.uint64).astype(np.uint32)
    _eq(
        tfactor.factor_mul32(_t(y2), f, q),
        jfactor.factor_mul32(jnp.asarray(y2), jf, jnp.uint32(q)),
    )


def test_barrett32_rejects_bad_moduli():
    for q in (1, 1 << 31):
        with pytest.raises(ValueError):
            tmod.barrett32(q)
