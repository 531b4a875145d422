"""The modular layer's extras, word for word against the JAX package on the
inputs of ``test_compact_uint_modulus.py``, ``test_modops_field.py`` and
the bigint tests: the modulus records and their range checks,
``MultiplyFactor32``, the 32- and 64-bit ``modops`` extras (lazy words
included), ``modular/compact.py`` and ``big_to_int`` / ``big_mod_u32_dot``.
u64 words cross as ``U64`` pairs (``to_u64_pair`` / ``from_u64_pair``).
Tolerance: none, every value is an exact integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.modular import barrett32 as jbarrett32
from primus_fhe_tpu.modular import barrett64 as jbarrett64
from primus_fhe_tpu.modular import compact as jck
from primus_fhe_tpu.modular import factor as jfactor
from primus_fhe_tpu.modular import modops as jm
from primus_fhe_tpu.modular import modulus as jmodulus
from primus_fhe_tpu.numeric import bigint as jbig
from primus_fhe_tpu.numeric import limb as jlimb
from primus_fhe_tpu_torch.modular import barrett32, barrett64
from primus_fhe_tpu_torch.modular import compact as ck
from primus_fhe_tpu_torch.modular import factor, modops, modulus
from primus_fhe_tpu_torch.numeric import bigint
from primus_fhe_tpu_torch.numeric.limb import from_u64_pair, to_u64_pair

Q32 = 1073692673  # test_modops_field.py's 30-bit prime
Q64 = 1125899906826241  # its 50-bit prime


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _ju64(x: np.ndarray):
    """numpy uint64 -> the JAX package's U64 pair."""
    return jlimb.to_u64_pair(np.asarray(x, dtype=np.uint64))


def _t64(x: np.ndarray):
    """numpy uint64 -> port words, through the U64 pair as a caller would."""
    return from_u64_pair(tuple(np.asarray(p) for p in _ju64(x)))


def _eq64(got: torch.Tensor, want_pair):
    lo, hi = to_u64_pair(got)
    np.testing.assert_array_equal(lo, np.asarray(want_pair.lo))
    np.testing.assert_array_equal(hi, np.asarray(want_pair.hi))


def _eq32(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_modulus_records_and_range_checks():
    qs = np.array([97, 999999937, 12345679, 1 << 29], dtype=np.uint32)
    np.testing.assert_array_equal(modulus.compact32(qs).value.numpy(),
                                  np.asarray(jmodulus.compact32(qs).value))
    assert int(modulus.uint32_modulus((1 << 31) - 1).value) == int(
        jmodulus.uint32_modulus((1 << 31) - 1).value)
    for port, jax_ in ((modulus.compact32, jmodulus.compact32),
                       (modulus.uint32_modulus, jmodulus.uint32_modulus)):
        bad = (1 << 30) if port is modulus.compact32 else (1 << 31)
        with pytest.raises(ValueError) as e1:
            port(bad)
        with pytest.raises(ValueError) as e2:
            jax_(bad)
        assert str(e1.value) == str(e2.value)
    for name in ("NativeModulus32", "NativeModulus64", "PowOf2Modulus32", "PowOf2Modulus64",
                 "CompactModulus64", "UintModulus64"):
        assert getattr(modulus, name)._fields == getattr(jmodulus, name)._fields, name
    mf, jmf = factor.multiply_factor32([3, 5], [Q32, 97]), jfactor.multiply_factor32(
        np.array([3, 5]), np.array([Q32, 97]))
    _eq32(mf.value, jmf.value)
    _eq32(mf.quotient, jmf.quotient)


def test_modops32_extras():
    m, jm32 = barrett32(Q32), jbarrett32(Q32)
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, Q32, size=64, dtype=np.uint32) for _ in range(3))
    aj, bj, cj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    lazy_a = (a.astype(np.uint64) + Q32 * (a & 1)).astype(np.uint32)  # in [0, 2q)
    _eq32(modops.lazy_add32(_t(lazy_a), _t(b), 2 * Q32),
          jm.lazy_add32(jnp.asarray(lazy_a), bj, jnp.uint32(2 * Q32)))
    _eq32(modops.double32(_t(a), Q32), jm.double32(aj, jnp.uint32(Q32)))
    _eq32(modops.sqr32(_t(a), m), jm.sqr32(aj, jm32))
    _eq32(modops.mul_add32(_t(a), _t(b), _t(c), m), jm.mul_add32(aj, bj, cj, jm32))
    for e in (0, 1, 2, 3, 17, Q32 - 2, Q32 - 1):
        _eq32(modops.exp32(_t(a), e, m), jm.exp32(aj, e, jm32))
    e = rng.integers(0, 1 << 32, size=64, dtype=np.uint32)  # tensor exponents
    _eq32(modops.exp32(_t(a), _t(e), m), jm.exp32(aj, jnp.asarray(e), jm32))
    _eq32(modops.exp_pow_of_2_32(_t(a), 5, m), jm.exp_pow_of_2_32(aj, 5, jm32))
    bz = b.copy()
    bz[0] = 0  # inv(0) = 0
    _eq32(modops.inv32(_t(bz), m, Q32), jm.inv32(jnp.asarray(bz), jm32, Q32))
    _eq32(modops.div32(_t(a), _t(b), m, Q32), jm.div32(aj, bj, jm32, Q32))


@pytest.mark.parametrize("qs", [(3, 4, 1000000007, (1 << 31) - 1), (1 << 30, 12345678, 2310)])
def test_uint_mul32(qs):
    rng = np.random.default_rng(len(qs) + qs[0])
    for q in qs:  # test_uint_mul32_arbitrary_moduli's moduli, any u32 inputs
        a, b = (rng.integers(0, 1 << 32, size=64, dtype=np.uint32) for _ in range(2))
        _eq32(modops.uint_mul32(_t(a), _t(b), q),
              jm.uint_mul32(jnp.asarray(a), jnp.asarray(b), jnp.uint32(q)))
    col = np.array(qs, dtype=np.uint32)[:, None]  # vector moduli
    a, b = (rng.integers(0, 1 << 32, size=(len(qs), 16), dtype=np.uint32) for _ in range(2))
    _eq32(modops.uint_mul32(_t(a), _t(b), _t(col)),
          jm.uint_mul32(jnp.asarray(a), jnp.asarray(b), jnp.asarray(col)))


def test_modops64_extras():
    m, jm64 = barrett64(Q64), jbarrett64(Q64)
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(1, Q64, size=16, dtype=np.uint64) for _ in range(3))
    av, bv, cv = _ju64(a), _ju64(b), _ju64(c)
    ta, tb, tc = _t64(a), _t64(b), _t64(c)
    qv = jlimb.to_u64_pair(np.uint64(Q64))
    _eq64(modops.double64(ta, Q64), jm.double64(av, qv))
    _eq64(modops.lazy_mul64(ta, tb, m), jm.lazy_mul64(av, bv, jm64))  # lazy words too
    wide_lo = rng.integers(0, 1 << 63, size=16, dtype=np.uint64) * np.uint64(2)
    wide_hi = rng.integers(0, Q64 >> 2, size=16, dtype=np.uint64)
    _eq64(modops.barrett_lazy_reduce_wide64(_t64(wide_lo), _t64(wide_hi), m),
          jm.barrett_lazy_reduce_wide64(_ju64(wide_lo), _ju64(wide_hi), jm64))
    _eq64(modops.sqr64(ta, m), jm.sqr64(av, jm64))
    _eq64(modops.mul_add64(ta, tb, tc, m), jm.mul_add64(av, bv, cv, jm64))
    for e in (0, 1, 5, 1 << 20):
        _eq64(modops.exp64(ta, e, m), jm.exp64(av, e, jm64))
    _eq64(modops.exp_pow_of_2_64(ta, 3, m), jm.exp_pow_of_2_64(av, 3, jm64))
    _eq64(modops.inv64(ta, m, Q64), jm.inv64(av, jm64, Q64))
    _eq64(modops.div64(ta, tb, m, Q64), jm.div64(av, bv, jm64, Q64))


@pytest.mark.parametrize("q", [1000000007, (1 << 62) + 123, (1 << 63) - 25, 1 << 52])
def test_uint_mul64(q):
    rng = np.random.default_rng(4)
    a, b = (rng.integers(0, min(q, 1 << 63), size=8, dtype=np.uint64) for _ in range(2))
    _eq64(modops.uint_mul64(_t64(a), _t64(b), q),
          jm.uint_mul64(_ju64(a), _ju64(b), jlimb.to_u64_pair(np.uint64(q))))


@pytest.mark.parametrize("q", [97, 12345678, 999999937, (1 << 30) - 35])
def test_compact32_tiers(q):
    rng = np.random.default_rng(q)
    a, b, c = (rng.integers(0, q, size=256, dtype=np.uint32) for _ in range(3))
    aj, bj, cj, qj = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.uint32(q)
    ta, tb, tc = _t(a), _t(b), _t(c)
    for name in ("compact_add32", "compact_sub32", "compact_lazy_sub32", "compact_mul32"):
        _eq32(getattr(ck, name)(ta, tb, q), getattr(jck, name)(aj, bj, qj))
    for name in ("compact_double32", "compact_neg32"):
        _eq32(getattr(ck, name)(ta, q), getattr(jck, name)(aj, qj))
    wide = ((a.astype(np.uint64) + np.uint64(q) - 1) % np.uint64(2 * q)).astype(np.uint32)
    _eq32(ck.compact_reduce_once32(_t(wide), q), jck.compact_reduce_once32(jnp.asarray(wide), qj))
    _eq32(ck.compact_mul_add32(ta, tb, tc, q), jck.compact_mul_add32(aj, bj, cj, qj))
    lo, hi = a, b % np.uint32(q)  # a wide value below q 2^32
    _eq32(ck.compact_reduce_wide32(_t(lo), _t(hi), q, 32),
          jck.compact_reduce_wide32(jnp.asarray(lo), jnp.asarray(hi), qj, 32))


@pytest.mark.parametrize("n", [16, 48, 53, 1])
def test_compact_dot32(n):
    q = (1 << 30) - 35
    rng = np.random.default_rng(n)
    a, b = (rng.integers(0, q, size=(3, n), dtype=np.uint32) for _ in range(2))
    _eq32(ck.compact_dot32(_t(a), _t(b), q),
          jck.compact_dot32(jnp.asarray(a), jnp.asarray(b), jnp.uint32(q)))
    # vector moduli as a column, and the contracted axis first
    qs = np.array([97, 999999937, (1 << 30) - 35], dtype=np.uint32)[:, None]
    a, b = a % qs, b % qs
    _eq32(ck.compact_dot32(_t(a), _t(b), _t(qs)),
          jck.compact_dot32(jnp.asarray(a), jnp.asarray(b), jnp.asarray(qs)))
    _eq32(ck.compact_dot32(_t(a.T), _t(b.T), q, dim=0),
          jck.compact_dot32(jnp.asarray(a.T), jnp.asarray(b.T), jnp.uint32(q), axis=0))


@pytest.mark.parametrize("q", [1000000007, 1125899906826241, (1 << 62) - 57])
def test_compact64_tiers(q):
    rng = np.random.default_rng(q % 100000)
    a, b = (rng.integers(0, q, size=32, dtype=np.uint64) for _ in range(2))
    av, bv, qv = _ju64(a), _ju64(b), jlimb.to_u64_pair(np.uint64(q))
    ta, tb = _t64(a), _t64(b)
    for name in ("compact_add64", "compact_sub64", "compact_lazy_sub64", "compact_mul64"):
        _eq64(getattr(ck, name)(ta, tb, q), getattr(jck, name)(av, bv, qv))
    _eq64(ck.compact_double64(ta, q), jck.compact_double64(av, qv))
    wide = (a + np.uint64(q) - np.uint64(1)) % np.uint64(2 * q)
    _eq64(ck.compact_reduce_once64(_t64(wide), q), jck.compact_reduce_once64(_ju64(wide), qv))


@pytest.mark.parametrize("n", [8, 19])
def test_compact_dot64(n):
    q = (1 << 62) - 57
    rng = np.random.default_rng(n + 50)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64) for _ in range(2))
    _eq64(ck.compact_dot64(_t64(a), _t64(b), q),
          jck.compact_dot64(_ju64(a), _ju64(b), jlimb.to_u64_pair(np.uint64(q))))


def test_bigint_extras():
    rng = np.random.default_rng(8)
    limbs = rng.integers(0, 1 << 32, size=(4, 5), dtype=np.uint64).astype(np.uint32)
    for row in limbs:
        assert bigint.big_to_int(_t(row)) == jbig.big_to_int(row)
    q = 536813569
    pows = np.array([pow(2, 32 * i, q) for i in range(5)], dtype=np.uint32)
    _eq32(bigint.big_mod_u32_dot(_t(limbs), _t(pows), barrett32(q)),
          jbig.big_mod_u32_dot(jnp.asarray(limbs), jnp.asarray(pows), jbarrett32(q)))
