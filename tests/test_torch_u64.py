"""Port vs reference: the u64 layer of the DCRT path.

- the u64 word helpers (``mul_hi_u64``, unsigned compares, the ``U64`` pair
  converters) on words at and above 2^63;
- ``barrett64`` fields, ``mul64``, ``shoup64``/``factor_mul_lazy64``/
  ``factor_mul64``, ``reduce_once64``/``reduce_twice64``/``add64``/``sub64``
  against the JAX functions at the two 50-bit DCRT moduli, the 60-bit golden
  prime and a 62-bit prime;
- the multi-limb big-integer helpers against ``primus_fhe_tpu.numeric.bigint``;
- ``sample_uniform_u64``: range and mean.

Tolerance: zero (bit-equal words) throughout, except the sampler's mean
(statistical, stated there).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.modular import factor as jfactor
from primus_fhe_tpu.modular import modops as jmodops
from primus_fhe_tpu.modular.modulus import barrett64 as jbarrett64
from primus_fhe_tpu.numeric import bigint as jbig
from primus_fhe_tpu.numeric.limb import U64, from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.numeric.limb import u64_lt as jlt, u64_mul_hi as jmulhi
from primus_fhe_tpu.numeric.limb import u64_mul_wide as jmulwide
from primus_fhe_tpu_torch.distr.sampling import sample_uniform_u64
from primus_fhe_tpu_torch.modular import (
    add64, barrett64, barrett64_int, factor_mul64, factor_mul_lazy64, mul64, reduce_once64,
    reduce_twice64, shoup64, sub64,
)
from primus_fhe_tpu_torch.numeric import bigint
from primus_fhe_tpu_torch.numeric.limb import (
    from_u64_pair, ge_u64, lt_u64, mul_hi_u64, mul_lo_u64, mul_wide_u64, to_u64_pair, u64_numpy,
    u64_tensor,
)

MODULI = [1125899906826241, 1125899906629633, 1152921504606830593, 4611686018427322369]


def _words(rng, n):
    """u64 words with the edge cases: 0, 1, 2^63 - 1, 2^63, 2^64 - 1."""
    edge = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], dtype=np.uint64)
    return np.concatenate([edge, rng.integers(0, 1 << 64, n, dtype=np.uint64)])


def _below(rng, q, n):
    return np.concatenate([np.array([0, q - 1], dtype=np.uint64),
                           rng.integers(0, q, n, dtype=np.uint64)])


def test_u64_helpers_match_reference():
    rng = np.random.default_rng(1)
    a, b = _words(rng, 500), _words(rng, 500)[::-1].copy()
    ta, tb = u64_tensor(a), u64_tensor(b)
    np.testing.assert_array_equal(u64_numpy(mul_hi_u64(ta, tb)), jfrom(jmulhi(jto(a), jto(b))))
    np.testing.assert_array_equal(u64_numpy(mul_lo_u64(ta, tb)), a * b)
    lo, hi = mul_wide_u64(ta, tb)
    jlo, jhi = jmulwide(jto(a), jto(b))
    np.testing.assert_array_equal(u64_numpy(lo), jfrom(jlo))
    np.testing.assert_array_equal(u64_numpy(hi), jfrom(jhi))
    np.testing.assert_array_equal(lt_u64(ta, tb).numpy(), np.asarray(jlt(jto(a), jto(b))))
    np.testing.assert_array_equal(ge_u64(ta, tb).numpy(), a >= b)
    const = 0xF123456789ABCDEF
    np.testing.assert_array_equal(
        u64_numpy(mul_hi_u64(ta, const)),
        np.array([(int(x) * const) >> 64 for x in a], dtype=np.uint64))
    # the pair converters round-trip through the reference's U64
    pair = jto(a)
    np.testing.assert_array_equal(u64_numpy(from_u64_pair(pair)), a)
    lo, hi = to_u64_pair(ta)
    np.testing.assert_array_equal(lo, np.asarray(pair.lo))
    np.testing.assert_array_equal(hi, np.asarray(pair.hi))


@pytest.mark.parametrize("q", MODULI)
def test_barrett_shoup_modops_match_reference(q):
    rng = np.random.default_rng(q % 1000)
    m, jm = barrett64(q), jbarrett64(q)
    assert int(u64_numpy(m.value)) == q
    assert int(u64_numpy(m.ratio0)) == int(jfrom(jm.ratio0))
    assert int(u64_numpy(m.ratio1)) == int(jfrom(jm.ratio1))
    a, b = _below(rng, q, 400), _below(rng, q, 400)[::-1].copy()
    want = jfrom(jmodops.mul64(jto(a), jto(b), jm))
    for rec in (m, barrett64_int(q)):
        np.testing.assert_array_equal(u64_numpy(mul64(u64_tensor(a), u64_tensor(b), rec)), want)
    np.testing.assert_array_equal(u64_numpy(add64(u64_tensor(a), u64_tensor(b), q)),
                                  jfrom(jmodops.add64(jto(a), jto(b), jto(np.uint64(q)))))
    np.testing.assert_array_equal(u64_numpy(sub64(u64_tensor(a), u64_tensor(b), q)),
                                  jfrom(jmodops.sub64(jto(a), jto(b), jto(np.uint64(q)))))
    # reductions of lazy words: [0, 2q) and [0, 4q) (past 2^63 for the 62-bit q)
    x2, x4 = (rng.integers(0, f * q, 400, dtype=np.uint64) for f in (2, 4))
    jq, j2q = jto(np.uint64(q)), jto(np.uint64(2 * q))
    np.testing.assert_array_equal(u64_numpy(reduce_once64(u64_tensor(x2), q)),
                                  jfrom(jmodops.reduce_once64(jto(x2), jq)))
    np.testing.assert_array_equal(u64_numpy(reduce_twice64(u64_tensor(x4), q, 2 * q)),
                                  jfrom(jmodops.reduce_twice64(jto(x4), jq, j2q)))
    # Shoup factors on any u64 operand
    w = rng.integers(0, q, 3, dtype=np.uint64)
    y = _words(rng, 300)
    for wi in w:
        f, jf = shoup64(int(wi), q), jfactor.shoup64(int(wi), q)
        assert int(u64_numpy(f.quotient)) == int(jfrom(jf.quotient))
        np.testing.assert_array_equal(u64_numpy(factor_mul_lazy64(u64_tensor(y), f, q)),
                                      jfrom(jfactor.factor_mul_lazy64(jto(y), jf, jq)))
        np.testing.assert_array_equal(u64_numpy(factor_mul64(u64_tensor(y), f, q)),
                                      jfrom(jfactor.factor_mul64(jto(y), jf, jq)))


def test_mul64_broadcast_moduli_of_two_widths():
    """A record over moduli of different widths (``shift`` a tensor)."""
    rng = np.random.default_rng(9)
    qs = [MODULI[0], MODULI[2]]
    m = barrett64(qs).map(lambda x: x.reshape(2, 1))
    a = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in qs])
    b = np.stack([rng.integers(0, q, 64, dtype=np.uint64) for q in qs])
    got = u64_numpy(mul64(u64_tensor(a), u64_tensor(b), m))
    want = np.array([[int(x) * int(y) % q for x, y in zip(a[i], b[i])] for i, q in enumerate(qs)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(got, want)


def test_bigint_helpers_match_reference():
    rng = np.random.default_rng(4)
    L = 4
    a = rng.integers(0, 1 << 32, (50, L), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (50, L), dtype=np.uint64).astype(np.uint32)
    b[0] = a[0]  # equal values
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    got, carry = bigint.big_add(ta, tb)
    want, jcarry = jbig.big_add(a, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry).astype(np.int64))
    np.testing.assert_array_equal(bigint.big_ge(ta, tb).numpy(), np.asarray(jbig.big_ge(a, b)))
    np.testing.assert_array_equal(bigint.big_cond_sub(ta, tb).numpy(),
                                  np.asarray(jbig.big_cond_sub(a, b)).astype(np.int64))
    s = rng.integers(0, 1 << 32, 50, dtype=np.uint64).astype(np.uint32)
    got, carry = bigint.big_mul_u32_add(ta, torch.from_numpy(s.astype(np.int64)), tb)
    want, jcarry = jbig.big_mul_u32_add(a, s, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry).astype(np.int64))
    for shift, width in ((0, 25), (25, 25), (30, 7), (96, 31), (120, 20)):
        np.testing.assert_array_equal(bigint.big_shr_window(ta, shift, width).numpy(),
                                      np.asarray(jbig.big_shr_window(a, shift, width)))
    assert bigint.big_from_int(12345678901234567890123, 3).tolist() == \
        jbig.big_from_int(12345678901234567890123, 3).tolist()
    # big_mod_u64_dot: limbs mod q via the power table
    q = MODULI[1]
    pow_t = np.array([pow(2, 32 * i, q) for i in range(L)], dtype=np.uint64)
    got = bigint.big_mod_u64_dot(ta, u64_tensor(pow_t), barrett64_int(q))
    want = jbig.big_mod_u64_dot(a, jto(pow_t), jbarrett64(q))
    np.testing.assert_array_equal(u64_numpy(got), jfrom(want))


def test_sample_uniform_u64_range_and_mean():
    """Uniform in [0, q): every draw below q; the mean within 6 standard
    errors of q/2 (q / sqrt(12 * 20000) each)."""
    for q in MODULI[:3]:
        x = sample_uniform_u64(torch.Generator().manual_seed(q % 97), (20000,), q)
        u = u64_numpy(x).astype(object)
        assert (u < q).all() and (u >= 0).all()
        mean = float(sum(u)) / len(u)
        assert abs(mean - q / 2) < 6 * q / np.sqrt(12 * 20000)
    with pytest.raises(ValueError):
        sample_uniform_u64(torch.Generator(), (2,), 1 << 62)


def test_u64_pair_of_jax_u64():
    """``from_u64_pair`` reads a reference ``U64`` directly."""
    v = np.array([[1, (1 << 64) - 1], [1 << 40, 7]], dtype=np.uint64)
    pair = jto(v)
    assert isinstance(pair, U64)
    np.testing.assert_array_equal(u64_numpy(from_u64_pair(pair)), v)
