"""Port vs reference: the 62-bit negacyclic product by a fixed NTT-domain
operand, and the u64 helpers of ``transforms/ntt.py``.

- the plain versions of kernel D (``mxu8_inverse64_mul``) and kernel E
  (``mxu8_roundtrip64_mul``) against ``mxu8_fused_inverse64_mul`` and
  ``mxu8_fused_roundtrip64_mul`` (Pallas in interpret mode) at log_n=8 over
  the 7-plane (50-bit), 8-plane (60-bit) and 62-bit moduli of
  ``tests/test_ntt_mxu8.py``; ``Mxu8Tables64.mul_table`` against
  ``Mxu8NttPlan64.inverse_mul_tabs``;
- ``monomial64``, ``pointwise_mul64``, ``negacyclic_mul64``,
  ``bit_reverse_permute`` and the four normal-order variants against
  ``primus_fhe_tpu/transforms/ntt.py``.

Inputs from a numpy seed; tolerance zero (bit-equal words).
"""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.modular.modulus import barrett64 as jbarrett64
from primus_fhe_tpu.numeric.limb import U64, from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.ops import ntt_mxu8 as jmxu
from primus_fhe_tpu.transforms import ntt as jntt
from primus_fhe_tpu.transforms.plan import build_plan32 as jbuild_plan32
from primus_fhe_tpu.transforms.plan import build_plan64 as jbuild_plan64
from primus_fhe_tpu_torch.modular.modulus import barrett64
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops import ntt64, ntt_mxu8
from primus_fhe_tpu_torch.transforms import ntt
from primus_fhe_tpu_torch.transforms.plan import build_plan32, build_plan64

Q50 = 1125899906826241  # 7 planes (bench.py's prime)
Q60 = 1152921504606830593  # 8 planes
Q62 = 4611686018425815041  # 8 planes, non-Solinas


@pytest.mark.parametrize("q", [Q50, Q60, Q62])
def test_inverse_mul_and_roundtrip_plain_match_reference(q):
    rng = np.random.default_rng(29)
    x = rng.integers(0, q, (2, 256), dtype=np.uint64)
    key = rng.integers(0, q, (256,), dtype=np.uint64)
    jplan = jmxu.Mxu8NttPlan64(8, q)
    jtabs = jplan.inverse_mul_tabs(key, 2)
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, [q]))
    mt = tables.mul_table(u64_tensor(key)[None])
    want_quot = [((int(k) << 64) // q) & ((1 << 64) - 1) for k in key]
    np.testing.assert_array_equal(u64_numpy(mt[0, 1]), np.array(want_quot, dtype=np.uint64))
    # the JAX pack holds the same words as (lo, hi) u32 halves
    np.testing.assert_array_equal(u64_numpy(mt[0, 0]).reshape(jplan.A, jplan.B),
                                  jfrom(U64(jtabs[0], jtabs[1])))

    f = jmxu.mxu8_fused_forward64(jplan, jto(x), 4, 2)
    want_d = jfrom(jmxu.mxu8_fused_inverse64_mul(jplan, f, jtabs, 1, 2))
    got_d = ntt_mxu8.mxu8_inverse64_mul(tables, u64_tensor(jfrom(f))[None], mt)
    np.testing.assert_array_equal(u64_numpy(got_d)[0], want_d)
    want_e = jfrom(jmxu.mxu8_fused_roundtrip64_mul(jplan, jto(x), jtabs, 1, 2))
    got_e = ntt_mxu8.mxu8_roundtrip64_mul(tables, u64_tensor(x)[None], mt)
    np.testing.assert_array_equal(u64_numpy(got_e)[0], want_e)


def test_mul_table_refuses_bad_keys():
    tables = ntt_mxu8.Mxu8Tables64(ntt64.NttTables64(8, [Q50]))
    with pytest.raises(ValueError):
        tables.mul_table(torch.full((1, 256), Q50, dtype=torch.int64))
    with pytest.raises(ValueError):
        tables.mul_table(torch.zeros((2, 256), dtype=torch.int64))
    meta = torch.zeros((1, 1, 256), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt_mxu8.mxu8_roundtrip64_mul(tables, meta, torch.zeros((1, 2, 256), dtype=torch.int64))


@pytest.mark.parametrize("log_n,q", [(5, Q50), (4, Q62)])
def test_u64_helpers_match_reference(log_n, q):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    plan, jplan = build_plan64(log_n, q), jbuild_plan64(log_n, q)
    m, jm = barrett64(q), jbarrett64(q)
    a = rng.integers(0, q, (2, n), dtype=np.uint64)
    b = rng.integers(0, q, (2, n), dtype=np.uint64)
    ta, tb = u64_tensor(a), u64_tensor(b)

    got = ntt.negacyclic_mul64(plan, m, ta, tb)
    want = jfrom(jntt.negacyclic_mul64(jplan, jm, jto(a), jto(b)))
    np.testing.assert_array_equal(u64_numpy(got), want)
    got = ntt.pointwise_mul64(m, ta, tb)
    np.testing.assert_array_equal(u64_numpy(got), jfrom(jntt.pointwise_mul64(jm, jto(a), jto(b))))

    degs = np.array([[0], [1], [n - 1], [n], [2 * n - 1], [-3]])
    for neg in (False, True):
        got = ntt.monomial64(plan, torch.from_numpy(degs), negate=neg)
        np.testing.assert_array_equal(u64_numpy(got), jfrom(jntt.monomial64(jplan, degs, neg)))
    np.testing.assert_array_equal(u64_numpy(ntt.monomial64(plan, 5)),
                                  jfrom(jntt.monomial64(jplan, 5)))

    np.testing.assert_array_equal(u64_numpy(ntt.bit_reverse_permute(ta, log_n)),
                                  jfrom(jntt.bit_reverse_permute(jto(a), log_n)))
    for of in (1, 4):
        np.testing.assert_array_equal(
            u64_numpy(ntt.forward64_normal_order(plan, ta, of)),
            jfrom(jntt.forward64_normal_order(jplan, jto(a), of)))
    for of in (1, 2):
        np.testing.assert_array_equal(
            u64_numpy(ntt.inverse64_normal_order(plan, ta, of)),
            jfrom(jntt.inverse64_normal_order(jplan, jto(a), of)))


def test_normal_order32_match_reference():
    log_n, q = 6, 536813569
    rng = np.random.default_rng(3)
    x = rng.integers(0, q, (2, 1 << log_n), dtype=np.int64)
    plan, jplan = build_plan32(log_n, q), jbuild_plan32(log_n, q)
    xj = np.asarray(x, dtype=np.uint32)
    for of in (1, 4):
        np.testing.assert_array_equal(
            ntt.forward32_normal_order(plan, torch.from_numpy(x), of).numpy(),
            np.asarray(jntt.forward32_normal_order(jplan, xj, of)).astype(np.int64))
    for of in (1, 2):
        np.testing.assert_array_equal(
            ntt.inverse32_normal_order(plan, torch.from_numpy(x), of).numpy(),
            np.asarray(jntt.inverse32_normal_order(jplan, xj, of)).astype(np.int64))
