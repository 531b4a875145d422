"""Port vs reference: the DCRT layer on bases of 5 and 6 moduli, past the
four that one u64 kernel launch takes (the wrappers launch once a group of
up to four, :func:`primus_fhe_tpu_torch.ops.ntt64.mod_groups`).

- ``build_dcrt_plan64`` and the forward and inverse transforms, plain and
  routed (``"auto"``, ``"butterfly"``, ``"mxu8"``: their plain versions on
  the CPU) at log_n 8 and the gadget's digits against JAX, ``RNSBase64``
  compose against the CRT on Python integers and decompose back;
- a short batched rotation (log_n 4, n_lwe 3, batch 2, one gadget level of
  2^25) on random key words, against JAX's ``dcrt_blind_rotate_batched``
  (its CRT compose included).

The moduli: five of 50 bits (``ntt_prime_chain(50, 12, 5)``, the first two
``bench_dcrt.py``'s) and six of 40 bits.  Both products take 8 limbs of 32
bits: JAX compiles its rotation (and its compose) once a shape, in time
that grows with the limbs (30-40 s a case here at 8, ~60 s at 10), not
with what the comparison covers.  Tolerance: zero (bit-equal words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot import dcrt_blind_rotate as jrot
from primus_fhe_tpu.decompose import BigUintApproxSignedBasis as JBasis
from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom, to_u64_pair as jto
from primus_fhe_tpu.rns import RNSBase64 as JBase
from primus_fhe_tpu.transforms import dcrt as jtd
from primus_fhe_tpu_torch.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
from primus_fhe_tpu_torch.decompose import BigUintApproxSignedBasis
from primus_fhe_tpu_torch.numeric.bigint import big_to_ints
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.ops.ntt64 import mod_groups
from primus_fhe_tpu_torch.rns import RNSBase64
from primus_fhe_tpu_torch.transforms import dcrt as td
from primus_fhe_tpu_torch.utils.primes import ntt_prime_chain


def _res(rng, moduli, shape):
    """Canonical residues ``(count, *shape)`` (u64 numpy)."""
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64) for q in moduli])


def _transforms(moduli, rng):
    log_n = 8
    plan, jplan = td.build_dcrt_plan64(log_n, moduli), jtd.build_dcrt_plan64(log_n, moduli)
    assert plan.count == len(moduli) and plan.ntt.moduli == tuple(moduli)
    x = _res(rng, moduli, (3, 1 << log_n))
    want_f = jfrom(jtd.dcrt_forward64(jplan, jto(x)))
    want_i = jfrom(jtd.dcrt_inverse64(jplan, jto(x)))
    np.testing.assert_array_equal(u64_numpy(td.dcrt_forward64(plan, u64_tensor(x))), want_f)
    np.testing.assert_array_equal(u64_numpy(td.dcrt_inverse64(plan, u64_tensor(x))), want_i)
    for route in td.ROUTES:
        np.testing.assert_array_equal(
            u64_numpy(td.dcrt_forward64_fast(plan, u64_tensor(x), route=route)), want_f)
        np.testing.assert_array_equal(
            u64_numpy(td.dcrt_inverse64_fast(plan, u64_tensor(x), route=route)), want_i)
    base, jbase = RNSBase64(moduli), JBase(moduli)
    assert (base.big_len, base.q_product) == (jbase.big_len, jbase.q_product)
    r = _res(rng, moduli, (16,))
    r[:, 0] = [q - 1 for q in moduli]
    big = base.compose(u64_tensor(r))
    Q = base.q_product
    for j in range(r.shape[1]):
        want = sum(int(r[i, j]) * (Q // q) * pow(Q // q, -1, q) for i, q in enumerate(moduli)) % Q
        assert big_to_ints(big[j:j + 1])[0] == want
    np.testing.assert_array_equal(u64_numpy(base.decompose(big)), r)
    basis, jbasis = BigUintApproxSignedBasis(base, 25), JBasis(jbase, 25)
    assert basis.decompose_length == jbasis.decompose_length
    got = basis.unsigned_decompose(big)
    want = jbasis.unsigned_decompose(jnp.asarray(big.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def _rotation(moduli, rng):
    log_n, n_lwe, k1, bsz = 4, 3, 2, 2
    n = 1 << log_n
    plan, jplan = td.build_dcrt_plan64(log_n, moduli), jtd.build_dcrt_plan64(log_n, moduli)
    base, jbase = RNSBase64(moduli), JBase(moduli)
    basis, jbasis = BigUintApproxSignedBasis(base, 25, 1), JBasis(jbase, 25, 1)
    level = basis.decompose_length
    bsk = np.stack([np.stack([np.stack([_res(rng, moduli, (k1, n)) for _ in range(level)])
                              for _ in range(k1)]) for _ in range(n_lwe)])
    accs = np.stack([_res(rng, moduli, (k1, n)) for _ in range(bsz)])
    lwes = rng.integers(0, 2 * n, (bsz, n_lwe + 1)).astype(np.int32)
    want = jfrom(jrot.dcrt_blind_rotate_batched(jplan, jbasis, jbase, jto(bsk), jnp.asarray(lwes),
                                                jto(accs)))
    got = dcrt_blind_rotate_batched(plan, basis, base, u64_tensor(bsk), torch.from_numpy(lwes),
                                    u64_tensor(accs))
    np.testing.assert_array_equal(u64_numpy(got), want)


@pytest.mark.parametrize("part", ["transforms", "rotation"])
@pytest.mark.parametrize("count", [5, 6])
def test_dcrt_past_four_moduli_matches_reference(count, part):
    moduli = ntt_prime_chain({5: 50, 6: 40}[count], 12, count)
    assert [(g.start, g.stop) for g in mod_groups(count)] == [(0, 4), (4, count)]
    {"transforms": _transforms, "rotation": _rotation}[part](
        moduli, np.random.default_rng(count))
