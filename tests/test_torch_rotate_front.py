"""Port vs reference: kernel F (``ops/rotate.py``), kernel G
(``ops/cmux_front.py``) and ``lattice/tfhe.cmux_delta``.

- ``rotate`` (the plain version on a CPU tensor) against ``pallas_rotate``
  in interpret mode, with and without ``subtract``, at the shapes of
  ``tests/test_pallas_ntt.py:104-125``; negative and large degrees wrap mod
  2N as the reference's ``% (2N)`` does;
- ``cmux_front`` against ``pallas_cmux_front`` (interpret mode) at TOY
  widths (N=32, k=1, 2^8 x 3) and at a 2^1 x 12 gadget;
- ``cmux_delta`` against the JAX ``cmux_delta`` at TOY widths, and the
  kernel path's composition (kernel G, then kernel 1's forward at
  ``out_factor=4``, then the external-product tail) built here from the
  plain versions gives the same words; ``acc + cmux_delta`` equals one
  ``fused_cmux_step``.

Inputs from a numpy seed; tolerance zero (bit-equal words).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.decompose import ApproxSignedBasis32 as JaxBasis
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu.ops.cmux_pallas import pallas_cmux_front
from primus_fhe_tpu.ops.rotate_pallas import pallas_rotate
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis32
from primus_fhe_tpu_torch.lattice import tfhe
from primus_fhe_tpu_torch.numeric.limb import MASK32
from primus_fhe_tpu_torch.ops import cmux_front, cmux_fused, ntt32, rotate


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_rotate_matches_pallas_rotate():
    n = 64
    rng = np.random.default_rng(5)
    v = rng.integers(0, 1 << 32, (3, 2, n), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([0, 7, 2 * n - 1], dtype=np.int32)
    for subtract in (False, True):
        want = np.asarray(pallas_rotate(jnp.asarray(v), jnp.asarray(degrees), n, subtract))
        got = rotate.rotate(_t(v), torch.from_numpy(degrees), subtract)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        got32 = rotate.rotate(_t(v).to(torch.int32), torch.from_numpy(degrees), subtract)
        assert got32.dtype == torch.int32
        np.testing.assert_array_equal((got32.to(torch.int64) & MASK32).numpy(), want)
    # any sign and size of degree is taken mod 2N
    shifted = torch.tensor([-2 * n, 7 - 6 * n, (1 << 40) + 2 * n - 1])
    np.testing.assert_array_equal(rotate.rotate(_t(v), shifted).numpy(),
                                  rotate.rotate(_t(v), torch.from_numpy(degrees)).numpy())
    with pytest.raises(ValueError):
        rotate.rotate(torch.zeros((1, 2, n), dtype=torch.int64, device="meta"),
                      torch.zeros(1, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("log_basis,level", [(8, 3), (1, 12)])
def test_cmux_front_matches_pallas(log_basis, level):
    n, k1 = 32, 2
    conv = tfhe.make_convolver(5, level, 1, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    jbasis = JaxBasis(None, log_basis, reverse_length=level)
    rng = np.random.default_rng(log_basis)
    acc = rng.integers(0, 1 << 32, (3, k1, n), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([0, 5, 2 * n - 1], dtype=np.int32)
    want = np.asarray(pallas_cmux_front(jnp.asarray(acc), jnp.asarray(degrees), jbasis,
                                        tuple(conv.primes), n))
    got = cmux_front.cmux_front(_t(acc), torch.from_numpy(degrees), basis, conv.primes)
    assert got.shape == (conv.count, 3, k1, level, n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    got32 = cmux_front.cmux_front(_t(acc).to(torch.int32), torch.from_numpy(degrees), basis,
                                  conv.primes)
    np.testing.assert_array_equal(got32.numpy().astype(np.int64), want.astype(np.int64))


def test_cmux_delta_matches_reference():
    n, k1, level, log_basis = 32, 2, 3, 8  # TOY
    conv = tfhe.make_convolver(5, level, 1, log_basis)
    jconv = jtfhe.make_convolver(5, level, 1, log_basis)
    basis = ApproxSignedBasis32(None, log_basis, reverse_length=level)
    jbasis = JaxBasis(None, log_basis, reverse_length=level)
    rng = np.random.default_rng(9)
    acc = rng.integers(0, 1 << 32, (3, k1, n), dtype=np.uint64).astype(np.uint32)
    degrees = np.array([1, n, 2 * n - 3], dtype=np.int32)
    key = np.stack([rng.integers(0, p, (k1, level, k1, n)) for p in conv.primes])
    want = np.asarray(jtfhe.cmux_delta(jconv, jbasis, jnp.asarray(acc), jnp.asarray(degrees),
                                       jnp.asarray(key.astype(np.uint32))))
    got = tfhe.cmux_delta(conv, basis, _t(acc), torch.from_numpy(degrees), _t(key))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the card's composition: kernel G, kernel 1 (lazy), the tail
    res = cmux_front.cmux_front(_t(acc), torch.from_numpy(degrees), basis, conv.primes)
    f = ntt32.forward32(conv.ntt, res, 4)
    composed = tfhe._external_product_tail(conv, f, _t(key), 1)
    np.testing.assert_array_equal(composed.numpy(), want.astype(np.int64))
    step = cmux_fused.fused_cmux_step(conv, basis, _t(acc), torch.from_numpy(degrees),
                                      _t(key))
    np.testing.assert_array_equal(step.numpy(), (acc.astype(np.int64) + want) & MASK32)
