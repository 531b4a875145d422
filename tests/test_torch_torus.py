"""Port vs reference: ``TorusConvolver32`` lift, forward, inverse, integer-CRT
recombine and negacyclic product at log_n=8.  Tolerance: zero (bit-equal;
lazy forward outputs compared mod p and in range)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.golden.model import naive_negacyclic_mul
from primus_fhe_tpu.lattice import tfhe as jtfhe
from primus_fhe_tpu_torch.lattice import tfhe

LOG_N = 8
N = 1 << LOG_N


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.fixture(scope="module")
def convs():
    return tfhe.make_convolver(LOG_N, 3, 1, 7), jtfhe.make_convolver(LOG_N, 3, 1, 7)


def test_primes_and_crt_constants(convs):
    conv, jconv = convs
    assert conv.primes == list(jconv.primes)
    assert conv.product == jconv.product
    np.testing.assert_array_equal(conv.inv_punctured.value.numpy(), _np(jconv.inv_punctured.value))
    np.testing.assert_array_equal(
        conv.inv_punctured.quotient.numpy(), _np(jconv.inv_punctured.quotient)
    )
    assert conv.punctured_mod_t == _np(jconv.punctured_mod_t).tolist()


def test_lift_forward_inverse_recombine(convs):
    conv, jconv = convs
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 32, (3, 2, N), dtype=np.uint64).astype(np.uint32)
    x[0, 0, :4] = [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    lifted = conv.lift(_t(x))
    np.testing.assert_array_equal(lifted.numpy(), _np(jconv.lift(jnp.asarray(x))))
    f = conv.forward(_t(x))
    jf = jconv.forward(jnp.asarray(x))
    np.testing.assert_array_equal(f.numpy(), _np(jf))
    lazy = conv.forward(_t(x), 4).numpy()
    for i, p in enumerate(conv.primes):
        assert (lazy[i] < 4 * p).all()
        np.testing.assert_array_equal(lazy[i] % p, f[i].numpy())
    inv = conv.inverse(f)
    np.testing.assert_array_equal(inv.numpy(), _np(jconv.inverse(jf)))
    # random canonical residues exercise every CRT branch, not just lifts
    res = np.stack(
        [rng.integers(0, p, (3, N), dtype=np.uint64) for p in conv.primes]
    ).astype(np.uint32)
    np.testing.assert_array_equal(
        conv.recombine(_t(res)).numpy(), _np(jconv.recombine(jnp.asarray(res)))
    )
    np.testing.assert_array_equal(conv.recombine(inv).numpy(), x.astype(np.int64))


def test_negacyclic_mul(convs):
    conv, jconv = convs
    rng = np.random.default_rng(9)
    a = rng.integers(0, 1 << 32, (2, N), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(-128, 129, (2, N)).astype(np.int64) % (1 << 32)  # small, like digits
    got = conv.negacyclic_mul(_t(a), _t(b))
    want = _np(jconv.negacyclic_mul(jnp.asarray(a), jnp.asarray(b.astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = naive_negacyclic_mul([int(v) for v in a[0]], [int(v) for v in b[0]], 1 << 32)
    np.testing.assert_array_equal(got[0].numpy(), np.array(exact, dtype=np.int64))


def test_glwe_phase_and_encrypt(convs):
    """``phase_torus`` per ciphertext equals the reference's (which is only
    right unbatched), a batch equals its rows, and a port encryption
    decrypts to its message within the noise (sigma 3.2: |e| < 64)."""
    from primus_fhe_tpu.lattice import glwe as jglwe
    from primus_fhe_tpu_torch.distr.sampling import DiscreteGaussian
    from primus_fhe_tpu_torch.lattice import glwe

    conv, jconv = convs
    rng = np.random.default_rng(12)
    secret = rng.integers(0, 2, (1, N)).astype(np.uint32)
    ct = rng.integers(0, 1 << 32, (3, 2, N), dtype=np.uint64).astype(np.uint32)
    batched = glwe.phase_torus(_t(ct), _t(secret), conv).numpy()
    for i in range(3):
        want = _np(jglwe.phase_torus(jnp.asarray(ct[i]), jnp.asarray(secret), jconv))
        np.testing.assert_array_equal(batched[i], want)
        np.testing.assert_array_equal(glwe.phase_torus(_t(ct[i]), _t(secret), conv).numpy(), want)
    g = torch.Generator().manual_seed(12)
    msg = _t(rng.integers(0, 1 << 32, N, dtype=np.uint64))
    enc = glwe.encrypt_torus(msg, _t(secret), DiscreteGaussian(3.2), conv, g)
    err = (glwe.phase_torus(enc, _t(secret), conv) - msg) & 0xFFFFFFFF
    err = torch.where(err >= 1 << 31, err - (1 << 32), err)
    assert int(err.abs().max()) < 64
