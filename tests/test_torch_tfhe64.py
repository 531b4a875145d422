"""Port vs the JAX package: the 64-bit torus tier
(``primus_fhe_tpu_torch/decompose/primitive.ApproxSignedBasis64``,
``transforms/torus.TorusConvolver64``, ``lattice/tfhe64.py``), on the cases
of ``tests/test_decompose.py:80-98``, ``tests/test_torus64.py`` and
``tests/test_tfhe64.py``; u64 words carried as int64 bit patterns, with
values past 2^63 (the top bit set) in every case.

- ``ApproxSignedBasis64`` digits: the torus basis 2^16 x 2 on full 64-bit
  values, 2^16 x 4 (no dropped bits), and the mod-q basis 2^10 over the
  50-bit prime: the JAX's words;
- ``TorusConvolver64``: lift, forward (both ``out_factor``s), inverse and
  recombine the JAX's words; the full-range negacyclic product (five primes:
  two kernel groups) against the JAX's and a schoolbook product mod 2^64;
- ``external_product64`` with a trivial GGSW(1) and GGSW(X^3): the JAX's
  words, the identity on full-range words and the negacyclic shift.

Tolerance: zero (exact integers).
"""

import random

import numpy as np
import pytest

from primus_fhe_tpu.decompose import ApproxSignedBasis64 as JBasis64
from primus_fhe_tpu.lattice import tfhe64 as jtfhe64
from primus_fhe_tpu.numeric import from_u64_pair as jfrom
from primus_fhe_tpu.numeric import to_u64_pair as jto
from primus_fhe_tpu.transforms.torus import TorusConvolver64 as JConv64
from primus_fhe_tpu_torch.decompose import ApproxSignedBasis64
from primus_fhe_tpu_torch.lattice import tfhe64
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver64

M64 = 1 << 64


def _words(rng, shape, bits=64):
    return np.array([rng.getrandbits(bits) for _ in range(int(np.prod(shape)))],
                    dtype=np.uint64).reshape(shape)


@pytest.mark.parametrize("modulus,log_basis,length", [
    (None, 16, 2), (None, 16, 4), (1125899906826241, 10, None)])
def test_approx_signed_basis64_matches_jax(modulus, log_basis, length):
    rng = random.Random(64 + log_basis)
    basis = ApproxSignedBasis64(modulus, log_basis, reverse_length=length)
    jbasis = JBasis64(modulus, log_basis, reverse_length=length)
    assert basis.scalars == jbasis.scalars and basis.drop_bits == jbasis.drop_bits
    if modulus is None:
        vals = _words(rng, (64,))
        vals[:4] = [0, M64 - 1, 1 << 63, (1 << 63) - 1]
    else:
        vals = np.array([rng.randrange(modulus) for _ in range(64)] + [modulus - 1],
                        dtype=np.uint64)
    got = u64_numpy(basis.decompose(u64_tensor(vals)))
    np.testing.assert_array_equal(got, jfrom(jbasis.decompose(jto(vals))))


def _naive(a, b):
    n = len(a)
    signed = [int(x) - M64 if int(x) >= M64 // 2 else int(x) for x in (*a, *b)]
    sa, sb = signed[:n], signed[n:]
    out = [0] * n
    for i in range(n):
        for j in range(n):
            if i + j < n:
                out[i + j] += sa[i] * sb[j]
            else:
                out[i + j - n] -= sa[i] * sb[j]
    return [v % M64 for v in out]


def test_torus_convolver64_matches_jax():
    rng = random.Random(646)
    log_n, n = 4, 16
    conv, jconv = TorusConvolver64(log_n, bound_bits=131), JConv64(log_n, bound_bits=131)
    assert conv.primes == jconv.primes and conv.count == 5
    a, b = _words(rng, (n,)), _words(rng, (n,))
    a[:3] = [M64 - 1, 1 << 63, 0]
    ta = u64_tensor(a)
    np.testing.assert_array_equal(conv.lift(ta).numpy(), np.asarray(jconv.lift(jto(a))))
    for of in (1, 4):
        np.testing.assert_array_equal(conv.forward(ta, of).numpy(),
                                      np.asarray(jconv.forward(jto(a), of)))
    res = conv.inverse(conv.forward(ta))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jconv.inverse(jconv.forward(jto(a)))))
    np.testing.assert_array_equal(u64_numpy(conv.recombine(res)), a)
    got = u64_numpy(conv.negacyclic_mul(ta, u64_tensor(b)))
    np.testing.assert_array_equal(got, jfrom(jconv.negacyclic_mul(jto(a), jto(b))))
    assert got.astype(object).tolist() == _naive(a, b)


def _trivial_ggsw64(basis, mu_poly, k, n):
    """Noise-free GGSW(mu): row r level l = mu * scalar_l at component r."""
    out = np.zeros((k + 1, basis.decompose_length, k + 1, n), dtype=object)
    for r in range(k + 1):
        for lvl in range(basis.decompose_length):
            out[r, lvl, r] = (mu_poly * basis.scalars[lvl]) % M64
    return out.astype(np.uint64)


@pytest.mark.parametrize("shift", [0, 3])
def test_external_product64_matches_jax(shift):
    rng = random.Random(6464 + shift)
    log_n, n, k, lb, lv = 4, 16, 1, 16, 4
    basis, jbasis = ApproxSignedBasis64(None, lb, reverse_length=lv), JBasis64(
        None, lb, reverse_length=lv)
    conv, jconv = tfhe64.make_convolver64(log_n, lv, k, lb), jtfhe64.make_convolver64(
        log_n, lv, k, lb)
    mu = np.zeros(n, dtype=object)
    mu[shift] = 1
    ggsw = _trivial_ggsw64(basis, mu, k, n)
    key = tfhe64.ggsw_to_ntt64(conv, u64_tensor(ggsw))
    jkey = jtfhe64.ggsw_to_ntt64(jconv, jto(ggsw))
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    glwe = _words(rng, (2, k + 1, n))
    glwe[0, 0, :2] = [M64 - 1, 1 << 63]
    got = u64_numpy(tfhe64.external_product64(conv, basis, u64_tensor(glwe), key))
    np.testing.assert_array_equal(got, jfrom(jtfhe64.external_product64(jconv, jbasis, jto(glwe),
                                                                        jkey)))
    want = np.zeros_like(glwe, dtype=object)
    for j in range(n):  # glwe * X^shift, negacyclic
        src = glwe[..., j].astype(object)
        if j + shift < n:
            want[..., j + shift] = src
        else:
            want[..., j + shift - n] = (-src) % M64
    assert (got.astype(object) == want).all()
