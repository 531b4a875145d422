"""The port's samplers, the host FFT oracle and the transform and polynomial
leftovers, against the JAX package.

- The torch-generator samplers (``sample_ternary``, the CRT-replicated
  samplers, ``DiscreteGaussian.sample_mod_u64``) are checked statistically
  on fixed seeds, in the style of ``tests/test_distr.py``: every frequency
  within 5 sigma of its probability, and each CRT slot holding the same
  logical draw.
- The host samplers (``DiscreteZiggurat``, ``HighPrecisionCDT``) and the
  complex FFT oracle run numpy code: their tables and outputs equal the
  JAX package's word for word on the same numpy ``Generator`` and inputs.
- ``TorusConvolver32.add_mul_lazy``, ``poly_mul_monomial32``,
  ``poly_rotate64``, ``dcrt_glwe_mul_poly``, ``dcrt_glwe_butterfly_mul``,
  ``ntru_phase`` and ``rotate_poly_q`` equal the JAX functions on the same
  seeded inputs (exact integers).
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primus_fhe_tpu.boot import ntru_blind_rotate as jnbr
from primus_fhe_tpu.distr import sampling as jsampling
from primus_fhe_tpu.distr import ziggurat as jzig
from primus_fhe_tpu.lattice import dcrt as jdcrt
from primus_fhe_tpu.numeric.limb import from_u64_pair as jfrom
from primus_fhe_tpu.numeric.limb import to_u64_pair as jto
from primus_fhe_tpu.poly import poly as jpoly
from primus_fhe_tpu.rns import RNSBase64 as JBase
from primus_fhe_tpu.transforms.fft import Complex128FftTable as JFft
from primus_fhe_tpu.transforms.torus import TorusConvolver32 as JConv
from primus_fhe_tpu_torch.boot import ntru_blind_rotate as nbr
from primus_fhe_tpu_torch.distr import sampling, ziggurat
from primus_fhe_tpu_torch.lattice import dcrt
from primus_fhe_tpu_torch.numeric.limb import u64_numpy, u64_tensor
from primus_fhe_tpu_torch.poly import poly
from primus_fhe_tpu_torch.rns import RNSBase64
from primus_fhe_tpu_torch.transforms import Complex128FftTable
from primus_fhe_tpu_torch.transforms.torus import TorusConvolver32

Q = 536813569
DRAWS = 1 << 16
MODULI = (1125899906826241, 1125899906629633)  # bench_dcrt.py's 2 x 50 bits


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _near(count: int, p: float, draws: int = DRAWS):
    sigma = math.sqrt(draws * p * (1 - p))
    assert abs(count - draws * p) < 5 * sigma, (count, draws * p, sigma)


@pytest.mark.parametrize("q", [Q, 97])
def test_sample_ternary_frequencies(q):
    t = sampling.sample_ternary(_gen(q), (DRAWS,), q)
    assert t.dtype == torch.int64 and set(t.unique().tolist()) <= {0, 1, q - 1}
    for value, p in ((0, 0.5), (1, 0.25), (q - 1, 0.25)):
        _near(int((t == value).sum()), p)
    # the reference's construction on the same kind of draw: two uniform bits
    j = np.asarray(jsampling.sample_ternary(__import__("jax").random.PRNGKey(3), (DRAWS,), q))
    for value, p in ((0, 0.5), (1, 0.25), (q - 1, 0.25)):
        _near(int((j == value).sum()), p)


def test_crt_samplers_replicate_one_draw():
    qcol = torch.tensor(MODULI).unsqueeze(1)
    bits = sampling.sample_crt_binary(_gen(1), (DRAWS,), MODULI)
    assert bits.shape == (2, DRAWS) and torch.equal(bits[0], bits[1])
    _near(int(bits[0].sum()), 0.5)
    tern = sampling.sample_crt_ternary(_gen(2), (DRAWS,), torch.tensor(MODULI))
    signed = torch.where(tern == qcol - 1, -1, tern)
    assert torch.equal(signed[0], signed[1]) and int(signed.abs().max()) == 1
    for value, p in ((0, 0.5), (1, 0.25), (-1, 0.25)):
        _near(int((signed[0] == value).sum()), p)
    gauss = sampling.DiscreteGaussian(3.2)
    gs = sampling.sample_crt_gaussian(_gen(3), (DRAWS,), MODULI, gauss)
    cent = torch.where(gs > qcol // 2, gs - qcol, gs)
    assert torch.equal(cent[0], cent[1]) and int(cent.abs().max()) < 40
    _near(int((cent[0] == 0).sum()), 1 / (3.2 * math.sqrt(2 * math.pi)))
    assert abs(cent[0].double().std().item() - 3.2) < 5 * 3.2 / math.sqrt(2 * DRAWS)
    # the JAX slots follow the same rule: -1 as q_i - 1, a negative s as q_i + s
    jt = np.asarray(jsampling.sample_crt_ternary(__import__("jax").random.PRNGKey(4), (64,),
                                                 jnp.asarray(np.array([97, Q], np.uint32))))
    assert jt.shape == (2, 64) and np.array_equal(jt[0] == 96, jt[1] == Q - 1)


def test_sample_mod_u64_wraps():
    gauss = sampling.DiscreteGaussian(3.2)
    q = (1 << 62) - 57
    u = gauss.sample_mod_u64(_gen(5), (DRAWS,), q)
    cent = torch.where(u > q // 2, u - q, u)
    assert int(cent.abs().max()) < 40 and int((u < 0).sum()) == 0
    _near(int((cent < 0).sum()), (1 - 1 / (3.2 * math.sqrt(2 * math.pi))) / 2)


@pytest.mark.parametrize("sigma", [25.0, 300.0])
def test_ziggurat_word_for_word(sigma):
    z, jz = ziggurat.DiscreteZiggurat(sigma), jzig.DiscreteZiggurat(sigma)
    assert z.m == jz.m and np.array_equal(z.x, jz.x) and np.array_equal(z.y, jz.y)
    got = z.sample_signed(np.random.default_rng(11), (4000,))
    want = jz.sample_signed(np.random.default_rng(11), (4000,))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(z.sample_mod(7, (64,), Q), jz.sample_mod(7, (64,), Q))
    assert abs(got.std() - sigma) < 0.05 * sigma


def test_high_precision_cdt_and_dispatch():
    c, jc = ziggurat.HighPrecisionCDT(3.2), jzig.HighPrecisionCDT(3.2)
    assert c.cdt_int == jc.cdt_int
    np.testing.assert_array_equal(c.sample_signed(np.random.default_rng(2), (2000,)),
                                  jc.sample_signed(np.random.default_rng(2), (2000,)))
    np.testing.assert_array_equal(c.sample_mod(3, (64,), Q), jc.sample_mod(3, (64,), Q))
    assert isinstance(ziggurat.make_discrete_gaussian(3.2), sampling.DiscreteGaussian)
    assert isinstance(ziggurat.make_discrete_gaussian(25.0), ziggurat.DiscreteZiggurat)
    with pytest.raises(ValueError, match="0.7"):
        ziggurat.make_discrete_gaussian(0.5)
    # a torch.Generator seeds numpy by its initial seed
    np.testing.assert_array_equal(c.sample_signed(_gen(9), (32,)),
                                  c.sample_signed(np.random.default_rng(9), (32,)))


def test_fft_oracle_word_for_word():
    rng = random.Random(31415)
    for log_n, bits_a, bits_b in ((5, 16, 12), (6, 24, 8)):
        n = 1 << log_n
        t, jt = Complex128FftTable(log_n), JFft(log_n)
        a = np.array([rng.getrandbits(bits_a) for _ in range(n)], dtype=np.uint32)
        b = np.array([rng.getrandbits(bits_b) for _ in range(n)], dtype=np.uint32)
        np.testing.assert_array_equal(t.forward_torus(_t(a)), jt.forward_torus(a))
        np.testing.assert_array_equal(t.negacyclic_mul(a, b), jt.negacyclic_mul(a, b))
        np.testing.assert_array_equal(t.inverse_torus(t.forward_torus(a)), a)
    a64 = np.array([rng.getrandbits(40) for _ in range(32)], dtype=np.uint64)
    np.testing.assert_array_equal(Complex128FftTable(5).negacyclic_mul(a64, a64, bits=64),
                                  JFft(5).negacyclic_mul(a64, a64, bits=64))
    with pytest.raises(ValueError):
        Complex128FftTable(60)


def test_torus_add_mul_lazy():
    conv, jconv = TorusConvolver32(5, 45), JConv(5, 45)
    assert conv.primes == list(jconv.primes)
    rng = np.random.default_rng(12)
    col = np.array(conv.primes, dtype=np.uint64)[:, None, None]
    acc, fa, fb = ((rng.integers(0, 1 << 30, (conv.count, 3, 32)) % col).astype(np.uint32)
                   for _ in range(3))
    want = np.asarray(jconv.add_mul_lazy(jnp.asarray(acc), jnp.asarray(fa), jnp.asarray(fb), 2))
    np.testing.assert_array_equal(conv.add_mul_lazy(_t(acc), _t(fa), _t(fb), 2).numpy(), want)
    np.testing.assert_array_equal(conv.add_mul_lazy(_t(acc), _t(fa), _t(fb)).numpy(), want)


def test_poly_monomial32_and_rotate64():
    rng = np.random.default_rng(13)
    a = rng.integers(0, Q, (3, 32), dtype=np.uint64).astype(np.uint32)
    for d in (-70, 33):
        np.testing.assert_array_equal(
            poly.poly_mul_monomial32(_t(a), d, Q).numpy(),
            np.asarray(jpoly.poly_mul_monomial32(jnp.asarray(a), d, jnp.uint32(Q))))
    q64 = MODULI[0]
    a64 = rng.integers(0, q64, (3, 32), dtype=np.uint64)
    degs = np.array([-5, 17, 40], dtype=np.int32)
    got = poly.poly_rotate64(u64_tensor(a64), torch.from_numpy(degs), q64)
    want = jfrom(jpoly.poly_rotate64(jto(a64), jnp.asarray(degs), jto(np.uint64(q64))))
    np.testing.assert_array_equal(u64_numpy(got), want)


def test_dcrt_glwe_mul_poly_and_butterfly():
    base, jbase = RNSBase64(MODULI), JBase(list(MODULI))
    rng = np.random.default_rng(14)
    col = np.array(MODULI, dtype=np.uint64)
    acc, rhs = (rng.integers(0, 1 << 62, (2, 2, 16), dtype=np.uint64) % col[:, None, None]
                for _ in range(2))
    p = rng.integers(0, 1 << 62, (2, 16), dtype=np.uint64) % col[:, None]
    got = dcrt.dcrt_glwe_mul_poly(u64_tensor(acc), u64_tensor(p), base)
    want = jfrom(jdcrt.dcrt_glwe_mul_poly(jto(acc), jto(p), jbase))
    np.testing.assert_array_equal(u64_numpy(got), want)
    s, m = dcrt.dcrt_glwe_butterfly_mul(u64_tensor(acc), u64_tensor(rhs), u64_tensor(p), base)
    js, jm = jdcrt.dcrt_glwe_butterfly_mul(jto(acc), jto(rhs), jto(p), jbase)
    np.testing.assert_array_equal(u64_numpy(s), jfrom(js))
    np.testing.assert_array_equal(u64_numpy(m), jfrom(jm))


def test_ntru_phase_and_rotate_poly_q():
    q = 1038337  # NTRU_128's q, at N = 32
    jctx = jnbr.make_ntru_context(5, q, 3, 6)
    ctx = nbr.make_ntru_context(5, q, 3, 6)
    jsk = jnbr.ntru_keygen(__import__("jax").random.PRNGKey(5), jctx)
    sk = nbr.NtruSecret(_t(jsk.f), _t(jsk.f_ntt), _t(jsk.f_inv_ntt))
    c = np.random.default_rng(15).integers(0, q, (3, 32)).astype(np.uint32)
    np.testing.assert_array_equal(nbr.ntru_phase(ctx, sk, _t(c)).numpy(),
                                  np.asarray(jnbr.ntru_phase(jctx, jsk, jnp.asarray(c))))
    np.testing.assert_array_equal(nbr.rotate_poly_q(_t(c), 37, 32, q).numpy(),
                                  np.asarray(jnbr.rotate_poly_q(jnp.asarray(c), 37, 32,
                                                                jnp.uint32(q))))
