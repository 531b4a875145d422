"""The port's samplers on a ``torch.Generator``, held to the reference
statistically (torch and jax.random draw different numbers): the CDT path
at sigma 3.2 and the rounded-continuous path at BOOLEAN_128's lwe_sigma
2^18.6, in the style of ``tests/test_distr.py``; and the NTRU path's
samplers: uniform mod q, ``sample_mod`` at NTRU_128's sigmas (0.5, 52)
beside the reference's, and the ternary draw of the NTRU secret.  The CDT
table itself is bit-equal to the reference's."""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.distr.stats import max_cdf_distance, sample_moments
from primus_fhe_tpu.params import BOOLEAN_128, NTRU_128
from primus_fhe_tpu_torch.distr import (
    DiscreteGaussian,
    sample_binary,
    sample_uniform,
    uniform_ternary,
    uniform_u32,
)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_binary_and_uniform():
    s = sample_binary(_gen(1), (20000,)).numpy()
    assert set(np.unique(s)) <= {0, 1}
    assert abs(s.mean() - 0.5) < 0.02
    u = uniform_u32(_gen(2), (20000,)).numpy()
    assert u.min() >= 0 and u.max() < 1 << 32
    assert abs(u.mean() / 2**32 - 0.5) < 0.02
    assert abs((u >> 31).mean() - 0.5) < 0.02  # top bit is drawn too


def test_cdt_table_matches_reference():
    port = DiscreteGaussian(3.2)
    ref = JaxGaussian(3.2)
    hi = np.asarray(ref.cdf_hi).astype(object)
    lo = np.asarray(ref.cdf_lo).astype(object)
    want = [int(h) * 2**32 + int(l) - 2**63 for h, l in zip(hi, lo)]
    assert port.cdf_shifted.tolist() == want
    np.testing.assert_array_equal(port.offsets, np.asarray(ref.offsets))


def test_cdt_moments():
    """Tolerances as in tests/test_distr.py: |mean| < 0.1, |var - s^2| < 0.5,
    CDF distance < 0.02 over 40000 samples."""
    s = DiscreteGaussian(3.2).sample_signed(_gen(3), (40000,)).numpy()
    mean, var = sample_moments(s)
    assert abs(mean) < 0.1
    assert abs(var - 3.2**2) < 0.5
    assert max_cdf_distance(s, 3.2, 20) < 0.02


def test_rounded_continuous_moments():
    """BOOLEAN_128's lwe_sigma takes the rounded-continuous path: mean
    within 2% of sigma, stddev within 2%, torus wrap sign-extends
    (tolerances of tests/test_security.py)."""
    sigma = BOOLEAN_128.lwe_sigma
    g = DiscreteGaussian(sigma)
    assert g.offsets is None
    s = g.sample_signed(_gen(4), (200_000,)).numpy()
    assert abs(s.mean()) < sigma * 0.02
    assert s.std() == pytest.approx(sigma, rel=0.02)
    t = g.sample_torus32(_gen(5), (1000,)).numpy()
    assert t.min() >= 0 and t.max() < 1 << 32
    t = np.where(t >= 1 << 31, t - (1 << 32), t)
    assert abs(t).max() < 12 * sigma


def test_samplers_follow_the_generator():
    """Same seed, same draws; the generator's device is the output's."""
    g = DiscreteGaussian(3.2)
    a = g.sample_torus32(_gen(7), (64,))
    b = g.sample_torus32(_gen(7), (64,))
    assert torch.equal(a, b)
    assert a.device == torch.device("cpu")


@pytest.mark.parametrize("q", [NTRU_128.q, 7, 1073692673])
def test_uniform_mod_q(q):
    """Range [0, q), mean (q-1)/2 within 1%, and for a small q every
    residue near its 1/q share (the reference's 64-bit multiply-shift)."""
    u = sample_uniform(_gen(11), (60000,), q).numpy()
    assert u.min() >= 0 and u.max() < q
    assert abs(u.mean() - (q - 1) / 2) < 0.01 * q
    if q < 100:
        freq = np.bincount(u, minlength=q) / u.size
        assert np.abs(freq - 1 / q).max() < 0.01


@pytest.mark.parametrize("sigma", [NTRU_128.sigma, NTRU_128.lwe_sigma])
def test_sample_mod_matches_reference_distribution(sigma):
    """``sample_mod`` wraps signed samples into [0, q): the centered draws
    have the reference's support and moments (the reference's own samples
    beside them, 40000 each)."""
    import jax

    q = NTRU_128.q
    port = DiscreteGaussian(sigma).sample_mod(_gen(12), (40000,), q).numpy()
    ref = np.asarray(JaxGaussian(sigma).sample_mod(jax.random.PRNGKey(12), (40000,), q))
    assert port.min() >= 0 and port.max() < q
    centered = [np.where(x > q // 2, x.astype(np.int64) - q, x) for x in (port, ref)]
    for c in centered:
        assert abs(c.mean()) < 0.05 * max(sigma, 1)
    assert centered[0].std() == pytest.approx(centered[1].std(), rel=0.03)
    assert abs(centered[0]).max() <= 10 * sigma + 1


def test_ternary_draw():
    """The NTRU secret's f' is uniform on {-1, 0, 1} (as the reference's
    ``integers(-1, 2)``)."""
    t = uniform_ternary(_gen(13), (60000,)).numpy()
    assert set(np.unique(t)) == {-1, 0, 1}
    for v in (-1, 0, 1):
        assert abs((t == v).mean() - 1 / 3) < 0.01
