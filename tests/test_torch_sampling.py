"""The port's samplers on a ``torch.Generator``, held to the reference
statistically (torch and jax.random draw different numbers): the CDT path
at sigma 3.2 and the rounded-continuous path at BOOLEAN_128's lwe_sigma
2^18.6, in the style of ``tests/test_distr.py``.  The CDT table itself is
bit-equal to the reference's."""

import numpy as np
import pytest
import torch

from primus_fhe_tpu.distr.sampling import DiscreteGaussian as JaxGaussian
from primus_fhe_tpu.distr.stats import max_cdf_distance, sample_moments
from primus_fhe_tpu.params import BOOLEAN_128
from primus_fhe_tpu_torch.distr import DiscreteGaussian, sample_binary, uniform_u32


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
