"""Statistical validation helpers for samplers (a host copy of
``primus_fhe_tpu/distr/stats.py``, numpy only, so that a sampler check on a
machine without JAX has its own).

Reference: ``crates/primus_distr/src/stats.rs:64,138`` and the shipped
validation executables (``examples/check_gaussian.rs``,
``examples/compare_samplers.rs``) — moment checks and CDF distances, used
by tests rather than asserted in production.
"""

from __future__ import annotations

import numpy as np


def sample_moments(samples) -> tuple[float, float]:
    """(mean, variance) of a signed sample array."""
    s = np.asarray(samples, dtype=np.float64)
    return float(s.mean()), float(s.var())


def discrete_gaussian_pmf(sigma: float, max_t: int) -> np.ndarray:
    """Normalized pmf of the discrete Gaussian on [-max_t, max_t]."""
    t = np.arange(-max_t, max_t + 1)
    w = np.exp(-(t.astype(np.float64) ** 2) / (2 * sigma**2))
    return w / w.sum()


def max_cdf_distance(samples, sigma: float, max_t: int) -> float:
    """Kolmogorov-Smirnov-style distance between empirical and ideal CDFs."""
    s = np.asarray(samples, dtype=np.int64)
    pmf = discrete_gaussian_pmf(sigma, max_t)
    ideal_cdf = np.cumsum(pmf)
    t = np.arange(-max_t, max_t + 1)
    emp_cdf = np.array([(s <= x).mean() for x in t])
    return float(np.abs(emp_cdf - ideal_cdf).max())


def chi2_statistic(samples, sigma: float, max_t: int) -> float:
    """Pearson chi-squared statistic against the ideal pmf."""
    s = np.asarray(samples, dtype=np.int64)
    pmf = discrete_gaussian_pmf(sigma, max_t)
    n = len(s)
    stat = 0.0
    for x, p in zip(range(-max_t, max_t + 1), pmf):
        if p * n < 5:
            continue
        observed = (s == x).sum()
        stat += (observed - n * p) ** 2 / (n * p)
    return float(stat)
