"""FHE noise samplers (binary, ternary, uniform, discrete Gaussian)."""

from .sampling import (
    DiscreteGaussian,
    sample_binary,
    sample_uniform,
    sample_uniform_u64,
    uniform_ternary,
    uniform_u32,
)

__all__ = ["DiscreteGaussian", "sample_binary", "sample_uniform", "sample_uniform_u64",
           "uniform_ternary", "uniform_u32"]
