"""FHE noise samplers (binary, uniform u32, discrete Gaussian)."""

from .sampling import DiscreteGaussian, sample_binary, uniform_u32

__all__ = ["DiscreteGaussian", "sample_binary", "uniform_u32"]
