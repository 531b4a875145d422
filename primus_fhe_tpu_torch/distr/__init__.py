"""FHE noise samplers (binary, ternary, uniform, discrete Gaussian, CRT
replicated) and the host large-sigma samplers."""

from .sampling import (
    DiscreteGaussian,
    sample_binary,
    sample_crt_binary,
    sample_crt_gaussian,
    sample_crt_ternary,
    sample_ternary,
    sample_uniform,
    sample_uniform_u64,
    uniform_ternary,
    uniform_u32,
)
from .ziggurat import DiscreteZiggurat, HighPrecisionCDT, make_discrete_gaussian

__all__ = [
    "DiscreteGaussian", "DiscreteZiggurat", "HighPrecisionCDT", "make_discrete_gaussian",
    "sample_binary", "sample_crt_binary", "sample_crt_gaussian", "sample_crt_ternary",
    "sample_ternary", "sample_uniform", "sample_uniform_u64", "uniform_ternary", "uniform_u32",
]
