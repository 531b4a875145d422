"""32-bit NTT plans, plain transforms, the torus convolver and the host FFT oracle."""

from .fft import Complex128FftTable
from .ntt import forward32, inverse32
from .plan import NttPlan32, build_plan32
from .torus import TorusConvolver32

__all__ = ["Complex128FftTable", "NttPlan32", "TorusConvolver32", "build_plan32", "forward32", "inverse32"]
