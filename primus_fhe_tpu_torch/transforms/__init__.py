"""32-bit NTT plans, plain transforms and the torus convolver."""

from .ntt import forward32, inverse32
from .plan import NttPlan32, build_plan32
from .torus import TorusConvolver32

__all__ = ["NttPlan32", "TorusConvolver32", "build_plan32", "forward32", "inverse32"]
