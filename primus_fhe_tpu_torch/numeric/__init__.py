"""u32 helpers over int64-carried words."""

from .limb import MASK32, mul_wide_u32, mulhi_u32, narrow_u32, widen_u32

__all__ = ["MASK32", "mul_wide_u32", "mulhi_u32", "narrow_u32", "widen_u32"]
