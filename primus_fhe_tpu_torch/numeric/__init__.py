"""u32 and u64 helpers over int64-carried words, and multi-limb big integers."""

from .limb import (
    MASK32,
    from_u64_pair,
    ge_u64,
    lt_u64,
    mul_hi_u64,
    mul_lo_u64,
    mul_wide_u32,
    mul_wide_u64,
    mulhi_u32,
    narrow_u32,
    to_u64_pair,
    u64_numpy,
    u64_tensor,
    widen_u32,
)

__all__ = [
    "MASK32", "from_u64_pair", "ge_u64", "lt_u64", "mul_hi_u64", "mul_lo_u64",
    "mul_wide_u32", "mul_wide_u64", "mulhi_u32", "narrow_u32", "to_u64_pair", "u64_numpy",
    "u64_tensor", "widen_u32",
]
