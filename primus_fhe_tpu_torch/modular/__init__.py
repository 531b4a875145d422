"""32-bit modulus records and modular operations."""

from .factor import ShoupFactor32, factor_mul32, factor_mul_lazy32, shoup32
from .modops import (
    add32,
    barrett_lazy_reduce32,
    barrett_lazy_reduce_wide32,
    dot32,
    lazy_mul32,
    mul32,
    neg32,
    reduce_once32,
    reduce_twice32,
    sub32,
    sum_mod32,
)
from .modulus import BarrettModulus32, barrett32, barrett32_int

__all__ = [
    "BarrettModulus32",
    "ShoupFactor32",
    "add32",
    "barrett32",
    "barrett32_int",
    "barrett_lazy_reduce32",
    "barrett_lazy_reduce_wide32",
    "dot32",
    "factor_mul32",
    "factor_mul_lazy32",
    "lazy_mul32",
    "mul32",
    "neg32",
    "reduce_once32",
    "reduce_twice32",
    "shoup32",
    "sub32",
    "sum_mod32",
]
