"""Coefficient-domain polynomial operations over Z_q[X]/(X^n + 1)."""

from .poly import (
    poly_add32,
    poly_add64,
    poly_evaluate32,
    poly_mul_monomial32,
    poly_mul_monomial64,
    poly_mul_scalar32,
    poly_naive_mul32,
    poly_neg32,
    poly_neg64,
    poly_rotate32,
    poly_rotate64,
    poly_sub32,
    poly_sub64,
    rot_index,
)

__all__ = [
    "poly_add32", "poly_add64", "poly_evaluate32", "poly_mul_monomial32", "poly_mul_monomial64",
    "poly_mul_scalar32", "poly_naive_mul32", "poly_neg32", "poly_neg64", "poly_rotate32",
    "poly_rotate64", "poly_sub32", "poly_sub64", "rot_index",
]
