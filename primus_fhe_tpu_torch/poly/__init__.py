"""Coefficient-domain polynomial operations over Z_q[X]/(X^n + 1)."""

from .poly import poly_rotate32, rot_index

__all__ = ["poly_rotate32", "rot_index"]
