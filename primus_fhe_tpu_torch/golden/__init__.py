"""Exact host-side models over Python integers (copy of
``primus_fhe_tpu/golden``): the NTT tables the port's plans read, and the
oracles its tests use."""

from .model import (
    GoldenNtt,
    barrett_lazy_reduce,
    barrett_lazy_reduce_wide,
    barrett_ratio,
    minimal_primitive_root,
    mod_inv,
    naive_negacyclic_mul,
    reduce_once,
    shoup_mul_lazy,
    shoup_quotient,
)

__all__ = [
    "GoldenNtt", "barrett_lazy_reduce", "barrett_lazy_reduce_wide", "barrett_ratio",
    "minimal_primitive_root", "mod_inv", "naive_negacyclic_mul", "reduce_once",
    "shoup_mul_lazy", "shoup_quotient",
]
