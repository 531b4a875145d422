"""Blind-rotation bootstrapping and the boolean gates built on it."""

from .blind_rotate import (
    blind_rotate,
    bootstrap,
    make_bootstrap_key,
    modulus_switch,
    test_polynomial,
)

__all__ = ["blind_rotate", "bootstrap", "make_bootstrap_key", "modulus_switch", "test_polynomial"]
