"""Blind-rotation bootstrapping and the boolean gates built on it, over the
torus (TFHE) and mod q (NTRU), circuit bootstrapping (LWE bit -> GGSW,
:mod:`.circuit_bootstrap`) and the RNS (DCRT) blind rotation
(:mod:`.dcrt_blind_rotate`)."""

from .blind_rotate import (
    blind_rotate,
    bootstrap,
    make_bootstrap_key,
    make_bootstrap_key_mxu,
    modulus_switch,
    test_polynomial,
)

__all__ = [
    "blind_rotate", "bootstrap", "make_bootstrap_key", "make_bootstrap_key_mxu",
    "modulus_switch", "test_polynomial",
]
