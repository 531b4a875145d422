"""Exact host-side NTT tables over Python integers (copy of what the port
uses of ``primus_fhe_tpu/golden``)."""

from .model import GoldenNtt, minimal_primitive_root, mod_inv

__all__ = ["GoldenNtt", "minimal_primitive_root", "mod_inv"]
