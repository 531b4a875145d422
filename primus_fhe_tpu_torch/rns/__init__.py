"""RNS bases with CRT precomputations."""

from .base import RNSBase64

__all__ = ["RNSBase64"]
