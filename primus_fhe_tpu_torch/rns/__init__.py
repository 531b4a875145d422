"""RNS bases with CRT precomputations and base converters."""

from .base import RNSBase32, RNSBase64
from .converter import BaseConverter32, BaseConverter64

__all__ = ["BaseConverter32", "BaseConverter64", "RNSBase32", "RNSBase64"]
