"""Approximate signed gadget decomposition (torus mode)."""

from .primitive import ApproxSignedBasis32

__all__ = ["ApproxSignedBasis32"]
