"""Approximate signed gadget decompositions: u32 words (torus or mod q) and
multi-limb values over an RNS product modulus."""

from .big_integer import BigUintApproxSignedBasis
from .primitive import ApproxSignedBasis32

__all__ = ["ApproxSignedBasis32", "BigUintApproxSignedBasis"]
