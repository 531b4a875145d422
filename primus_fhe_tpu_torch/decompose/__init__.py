"""Approximate signed gadget decompositions: u32 and u64 words (torus or mod q) and
multi-limb values over an RNS product modulus."""

from .big_integer import BigUintApproxSignedBasis
from .primitive import ApproxSignedBasis32, ApproxSignedBasis64

__all__ = ["ApproxSignedBasis32", "ApproxSignedBasis64", "BigUintApproxSignedBasis"]
