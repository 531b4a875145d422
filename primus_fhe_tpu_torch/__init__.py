"""primus-fhe-tpu-torch: the TFHE boolean-gate path in PyTorch and CUDA.

The port of :mod:`primus_fhe_tpu` to PyTorch on an NVIDIA Hopper card.  The
JAX package stays the reference: every module here keeps its counterpart's
path and public function names, and computes the same integers on the same
inputs.  The port imports nothing of the JAX package: the host-only helpers
it needs (the parameter records, ``golden.model``, ``utils.{primes,gcd,bits}``,
``noise``) are copies of what it calls, held equal to the originals by the
CPU tests.  Entry points that carry keys across from the JAX package
(``from_jax_*``) put them on the card unless asked for the CPU.

How u32 values are carried
--------------------------
PyTorch's ``uint32`` has no add, shift or compare on the CPU, so:

- public tensors hold u32 torus words (and residues) in ``torch.int64``,
  in the range ``[0, 2^32)``; every wrapping add, sub and mul is masked
  with ``& 0xFFFFFFFF`` (:data:`numeric.limb.MASK32`);
- a product of two u32 words wraps past 2^63 in int64: its low 32 bits stay
  exact, its high bits do not, so ``mulhi``, Barrett and Shoup quotients use
  a 16-bit split (:func:`numeric.limb.mulhi_u32`) or operands below 2^31;
- kernel wrappers (:mod:`ops`) narrow values to 32-bit storage at entry
  (an int32 bit pattern that the CUDA code reads as ``uint32_t``) and widen
  them at exit.  A wrapper returns the storage it was given: int64 in,
  int64 out; int32 bit patterns in, int32 bit patterns out.  The blind
  rotation hands its accumulator over narrowed, so that the narrowing
  happens once per bootstrap and not once per CMux step.

Kernels
-------
Every kernel wrapper in :mod:`ops` runs its plain PyTorch version for a
tensor on the CPU and its hand-written CUDA kernel (``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use) for a tensor on a CUDA device; it
raises for anything else.  Each wrapper counts its kernel launches in a
``launches`` attribute.
"""

__version__ = "0.1.0"
