"""Lattice ciphertext layer over the 2^32 torus: LWE ``(..., n+1)``,
GLWE ``(..., k+1, N)``, GGSW ``(..., k+1, L, k+1, N)`` as int64 tensors."""
