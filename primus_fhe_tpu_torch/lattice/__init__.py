"""Lattice ciphertext layer as int64 tensors: over the 2^32 torus LWE
``(..., n+1)``, GLWE ``(..., k+1, N)``, GGSW ``(..., k+1, L, k+1, N)``, the
external product and the LWE, GLWE and packing key switches; over a prime
``q`` LWE, RLWE, GLev and GGSW; NTRU samples and the DCRT tier."""
