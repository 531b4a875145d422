"""Hand-written CUDA kernels with their plain PyTorch versions.

- :mod:`.ntt32`: kernels 1 and 2, the 32-bit NTT and inverse NTT;
- :mod:`.cmux_fused`: kernels 3 and 4, the two launches of a CMux step;
- :mod:`.build`: compiles ``csrc/`` with ``nvcc`` at first use and binds it.
"""
