"""Hand-written CUDA kernels with their plain PyTorch versions.

- :mod:`.ntt32`: kernels 1 and 2, the 32-bit NTT and inverse NTT;
- :mod:`.cmux_fused`: kernels 3 and 4, the two launches of a CMux step;
- :mod:`.cmux_mxu`: kernel A, the one-launch int8 TFHE CMux step, its plan
  and the MXU bootstrap-key preparation;
- :mod:`.ntru_cmux_mxu`: kernel B, the one-launch int8 NGS CMux step, and
  the MXU evaluation-key preparation;
- :mod:`.ntt_mxu8`: kernel C, the int8 four-step forward NTT; its u64
  tiers ``mxu8_forward64``/``mxu8_inverse64``; kernels D and E, the inverse
  with a fused key multiply and the fused round trip;
- :mod:`.ntt64`: the u64 butterfly NTT and inverse NTT;
- :mod:`.rotate`: kernel F, the negacyclic torus rotation;
- :mod:`.cmux_front`: kernel G, the CMux front end (digit residues);
- :mod:`.ntt_stages`: the coefficient-sharded NTT's shard-local stage
  kernels (u32 and u64, forward and inverse) on per-lane tables;
- :mod:`.ntt_mxu8_dyn`: a residue shard's plan, whose tables feed the
  byte-radix u64 kernels of :mod:`.ntt_mxu8`;
- :mod:`.mxu_common`: the host four-step matrices;
- :mod:`.build`: compiles ``csrc/`` with ``nvcc`` at first use and binds it.
"""
