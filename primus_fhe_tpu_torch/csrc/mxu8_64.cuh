// The u64 tiers (7 and 8 byte planes, q < 2^62) of the byte-radix four-step
// NTT: the fold of the plane sums to one u64 word and the shared-memory
// geometry of a row group, shared by ntt_mxu8.cu (the fused transforms,
// kernels D and E) and ntt_mxu8_split.cu (the four half-transforms of the
// coefficient-sharded NTT).
//
// Each plane sum is exact in int32 (|d_c| < 1024 * 255 * 128 < 2^25), but
// sum_c d_c 2^(8c) spans ~2^81, so fold_planes splits it at 2^32:
//   L = sum_{c<4} d_c 2^(8c), H = sum_{c>=4} d_c 2^(8(c-4))   (|L|, |H| < 2^49.1)
//   y = (L + off) + Shoup(H + off, 2^32 mod q)   (off: a multiple of q >= 2^50)
// a u64 word congruent to the value (y < 2^51 + 3q < 2^64).
#pragma once

#include "modarith64.cuh"
#include "mxu8.cuh"

constexpr int LDA64 = 8 * PFT_MXU_B + 16;  // bytes per 128-word row, +16 against bank conflicts

template <int P>
__device__ __forceinline__ uint64_t fold_planes(const int (&d)[P], const Mod64& c) {
  const int64_t lo = (int64_t)d[0] + (int64_t)d[1] * 256 + (int64_t)d[2] * 65536 +
                     (int64_t)d[3] * 16777216;
  int64_t hi = 0;
#pragma unroll
  for (int i = P - 1; i >= 4; --i) hi = hi * 256 + d[i];
  return (uint64_t)(lo + (int64_t)c.off) +
         shoup64_lazy((uint64_t)(hi + (int64_t)c.off), c.c32, c.c32_p, c.q);
}

struct Geometry64 {
  int n, A, G, np1, kb1, lda1;
  size_t s_cols, s_rows;  // bytes of the [(row, k0)][k1] and [(row, r0)][k0] buffers
};

__host__ __device__ inline Geometry64 geometry64(int log_n) {
  Geometry64 g;
  g.n = 1 << log_n;
  g.A = g.n / PFT_MXU_B;
  g.G = 32 / g.A;
  g.np1 = round_up(g.A, 8);
  g.kb1 = round_up(8 * g.A, 32);
  g.lda1 = g.kb1 + 16;
  g.s_cols = (size_t)g.G * PFT_MXU_B * g.lda1;
  g.s_rows = (size_t)g.G * g.A * LDA64;
  return g;
}
