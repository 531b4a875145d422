// Byte-radix four-step NTT building blocks on Hopper int8 tensor cores,
// shared by the MXU-family kernels (cmux_mxu.cu, ntt_mxu8.cu).
//
// Every dense pass of the four-step NTT is one exact integer product
//
//   Out[m][(c, n)] = sum_k a[m][k] * w[(c, n)][k]      (int8 x int8 -> int32)
//   value[m][n]    = sum_c 2^(8c) Out[m][(c, n)]  mod q
//
// where `w` holds the balanced base-256 digits (c = 0..3, each in
// [-128, 127]) of M[n][k'] * 2^(8l) mod q, with the contraction index
// k = (k', l) running over the byte planes l of the operand.  The operand
// side feeds its words' own bytes: a u32 value v = sum_l byte_l 2^(8l) is
// exactly its 4 unsigned bytes (mma .u8 x .s8), and a small signed gadget
// digit is 1 or 2 signed bytes (.s8 x .s8).  So no byte is biased and no
// row-sum correction exists (the TPU kernels' XOR-0x80 bias tables are not
// needed).
//
// int32 bound: |a| <= 255, |w| <= 128 and k <= 512 bytes give
// |Out| <= 512 * 255 * 128 < 2^24, and |value| < 2^24 * 2^25 = 2^49 before
// the final reduction (reduce_planes).
//
// Products run as mma.sync.m16n8k32 fragments: a warp takes 16 x 8 output
// tiles, the four c planes of the same (m, n) kept in registers, so the
// epilogue sees all four and reduces in place.  No float enters.
#pragma once

#include "modarith32.cuh"

// Launch configuration of the MXU-family kernels.
#define PFT_MXU_B 128          // four-step column count (lanes of the natural layout)
#define PFT_MXU_LDA2 528       // row stride (bytes) of a 4 * 128-byte operand, +16 against bank conflicts

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// D += A * B for one m16n8k32 tile.  A: 16 x 32 bytes row-major
// (u8 when A_UNSIGNED, else s8); B: 32 x 8 s8 "col" (stored [n][k]).
template <bool A_UNSIGNED>
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  if constexpr (A_UNSIGNED) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// sum_c 2^(8c) d_c mod q, canonical.  |sum| < 2^49 (see above); `off` is a
// multiple of q >= 2^49, so off + sum lies in [0, 2^51) and one wide
// Barrett pass plus one conditional subtraction finish.
__device__ __forceinline__ uint32_t reduce_planes(int d0, int d1, int d2, int d3,
                                                  const PrimeConsts& pc, uint64_t off) {
  const int64_t v = (int64_t)d0 + ((int64_t)d1 << 8) + ((int64_t)d2 << 16) + ((int64_t)d3 << 24);
  return reduce_once(barrett_lazy_wide((uint64_t)((int64_t)off + v), pc.ratio, pc.q), pc.q);
}

__host__ __device__ __forceinline__ uint64_t plane_offset(uint32_t q) {
  return ((1ull << 49) / q + 1) * q;
}

// Block-wide product of an operand in shared memory with a plane matrix in
// global memory (L2-resident):
//
//   a: rows m < m_rows (rounded up to 16 rows of readable memory), row
//      stride lda bytes (a multiple of 4), kb bytes used per row;
//   w: 4 * np rows [(c, n)] of kb bytes (kb a multiple of 32), np a multiple
//      of 8; rows n >= n_real are zero.
//
// Calls epi(m, n, d0, d1, d2, d3) once for every m < m_rows, n < n_real,
// with d_c the int32 product of plane c.  A warp's task is one 8-column
// tile of w against MT 16-row tiles of a: each w fragment is loaded once
// for MT products, and the k loop is unrolled so that the next step's
// loads are in flight during this step's products (the loads come from
// L2, so the kernel is bound by their latency, not by the tensor cores).
template <bool A_UNSIGNED, int MT, class Epi>
__device__ __forceinline__ void mm_planes(const uint8_t* a, int lda, int m_rows,
                                          const int8_t* __restrict__ w, int np, int n_real,
                                          int kb, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = (m_rows + 16 * MT - 1) / (16 * MT), nt = np >> 3;
  const size_t plane = (size_t)np * kb;
  for (int task = threadIdx.x >> 5; task < mg * nt; task += blockDim.x >> 5) {
    const int m0 = (task % mg) * 16 * MT, n0 = (task / mg) << 3;
    int acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0;
    const uint8_t* a0 = a + (size_t)(m0 + g) * lda + t * 4;
    const int8_t* wr = w + (size_t)(n0 + g) * kb + t * 4;
#pragma unroll 4
    for (int k = 0; k < kb; k += 32) {
      uint32_t b[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int8_t* wc = wr + c * plane + k;
        b[c][0] = __ldg((const uint32_t*)wc);
        b[c][1] = __ldg((const uint32_t*)(wc + 16));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (m0 + 16 * i >= m_rows) break;  // uniform across the warp
        const uint8_t* ai = a0 + (size_t)(16 * i) * lda + k;
        const uint32_t af[4] = {*(const uint32_t*)ai, *(const uint32_t*)(ai + 8 * lda),
                                *(const uint32_t*)(ai + 16), *(const uint32_t*)(ai + 8 * lda + 16)};
#pragma unroll
        for (int c = 0; c < 4; ++c) mma_k32<A_UNSIGNED>(acc[i][c], af, b[c][0], b[c][1]);
      }
    }
    // accumulator fragment: e = 0,1 -> row g, cols 2t, 2t+1; e = 2,3 -> row g+8
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * i + g + ((e >> 1) << 3);
        const int n = n0 + 2 * t + (e & 1);
        if (m < m_rows && n < n_real)
          epi(m, n, acc[i][0][e], acc[i][1][e], acc[i][2][e], acc[i][3][e]);
      }
  }
}

// Negacyclic source of coefficient c of v * X^d (d in [0, 2n)): index into
// v and whether the term is negated.
__device__ __forceinline__ int rot_source(int c, int d, int n, bool* neg) {
  int e = c - d;
  if (e < 0) e += 2 * n;
  *neg = e >= n;
  return e >= n ? e - n : e;
}

// Gadget-decomposition constants of an ApproxSignedBasis32 (host pack of
// ops/cmux_fused._basis_pack: level, log_basis, drop_bits, B-1, carry_mask,
// modulus-B, init_carry_mask or 0, wrap_threshold or 0, adjust_add,
// modulus or 0).
struct MxuBasis {
  int level, log_basis, drop_bits;
  uint32_t bm1, cmask, mmb, init_mask, wrap_thr, adj_add, modulus;
};

inline MxuBasis unpack_mxu_basis(const uint64_t* h) {
  return MxuBasis{(int)h[0],      (int)h[1],      (int)h[2],      (uint32_t)h[3], (uint32_t)h[4],
                  (uint32_t)h[5], (uint32_t)h[6], (uint32_t)h[7], (uint32_t)h[8], (uint32_t)h[9]};
}

// Writes the signed digits of every level of `v` as byte planes: level l's
// digit goes to dst[l * level_stride + plane] for plane < dp (1 plane when
// |digit| <= 128, else 2).  Torus mode (modulus 0): the digit is the u32
// two's complement of the carry chain; mod-q mode: pre-adjust above
// wrap_threshold, and a digit above B-1 stands for digit - q.
__device__ __forceinline__ void write_digits(uint32_t v, const MxuBasis& bc, int dp, int8_t* dst,
                                             int level_stride) {
  if (bc.wrap_thr != 0u && v >= bc.wrap_thr) v += bc.adj_add;
  uint32_t carry = (v & bc.init_mask) != 0u;
  for (int l = 0; l < bc.level; ++l) {
    const uint32_t temp = ((v >> (bc.drop_bits + l * bc.log_basis)) & bc.bm1) + carry;
    const uint32_t next = (temp & bc.cmask) != 0u;
    const uint32_t sgn = temp > bc.bm1 ? 0u : temp + bc.mmb;
    const uint32_t digit = next ? sgn : temp;
    carry = next;
    const int sd = bc.modulus != 0u ? (digit > bc.bm1 ? (int)digit - (int)bc.modulus : (int)digit)
                                    : (int)digit;
    const int8_t s0 = (int8_t)sd;
    dst[l * level_stride] = s0;
    if (dp == 2) dst[l * level_stride + 1] = (int8_t)((sd - s0) >> 8);
  }
}

// mm_planes with NP output planes (the 7- and 8-plane tiers of the u64
// four-step): calls epi(m, n, d) with d[c] the int32 product of plane c.
// Same tiling and operand rules as mm_planes.
template <bool A_UNSIGNED, int MT, int NP, class Epi>
__device__ __forceinline__ void mm_planes_n(const uint8_t* a, int lda, int m_rows,
                                            const int8_t* __restrict__ w, int np, int n_real,
                                            int kb, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = (m_rows + 16 * MT - 1) / (16 * MT), nt = np >> 3;
  const size_t plane = (size_t)np * kb;
  for (int task = threadIdx.x >> 5; task < mg * nt; task += blockDim.x >> 5) {
    const int m0 = (task % mg) * 16 * MT, n0 = (task / mg) << 3;
    int acc[MT][NP][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < NP; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0;
    const uint8_t* a0 = a + (size_t)(m0 + g) * lda + t * 4;
    const int8_t* wr = w + (size_t)(n0 + g) * kb + t * 4;
#pragma unroll 2
    for (int k = 0; k < kb; k += 32) {
      uint32_t b[NP][2];
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        const int8_t* wc = wr + c * plane + k;
        b[c][0] = __ldg((const uint32_t*)wc);
        b[c][1] = __ldg((const uint32_t*)(wc + 16));
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (m0 + 16 * i >= m_rows) break;  // uniform across the warp
        const uint8_t* ai = a0 + (size_t)(16 * i) * lda + k;
        const uint32_t af[4] = {*(const uint32_t*)ai, *(const uint32_t*)(ai + 8 * lda),
                                *(const uint32_t*)(ai + 16), *(const uint32_t*)(ai + 8 * lda + 16)};
#pragma unroll
        for (int c = 0; c < NP; ++c) mma_k32<A_UNSIGNED>(acc[i][c], af, b[c][0], b[c][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * i + g + ((e >> 1) << 3);
        const int n = n0 + 2 * t + (e & 1);
        if (m < m_rows && n < n_real) {
          int d[NP];
#pragma unroll
          for (int c = 0; c < NP; ++c) d[c] = acc[i][c][e];
          epi(m, n, d);
        }
      }
  }
}
