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
// |Out| <= 512 * 255 * 128 < 2^24 (reduce_planes32 below folds the four
// planes in 32-bit arithmetic).
//
// Products run as mma.sync.m16n8k32 fragments: a warp takes 16 x 8 output
// tiles, the four c planes of the same (m, n) kept in registers, so the
// epilogue sees all four and reduces in place.  Kernels A and B run their
// two large passes on wgmma instead (the Hopper section at the end of this
// file).  No float enters.
#pragma once

#include "modarith32.cuh"

// Launch configuration of the MXU-family kernels.
#define PFT_MXU_B 128          // four-step column count (lanes of the natural layout)

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

// Product of an operand in shared memory with a plane matrix in
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
//
// The product runs over warps warp0 < nwarps only (a kernel whose other
// warps have another role), with w in global memory or, when W_SHARED, in
// shared memory; with W_SHARED, epi is also called on the tiles' padding
// (m < m_rows rounded up to 16 MT, n < np) and must keep its own stores in
// bounds: a call that branches on the bounds serialises the epilogues of a
// warp.
template <bool A_UNSIGNED, int MT, bool W_SHARED = false, class Epi>
__device__ __forceinline__ void mm_planes_w(const uint8_t* a, int lda, int m_rows,
                                            const int8_t* __restrict__ w, int np, int n_real,
                                            int kb, int warp0, int nwarps, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mg = (m_rows + 16 * MT - 1) / (16 * MT), nt = np >> 3;
  const size_t plane = (size_t)np * kb;
  for (int task = warp0; task < mg * nt; task += nwarps) {
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
        if constexpr (W_SHARED) {
          b[c][0] = *(const uint32_t*)wc;
          b[c][1] = *(const uint32_t*)(wc + 16);
        } else {
          b[c][0] = __ldg((const uint32_t*)wc);
          b[c][1] = __ldg((const uint32_t*)(wc + 16));
        }
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
        if (W_SHARED || (m < m_rows && n < n_real))
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

// ---------------------------------------------------------------------------
// Hopper building blocks of kernels A and B (cmux_mxu.cu): warpgroup int8
// products (wgmma) with both operands in shared memory, mbarriers, and 1-D
// bulk copies (optionally multicast across a thread-block cluster).
//
// Operand layout ("core-matrix" order, no swizzle): a K-major matrix of R
// rows by 512 bytes is stored as [R / 8][32 chunks of 16 bytes][8 rows][16
// bytes], so byte k of row m sits at wg_op_offset(m, k / 4) + k % 4.  A
// wgmma descriptor then reads 8-row groups SBO = 4096 bytes apart and the
// two 16-byte halves of a 32-byte k-step LBO = 128 bytes apart.
//
// Plane-tile layout: a 64-row by 32-byte tile of the plane matrix is 2 KB,
// [8 row groups][2 halves][8 rows][16 bytes] (LBO 128, SBO 256).  The host
// stores the plane matrices in stream order (ops/cmux_mxu.py:wgmma_layout),
// each 16 KB stage contiguous, so one bulk copy moves a stage.
#define PFT_WG_STAGE 16384     // bytes of one ring stage
#define PFT_WG_OP_GROUP 4096   // bytes of 8 operand rows of 512 bytes
#define PFT_WG_MAX_N 96        // widest operand chunk of one wgmma pass

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of the u32 word `word` (of 128) of operand row m.
__device__ __forceinline__ uint32_t wg_op_offset(int m, int word) {
  return (uint32_t)((((m >> 3) << 5) + (word >> 2)) << 7) + ((m & 7) << 4) + ((word & 3) << 2);
}

// Rows of an operand chunk of at most PFT_WG_MAX_N rows, rounded up to the
// int8 wgmma widths this file instantiates.
__host__ __device__ __forceinline__ int wg_chunk_width(int rows) {
  return rows > 64 ? 96 : rows > 48 ? 64 : rows > 32 ? 48 : rows > 16 ? 32 : rows > 8 ? 16 : 8;
}

// Rows an operand of `rows` rows occupies: full chunks plus the last one.
__host__ __device__ __forceinline__ int wg_padded_rows(int rows) {
  const int full = (rows - 1) / PFT_WG_MAX_N;
  return full * PFT_WG_MAX_N + wg_chunk_width(rows - full * PFT_WG_MAX_N);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrives on the barrier at the same offset in cluster block `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 r;\nmapa.shared::cluster.u32 r, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [r];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Global -> shared bulk copy completing on `bar`; with mask != 0, into the
// same offsets of every cluster block in mask (and on their barriers).
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint16_t mask) {
  if (mask == 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
}

// sum_c 2^(8c) d_c mod q in 32-bit arithmetic, for plane sums |d_c| < 2^24:
// each d_c + 2^24 times w_c = 2^(8c) mod q by Shoup (lazy, [0, 2q)), and
// corr = -(sum_c 2^(24 + 8c)) mod q takes the offsets back out.  Canonical:
// sum_c 2^(8c) d_c mod q.  Needs q < 2^30.
struct PlaneShoup {
  uint32_t w[4], wp[4], corr, q;
};

__device__ __forceinline__ PlaneShoup plane_shoup(const PrimeConsts& pc) {
  PlaneShoup ps;
  const uint32_t q = pc.q;
  uint32_t w = 1;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t x = (uint64_t)w << 32;
    uint64_t qh = __umul64hi(x, pc.ratio);  // floor(x / q) or one less
    if (x - qh * q >= q) ++qh;
    ps.w[c] = w;
    ps.wp[c] = (uint32_t)qh;
    w = reduce_once(barrett_lazy_wide((uint64_t)w << 8, pc.ratio, q), q);
  }
  uint32_t off = 0;  // sum_c 2^24 w_c mod q, 2^24 mod q = w_3
#pragma unroll
  for (int c = 0; c < 4; ++c)
    off = reduce_once(
        off + reduce_once(barrett_lazy_wide((uint64_t)ps.w[3] * ps.w[c], pc.ratio, q), q), q);
  ps.corr = off == 0 ? 0 : q - off;
  ps.q = q;
  return ps;
}

// 2^(8 c0) (d_a + 2^8 d_b) + offsets, in [0, 2q).
__device__ __forceinline__ uint32_t plane_pair(int da, int db, int c0, const PlaneShoup& ps) {
  const uint32_t a = shoup_mul_lazy((uint32_t)(da + (1 << 24)), ps.w[c0], ps.wp[c0], ps.q);
  const uint32_t b = shoup_mul_lazy((uint32_t)(db + (1 << 24)), ps.w[c0 + 1], ps.wp[c0 + 1], ps.q);
  return reduce_once(a + b, 2 * ps.q);
}

// The two pairs' sum with the offsets removed: canonical.
__device__ __forceinline__ uint32_t plane_finish(uint32_t lo, uint32_t hi, const PlaneShoup& ps) {
  const uint32_t x = reduce_once(lo + hi, 2 * ps.q) + ps.corr;  // [0, 3q)
  return reduce_once(x >= 2 * ps.q ? x - 2 * ps.q : x, ps.q);
}

__device__ __forceinline__ uint32_t reduce_planes32(int d0, int d1, int d2, int d3,
                                                    const PlaneShoup& ps) {
  return plane_finish(plane_pair(d0, d1, 0, ps), plane_pair(d2, d3, 2, ps), ps);
}

// Makes this thread's shared-memory stores visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Named barrier `id` (1-15) over `threads` threads, a multiple of 32.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void wg_fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x NW, s32) += A (64 x 32, s8, descriptor da) * B (32 x NW, u8,
// descriptor db), both K-major in shared memory.  Thread T of warp w of the
// warpgroup holds rows 16w + T/4 (+8) and columns 8j + 2(T%4) (+1):
// d[4j + e] is row 16w + T/4 + 8(e >> 1), column 8j + 2(T%4) + (e & 1).
template <int NW>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.u8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int (&d)[24], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int (&d)[48], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.u8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(da), "l"(db), "r"(1));
  }
};
