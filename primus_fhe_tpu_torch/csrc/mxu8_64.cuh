// The u64 tiers (7 and 8 byte planes, q < 2^62) of the byte-radix four-step
// NTT: the fold of the plane sums to one u64 word and the wgmma building
// blocks of ntt_mxu8.cu (the fused transforms and kernel D).
//
// Each plane sum is exact in int32 (|d_c| < 1024 * 255 * 128 < 2^25), but
// sum_c d_c 2^(8c) spans ~2^81, so fold_planes splits it at 2^32:
//   L = sum_{c<4} d_c 2^(8c), H = sum_{c>=4} d_c 2^(8(c-4))   (|L|, |H| < 2^49.1)
//   y = (L + off) + Shoup(H + off, 2^32 mod q)   (off: a multiple of q >= 2^50)
// a u64 word congruent to the value (y < 2^51 + 3q < 2^64).
#pragma once

#include "modarith64.cuh"
#include "mxu8.cuh"

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

// ---------------------------------------------------------------------------
// mxu8_forward64, mxu8_inverse64 and kernel D on wgmma (ntt_mxu8.cu).

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Both passes: the operand rows are the M side (u8, K-major core matrices:
// pass 2's rows of 1024 bytes with byte k of row m at wg_op_offset64, SBO =
// 8 rows x 1024 bytes, LBO = 128; pass 1's chunk the same with rows of kb1
// bytes) and the plane matrix the N side (s8, a k-step's 16 P rows in 8-row
// groups, [group][k half][8 rows][16 bytes]: LBO 128, SBO 256), so the
// products are m64nNk32.s32.u8.s8 with N = 16 P, or N = 64 for half a
// k-step's rows (the inverse's pass 1 on one M tile).
#define PFT_WG_OP_GROUP64 8192  // bytes of 8 operand rows of 1024 bytes

// Byte offset of u64 word `word` (of 128) of operand row m.
__device__ __forceinline__ uint32_t wg_op_offset64(int m, int word) {
  return (uint32_t)((((m >> 3) << 6) + (word >> 1)) << 7) + ((m & 7) << 4) + ((word & 1) << 3);
}

// D (64 x NW, s32) += A (64 x 32, u8, descriptor da) * B (32 x NW, s8,
// descriptor db); the accumulator layout of Wgmma<NW> (mxu8.cuh).
template <int NW>
struct WgmmaUS;

template <>
struct WgmmaUS<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 {"
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
struct WgmmaUS<112> {
  static __device__ __forceinline__ void mma(int (&d)[56], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k32.s32.u8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, %56, %57, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaUS<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};
