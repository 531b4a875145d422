// Kernel C: forward negacyclic NTT of canonical residues mod p < 2^30 as a
// byte-radix four-step on the int8 tensor cores (mxu8.cuh).
//
// Replaces the u32 tier (4 byte planes) of mxu8_fused_forward64
// (primus_fhe_tpu/ops/ntt_mxu8.py, kernel _make_fwd_kernel8, launched via
// ops/mxu_common._natural_call), which both MXU key preparations run.
//
// One thread block per (prime, group of G rows), G * A = 32 (A = n / 128):
//   pass 1: the rows' words, transposed to [(row, k0)][k1] in shared
//           memory, x w1 (4 planes) -> X[row][r0][k0], times tw[r0][k0];
//   pass 2: their bytes x w2 -> canonical NTT values in bit-reversed order,
//           written in the natural (A, 128) view.
// What bounds it: 16 x 512 x 512 bytes of pass-2 product per row against
// 8 KB in and out, so the tensor cores, not device memory; a key
// preparation runs it once over the whole key (7560 rows a prime for the
// BOOLEAN_128 bootstrap key).
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "mxu8.cuh"

namespace {

__global__ void __launch_bounds__(256) ntt_mxu8_forward_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ out, const int8_t* __restrict__ w1,
    const int8_t* __restrict__ w2, const uint32_t* __restrict__ tw, PrimeSet ps, int rows,
    int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  constexpr int W2 = PFT_MXU_LDA2 / 4;
  const int n = 1 << log_n, A = n / B, G = 32 / A;
  const int np1 = round_up(A, 8), kb = round_up(4 * A, 32), lda = kb + 16, wv = lda / 4;
  const int groups = (rows + G - 1) / G;
  const int pi = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * G;
  const int g_rows = rows - row0 < G ? rows - row0 : G;
  const PrimeConsts pc = ps.p[pi];
  const uint32_t q = pc.q;
  const uint64_t off = plane_offset(q);
  uint32_t* sv = (uint32_t*)smem;                                  // [(row, k0)][k1]
  uint32_t* sy = (uint32_t*)(smem + (size_t)G * B * lda);          // [(row, r0)][k0]
  const size_t base = ((size_t)pi * rows + row0) * n;

  for (int i = threadIdx.x; i < g_rows * n; i += blockDim.x) {
    const int g = i / n, c = i % n;
    sv[(g * B + c % B) * wv + c / B] = in[base + i];
  }
  __syncthreads();
  const uint32_t* t = tw + (size_t)pi * 4 * n;
  mm_planes<true, 2>(smem, lda, g_rows * B, w1 + (size_t)pi * 4 * np1 * kb, np1, A, kb,
                  [&](int m, int r0, int d0, int d1, int d2, int d3) {
                    const int g = m / B, k0 = m % B, idx = r0 * B + k0;
                    const uint32_t x = reduce_planes(d0, d1, d2, d3, pc, off);
                    sy[(g * A + r0) * W2 + k0] = shoup_mul_lazy(x, t[idx], t[n + idx], q);
                  });
  __syncthreads();
  mm_planes<true, 2>((const uint8_t*)sy, PFT_MXU_LDA2, g_rows * A, w2 + (size_t)pi * 16 * B * B, B,
                  B, 4 * B, [&](int m, int r1, int d0, int d1, int d2, int d3) {
                    out[base + (size_t)m * B + r1] = reduce_planes(d0, d1, d2, d3, pc, off);
                  });
}

}  // namespace

extern "C" {

int pft_ntt_mxu8_forward(const void* in, void* out, const void* w1, const void* w2,
                         const void* tw, const void* prime_pack, int kp, int rows, int log_n,
                         void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 8 || log_n > 12 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const int A = (1 << log_n) / PFT_MXU_B, G = 32 / A;
  const size_t smem = (size_t)G * PFT_MXU_B * (round_up(4 * A, 32) + 16) + 32 * PFT_MXU_LDA2;
  cudaError_t err = cudaFuncSetAttribute(ntt_mxu8_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (rows + G - 1) / G;
  ntt_mxu8_forward_kernel<<<kp * groups, 256, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const int8_t*)w1, (const int8_t*)w2,
      (const uint32_t*)tw, ps, rows, log_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
