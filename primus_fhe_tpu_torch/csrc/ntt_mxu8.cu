// Kernel C: forward negacyclic NTT of canonical residues mod p < 2^30 as a
// byte-radix four-step on the int8 tensor cores (mxu8.cuh).  Below it, the
// u64 kernels mxu8_forward64 and mxu8_inverse64 (7 and 8 byte planes), and
// kernels D and E: the inverse with a fused key multiply and the fused round
// trip (the negacyclic product by a fixed NTT-domain operand).
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

#include "mxu8_64.cuh"

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

// ---------------------------------------------------------------------------
// mxu8_forward64 / mxu8_inverse64: the 7- and 8-plane tiers (q < 2^62)
//
// Replace the q >= 2^30 tiers of mxu8_fused_forward64 / mxu8_fused_inverse64
// (primus_fhe_tpu/ops/ntt_mxu8.py:917,959; bodies _make_fwd_kernel8 and
// _make_inv_kernel8).  Table-driven: q, the plane matrices and the twiddle
// tables are run-time arguments, P (output planes) a template parameter.
//
// Operands are the 8 unsigned bytes of each u64 word (mma u8 x s8), so any
// u64 input is taken whole and no XOR-0x80 bias table exists; the matrices
// hold P balanced base-256 digits of M * 2^(8l) mod q for l = 0..7.  Each
// plane sum is exact in int32 (|d_c| < 1024 * 255 * 128 < 2^25), but
// sum_c d_c 2^(8c) spans ~2^81, so fold_planes (mxu8_64.cuh) splits it at 2^32:
//   L = sum_{c<4} d_c 2^(8c), H = sum_{c>=4} d_c 2^(8(c-4))   (|L|, |H| < 2^49.1)
//   y = (L + off) + Shoup(H + off, 2^32 mod q)   (off: a multiple of q >= 2^50)
// a u64 word congruent to the value (y < 2^51 + 3q < 2^64).  The TPU kernels'
// Solinas and u32-pair folds are not needed: one path serves every q.
//
// Forward, one block per (modulus, group of G = 32 / A rows):
//   pass 1: words transposed to [(row, k0)][k1] x w1 -> X[row][r0][k0],
//           times tw[r0][k0] (Shoup, [0, 2q)) -> [(row, r0)][k0];
//   pass 2: x w2 -> canonical NTT values, bit-reversed, natural (A, 128) view.
// Inverse (mirrored): pass 1 on the natural rows [(row, r0)][r1] x wi1,
// times twi[r0][k0] -> [(row, k0)][r0]; pass 2 x wi2 (inv_n folded in) ->
// canonical values in normal order.
//
// Kernel D, mxu8_inverse64_mul (mxu8_fused_inverse64_mul, ntt_mxu8.py:968;
// body _make_inv_kernel8 with mul=True): the inverse with a lazy Shoup
// multiply by the fixed operand's word at the same flat index as each input
// word is loaded; the product (< 2q) is a u64 word like any other for the
// unsigned-byte feed.
//
// Kernel E, mxu8_roundtrip64_mul (mxu8_fused_roundtrip64_mul,
// ntt_mxu8.py:977; body _make_rt_kernel8): forward passes 1-2, the key
// multiply on the folded pass-2 word (no canonical step: Shoup takes any
// u64), inverse passes 1-2, all in one block per row group; the forward's
// output never leaves shared memory.  Two buffers of the larger layout ping
// pong: load -> X (columns), pass 1 -> Y (rows), pass 2 -> X (rows), inverse
// pass 1 -> Y (columns), inverse pass 2 -> device memory.  E is held to 128
// registers (two blocks an SM, as the forward kernel runs): at the 148 it
// takes unbounded it ran one block an SM and lost to forward + D.
//
// What bounds D and E: per row of n = 4096 words, the four passes are
// 4 x (P x 8 x n x 128) int8 products at P = 7 (E; D has half) against
// 32 KB in and 32 KB out, so the tensor cores; on mma.sync the issue rate of
// the m16n8k32 tiles, not device memory, sets the time (the butterfly route
// needs ~n log n 64-bit multiplies instead, and wins per call).
// ---------------------------------------------------------------------------

template <int P>
__global__ void __launch_bounds__(256) ntt_mxu8_forward64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ w1,
    const int8_t* __restrict__ w2, const uint64_t* __restrict__ tw, ModSet64 ms, int rows,
    int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  const Geometry64 geo = geometry64(log_n);
  const int n = geo.n, A = geo.A, G = geo.G;
  const int groups = (rows + G - 1) / G;
  const int mi = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * G;
  const int g_rows = rows - row0 < G ? rows - row0 : G;
  const Mod64 mc = ms.m[mi];
  uint8_t* sc = smem;               // [(row, k0)][k1 words]
  uint8_t* sr = smem + geo.s_cols;  // [(row, r0)][k0 words]
  const size_t base = ((size_t)mi * rows + row0) * n;

  for (int i = threadIdx.x; i < g_rows * n; i += blockDim.x) {
    const int g = i / n, c = i % n;
    *(uint64_t*)(sc + (size_t)(g * B + c % B) * geo.lda1 + (c / B) * 8) = in[base + i];
  }
  __syncthreads();
  const uint64_t* t = tw + (size_t)mi * 4 * n;
  mm_planes_n<true, 2, P>(sc, geo.lda1, g_rows * B, w1 + (size_t)mi * P * geo.np1 * geo.kb1,
                          geo.np1, A, geo.kb1, [&](int m, int r0, const int (&d)[P]) {
                            const int g = m / B, k0 = m % B, idx = r0 * B + k0;
                            *(uint64_t*)(sr + (size_t)(g * A + r0) * LDA64 + k0 * 8) =
                                shoup64_lazy(fold_planes<P>(d, mc), t[idx], t[n + idx], mc.q);
                          });
  __syncthreads();
  mm_planes_n<true, 2, P>(sr, LDA64, g_rows * A, w2 + (size_t)mi * P * B * 8 * B, B, B, 8 * B,
                          [&](int m, int r1, const int (&d)[P]) {
                            out[base + (size_t)m * B + r1] = canonical64(fold_planes<P>(d, mc), mc);
                          });
}

template <int P, bool MUL>
__global__ void __launch_bounds__(256) ntt_mxu8_inverse64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ wi1,
    const int8_t* __restrict__ wi2, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ key, ModSet64 ms, int rows, int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  const Geometry64 geo = geometry64(log_n);
  const int n = geo.n, A = geo.A, G = geo.G;
  const int groups = (rows + G - 1) / G;
  const int mi = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * G;
  const int g_rows = rows - row0 < G ? rows - row0 : G;
  const Mod64 mc = ms.m[mi];
  uint8_t* sc = smem;               // [(row, k0)][r0 words]
  uint8_t* sr = smem + geo.s_cols;  // [(row, r0)][r1 words]: the natural rows
  const size_t base = ((size_t)mi * rows + row0) * n;

  const uint64_t* kt = MUL ? key + (size_t)mi * 2 * n : nullptr;
  for (int i = threadIdx.x; i < g_rows * n; i += blockDim.x) {
    uint64_t x = in[base + i];
    if constexpr (MUL) {
      const int c = i & (n - 1);
      x = shoup64_lazy(x, kt[c], kt[n + c], mc.q);
    }
    *(uint64_t*)(sr + (size_t)(i / B) * LDA64 + (i % B) * 8) = x;
  }
  __syncthreads();
  const uint64_t* t = tw + (size_t)mi * 4 * n + 2 * n;
  mm_planes_n<true, 2, P>(sr, LDA64, g_rows * A, wi1 + (size_t)mi * P * B * 8 * B, B, B, 8 * B,
                          [&](int m, int k0, const int (&d)[P]) {
                            const int g = m / A, r0 = m % A, idx = r0 * B + k0;
                            *(uint64_t*)(sc + (size_t)(g * B + k0) * geo.lda1 + r0 * 8) =
                                shoup64_lazy(fold_planes<P>(d, mc), t[idx], t[n + idx], mc.q);
                          });
  __syncthreads();
  mm_planes_n<true, 2, P>(sc, geo.lda1, g_rows * B, wi2 + (size_t)mi * P * geo.np1 * geo.kb1,
                          geo.np1, A, geo.kb1, [&](int m, int k1, const int (&d)[P]) {
                            const int g = m / B, k0 = m % B;
                            out[base + (size_t)g * n + k1 * B + k0] =
                                canonical64(fold_planes<P>(d, mc), mc);
                          });
}

template <int P>
__global__ void __launch_bounds__(256, 2) ntt_mxu8_roundtrip64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ w1,
    const int8_t* __restrict__ w2, const int8_t* __restrict__ wi1, const int8_t* __restrict__ wi2,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ key, ModSet64 ms, int rows,
    int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  const Geometry64 geo = geometry64(log_n);
  const int n = geo.n, A = geo.A, G = geo.G;
  const int groups = (rows + G - 1) / G;
  const int mi = blockIdx.x / groups;
  const int row0 = (blockIdx.x % groups) * G;
  const int g_rows = rows - row0 < G ? rows - row0 : G;
  const Mod64 mc = ms.m[mi];
  uint8_t* sx = smem;                                                         // X
  uint8_t* sy = smem + (geo.s_cols > geo.s_rows ? geo.s_cols : geo.s_rows);  // Y
  const size_t base = ((size_t)mi * rows + row0) * n;

  for (int i = threadIdx.x; i < g_rows * n; i += blockDim.x) {
    const int g = i / n, c = i % n;
    *(uint64_t*)(sx + (size_t)(g * B + c % B) * geo.lda1 + (c / B) * 8) = in[base + i];
  }
  __syncthreads();
  const uint64_t* t = tw + (size_t)mi * 4 * n;
  const uint64_t* kt = key + (size_t)mi * 2 * n;
  // forward pass 1: X [(row, k0)][k1] -> Y [(row, r0)][k0], twiddled
  mm_planes_n<true, 2, P>(sx, geo.lda1, g_rows * B, w1 + (size_t)mi * P * geo.np1 * geo.kb1,
                          geo.np1, A, geo.kb1, [&](int m, int r0, const int (&d)[P]) {
                            const int g = m / B, k0 = m % B, idx = r0 * B + k0;
                            *(uint64_t*)(sy + (size_t)(g * A + r0) * LDA64 + k0 * 8) =
                                shoup64_lazy(fold_planes<P>(d, mc), t[idx], t[n + idx], mc.q);
                          });
  __syncthreads();
  // forward pass 2 and the key: Y -> X [(row, r0)][r1], the natural rows
  mm_planes_n<true, 2, P>(sy, LDA64, g_rows * A, w2 + (size_t)mi * P * B * 8 * B, B, B, 8 * B,
                          [&](int m, int r1, const int (&d)[P]) {
                            const int idx = (m % A) * B + r1;
                            *(uint64_t*)(sx + (size_t)m * LDA64 + r1 * 8) =
                                shoup64_lazy(fold_planes<P>(d, mc), kt[idx], kt[n + idx], mc.q);
                          });
  __syncthreads();
  // inverse pass 1: X -> Y [(row, k0)][r0], twiddled
  mm_planes_n<true, 2, P>(sx, LDA64, g_rows * A, wi1 + (size_t)mi * P * B * 8 * B, B, B, 8 * B,
                          [&](int m, int k0, const int (&d)[P]) {
                            const int g = m / A, r0 = m % A, idx = r0 * B + k0;
                            *(uint64_t*)(sy + (size_t)(g * B + k0) * geo.lda1 + r0 * 8) =
                                shoup64_lazy(fold_planes<P>(d, mc), t[2 * n + idx],
                                             t[3 * n + idx], mc.q);
                          });
  __syncthreads();
  // inverse pass 2: Y -> canonical values in normal order
  mm_planes_n<true, 2, P>(sy, geo.lda1, g_rows * B, wi2 + (size_t)mi * P * geo.np1 * geo.kb1,
                          geo.np1, A, geo.kb1, [&](int m, int k1, const int (&d)[P]) {
                            const int g = m / B, k0 = m % B;
                            out[base + (size_t)g * n + k1 * B + k0] =
                                canonical64(fold_planes<P>(d, mc), mc);
                          });
}

// Which u64 kernel a launch runs.
enum class Kind64 { kForward, kInverse, kInverseMul, kRoundTrip };

template <int P>
int launch_mxu8_64(Kind64 kind, const void* in, void* out, const void* const* w,
                   const void* tw, const void* key, const ModSet64& ms, int rows, int log_n,
                   void* stream) {
  const Geometry64 geo = geometry64(log_n);
  const size_t buf = geo.s_cols > geo.s_rows ? geo.s_cols : geo.s_rows;
  const size_t smem = kind == Kind64::kRoundTrip ? 2 * buf : geo.s_cols + geo.s_rows;
  const int grid = ms.count * ((rows + geo.G - 1) / geo.G);
  const auto i64 = (const uint64_t*)in;
  const auto o64 = (uint64_t*)out;
  const auto t64 = (const uint64_t*)tw;
  const auto k64 = (const uint64_t*)key;
  const auto w0 = (const int8_t*)w[0], w1 = (const int8_t*)w[1];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (kind) {
    case Kind64::kForward:
      err = cudaFuncSetAttribute(ntt_mxu8_forward64_kernel<P>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      ntt_mxu8_forward64_kernel<P><<<grid, 256, smem, st>>>(i64, o64, w0, w1, t64, ms, rows, log_n);
      break;
    case Kind64::kInverse:
      err = cudaFuncSetAttribute(ntt_mxu8_inverse64_kernel<P, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      ntt_mxu8_inverse64_kernel<P, false><<<grid, 256, smem, st>>>(i64, o64, w0, w1, t64, nullptr,
                                                                   ms, rows, log_n);
      break;
    case Kind64::kInverseMul:
      err = cudaFuncSetAttribute(ntt_mxu8_inverse64_kernel<P, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      ntt_mxu8_inverse64_kernel<P, true><<<grid, 256, smem, st>>>(i64, o64, w0, w1, t64, k64, ms,
                                                                  rows, log_n);
      break;
    case Kind64::kRoundTrip:
      err = cudaFuncSetAttribute(ntt_mxu8_roundtrip64_kernel<P>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      ntt_mxu8_roundtrip64_kernel<P><<<grid, 256, smem, st>>>(
          i64, o64, w0, w1, (const int8_t*)w[2], (const int8_t*)w[3], t64, k64, ms, rows, log_n);
      break;
  }
  return (int)cudaGetLastError();
}

int launch_mxu8_64_any(Kind64 kind, const void* in, void* out, const void* const* w,
                       const void* tw, const void* key, const void* mod_pack, int count, int rows,
                       int log_n, int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 12 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (planes == 7) return launch_mxu8_64<7>(kind, in, out, w, tw, key, ms, rows, log_n, stream);
  if (planes == 8) return launch_mxu8_64<8>(kind, in, out, w, tw, key, ms, rows, log_n, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int pft_ntt_mxu8_forward64(const void* in, void* out, const void* w1, const void* w2,
                           const void* tw, const void* mod_pack, int count, int rows, int log_n,
                           int planes, void* stream) {
  const void* w[2] = {w1, w2};
  return launch_mxu8_64_any(Kind64::kForward, in, out, w, tw, nullptr, mod_pack, count, rows,
                            log_n, planes, stream);
}

int pft_ntt_mxu8_inverse64(const void* in, void* out, const void* wi1, const void* wi2,
                           const void* tw, const void* mod_pack, int count, int rows, int log_n,
                           int planes, void* stream) {
  const void* w[2] = {wi1, wi2};
  return launch_mxu8_64_any(Kind64::kInverse, in, out, w, tw, nullptr, mod_pack, count, rows,
                            log_n, planes, stream);
}

int pft_ntt_mxu8_inverse64_mul(const void* in, void* out, const void* wi1, const void* wi2,
                               const void* tw, const void* key, const void* mod_pack, int count,
                               int rows, int log_n, int planes, void* stream) {
  const void* w[2] = {wi1, wi2};
  return launch_mxu8_64_any(Kind64::kInverseMul, in, out, w, tw, key, mod_pack, count, rows,
                            log_n, planes, stream);
}

int pft_ntt_mxu8_roundtrip64_mul(const void* in, void* out, const void* w1, const void* w2,
                                 const void* wi1, const void* wi2, const void* tw,
                                 const void* key, const void* mod_pack, int count, int rows,
                                 int log_n, int planes, void* stream) {
  const void* w[4] = {w1, w2, wi1, wi2};
  return launch_mxu8_64_any(Kind64::kRoundTrip, in, out, w, tw, key, mod_pack, count, rows,
                            log_n, planes, stream);
}

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
