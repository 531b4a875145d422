// Kernels ntt32_stages_forward/inverse and ntt64_stages_forward/inverse: a run
// of butterfly stages over rows of width 2^log_w, the shard-local part of the
// coefficient-sharded NTT (parallel/coeff_sharded.py).
//
// Replace pallas_stages_forward32 / pallas_stages_inverse32 and
// pallas_stages_forward64 / pallas_stages_inverse64
// (primus_fhe_tpu/ops/ntt_pallas.py:620,629,675,683; bodies
// _make_fwd_kernel32, _make_inv_stages_kernel32, _make_fwd_kernel and
// _make_inv_stages_kernel64).  What sets them apart from ntt32.cu / ntt64.cu:
// the twiddles are caller-supplied per-lane tables (log_w, 2^log_w), each
// shard's slice of the expanded tables, so stage s reads w[s][lane] and not a
// compact bit-reversed table; and the inverse has no fused inv_n stage (on
// the mesh that stage is an exchange stage).
//
// One thread block per row; the row sits in shared memory through every
// stage (a u64 row of 2^14 words is 128 KB: dynamic shared memory past the
// 48 KB default), one butterfly per thread per pass.  The tables stay in
// device memory and are read stage by stage: at the u64 shard of n = 2^16
// over 4 shards they are 14 x 2^14 x 16 B = 3.7 MB, read by every row's
// block (from L2 after the first).
//
// Schedules (lazy words bit-equal to the TPU kernels, which the exchange
// stages consume):
// - u32 forward: Harvey butterflies in [0, 4q); the x lane multiplies by its
//   own table entry and the y lane by its own (the TPU's select form);
//   canonical output on request.
// - u32 inverse: x' = x + y reduced below 2q, y' = Shoup(x + 2q - y) with the
//   y lane's entry; output lazy in [0, 2q).
// - u64 forward: while (4 + 4 log_w) q < 2^64, reductions are deferred and
//   the Shoup quotient is the approximate one (shoup64_approx), one
//   reduction chain at the end; otherwise exact Shoup and a reduction each
//   stage.  out_factor 1, 2 or 4.
// - u64 inverse: x' = x + y unreduced, y' = shoup64_approx(x + c q - y), the
//   bound c (units of q, from in_factor) doubling each stage and cut back to
//   2 by a reduction chain when the next stage would pass 2^64; output in
//   [0, 2q).  The x lane's entry serves the pair.
//
// What bounds them: a row is read once and written once, but the tables
// (2 words a lane a stage) are read per row block; with few rows (2 rows of
// 2^14 at the u64 shape) two blocks run and the launch is bound by latency.

#include "modarith32.cuh"
#include "modarith64.cuh"

namespace {

// First word of butterfly i in a stage of half-block 2^log_t; its partner is
// 2^log_t further on.
__device__ __forceinline__ int pair_x(int i, int log_t) {
  return ((i >> log_t) << (log_t + 1)) + (i & ((1 << log_t) - 1));
}

__global__ void stages32_forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                        const uint32_t* __restrict__ w,
                                        const uint32_t* __restrict__ wp, uint32_t q, int log_w,
                                        int canonical) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sv = reinterpret_cast<uint32_t*>(smem_raw);
  const int width = 1 << log_w, half = width >> 1;
  const uint32_t two_q = 2u * q;
  const uint32_t* src = in + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  for (int s = 0; s < log_w; ++s) {
    const int log_t = log_w - 1 - s;
    const uint32_t* ws = w + (size_t)s * width;
    const uint32_t* ps = wp + (size_t)s * width;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int xi = pair_x(i, log_t), yi = xi + (1 << log_t);
      const uint32_t y = sv[yi];
      const uint32_t tx = reduce_once(sv[xi], two_q);
      sv[xi] = tx + shoup_mul_lazy(y, ws[xi], ps[xi], q);
      sv[yi] = tx + two_q - shoup_mul_lazy(y, ws[yi], ps[yi], q);
    }
    __syncthreads();
  }
  uint32_t* dst = out + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    uint32_t v = sv[i];
    if (canonical) v = reduce_once(reduce_once(v, two_q), q);
    dst[i] = v;
  }
}

__global__ void stages32_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                        const uint32_t* __restrict__ w,
                                        const uint32_t* __restrict__ wp, uint32_t q, int log_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* sv = reinterpret_cast<uint32_t*>(smem_raw);
  const int width = 1 << log_w, half = width >> 1;
  const uint32_t two_q = 2u * q;
  const uint32_t* src = in + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  for (int s = 0; s < log_w; ++s) {
    const uint32_t* ws = w + (size_t)s * width;
    const uint32_t* ps = wp + (size_t)s * width;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int xi = pair_x(i, s), yi = xi + (1 << s);
      const uint32_t x = sv[xi], y = sv[yi];
      sv[xi] = reduce_once(x + y, two_q);
      sv[yi] = shoup_mul_lazy(x + two_q - y, ws[yi], ps[yi], q);
    }
    __syncthreads();
  }
  uint32_t* dst = out + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) dst[i] = sv[i];
}

__global__ void stages64_forward_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                        const uint64_t* __restrict__ w,
                                        const uint64_t* __restrict__ wp, uint64_t q, int log_w,
                                        int defer, int out_factor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* sv = reinterpret_cast<uint64_t*>(smem_raw);
  const int width = 1 << log_w, half = width >> 1;
  const uint64_t two_q = 2 * q, mq = defer ? 4 * q : 2 * q;
  const uint64_t* src = in + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  for (int s = 0; s < log_w; ++s) {
    const int log_t = log_w - 1 - s;
    const uint64_t* ws = w + (size_t)s * width;
    const uint64_t* ps = wp + (size_t)s * width;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int xi = pair_x(i, log_t), yi = xi + (1 << log_t);
      const uint64_t x = sv[xi], y = sv[yi];
      const uint64_t tx = defer ? x : reduce_once64(x, two_q);
      const uint64_t m = defer ? shoup64_approx(y, ws[xi], ps[xi], q)
                               : shoup64_lazy(y, ws[xi], ps[xi], q);
      sv[xi] = tx + m;
      sv[yi] = tx + (mq - m);
    }
    __syncthreads();
  }
  uint64_t* dst = out + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    uint64_t v = sv[i];
    if (defer) v = reduce_chain64(v, q, 4 + 4 * log_w, 4);
    if (out_factor <= 2) v = reduce_once64(v, two_q);
    if (out_factor == 1) v = reduce_once64(v, q);
    dst[i] = v;
  }
}

__global__ void stages64_inverse_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                        const uint64_t* __restrict__ w,
                                        const uint64_t* __restrict__ wp, uint64_t q, int log_w,
                                        int in_factor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* sv = reinterpret_cast<uint64_t*>(smem_raw);
  const int width = 1 << log_w, half = width >> 1;
  const uint64_t* src = in + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  int log_c = 0;  // the words' bound is c = 2^log_c units of q
  while ((1 << log_c) < in_factor) ++log_c;
  for (int s = 0; s < log_w; ++s) {
    // 2 c q >= 2^64: cut the bound back to 2q before this stage's sums
    const bool cut = log_c >= 63 || q >= ((1ull << 63) >> log_c);
    const int bound = 1 << log_c;
    if (cut) log_c = 1;
    const uint64_t cq = q << log_c;
    const uint64_t* ws = w + (size_t)s * width;
    const uint64_t* ps = wp + (size_t)s * width;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int xi = pair_x(i, s), yi = xi + (1 << s);
      uint64_t x = sv[xi], y = sv[yi];
      if (cut) {
        x = reduce_chain64(x, q, bound, 2);
        y = reduce_chain64(y, q, bound, 2);
      }
      sv[xi] = x + y;
      sv[yi] = shoup64_approx(x + cq - y, ws[xi], ps[xi], q);
    }
    __syncthreads();
    log_c = log_c + 1 > 2 ? log_c + 1 : 2;
  }
  uint64_t* dst = out + (size_t)blockIdx.x * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    dst[i] = reduce_chain64(sv[i], q, 1 << log_c, 2);
}

// Opt in to more than 48 KB of dynamic shared memory where a row needs it.
template <class K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int stage_threads(int log_w) {
  const int half = 1 << (log_w - 1);
  return half < 1024 ? half : 1024;
}

}  // namespace

extern "C" {

int pft_ntt32_stages_forward(const void* in, void* out, const void* w, const void* wp, int q,
                             int rows, int log_w, int canonical, void* stream) {
  if (rows < 1 || log_w < 1 || log_w > 15 || q < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << log_w;
  const int err = prepare(stages32_forward_kernel, smem);
  if (err) return err;
  stages32_forward_kernel<<<rows, stage_threads(log_w), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)w, (const uint32_t*)wp, (uint32_t)q,
      log_w, canonical);
  return (int)cudaGetLastError();
}

int pft_ntt32_stages_inverse(const void* in, void* out, const void* w, const void* wp, int q,
                             int rows, int log_w, void* stream) {
  if (rows < 1 || log_w < 1 || log_w > 15 || q < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) << log_w;
  const int err = prepare(stages32_inverse_kernel, smem);
  if (err) return err;
  stages32_inverse_kernel<<<rows, stage_threads(log_w), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)w, (const uint32_t*)wp, (uint32_t)q,
      log_w);
  return (int)cudaGetLastError();
}

int pft_ntt64_stages_forward(const void* in, void* out, const void* w, const void* wp,
                             uint64_t q, int rows, int log_w, int out_factor, void* stream) {
  if (rows < 1 || log_w < 1 || log_w > 14 || q < 2 || q >= (1ull << 62))
    return (int)cudaErrorInvalidValue;
  // the TPU kernel's test: (4 + 4 log_w) q < 2^64
  const int defer = q <= (~0ull) / (uint64_t)(4 + 4 * log_w);
  const size_t smem = sizeof(uint64_t) << log_w;
  const int err = prepare(stages64_forward_kernel, smem);
  if (err) return err;
  stages64_forward_kernel<<<rows, stage_threads(log_w), smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)w, (const uint64_t*)wp, q, log_w,
      defer, out_factor);
  return (int)cudaGetLastError();
}

int pft_ntt64_stages_inverse(const void* in, void* out, const void* w, const void* wp,
                             uint64_t q, int rows, int log_w, int in_factor, void* stream) {
  if (rows < 1 || log_w < 1 || log_w > 14 || q < 2 || q >= (1ull << 62) || in_factor < 2 ||
      (in_factor & (in_factor - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint64_t) << log_w;
  const int err = prepare(stages64_inverse_kernel, smem);
  if (err) return err;
  stages64_inverse_kernel<<<rows, stage_threads(log_w), smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)w, (const uint64_t*)wp, q, log_w,
      in_factor);
  return (int)cudaGetLastError();
}

}  // extern "C"
