// Kernels 1 and 2: 32-bit negacyclic NTT and inverse NTT, all primes in one
// launch.
//
// Replaces pallas_forward32 / pallas_inverse32
// (primus_fhe_tpu/ops/ntt_pallas.py, _make_fwd_kernel32 / _make_inv_kernel32).
// One thread block per polynomial row (grid = kp * rows_per_prime, prime
// index = row / rows_per_prime); the row sits in shared memory (n words,
// 8 KB at n = 2048) through all log_n butterfly stages.  Twiddles come from
// the compact bit-reversed root tables (kp, n) of GoldenNtt.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "modarith32.cuh"

namespace {

__global__ void ntt32_forward_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                     const uint32_t* __restrict__ roots,
                                     const uint32_t* __restrict__ roots_p, PrimeSet ps,
                                     int rows_per_prime, int log_n, int canonical) {
  extern __shared__ uint32_t sv[];
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const int pi = (int)(row / rows_per_prime);
  const uint32_t q = ps.p[pi].q;
  const uint32_t* src = in + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  ntt_forward_smem(sv, roots + (size_t)pi * n, roots_p + (size_t)pi * n, q, log_n);
  uint32_t* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = sv[i];
    if (canonical) v = reduce_once(reduce_once(v, 2u * q), q);
    dst[i] = v;
  }
}

__global__ void ntt32_inverse_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                     const uint32_t* __restrict__ inv_roots,
                                     const uint32_t* __restrict__ inv_roots_p, PrimeSet ps,
                                     int rows_per_prime, int log_n, int canonical) {
  extern __shared__ uint32_t sv[];
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const int pi = (int)(row / rows_per_prime);
  const uint32_t* src = in + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = src[i];
  __syncthreads();
  ntt_inverse_smem(sv, inv_roots + (size_t)pi * n, inv_roots_p + (size_t)pi * n, ps.p[pi],
                   log_n, canonical != 0);
  uint32_t* dst = out + row * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = sv[i];
}

}  // namespace

extern "C" {

const char* pft_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int pft_ntt32_forward(const void* in, void* out, const void* roots, const void* roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > 12) return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const size_t smem = sizeof(uint32_t) << log_n;
  ntt32_forward_kernel<<<kp * rows_per_prime, block_threads(log_n), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)roots, (const uint32_t*)roots_p, ps,
      rows_per_prime, log_n, canonical);
  return (int)cudaGetLastError();
}

int pft_ntt32_inverse(const void* in, void* out, const void* inv_roots, const void* inv_roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > 12) return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const size_t smem = sizeof(uint32_t) << log_n;
  ntt32_inverse_kernel<<<kp * rows_per_prime, block_threads(log_n), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)inv_roots,
      (const uint32_t*)inv_roots_p, ps, rows_per_prime, log_n, canonical);
  return (int)cudaGetLastError();
}

}  // extern "C"
