// Kernels 3 and 4: the two launches of one blind-rotation CMux step,
// acc <- acc + (acc * X^d - acc) [external product] GGSW.
//
// Replaces cmux_stage1 / cmux_stage2 (primus_fhe_tpu/ops/cmux_fused.py).
// Stage 1 shares its device functions (modarith32.cuh) with kernels F and G
// (cmux_front.cu), the standalone rotation and CMux front end.
//
// Stage 1: one block per (prime, accumulator row, level).  The rotate-diff
//   is index arithmetic plus a sign, the signed gadget digit of the level is
//   re-derived per coefficient from the carry chain, lifted mod the prime,
//   and forward-transformed in shared memory.  Output (kp, rows, L, n),
//   lazy in [0, 4p).
// Stage 2: one block per (ciphertext b, output component j).  MAC of the
//   k1*L digit rows against the GGSW rows per prime, inverse NTT of every
//   prime's row in shared memory (kp * n words, 16 KB at n = 2048, kp = 2),
//   Shoup multiply by (P/p_i)^-1, integer CRT in native 64-bit arithmetic,
//   wrapping add to acc.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "modarith32.cuh"

namespace {

__global__ void cmux_stage1_kernel(const uint32_t* __restrict__ acc,
                                   const int32_t* __restrict__ degrees,
                                   uint32_t* __restrict__ out, const uint32_t* __restrict__ roots,
                                   const uint32_t* __restrict__ roots_p, PrimeSet ps,
                                   BasisConsts bc, int rows, int k1, int log_n) {
  extern __shared__ uint32_t sv[];
  const int n = 1 << log_n;
  const int L = bc.level;
  const int l = blockIdx.x % L;
  const int row = (blockIdx.x / L) % rows;
  const int pi = blockIdx.x / (L * rows);
  const int d = degree_mod(degrees[row / k1], n);
  const uint32_t* a = acc + (size_t)row * n;
  const PrimeConsts& pc = ps.p[pi];
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    sv[c] = lift_mod_p(signed_digit(rotated_at(a, c, d, n) - a[c], bc, l), pc);
  __syncthreads();
  ntt_forward_smem(sv, roots + (size_t)pi * n, roots_p + (size_t)pi * n, pc.q, log_n);
  uint32_t* dst = out + (((size_t)pi * rows + row) * L + l) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = sv[c];
}

__global__ void cmux_stage2_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ key,
                                   const uint32_t* __restrict__ acc, uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ inv_roots,
                                   const uint32_t* __restrict__ inv_roots_p, PrimeSet ps,
                                   CrtConsts crt, int bsz, int k1, int L, int log_n) {
  extern __shared__ uint32_t sv[];  // (kp, n)
  const int n = 1 << log_n;
  const int kp = ps.kp;
  const int b = blockIdx.x / k1;
  const int j = blockIdx.x % k1;
  const int rows = bsz * k1;
  for (int pi = 0; pi < kp; ++pi) {
    const PrimeConsts& pc = ps.p[pi];
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      uint64_t s = 0;
      for (int r = 0; r < k1; ++r) {
        for (int l = 0; l < L; ++l) {
          const uint32_t fv = f[(((size_t)pi * rows + b * k1 + r) * L + l) * n + c];
          const uint32_t kv = key[((((size_t)pi * k1 + r) * L + l) * k1 + j) * n + c];
          s += reduce_once(barrett_lazy_wide((uint64_t)fv * kv, pc.ratio, pc.q), pc.q);
        }
      }
      sv[pi * n + c] = reduce_once(barrett_lazy_wide(s, pc.ratio, pc.q), pc.q);
    }
  }
  __syncthreads();
  for (int pi = 0; pi < kp; ++pi)
    ntt_inverse_smem(sv + pi * n, inv_roots + (size_t)pi * n, inv_roots_p + (size_t)pi * n,
                     ps.p[pi], log_n, true);
  const size_t base = ((size_t)b * k1 + j) * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    uint64_t fix = 0;    // sum y_i * floor(2^64 / p_i), mod 2^64
    uint32_t over = 0;   // ... and its carries out of 2^64
    uint32_t total = 0;  // sum y_i * (P/p_i), mod 2^32
    for (int pi = 0; pi < kp; ++pi) {
      const uint32_t q = ps.p[pi].q;
      const uint32_t y = reduce_once(shoup_mul_lazy(sv[pi * n + c], crt.iw[pi], crt.ipq[pi], q), q);
      const uint64_t nf = fix + (uint64_t)y * crt.afix[pi];
      over += nf < fix;
      fix = nf;
      total += y * crt.pmod[pi];
    }
    const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
    out[base + c] = acc[base + c] + (total - alpha * crt.pmt);
  }
}

}  // namespace

extern "C" {

int pft_cmux_stage1(const void* acc, const void* degrees, void* out, const void* roots,
                    const void* roots_p, const void* prime_pack, const void* basis_pack, int kp,
                    int bsz, int k1, int log_n, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > 12) return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const BasisConsts bc = unpack_basis((const uint64_t*)basis_pack);
  const int rows = bsz * k1;
  const size_t smem = sizeof(uint32_t) << log_n;
  cmux_stage1_kernel<<<kp * rows * bc.level, block_threads(log_n), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)degrees, (uint32_t*)out, (const uint32_t*)roots,
      (const uint32_t*)roots_p, ps, bc, rows, k1, log_n);
  return (int)cudaGetLastError();
}

int pft_cmux_stage2(const void* f, const void* key, const void* acc, void* out,
                    const void* inv_roots, const void* inv_roots_p, const void* prime_pack,
                    const void* crt_pack, int kp, int bsz, int k1, int level, int log_n,
                    void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > 12) return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const CrtConsts crt = unpack_crt((const uint64_t*)crt_pack, kp);
  const size_t smem = ((size_t)kp * sizeof(uint32_t)) << log_n;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cmux_stage2_kernel<<<bsz * k1, block_threads(log_n), smem, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (const uint32_t*)key, (const uint32_t*)acc, (uint32_t*)out,
      (const uint32_t*)inv_roots, (const uint32_t*)inv_roots_p, ps, crt, bsz, k1, level, log_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
