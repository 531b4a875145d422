// Kernels F and G: the standalone torus rotation and the CMux front end.
//
// Kernel F, rotate: out[j] = +-v[(j - d) mod N] (negacyclic sign), optionally
//   minus v[j], in u32 words, one degree per ciphertext.  Replaces
//   pallas_rotate (primus_fhe_tpu/ops/rotate_pallas.py:29); its chain of
//   log2(2N) conditional rolls becomes index arithmetic (rotated_at).  One
//   block per (ciphertext, component) row; the degree is taken mod 2N for
//   any sign.  The blind rotation runs it once a bootstrap, for the
//   accumulator's initial rotation v * X^-b.
//
// Kernel G, cmux_front: CMux stage 1 without its NTT.  The rotate-diff
//   acc * X^d - acc, the signed gadget digits of every level (one carry
//   chain per coefficient, digit_step) and the centered lift of each digit
//   mod each prime, written out as (kp, B, k1, L, N) canonical residues.
//   Replaces pallas_cmux_front (primus_fhe_tpu/ops/cmux_pallas.py:74).  One
//   block per accumulator row (ciphertext, component).
//
// What bounds them: both are elementwise over rows in device memory.  F
// reads N words and writes N a row; G reads N and writes kp * L * N (6x at
// BOOLEAN_128), so device-memory bytes, not arithmetic, set their time; the
// source row stays in L1/L2 for the gathered reads.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "modarith32.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rotate_kernel(const uint32_t* __restrict__ in,
                                                          const int32_t* __restrict__ degrees,
                                                          uint32_t* __restrict__ out, int rows,
                                                          int log_n, int subtract) {
  const int n = 1 << log_n;
  const int r = blockIdx.x;  // ciphertext r / rows, component r % rows
  const int d = degree_mod(degrees[r / rows], n);
  const uint32_t* a = in + (size_t)r * n;
  uint32_t* o = out + (size_t)r * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uint32_t v = rotated_at(a, c, d, n);
    o[c] = subtract ? v - a[c] : v;
  }
}

__global__ void __launch_bounds__(kThreads) cmux_front_kernel(const uint32_t* __restrict__ acc,
                                                              const int32_t* __restrict__ degrees,
                                                              uint32_t* __restrict__ out,
                                                              PrimeSet ps, BasisConsts bc,
                                                              int rows, int k1, int log_n) {
  const int n = 1 << log_n;
  const int L = bc.level;
  const int row = blockIdx.x;  // b * k1 + j
  const int d = degree_mod(degrees[row / k1], n);
  const uint32_t* a = acc + (size_t)row * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uint32_t diff = rotated_at(a, c, d, n) - a[c];
    uint32_t carry = (diff & bc.init_mask) != 0u;
    for (int l = 0; l < L; ++l) {
      const uint32_t digit = digit_step(diff, bc, l, carry);
      for (int pi = 0; pi < ps.kp; ++pi)
        out[(((size_t)pi * rows + row) * L + l) * n + c] = lift_mod_p(digit, ps.p[pi]);
    }
  }
}

}  // namespace

extern "C" {

int pft_rotate(const void* in, const void* degrees, void* out, int bsz, int rows, int log_n,
               int subtract, void* stream) {
  if (bsz < 1 || rows < 1 || log_n < 1 || log_n > 16) return (int)cudaErrorInvalidValue;
  const int threads = (1 << log_n) < kThreads ? (1 << log_n) : kThreads;
  rotate_kernel<<<bsz * rows, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (const int32_t*)degrees, (uint32_t*)out, rows, log_n, subtract);
  return (int)cudaGetLastError();
}

int pft_cmux_front(const void* acc, const void* degrees, void* out, const void* prime_pack,
                   const void* basis_pack, int kp, int bsz, int k1, int log_n, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || bsz < 1 || k1 < 1 || log_n < 1 || log_n > 16)
    return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const BasisConsts bc = unpack_basis((const uint64_t*)basis_pack);
  const int threads = (1 << log_n) < kThreads ? (1 << log_n) : kThreads;
  cmux_front_kernel<<<bsz * k1, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)degrees, (uint32_t*)out, ps, bc, bsz * k1, k1, log_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
