// Exact 32-bit modular arithmetic shared by the NTT and CMux kernels.
//
// Device counterparts of the u32 helpers the TPU kernels emulate with
// 16-bit limbs (primus_fhe_tpu/ops/cmux_pallas.py:32-71 and
// ops/cmux_fused.py:110-124): Hopper multiplies 32x32 -> 64 bits natively
// and takes high words with __umulhi / __umul64hi, so each helper is a few
// instructions.  Every formula matches the plain PyTorch version bit for
// bit (lazy ranges included).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PFT_MAX_KP 4

// Per-prime constants (host pack: 7 uint64 words per prime, in this order).
struct PrimeConsts {
  uint32_t q;
  uint32_t inv_n, inv_n_p;      // inverse NTT final stage, left half
  uint32_t inv_n_w, inv_n_w_p;  // inverse NTT final stage, right half
  uint32_t wrap_c;              // 2^32 mod q (centered lift)
  uint64_t ratio;               // floor(2^64 / q) (Barrett)
};

struct PrimeSet {
  PrimeConsts p[PFT_MAX_KP];
  int kp;
};

// CRT recombination constants (host pack: 4 words per prime, then P mod 2^32).
struct CrtConsts {
  uint32_t iw[PFT_MAX_KP];    // (P/p_i)^-1 mod p_i
  uint32_t ipq[PFT_MAX_KP];   // its Shoup quotient
  uint64_t afix[PFT_MAX_KP];  // floor(2^64 / p_i)
  uint32_t pmod[PFT_MAX_KP];  // (P/p_i) mod 2^32
  uint32_t pmt;               // P mod 2^32
};

inline PrimeSet unpack_primes(const uint64_t* h, int kp) {
  PrimeSet s{};
  s.kp = kp;
  for (int i = 0; i < kp; ++i) {
    const uint64_t* w = h + 7 * i;
    s.p[i].q = (uint32_t)w[0];
    s.p[i].inv_n = (uint32_t)w[1];
    s.p[i].inv_n_p = (uint32_t)w[2];
    s.p[i].inv_n_w = (uint32_t)w[3];
    s.p[i].inv_n_w_p = (uint32_t)w[4];
    s.p[i].wrap_c = (uint32_t)w[5];
    s.p[i].ratio = w[6];
  }
  return s;
}

inline CrtConsts unpack_crt(const uint64_t* h, int kp) {
  CrtConsts c{};
  for (int i = 0; i < kp; ++i) {
    c.iw[i] = (uint32_t)h[4 * i];
    c.ipq[i] = (uint32_t)h[4 * i + 1];
    c.afix[i] = h[4 * i + 2];
    c.pmod[i] = (uint32_t)h[4 * i + 3];
  }
  c.pmt = (uint32_t)h[4 * kp];
  return c;
}

__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

// Shoup: y * w mod q in [0, 2q), with wp = floor(w * 2^32 / q).
__device__ __forceinline__ uint32_t shoup_mul_lazy(uint32_t y, uint32_t w, uint32_t wp,
                                                   uint32_t q) {
  return w * y - q * __umulhi(y, wp);
}

// Barrett: v mod q in [0, 2q) for any v < 2^64, ratio = floor(2^64 / q).
// q_hat = floor(v * ratio / 2^64) is exact, as in the four-product
// diagram of the TPU kernel.
__device__ __forceinline__ uint32_t barrett_lazy_wide(uint64_t v, uint64_t ratio, uint32_t q) {
  uint32_t q_hat = (uint32_t)__umul64hi(v, ratio);
  return (uint32_t)v - q_hat * q;
}

// Centered lift of a torus word to [0, q): x, or x - 2^32 when x >= 2^31.
__device__ __forceinline__ uint32_t lift_mod_p(uint32_t x, const PrimeConsts& c) {
  uint32_t r = reduce_once(barrett_lazy_wide((uint64_t)x, c.ratio, c.q), c.q);
  if (x >> 31) r = (r < c.wrap_c) ? r + c.q - c.wrap_c : r - c.wrap_c;
  return r;
}

// Forward negacyclic NTT of v[0, n) in shared memory, in place: normal-order
// input in [0, 4q), bit-reversed output lazy in [0, 4q).  Cooley-Tukey
// stages with Harvey butterflies; roots/roots_p are the prime's bit-reversed
// root table and Shoup quotients.  Every thread of the block must call it;
// the caller synchronises before (inputs written) and it synchronises after
// each stage.
__device__ __forceinline__ void ntt_forward_smem(uint32_t* v, const uint32_t* __restrict__ roots,
                                                 const uint32_t* __restrict__ roots_p,
                                                 uint32_t q, int log_n) {
  const int half = 1 << (log_n - 1);
  const uint32_t two_q = 2u * q;
  for (int s = 0; s < log_n; ++s) {
    const int log_t = log_n - 1 - s;
    const int t = 1 << log_t;
    const int m = 1 << s;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i >> log_t;
      const int xi = (j << (log_t + 1)) + (i & (t - 1));
      const int yi = xi + t;
      const uint32_t x = v[xi];
      const uint32_t tx = x >= two_q ? x - two_q : x;
      const uint32_t ty = shoup_mul_lazy(v[yi], roots[m + j], roots_p[m + j], q);
      v[xi] = tx + ty;
      v[yi] = tx + two_q - ty;
    }
    __syncthreads();
  }
}

// Inverse negacyclic NTT of v[0, n) in shared memory, in place: bit-reversed
// input in [0, 2q), normal-order output, canonical if `canonical` else lazy
// in [0, 2q).  Gentleman-Sande stages, inv_n folded into the last one.
__device__ __forceinline__ void ntt_inverse_smem(uint32_t* v,
                                                 const uint32_t* __restrict__ inv_roots,
                                                 const uint32_t* __restrict__ inv_roots_p,
                                                 const PrimeConsts& c, int log_n, bool canonical) {
  const int n = 1 << log_n;
  const int half = n >> 1;
  const uint32_t q = c.q;
  const uint32_t two_q = 2u * q;
  for (int s = 0; s < log_n - 1; ++s) {
    const int log_t = s;
    const int t = 1 << log_t;
    const int start = 1 + n - (n >> s);
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int j = i >> log_t;
      const int xi = (j << (log_t + 1)) + (i & (t - 1));
      const int yi = xi + t;
      const uint32_t x = v[xi];
      const uint32_t y = v[yi];
      const uint32_t sxy = x + y;
      v[xi] = sxy >= two_q ? sxy - two_q : sxy;
      v[yi] = shoup_mul_lazy(x + two_q - y, inv_roots[start + j], inv_roots_p[start + j], q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const uint32_t x = v[i];
    const uint32_t y = v[i + half];
    const uint32_t sxy = x + y;
    const uint32_t tx = sxy >= two_q ? sxy - two_q : sxy;
    uint32_t ox = shoup_mul_lazy(tx, c.inv_n, c.inv_n_p, q);
    uint32_t oy = shoup_mul_lazy(x + two_q - y, c.inv_n_w, c.inv_n_w_p, q);
    if (canonical) {
      ox = reduce_once(ox, q);
      oy = reduce_once(oy, q);
    }
    v[i] = ox;
    v[i + half] = oy;
  }
  __syncthreads();
}

// Gadget-decomposition constants of an ApproxSignedBasis32 in torus mode
// (host pack of ops/cmux_fused._basis_pack, first 7 words: level,
// log_basis, drop_bits, B-1, carry_mask, 2^32-B, init_carry_mask or 0).
struct BasisConsts {
  int level, log_basis, drop_bits;
  uint32_t bm1, cmask, mmb, init_mask;
};

inline BasisConsts unpack_basis(const uint64_t* h) {
  return BasisConsts{(int)h[0],      (int)h[1],      (int)h[2],     (uint32_t)h[3],
                     (uint32_t)h[4], (uint32_t)h[5], (uint32_t)h[6]};
}

// One level of the signed-digit carry chain (decompose/primitive.py): the
// digit of level `l` of torus word v, as a u32 (two's complement when
// negative); `carry` goes in and out.  Start the chain with
// carry = (v & init_mask) != 0 (init_mask = 0 when nothing is dropped).
__device__ __forceinline__ uint32_t digit_step(uint32_t v, const BasisConsts& bc, int l,
                                               uint32_t& carry) {
  const uint32_t temp = ((v >> (bc.drop_bits + l * bc.log_basis)) & bc.bm1) + carry;
  const uint32_t next = (temp & bc.cmask) != 0u;
  const uint32_t sgn = temp > bc.bm1 ? 0u : temp + bc.mmb;
  carry = next;
  return next ? sgn : temp;
}

// Signed digit of `level` for torus word v: the chain of levels 0..level.
__device__ __forceinline__ uint32_t signed_digit(uint32_t v, const BasisConsts& bc, int level) {
  uint32_t carry = (v & bc.init_mask) != 0u;
  uint32_t digit = 0;
  for (int lv = 0; lv <= level; ++lv) digit = digit_step(v, bc, lv, carry);
  return digit;
}

// Coefficient c of a * X^d mod X^n + 1 over the torus (d in [0, 2n)):
// +-a[(c - d) mod n], negated when (c - d) mod 2n >= n.
__device__ __forceinline__ uint32_t rotated_at(const uint32_t* a, int c, int d, int n) {
  int e = c - d;
  if (e < 0) e += 2 * n;
  const uint32_t src = a[e >= n ? e - n : e];
  return e >= n ? 0u - src : src;
}

// A degree of any sign taken mod 2n.
__device__ __forceinline__ int degree_mod(int d, int n) {
  d %= 2 * n;
  return d < 0 ? d + 2 * n : d;
}

inline int block_threads(int log_n) {
  const int half = 1 << (log_n - 1);
  return half < 1024 ? half : 1024;
}
