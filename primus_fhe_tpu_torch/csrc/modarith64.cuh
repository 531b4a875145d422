// Exact 64-bit modular arithmetic (q < 2^62) shared by the u64 NTT kernels.
//
// The TPU kernels emulate every u64 product with u32-pair limb products and
// 16-bit splits (primus_fhe_tpu/ops/ntt_pallas.py:129-299); Hopper has
// 64-bit integer registers, and __umul64hi gives the high word of a 64x64
// product, so a Shoup multiply is three multiplies.  Every formula matches
// the plain PyTorch version bit for bit (lazy ranges included).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define PFT_MAX_MOD64 4
#define PFT_MOD64_WORDS 9

// Per-modulus constants (host pack: PFT_MOD64_WORDS uint64 words per
// modulus, in this order).
struct Mod64 {
  uint64_t q;
  uint64_t inv_n, inv_n_p;      // inverse NTT final stage, left half
  uint64_t inv_n_w, inv_n_w_p;  // inverse NTT final stage, right half
  uint64_t c32, c32_p;          // 2^32 mod q and its Shoup quotient
  uint64_t p1;                  // floor(2^64 / q): the Shoup quotient of 1
  uint64_t off;                 // the least multiple of q >= 2^50
};

struct ModSet64 {
  Mod64 m[PFT_MAX_MOD64];
  int count;
};

inline ModSet64 unpack_mod64(const uint64_t* h, int count) {
  ModSet64 s{};
  s.count = count;
  for (int i = 0; i < count; ++i) {
    const uint64_t* w = h + PFT_MOD64_WORDS * i;
    s.m[i] = Mod64{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8]};
  }
  return s;
}

__device__ __forceinline__ uint64_t reduce_once64(uint64_t x, uint64_t q) {
  return x >= q ? x - q : x;
}

// Shoup: y * w mod q in [0, 2q) for ANY y < 2^64, with wp = floor(w * 2^64 / q).
__device__ __forceinline__ uint64_t shoup64_lazy(uint64_t y, uint64_t w, uint64_t wp, uint64_t q) {
  return w * y - q * __umul64hi(y, wp);
}

// Shoup with the TPU kernels' approximate quotient (ops/ntt_pallas.py
// _make_shoup_lazy64(exact=False)): hi64(y * wp) without the low cross
// products' carries, so q_hat may be under by up to 2 and the result lies in
// [0, 4q).  The u64 stage kernels keep it, so their lazy words are the TPU's.
__device__ __forceinline__ uint64_t shoup64_approx(uint64_t y, uint64_t w, uint64_t wp,
                                                   uint64_t q) {
  const uint32_t ylo = (uint32_t)y, yhi = (uint32_t)(y >> 32);
  const uint32_t plo = (uint32_t)wp, phi = (uint32_t)(wp >> 32);
  const uint64_t q_hat = (uint64_t)yhi * phi + __umulhi(ylo, phi) + __umulhi(yhi, plo);
  return w * y - q * q_hat;
}

// Conditional subtractions of (cp/2) q, (cp/4) q, ..., target q, cp the least
// power of two >= bound: takes a word below bound * q to below target * q
// (ntt_pallas.py _reduce_chain64).
__device__ __forceinline__ uint64_t reduce_chain64(uint64_t v, uint64_t q, int bound,
                                                   int target) {
  int cp = 1;
  while (cp < bound) cp <<= 1;
  while (cp > target) {
    cp >>= 1;
    v = v >= (uint64_t)cp * q ? v - (uint64_t)cp * q : v;
  }
  return v;
}

// Any u64 word -> its canonical residue mod q.
__device__ __forceinline__ uint64_t canonical64(uint64_t y, const Mod64& c) {
  return reduce_once64(shoup64_lazy(y, 1, c.p1, c.q), c.q);
}

inline int block_threads64(int log_n) {
  const int half = 1 << (log_n - 1);
  return half < 1024 ? half : 1024;
}
