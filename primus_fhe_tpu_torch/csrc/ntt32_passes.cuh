// Radix-8 register passes of the 32-bit negacyclic NTT, shared by kernels
// 1-2 (csrc/ntt32.cu) and the CMux step kernel (csrc/cmux_fused.cu).
//
// A pass runs R <= 3 butterfly stages on groups of 2^R words: each thread
// holds a group in registers through its R stages, so a transform of
// log_n stages takes ceil(log_n / 3) passes with one barrier after each,
// not one barrier a stage.  The butterflies are the plain version's
// (transforms/ntt.py): Harvey forward stages lazy in [0, 4q), Gentleman-
// Sande inverse stages lazy in [0, 2q), inv_n folded into the last inverse
// stage; regrouping the stages into passes changes no word.
//
// Slots: forward group g of a pass at stages s0 .. s0+R-1 holds slots
// hi * 2^(t+R) + k * 2^t + lo (t = log_n - s0 - R, hi = g >> t, lo = g mod
// 2^t); inverse group g holds hi * 2^(s0+R) + k * 2^s0 + lo (hi = g >> s0).
// Where a pass reads and writes its words is the caller's: src.load(row,
// base, ls, v) and dst.store(row, base, ls, v) move the 2^R words base +
// k * 2^ls of row `row` (SmemRows for swizzled rows in shared memory;
// slot_load / slot_store adapt a function of one slot).
//
// Values are u32 words (int32 storage on the PyTorch side).
#pragma once

#include "modarith32.cuh"

// Shared-memory word of slot i in the step kernel: bits 0-4 XOR bits 3-7.
// Every 8-word radix pass and every coefficient-order sweep of a warp hits
// 32 distinct banks.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 31); }

struct SwzStep {
  static __device__ __forceinline__ int at(int i) { return swz(i); }
};

// Kernels 1-2 also run passes of 2 and 4 adjacent slots a group (the
// forward's last pass and the inverse's first at log_n = 10, 11); bits 5-6
// XORed into bits 0-1 as well make those conflict free too.
struct SwzNtt {
  static __device__ __forceinline__ int at(int i) { return swz(i) ^ ((i >> 5) & 3); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// G = 2, 4 or 8 adjacent words at p (8-byte aligned for 2, 16 for more) in
// one or two vector accesses.
template <int G>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[G]) {
  if constexpr (G == 2) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < G / 4; ++c) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[c];
      v[4 * c] = t.x;
      v[4 * c + 1] = t.y;
      v[4 * c + 2] = t.z;
      v[4 * c + 3] = t.w;
    }
  }
}
template <int G>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&v)[G]) {
  if constexpr (G == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < G / 4; ++c)
      reinterpret_cast<uint4*>(p)[c] = make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// Harvey forward butterfly (x, y) -> (x + wy, x - wy), lazy in [0, 4q).
__device__ __forceinline__ void fwd_bf(uint32_t& x, uint32_t& y, uint32_t w, uint32_t wp,
                                       uint32_t q) {
  const uint32_t two_q = 2u * q;
  const uint32_t tx = x >= two_q ? x - two_q : x;
  const uint32_t ty = shoup_mul_lazy(y, w, wp, q);
  x = tx + ty;
  y = tx + two_q - ty;
}

// Gentleman-Sande inverse butterfly (x, y) -> (x + y, w (x - y)), lazy in [0, 2q).
__device__ __forceinline__ void inv_bf(uint32_t& x, uint32_t& y, uint32_t w, uint32_t wp,
                                       uint32_t q) {
  const uint32_t two_q = 2u * q;
  const uint32_t s = x + y;
  const uint32_t d = x + two_q - y;
  x = s >= two_q ? s - two_q : s;
  y = shoup_mul_lazy(d, w, wp, q);
}

// R forward stages on the 2^R words v of one radix group.  tw(e, j, w, wp)
// gives the twiddle of block j (within the group's span) at stage e.
template <int R, class TW>
__device__ __forceinline__ void fwd_stages(uint32_t (&v)[1 << R], TW tw, uint32_t q) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int h = 1 << (R - 1 - e);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      if (!(k & h)) {
        uint32_t w, wp;
        tw(e, k >> (R - e), w, wp);
        fwd_bf(v[k], v[k + h], w, wp, q);
      }
  }
}

// Forward twiddles of a group at stages s0 .. s0+R-1 from a root table and
// its Shoup quotients (16-byte aligned): stage e's 2^e roots are the run at
// 2^(s0+e) + hi 2^e, read in one access; w[2^e + j] is block j's.
struct FwdTable {
  const uint32_t* w;
  const uint32_t* wp;
  template <int R>
  __device__ __forceinline__ void get(int s0, int hi, uint32_t (&tw)[1 << R],
                                      uint32_t (&twp)[1 << R]) const {
    tw[1] = w[(1 << s0) + hi];
    twp[1] = wp[(1 << s0) + hi];
    if constexpr (R > 1) {
      uint32_t a[2], b[2];
      load_words(w + (2 << s0) + 2 * hi, a);
      load_words(wp + (2 << s0) + 2 * hi, b);
      tw[2] = a[0], tw[3] = a[1], twp[2] = b[0], twp[3] = b[1];
    }
    if constexpr (R > 2) {
      uint32_t a[4], b[4];
      load_words(w + (4 << s0) + 4 * hi, a);
      load_words(wp + (4 << s0) + 4 * hi, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) tw[4 + j] = a[j], twp[4 + j] = b[j];
    }
  }
};

// The 7 twiddles of stages 0-2 (s0 = 0, hi = 0), held in registers.
struct FwdFirst {
  uint32_t w[8], wp[8];
  __device__ __forceinline__ explicit FwdFirst(const uint32_t* roots, const uint32_t* roots_p,
                                               int count) {
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      w[i] = i < count ? __ldg(roots + i) : 0u;
      wp[i] = i < count ? __ldg(roots_p + i) : 0u;
    }
  }
  template <int R>
  __device__ __forceinline__ void get(int, int, uint32_t (&tw)[1 << R],
                                      uint32_t (&twp)[1 << R]) const {
#pragma unroll
    for (int i = 1; i < (1 << R); ++i) tw[i] = w[i], twp[i] = wp[i];
  }
};

// Inverse twiddle ti of a root table and its quotients (any memory), of
// which w holds the words from `lo` on.
struct InvTable {
  const uint32_t* w;
  const uint32_t* wp;
  int lo = 0;
  __device__ __forceinline__ void operator()(int ti, uint32_t& tw, uint32_t& twp) const {
    tw = w[ti - lo];
    twp = wp[ti - lo];
  }
};

// Rows of 2^log_n words in shared memory, slot c of row r at word
// r 2^log_n + SW::at(c): the group access of a pass.
template <class SW>
struct SmemRows {
  uint32_t* p;
  int log_n;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint32_t (&v)[G]) const {
    const uint32_t* r = p + (row << log_n);
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = r[SW::at(base + (k << ls))];
  }
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
    uint32_t* r = p + (row << log_n);
#pragma unroll
    for (int k = 0; k < G; ++k) r[SW::at(base + (k << ls))] = v[k];
  }
};

// A group access through a function of one slot: f(row, c) gives slot c's
// word (SlotLoad), or f(row, c, v) takes it (SlotStore).
template <class F>
struct SlotLoad {
  F f;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint32_t (&v)[G]) const {
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = f(row, base + (k << ls));
  }
};
template <class F>
struct SlotStore {
  F f;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
#pragma unroll
    for (int k = 0; k < G; ++k) f(row, base + (k << ls), v[k]);
  }
};
template <class F>
__device__ __forceinline__ SlotLoad<F> slot_load(F f) {
  return {f};
}
template <class F>
__device__ __forceinline__ SlotStore<F> slot_store(F f) {
  return {f};
}

// One forward pass of R stages s0 .. s0+R-1 over `count` rows, the block's
// threads striding over (row, group); tw.get<R>(s0, hi, ...) gives a
// group's twiddles (FwdTable, FwdFirst).
template <int R, class TW, class LOAD, class STORE>
__device__ void fwd_pass(int count, int log_n, int s0, const TW& tw, uint32_t q, const LOAD& src,
                         const STORE& dst) {
  const int log_t = log_n - s0 - R;
  const int log_g = log_n - R;  // groups a row
  for (int it = threadIdx.x; it < (count << log_g); it += blockDim.x) {
    const int g = it & ((1 << log_g) - 1);
    const int hi = g >> log_t;
    const int base = (hi << (log_t + R)) + (g & ((1 << log_t) - 1));
    uint32_t v[1 << R], w[1 << R], wp[1 << R];
    src.load(it >> log_g, base, log_t, v);
    tw.template get<R>(s0, hi, w, wp);
    fwd_stages<R>(
        v,
        [&](int e, int j, uint32_t& ww, uint32_t& wwp) {
          ww = w[(1 << e) + j];
          wwp = wp[(1 << e) + j];
        },
        q);
    dst.store(it >> log_g, base, log_t, v);
  }
}

// Whether an inverse pass holds the final stage, and its output then:
// inv_n folded in, canonical or lazy in [0, 2q).
enum class Last { no, canonical, lazy };

// One inverse pass of R stages s0 .. s0+R-1 over `count` rows;
// tw(ti, w, wp) gives twiddle ti of the prime's inverse table.
template <int R, Last LAST, class TW, class LOAD, class STORE>
__device__ void inv_pass(int count, int log_n, int s0, const TW& tw, const PrimeConsts& pc,
                         const LOAD& src, const STORE& dst) {
  const int n = 1 << log_n;
  const int log_g = log_n - R;
  const uint32_t q = pc.q, two_q = 2u * q;
  for (int it = threadIdx.x; it < (count << log_g); it += blockDim.x) {
    const int g = it & ((1 << log_g) - 1);
    const int hi = g >> s0;
    const int base = (hi << (s0 + R)) + (g & ((1 << s0) - 1));
    uint32_t v[1 << R];
    src.load(it >> log_g, base, s0, v);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int h = 1 << e;
      const int start = 1 + n - (n >> (s0 + e));
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) {
        if (k & h) continue;
        if (LAST != Last::no && e == R - 1) {
          const uint32_t x = v[k], y = v[k + h];
          const uint32_t s = x + y;
          const uint32_t tx = s >= two_q ? s - two_q : s;
          v[k] = shoup_mul_lazy(tx, pc.inv_n, pc.inv_n_p, q);
          v[k + h] = shoup_mul_lazy(x + two_q - y, pc.inv_n_w, pc.inv_n_w_p, q);
          if (LAST == Last::canonical) {
            v[k] = reduce_once(v[k], q);
            v[k + h] = reduce_once(v[k + h], q);
          }
        } else {
          uint32_t w, wp;
          tw(start + (hi << (R - 1 - e)) + (k >> (e + 1)), w, wp);
          inv_bf(v[k], v[k + h], w, wp, q);
        }
      }
    }
    dst.store(it >> log_g, base, s0, v);
  }
}

// The inverse passes from stage s0 on, over `count` rows held at SW in
// `rows`: radix 8 with a barrier after each, the last one (R = 1..3)
// holding the final stage, whose output goes to last_store instead.
template <class SW, Last LAST, class TW, class STORE>
__device__ void inv_rest(uint32_t* rows, int count, int log_n, int s0, const TW& tw,
                         const PrimeConsts& pc, const STORE& last_store) {
  const SmemRows<SW> sr{rows, log_n};
  for (; s0 < log_n; s0 += 3) {
    const int r = log_n - s0;
    if (r > 3) {
      inv_pass<3, Last::no>(count, log_n, s0, tw, pc, sr, sr);
      __syncthreads();
    } else if (r == 3) {
      inv_pass<3, LAST>(count, log_n, s0, tw, pc, sr, last_store);
    } else if (r == 2) {
      inv_pass<2, LAST>(count, log_n, s0, tw, pc, sr, last_store);
    } else {
      inv_pass<1, LAST>(count, log_n, s0, tw, pc, sr, last_store);
    }
  }
}
