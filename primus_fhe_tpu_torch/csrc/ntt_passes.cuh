// Radix-8 register passes of the negacyclic NTT on u32 or u64 words, shared
// by kernels 1-2 (csrc/ntt32.cu), the CMux step kernel (csrc/cmux_fused.cu),
// row 10's u64 kernels and kernel E (csrc/ntt64.cu), row 13's row halves K2
// and Ki1 (csrc/ntt_mxu8_split.cu: the 128-point cyclic transform, from the
// same butterflies and table layout), and row 11's u32 and u64 stage
// kernels (csrc/ntt_stages.cu: the same slot maps on per-lane tables, with
// their own butterflies, lane_pass at the end).
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
// k * 2^ls of row `row` (SmemRows for swizzled u32 rows in shared memory;
// slot_load / slot_store adapt a function of one slot).
//
// The word type W is the modulus's (uint32_t: kernels 1-2 and the step
// kernel, int32 storage on the PyTorch side; uint64_t: row 10, int64
// storage); Word<W> gives its Shoup multiply, its conditional subtraction
// and its read-only load.  The schedule is the same at both widths: only
// the word type, the Shoup multiply and the swizzle (the caller's load and
// store functors) differ.
#pragma once

#include "modarith32.cuh"
#include "modarith64.cuh"

template <class W>
struct Word;

template <>
struct Word<uint32_t> {
  static __device__ __forceinline__ uint32_t sub_if(uint32_t x, uint32_t q) {
    return reduce_once(x, q);
  }
  static __device__ __forceinline__ uint32_t shoup(uint32_t y, uint32_t w, uint32_t wp,
                                                   uint32_t q) {
    return shoup_mul_lazy(y, w, wp, q);
  }
  static __device__ __forceinline__ uint32_t ldg(const uint32_t* p) { return __ldg(p); }
};

template <>
struct Word<uint64_t> {
  static __device__ __forceinline__ uint64_t sub_if(uint64_t x, uint64_t q) {
    return reduce_once64(x, q);
  }
  static __device__ __forceinline__ uint64_t shoup(uint64_t y, uint64_t w, uint64_t wp,
                                                   uint64_t q) {
    return shoup64_lazy(y, w, wp, q);
  }
  static __device__ __forceinline__ uint64_t ldg(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  }
};

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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// G = 2, 4 or 8 adjacent u64 words at p (16-byte aligned), 16 bytes an access.
template <int G>
__device__ __forceinline__ void load_words(const uint64_t* p, uint64_t (&v)[G]) {
#pragma unroll
  for (int c = 0; c < G / 2; ++c) {
    const ulonglong2 t = reinterpret_cast<const ulonglong2*>(p)[c];
    v[2 * c] = t.x;
    v[2 * c + 1] = t.y;
  }
}
template <int G>
__device__ __forceinline__ void store_words(uint64_t* p, const uint64_t (&v)[G]) {
#pragma unroll
  for (int c = 0; c < G / 2; ++c)
    reinterpret_cast<ulonglong2*>(p)[c] = make_ulonglong2(v[2 * c], v[2 * c + 1]);
}

// Harvey forward butterfly (x, y) -> (x + wy, x - wy), lazy in [0, 4q).
template <class W>
__device__ __forceinline__ void fwd_bf(W& x, W& y, W w, W wp, W q) {
  const W two_q = W(2) * q;
  const W tx = x >= two_q ? x - two_q : x;
  const W ty = Word<W>::shoup(y, w, wp, q);
  x = tx + ty;
  y = tx + two_q - ty;
}

// Gentleman-Sande inverse butterfly (x, y) -> (x + y, w (x - y)), lazy in [0, 2q).
template <class W>
__device__ __forceinline__ void inv_bf(W& x, W& y, W w, W wp, W q) {
  const W two_q = W(2) * q;
  const W s = x + y;
  const W d = x + two_q - y;
  x = s >= two_q ? s - two_q : s;
  y = Word<W>::shoup(d, w, wp, q);
}

// R forward stages on the 2^R words v of one radix group.  tw(e, j, w, wp)
// gives the twiddle of block j (within the group's span) at stage e.
template <int R, class TW, class W>
__device__ __forceinline__ void fwd_stages(W (&v)[1 << R], TW tw, W q) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int h = 1 << (R - 1 - e);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      if (!(k & h)) {
        W w, wp;
        tw(e, k >> (R - e), w, wp);
        fwd_bf(v[k], v[k + h], w, wp, q);
      }
  }
}

// Gentleman-Sande stages 0 .. E-1 of the R on the 2^R words v of one radix
// group (all R by default; E = R - 1 where the caller runs the last stage
// itself): fwd_stages mirrored, stage e pairing slots k, k + 2^e;
// tw(e, j, w, wp) gives the twiddle of block j at stage e.
template <int R, int E = R, class TW, class W>
__device__ __forceinline__ void inv_stages(W (&v)[1 << R], TW tw, W q) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int h = 1 << e;
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      if (!(k & h)) {
        W w, wp;
        tw(e, k >> (e + 1), w, wp);
        inv_bf(v[k], v[k + h], w, wp, q);
      }
  }
}

// Forward twiddles of a group at stages s0 .. s0+R-1 (R <= 4) from a root
// table and its Shoup quotients (16-byte aligned): stage e's 2^e roots are
// the run at 2^(s0+e) + hi 2^e, read in one access (two for 4 u64 roots,
// four for 8); w[2^e + j] is block j's.
template <class W>
struct FwdTable {
  const W* w;
  const W* wp;
  template <int R>
  __device__ __forceinline__ void get(int s0, int hi, W (&tw)[1 << R], W (&twp)[1 << R]) const {
    tw[1] = w[(1 << s0) + hi];
    twp[1] = wp[(1 << s0) + hi];
    if constexpr (R > 1) {
      W a[2], b[2];
      load_words(w + (2 << s0) + 2 * hi, a);
      load_words(wp + (2 << s0) + 2 * hi, b);
      tw[2] = a[0], tw[3] = a[1], twp[2] = b[0], twp[3] = b[1];
    }
    if constexpr (R > 2) {
      W a[4], b[4];
      load_words(w + (4 << s0) + 4 * hi, a);
      load_words(wp + (4 << s0) + 4 * hi, b);
#pragma unroll
      for (int j = 0; j < 4; ++j) tw[4 + j] = a[j], twp[4 + j] = b[j];
    }
    if constexpr (R > 3) {
      W a[8], b[8];
      load_words(w + (8 << s0) + 8 * hi, a);
      load_words(wp + (8 << s0) + 8 * hi, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) tw[8 + j] = a[j], twp[8 + j] = b[j];
    }
  }
};
template <class W>
FwdTable(const W*, const W*) -> FwdTable<W>;

// The 7 twiddles of stages 0-2 (s0 = 0, hi = 0), held in registers.
template <class W>
struct FwdFirst {
  W w[8], wp[8];
  __device__ __forceinline__ explicit FwdFirst(const W* roots, const W* roots_p, int count) {
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      w[i] = i < count ? Word<W>::ldg(roots + i) : W(0);
      wp[i] = i < count ? Word<W>::ldg(roots_p + i) : W(0);
    }
  }
  template <int R>
  __device__ __forceinline__ void get(int, int, W (&tw)[1 << R], W (&twp)[1 << R]) const {
#pragma unroll
    for (int i = 1; i < (1 << R); ++i) tw[i] = w[i], twp[i] = wp[i];
  }
};

// Inverse twiddle ti of a root table and its quotients (any memory), of
// which w holds the words from `lo` on.
template <class W>
struct InvTable {
  const W* w;
  const W* wp;
  int lo = 0;
  __device__ __forceinline__ void operator()(int ti, W& tw, W& twp) const {
    tw = w[ti - lo];
    twp = wp[ti - lo];
  }
};
template <class W>
InvTable(const W*, const W*) -> InvTable<W>;
template <class W>
InvTable(const W*, const W*, int) -> InvTable<W>;

// Rows of any u64 words in device memory (row `row` at p + row 2^log_n),
// each word brought to [0, 2q) as it loads by a lazy Shoup multiply by 1
// (p1 = floor(2^64 / q)): a pass's group of G words at stride 2^ls (load),
// or G adjacent words from a 16-byte aligned word in 16-byte accesses
// (load_adjacent).  Kernel E (csrc/ntt64.cu) and row 13's K2 and Ki1
// (csrc/ntt_mxu8_split.cu) take any u64 word so.
struct AnyIn64 {
  const uint64_t* p;
  int log_n;
  uint64_t q, p1;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint64_t (&v)[G]) const {
    const uint64_t* r = p + ((size_t)row << log_n) + base;
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = shoup64_lazy(Word<uint64_t>::ldg(r + (k << ls)), 1, p1, q);
  }
  template <int G>
  __device__ __forceinline__ void load_adjacent(int row, int base, uint64_t (&v)[G]) const {
    load_words(p + ((size_t)row << log_n) + base, v);
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = shoup64_lazy(v[k], 1, p1, q);
  }
};

// Stages of a forward's last pass and of an inverse's first (radix 8, the
// remainder): 1..3.
__host__ __device__ inline int remainder_stages(int log_n) { return log_n - 3 * ((log_n - 1) / 3); }

// Shared-memory word of a tile's word i: bits 3-6 XORed into bits 0-3 and
// bits 4-5 into bits 0-1.  Each half-warp of a pass of 8 words a group at
// any stride, of a pass of 2 or 4 adjacent words a group, and of a sweep in
// coefficient order hits 16 distinct words mod 16.
__device__ __forceinline__ int swz64(int i) { return i ^ ((i >> 3) & 15) ^ ((i >> 4) & 3); }

// A tile's rows of 2^log_n u64 words in shared memory (row 10, E, row 11's
// u64 stages): slot c of row r, the tile's word i = r 2^log_n + c, at
// swz64(i).
struct SmemRows64 {
  uint64_t* p;
  int log_n;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint64_t (&v)[G]) const {
    const int i = (row << log_n) + base;
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = p[swz64(i + (k << ls))];
  }
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint64_t (&v)[G]) const {
    const int i = (row << log_n) + base;
#pragma unroll
    for (int k = 0; k < G; ++k) p[swz64(i + (k << ls))] = v[k];
  }
};

// Rows of 2^log_n u32 words in shared memory, slot c of row r at word
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
template <int R, class TW, class LOAD, class STORE, class W>
__device__ void fwd_pass(int count, int log_n, int s0, const TW& tw, W q, const LOAD& src,
                         const STORE& dst) {
  const int log_t = log_n - s0 - R;
  const int log_g = log_n - R;  // groups a row
  for (int it = threadIdx.x; it < (count << log_g); it += blockDim.x) {
    const int g = it & ((1 << log_g) - 1);
    const int hi = g >> log_t;
    const int base = (hi << (log_t + R)) + (g & ((1 << log_t) - 1));
    W v[1 << R], w[1 << R], wp[1 << R];
    src.load(it >> log_g, base, log_t, v);
    tw.template get<R>(s0, hi, w, wp);
    fwd_stages<R>(
        v,
        [&](int e, int j, W& ww, W& wwp) {
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
// tw(ti, w, wp) gives twiddle ti of the modulus's inverse table; pc holds
// the modulus q and the final stage's inv_n, inv_n_w and their quotients
// (PrimeConsts, Mod64).
template <int R, Last LAST, class TW, class PC, class LOAD, class STORE>
__device__ void inv_pass(int count, int log_n, int s0, const TW& tw, const PC& pc,
                         const LOAD& src, const STORE& dst) {
  using W = decltype(PC::q);
  const int n = 1 << log_n;
  const int log_g = log_n - R;
  const W q = pc.q, two_q = W(2) * q;
  for (int it = threadIdx.x; it < (count << log_g); it += blockDim.x) {
    const int g = it & ((1 << log_g) - 1);
    const int hi = g >> s0;
    const int base = (hi << (s0 + R)) + (g & ((1 << s0) - 1));
    W v[1 << R];
    src.load(it >> log_g, base, s0, v);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int h = 1 << e;
      const int start = 1 + n - (n >> (s0 + e));
#pragma unroll
      for (int k = 0; k < (1 << R); ++k) {
        if (k & h) continue;
        if (LAST != Last::no && e == R - 1) {
          const W x = v[k], y = v[k + h];
          const W s = x + y;
          const W tx = s >= two_q ? s - two_q : s;
          v[k] = Word<W>::shoup(tx, pc.inv_n, pc.inv_n_p, q);
          v[k + h] = Word<W>::shoup(x + two_q - y, pc.inv_n_w, pc.inv_n_w_p, q);
          if (LAST == Last::canonical) {
            v[k] = Word<W>::sub_if(v[k], q);
            v[k + h] = Word<W>::sub_if(v[k + h], q);
          }
        } else {
          W w, wp;
          tw(start + (hi << (R - 1 - e)) + (k >> (e + 1)), w, wp);
          inv_bf(v[k], v[k + h], w, wp, q);
        }
      }
    }
    dst.store(it >> log_g, base, s0, v);
  }
}

// The inverse passes from stage s0 on, over `count` rows that `rows` reads
// and writes (SmemRows): radix 8 with a barrier after each, the last one
// (R = 1..3) holding the final stage, whose output goes to last_store
// instead.
template <Last LAST, class ROWS, class TW, class PC, class STORE>
__device__ void inv_rest(const ROWS& rows, int count, int log_n, int s0, const TW& tw,
                         const PC& pc, const STORE& last_store) {
  for (; s0 < log_n; s0 += 3) {
    const int r = log_n - s0;
    if (r > 3) {
      inv_pass<3, Last::no>(count, log_n, s0, tw, pc, rows, rows);
      __syncthreads();
    } else if (r == 3) {
      inv_pass<3, LAST>(count, log_n, s0, tw, pc, rows, last_store);
    } else if (r == 2) {
      inv_pass<2, LAST>(count, log_n, s0, tw, pc, rows, last_store);
    } else {
      inv_pass<1, LAST>(count, log_n, s0, tw, pc, rows, last_store);
    }
  }
}

// ---------------------------------------------------------------------------
// Passes on per-lane tables (row 11's stage kernels, csrc/ntt_stages.cu, on
// u32 or u64 words): the slot maps above, but every butterfly reads its
// entries in a (stages, lanes) table, as the per-lane stage functions do,
// and the butterfly is the caller's functor: bf.words(e, v) runs on all 2^R
// words before stage e of the pass (the u64 inverse's cut of their bound),
// then bf(e, x, y, ...) on each pair with the entries its slot policy
// (BF::slots) names: the x slot's (the u64 pair: w, wp), the y slot's (the
// u32 inverse), or both (the u32 forward's select form: w_x, wp_x, w_y,
// wp_y).  Only those slots' entries are read.

enum class Slots { x, y, both };

// First slot of group g of a pass of R stages whose group's slots lie 2^ls
// apart (ls = t for a forward pass, s0 for an inverse one): its slots are
// base + k 2^ls.
__device__ __forceinline__ int group_base(int g, int ls, int R) {
  return ((g >> ls) << (ls + R)) + (g & ((1 << ls) - 1));
}

// Whether slot k of a group is the x word of stage e: a forward stage e of
// R pairs k with k + 2^(R-1-e), an inverse one k with k + 2^e.
template <int R, bool INV>
__device__ __forceinline__ constexpr bool x_slot(int e, int k) {
  return !(k & (INV ? 1 << e : 1 << (R - 1 - e)));
}

// Whether a butterfly of policy S reads slot k's entry at stage e.
template <Slots S, int R, bool INV>
__device__ __forceinline__ constexpr bool read_slot(int e, int k) {
  return S == Slots::both || x_slot<R, INV>(e, k) == (S == Slots::x);
}

// R stages on a group's 2^R words, forward (INV false) or inverse pairs;
// w[e][k], wp[e][k] the entries of slot k at stage e (those BF::slots reads).
template <int R, bool INV, class W, class BF>
__device__ __forceinline__ void lane_stages(W (&v)[1 << R], const W (&w)[R][1 << R],
                                            const W (&wp)[R][1 << R], const BF& bf) {
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int h = INV ? 1 << e : 1 << (R - 1 - e);
    bf.words(e, v);
#pragma unroll
    for (int k = 0; k < (1 << R); ++k)
      if (x_slot<R, INV>(e, k)) {
        if constexpr (BF::slots == Slots::both) {
          bf(e, v[k], v[k + h], w[e][k], wp[e][k], w[e][k + h], wp[e][k + h]);
        } else {
          const int s = BF::slots == Slots::x ? k : k + h;
          bf(e, v[k], v[k + h], w[e][s], wp[e][s]);
        }
      }
  }
}

// A (stages, lanes) table and its Shoup quotients: stage s's entry of lane
// i at s * stride + i (the pointers already at the pass's first stage and
// the block's first lane).
template <class W>
struct LaneTable {
  const W* w;
  const W* wp;
  size_t stride;
  // the same table from stage s on
  __device__ __forceinline__ LaneTable at(int s) const {
    return LaneTable{w + s * stride, wp + s * stride, stride};
  }
  // the entries of the slots S reads of a group at base + k 2^ls, R stages on
  template <int R, bool INV, Slots S>
  __device__ __forceinline__ void get(int base, int ls, W (&tw)[R][1 << R],
                                      W (&twp)[R][1 << R]) const {
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int k = 0; k < (1 << R); ++k)
        if (read_slot<S, R, INV>(e, k)) {
          const size_t i = e * stride + base + (k << ls);
          tw[e][k] = Word<W>::ldg(w + i);
          twp[e][k] = Word<W>::ldg(wp + i);
        }
  }
};

// One pass of R stages s0 .. s0+R-1 over `count` rows of 2^log_l words:
// each thread takes groups g, g + blockDim.x, ..., reads a group's table
// entries once (tab.get, tab at stage s0) and runs the group of every row
// with them.  The first group's entries are read before sync(), the
// barrier that the pass's input waits on (a block's or a cluster's, or
// none for device memory), so they are in flight across it.
template <int R, bool INV, class W, class SYNC, class LOAD, class STORE, class BF>
__device__ __forceinline__ void lane_pass(int count, int log_l, int s0, const LaneTable<W>& tab,
                                          const SYNC& sync, const LOAD& src, const STORE& dst,
                                          const BF& bf) {
  const int ls = INV ? s0 : log_l - s0 - R;
  const int groups = 1 << (log_l - R);
  int g = threadIdx.x;
  W w[R][1 << R], wp[R][1 << R];
  if (g < groups) tab.template get<R, INV, BF::slots>(group_base(g, ls, R), ls, w, wp);
  sync();
  for (; g < groups; g += blockDim.x) {
    const int base = group_base(g, ls, R);
    if (g != (int)threadIdx.x) tab.template get<R, INV, BF::slots>(base, ls, w, wp);
    for (int r = 0; r < count; ++r) {
      W v[1 << R];
      src.load(r, base, ls, v);
      lane_stages<R, INV>(v, w, wp, bf);
      dst.store(r, base, ls, v);
    }
  }
}
