// Kernels ntt32_stages_forward/inverse and ntt64_stages_forward/inverse: a run
// of butterfly stages over rows of width 2^log_w, the shard-local part of the
// coefficient-sharded NTT (parallel/coeff_sharded.py).
//
// Replace pallas_stages_forward32 / pallas_stages_inverse32 and
// pallas_stages_forward64 / pallas_stages_inverse64
// (primus_fhe_tpu/ops/ntt_pallas.py:620,629,675,683, through _stage_call32
// :599 and _stage_call64 :650 to pallas_call :609 and :661; bodies
// _make_fwd_kernel32, _make_inv_stages_kernel32, _make_fwd_kernel :324 and
// _make_inv_stages_kernel64 :555).  What sets them apart from ntt32.cu /
// ntt64.cu: the twiddles are caller-supplied per-lane tables (log_w,
// 2^log_w), each shard's slice of the expanded tables, so stage s reads
// w[s][lane] and not a compact bit-reversed table; and the inverse has no
// fused inv_n stage (on the mesh that stage is an exchange stage).
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
//   reduction chain at the end; otherwise exact Shoup and a reduction of x
//   below 2q each stage.  out_factor 1, 2 or 4.  The x lane's entry serves
//   the pair.
// - u64 inverse: x' = x + y unreduced, y' = shoup64_approx(x + c q - y), the
//   bound c (units of q, from in_factor) doubling each stage (at least to 4)
//   and cut back to 2 by a reduction chain of both words when the next
//   stage would pass 2^64; output in [0, 2q).  The x lane's entry serves the
//   pair.  Words pass 2^63 at q near 2^62: every comparison is unsigned.
//
// The u32 kernels (stages32_*) keep the first design: one block a row, the
// row in shared memory, one radix-2 butterfly a thread a stage, one barrier
// a stage, the tables read from device memory stage by stage.
//
// The u64 kernels (stages64_*).  What bounds them: each input word is read
// once and each output written once, with the x lanes' table entries, 16
// bytes an x lane a stage (phase 15's shard, 2 rows of 2^14 words: 0.52 MB
// of rows and 1.84 MB of tables, 0.0007 ms at 3.35 TB/s; chip_smoke.py's
// b64), against 229k Shoup multiplies, well under a microsecond at the
// 32-bit multiply peak.
// The first design (the u32 kernels' above, on u64 words) ran a row on one
// SM: 2 blocks at that shape, 130 SMs idle, each block's 114,688 butterflies
// issued alone, 14 block-wide barriers of 1024 threads, and 1.8 MB of
// tables a block through one SM's load path, once a row.  It took 45-63x
// its bound.  This design:
// - a row over a thread-block cluster of C = 2^c blocks (C = 1, 2, 4, 8),
//   each holding one slice of 2^(log_w - c) words of each row of a tile of
//   T rows in shared memory (swz64: conflict-free a half-warp), so 2 rows of
//   2^14 words occupy 16 SMs.  The forward's first c stages pair words of
//   different slices: each block runs them on its share of the groups of C
//   words (offset j in the slices, all C slices) straight from device
//   memory and stores each word into its owner's shared memory through
//   cluster.map_shared_rank; a cluster barrier; then every later stage
//   pairs words of one slice.  The inverse mirrors it: the stages within a
//   slice first, a cluster barrier, then the last c stages on groups
//   gathered from the C slices over distributed shared memory and stored
//   straight to device memory, and a second cluster barrier that keeps
//   every slice alive until its peers' reads are done.
// - the stages within a slice as radix-8 register passes (lane_pass in
//   csrc/ntt_passes.cuh: the slot maps of kernels 1-2 and row 10 with this
//   row's butterflies): ceil((log_w - c) / 3) passes and one block barrier
//   each, not one a stage.  The forward's first pass (c = 0) reads device
//   memory and its last (the remainder, 1-3 stages) stores 2^R adjacent
//   words, 16 bytes an access; the inverse mirrors it, its first pass (the
//   remainder) loading 2^R adjacent words.
// - each table entry a launch reads once from device memory per tile of T
//   rows, not once a row: a thread reads a group's x-slot entries (w and
//   its quotient) once and runs the group of every row of the tile with
//   them; only x lanes' entries are read (half of each 32-byte sector where
//   x and y lanes alternate, at the last passes' small strides).  A pass
//   issues its first group's entries before the barrier its input waits on.
// - the C entry picks c and T (pick_grid: the fewest waves, then for the
//   forward the fewest phases, passes and stages across the cluster, then
//   the most SMs, the largest tile, the smallest cluster; a split row's
//   slices at least 2^8 words forward, 2^7 inverse, a block's tile at most
//   2^14 words = 128 KB) and launches with the cluster attribute; no caller
//   sets the grid.
//   log_w <= 16: a 512 KB row over at least 4 blocks.
//
// Regrouping the stages into passes and cluster stages changes no word:
// every butterfly is the plain version's (ops/ntt_stages.py) on the same
// pair with the same lazy range, so the words equal
// ntt64_stages_forward_plain / ntt64_stages_inverse_plain.

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// The u32 stage kernels


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

// ---------------------------------------------------------------------------
// The u64 stage kernels

constexpr int ST_THREADS = 256;
constexpr int ST_MAX_LOG_W = 16;
constexpr int ST_MAX_LOG_C = 3;       // clusters of up to 8 blocks (portable)
constexpr int ST_TILE_LOG_WORDS = 14;  // a block's T rows x 2^l words: at most 128 KB
constexpr int ST_MIN_SPLIT_LOG = 7;    // the pick splits a row only into slices of >= 2^7 words
constexpr int ST_SMEM_MAX = 232448;    // 227 KB

struct Stages64Args {
  const uint64_t* in;  // (rows, 2^log_w)
  uint64_t* out;       // (rows, 2^log_w)
  const uint64_t* w;   // (log_w, 2^log_w): stage s's entry of lane i at s 2^log_w + i
  const uint64_t* wp;  // their Shoup quotients
  uint64_t q;
  int rows, log_w;
  int log_c, tile;  // clusters of 2^log_c blocks a row, tiles of `tile` rows
  int out_factor;   // the forward's: 1, 2 or 4
  int log_in;       // the inverse's: log2(in_factor)
  int log_out;      // the inverse's final bound, 2^log_out q (its output chain)
};

// A launch with 2^log_c blocks a cluster and tiles of `tile` rows is
// possible: slices of at least one word a block's share of the first (or
// last) c stages, a block's tile at most 2^14 words.
__host__ __device__ inline bool grid_ok(int log_w, int log_c, int tile) {
  const int l = log_w - log_c;
  return log_c >= 0 && log_c <= ST_MAX_LOG_C && l >= 1 && l >= log_c && tile >= 1 && tile <= 8 &&
         ((long)tile << l) <= (1L << ST_TILE_LOG_WORDS);
}

// Threads a block: one a group of the slice's remainder pass (its most
// groups), at least a warp and at most ST_THREADS.
inline int st_threads(int l) {
  const int groups = l > 3 ? 1 << (l - remainder_stages(l)) : 1;
  return groups < 32 ? 32 : groups > ST_THREADS ? ST_THREADS : groups;
}

inline size_t st_smem(int l, int tile) { return sizeof(uint64_t) * ((size_t)tile << l); }

// The block's part: slice `rank` (lanes rank 2^l ..) of the `count` rows of
// its tile from row0.
struct Slice {
  int rank, count, l;
  size_t row0;
};

__device__ __forceinline__ Slice block_slice(const Stages64Args& a) {
  const int rank = (int)blockIdx.x & ((1 << a.log_c) - 1);
  const int row0 = ((int)blockIdx.x >> a.log_c) * a.tile;
  return Slice{rank, min(a.tile, a.rows - row0), a.log_w - a.log_c, (size_t)row0};
}

// Conditional subtractions of 2^(from-1) q, ..., 2^to q on G words: each
// from below 2^from q to below 2^to q (reduce_chain64 from a power of two).
// The words are independent, so each step's G subtractions issue together.
template <int G>
__device__ __forceinline__ void chain_down(uint64_t (&v)[G], uint64_t q, int from, int to) {
  for (int j = from - 1; j >= to; --j) {
    const uint64_t m = q << j;
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = v[k] >= m ? v[k] - m : v[k];
  }
}

// The forward's butterfly on (x, y) with the x lane's entry: deferred (x +
// m, x + 4q - m, m the approximate Shoup product in [0, 4q)) or exact (x
// below 2q first, m in [0, 2q), x + m, x + 2q - m).
template <bool DEFER>
struct FwdBf64 {
  uint64_t q;
  template <int G>
  __device__ __forceinline__ void words(int, uint64_t (&)[G]) const {}
  __device__ __forceinline__ void operator()(int, uint64_t& x, uint64_t& y, uint64_t w,
                                             uint64_t wp) const {
    const uint64_t tx = DEFER ? x : reduce_once64(x, 2 * q);
    const uint64_t m = DEFER ? shoup64_approx(y, w, wp, q) : shoup64_lazy(y, w, wp, q);
    x = tx + m;
    y = tx + ((DEFER ? 4 : 2) * q - m);
  }
};

// The inverse's bound schedule over R consecutive stages, from the words'
// bound 2^log_c q before the first (advanced past the R stages): a stage
// where 2 c q >= 2^64 first cuts every word below 2q, then after the stage
// c = max(2c, 4).  The cut depends only on the stage, q and in_factor, so it
// is resolved once a pass, and so is its kind: 0 no stage cuts, 1 every cut
// is one subtraction of 2q (from 4q: at q >= 2^61 every stage after the
// first), 2 a longer chain.
template <int R>
struct InvSched {
  int cut[R];      // 0, or the bound's log before the stage's cut
  uint64_t cq[R];  // c q after the cut
  int kind;
  __device__ __forceinline__ InvSched(uint64_t q, int& log_c) : kind(0) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const bool c = log_c >= 63 || q >= ((1ull << 63) >> log_c);
      cut[e] = c ? log_c : 0;
      if (c) {
        kind = log_c == 2 && kind < 2 ? 1 : 2;
        log_c = 1;
      }
      cq[e] = q << log_c;
      log_c = log_c + 1 > 2 ? log_c + 1 : 2;
    }
  }
};

// The inverse's butterflies of a pass of KIND (InvSched): x + y and
// shoup64_approx(x + c q - y), after the stage's cut of all the group's
// words (words(), outside the butterflies).  A runtime branch or loop among
// the unrolled butterflies costs a third of the pass, so the kind is a
// template: none, one branch-free conditional subtraction (of 2q, or of
// 2^64 - 1 where the stage does not cut: its words are below 2^63), or the
// chain.
template <int R, int KIND>
struct InvBf64 {
  uint64_t q;
  InvSched<R> s;
  template <int G>
  __device__ __forceinline__ void words(int e, uint64_t (&v)[G]) const {
    if (KIND == 1) {
      const uint64_t m = s.cut[e] ? 2 * q : ~0ull;
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = v[k] >= m ? v[k] - m : v[k];
    }
    if (KIND == 2 && s.cut[e]) chain_down(v, q, s.cut[e], 1);
  }
  __device__ __forceinline__ void operator()(int e, uint64_t& x, uint64_t& y, uint64_t w,
                                             uint64_t wp) const {
    const uint64_t sum = x + y;
    y = shoup64_approx(x + s.cq[e] - y, w, wp, q);
    x = sum;
  }
};

// Runs f(bf) with the inverse's butterflies of the next R stages (advancing
// log_c past them), their kind resolved to a template.
template <int R, class F>
__device__ __forceinline__ void with_inv_bf(uint64_t q, int& log_c, const F& f) {
  const InvSched<R> s(q, log_c);
  if (s.kind == 0)
    f(InvBf64<R, 0>{q, s});
  else if (s.kind == 1)
    f(InvBf64<R, 1>{q, s});
  else
    f(InvBf64<R, 2>{q, s});
}

// The forward's output words: the deferred chain from (4 + 4 log_w) q to
// 4q, then below 2q for out_factor <= 2 and below q for 1.
template <bool DEFER>
struct FwdOut {
  uint64_t q;
  int log_chain;  // ceil(log2(4 + 4 log_w))
  int out_factor;
  template <int G>
  __device__ __forceinline__ void operator()(uint64_t (&v)[G]) const {
    if (DEFER) chain_down(v, q, log_chain, 2);
    if (out_factor <= 2) chain_down(v, q, 2, 1);
    if (out_factor == 1) chain_down(v, q, 1, 0);
  }
};

// The inverse's output words: below 2^log_out q to below 2q.
struct InvOut {
  uint64_t q;
  int log_out;
  template <int G>
  __device__ __forceinline__ void operator()(uint64_t (&v)[G]) const {
    chain_down(v, q, log_out, 1);
  }
};

// The tile's rows in device memory from the block's first lane (slot c of
// row r at p + r 2^log_w + c): a group's 2^R adjacent words (ls = 0) in
// 16-byte accesses, else one word at a time, a warp's words adjacent.
struct GlobalRows {
  const uint64_t* p;
  int log_w;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint64_t (&v)[G]) const {
    const uint64_t* r = p + ((size_t)row << log_w) + base;
    if (ls == 0) {
      load_words(r, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = Word<uint64_t>::ldg(r + (k << ls));
    }
  }
};

// The same rows as the output, each word through `fix` as it is stored.
template <class FIX>
struct GlobalOut {
  uint64_t* p;
  int log_w;
  FIX fix;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint64_t (&v)[G]) const {
    uint64_t o[G];
#pragma unroll
    for (int k = 0; k < G; ++k) o[k] = v[k];
    fix(o);
    uint64_t* r = p + ((size_t)row << log_w) + base;
    if (ls == 0) {
      store_words(r, o);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) r[k << ls] = o[k];
    }
  }
};

// The barrier a pass's input waits on.
struct NoSync {
  __device__ __forceinline__ void operator()() const {}
};
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct ClusterSync {
  __device__ __forceinline__ void operator()() const { cg::this_cluster().sync(); }
};

// The forward's stages within a slice of 2^l words: radix-8 passes, the
// remainder last; the first reads `src` after sync0, the middle ones the
// shared-memory rows, the last stores to `dst`.
template <class BF, class SRC, class SYNC0, class DST>
__device__ __forceinline__ void fwd_passes(int count, int l, const LaneTable& tab, const BF& bf,
                                           const SRC& src, const SYNC0& sync0,
                                           const SmemRows64& rows, const DST& dst) {
  if (l <= 3) {  // one pass
    if (l == 3) lane_pass<3, false>(count, l, 0, tab, sync0, src, dst, bf);
    if (l == 2) lane_pass<2, false>(count, l, 0, tab, sync0, src, dst, bf);
    if (l == 1) lane_pass<1, false>(count, l, 0, tab, sync0, src, dst, bf);
    return;
  }
  const int r = remainder_stages(l);
  lane_pass<3, false>(count, l, 0, tab, sync0, src, rows, bf);
  for (int s0 = 3; s0 < l - r; s0 += 3)
    lane_pass<3, false>(count, l, s0, tab.at(s0), BlockSync{}, rows, rows, bf);
  if (r == 3) lane_pass<3, false>(count, l, l - 3, tab.at(l - 3), BlockSync{}, rows, dst, bf);
  if (r == 2) lane_pass<2, false>(count, l, l - 2, tab.at(l - 2), BlockSync{}, rows, dst, bf);
  if (r == 1) lane_pass<1, false>(count, l, l - 1, tab.at(l - 1), BlockSync{}, rows, dst, bf);
}

// The inverse's stages within a slice: radix-8 passes, the remainder (1-3
// stages) first, from device memory, the last storing to `dst`; log_c the
// words' bound, advanced past the slice's stages.
template <class DST>
__device__ __forceinline__ void inv_passes(int count, int l, const LaneTable& tab, uint64_t q,
                                           int& log_c, const GlobalRows& src,
                                           const SmemRows64& rows, const DST& dst) {
  const int r = remainder_stages(l);
  if (r == 3) {
    with_inv_bf<3>(q, log_c, [&](const auto& bf) {
      if (l == 3) lane_pass<3, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<3, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  } else if (r == 2) {
    with_inv_bf<2>(q, log_c, [&](const auto& bf) {
      if (l == 2) lane_pass<2, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<2, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  } else {
    with_inv_bf<1>(q, log_c, [&](const auto& bf) {
      if (l == 1) lane_pass<1, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<1, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  }
  for (int s0 = r; s0 < l; s0 += 3) {
    with_inv_bf<3>(q, log_c, [&](const auto& bf) {
      if (s0 + 3 < l)
        lane_pass<3, true>(count, l, s0, tab.at(s0), BlockSync{}, rows, rows, bf);
      else
        lane_pass<3, true>(count, l, s0, tab.at(s0), BlockSync{}, rows, dst, bf);
    });
  }
}

// The forward's first c stages of a row split over a cluster of C = 2^c
// blocks: group j (j in this block's share of the slice offsets) is the C
// words j + k 2^l, one a slice, loaded from device memory; its stages run
// in registers with the x lanes' entries, read once for the tile's rows;
// word k goes to slice k's shared memory (block k of the cluster).
template <int C, class BF>
__device__ __forceinline__ void cross_forward(const Stages64Args& a, const Slice& b,
                                              uint64_t* sm, const BF& bf) {
  constexpr int c = C == 2 ? 1 : C == 4 ? 2 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = 1 << (b.l - c), first = b.rank * per + (int)threadIdx.x;
  const LaneTable tab{a.w, a.wp, (size_t)1 << a.log_w};
  const uint64_t* in = a.in + (b.row0 << a.log_w);
  uint64_t w[c][C], wp[c][C];
  if (first < (b.rank + 1) * per) tab.get<c, false>(first, b.l, w, wp);
  cluster.sync();  // every block of the cluster has started: its shared memory takes stores
  for (int j = first; j < (b.rank + 1) * per; j += blockDim.x) {
    if (j != first) tab.get<c, false>(j, b.l, w, wp);
    for (int r = 0; r < b.count; ++r) {
      uint64_t v[C];
#pragma unroll
      for (int k = 0; k < C; ++k)
        v[k] = Word<uint64_t>::ldg(in + ((size_t)r << a.log_w) + j + (k << b.l));
      lane_stages<c, false>(v, w, wp, bf);
      uint64_t* word = sm + swz64((r << b.l) + j);
#pragma unroll
      for (int k = 0; k < C; ++k) *cluster.map_shared_rank(word, k) = v[k];
    }
  }
}

// The inverse's last c stages of a split row, mirrored: after a cluster
// barrier (every slice's own stages done), group j gathers word j of each
// slice over distributed shared memory, runs the stages and stores the C
// words to device memory through the output chain; a second barrier keeps
// every slice alive until its peers' reads are done.
template <int C>
__device__ __forceinline__ void cross_inverse(const Stages64Args& a, const Slice& b, uint64_t* sm,
                                              int log_c) {
  constexpr int c = C == 2 ? 1 : C == 4 ? 2 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = 1 << (b.l - c), first = b.rank * per + (int)threadIdx.x;
  const size_t stride = (size_t)1 << a.log_w;
  const LaneTable tab{a.w + b.l * stride, a.wp + b.l * stride, stride};
  const InvOut fix{a.q, a.log_out};
  uint64_t* out = a.out + (b.row0 << a.log_w);
  with_inv_bf<c>(a.q, log_c, [&](const auto& bf) {
    uint64_t w[c][C], wp[c][C];
    if (first < (b.rank + 1) * per) tab.get<c, true>(first, b.l, w, wp);
    cluster.sync();  // every slice's stages within it are done
    for (int j = first; j < (b.rank + 1) * per; j += blockDim.x) {
      if (j != first) tab.get<c, true>(j, b.l, w, wp);
      for (int r = 0; r < b.count; ++r) {
        uint64_t v[C];
        uint64_t* word = sm + swz64((r << b.l) + j);
#pragma unroll
        for (int k = 0; k < C; ++k) v[k] = *cluster.map_shared_rank(word, k);
        lane_stages<c, true>(v, w, wp, bf);
        fix(v);
#pragma unroll
        for (int k = 0; k < C; ++k) out[((size_t)r << a.log_w) + j + (k << b.l)] = v[k];
      }
    }
  });
  cluster.sync();  // keep every slice alive until its peers' reads are done
}

template <bool DEFER>
__global__ void __launch_bounds__(ST_THREADS, 1) stages64_forward_kernel(const Stages64Args a) {
  extern __shared__ __align__(16) uint64_t sm[];
  const Slice b = block_slice(a);
  const size_t stride = (size_t)1 << a.log_w;
  const size_t lane0 = (size_t)b.rank << b.l;
  const FwdBf64<DEFER> bf{a.q};
  const FwdOut<DEFER> fix{a.q, 32 - __clz(4 * a.log_w + 3), a.out_factor};
  const GlobalOut<FwdOut<DEFER>> dst{a.out + (b.row0 << a.log_w) + lane0, a.log_w, fix};
  // the slice's stages: the table's rows log_c .., its lanes from lane0
  const LaneTable tab{a.w + a.log_c * stride + lane0, a.wp + a.log_c * stride + lane0, stride};
  const SmemRows64 rows{sm, b.l};
  if (a.log_c == 0) {
    fwd_passes(b.count, b.l, tab, bf, GlobalRows{a.in + (b.row0 << a.log_w), a.log_w}, NoSync{},
               rows, dst);
    return;
  }
  if (a.log_c == 1) cross_forward<2>(a, b, sm, bf);
  if (a.log_c == 2) cross_forward<4>(a, b, sm, bf);
  if (a.log_c == 3) cross_forward<8>(a, b, sm, bf);
  fwd_passes(b.count, b.l, tab, bf, rows, ClusterSync{}, rows, dst);
}

__global__ void __launch_bounds__(ST_THREADS, 1) stages64_inverse_kernel(const Stages64Args a) {
  extern __shared__ __align__(16) uint64_t sm[];
  const Slice b = block_slice(a);
  const size_t stride = (size_t)1 << a.log_w;
  const size_t lane0 = (size_t)b.rank << b.l;
  const LaneTable tab{a.w + lane0, a.wp + lane0, stride};  // the slice's stages 0 .. l-1
  const GlobalRows src{a.in + (b.row0 << a.log_w) + lane0, a.log_w};
  const SmemRows64 rows{sm, b.l};
  int log_c = a.log_in;
  if (a.log_c == 0) {
    const GlobalOut<InvOut> dst{a.out + (b.row0 << a.log_w), a.log_w, InvOut{a.q, a.log_out}};
    inv_passes(b.count, b.l, tab, a.q, log_c, src, rows, dst);
    return;
  }
  inv_passes(b.count, b.l, tab, a.q, log_c, src, rows, rows);
  if (a.log_c == 1) cross_inverse<2>(a, b, sm, log_c);
  if (a.log_c == 2) cross_inverse<4>(a, b, sm, log_c);
  if (a.log_c == 3) cross_inverse<8>(a, b, sm, log_c);
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


// What the u64 launches read of a device, set up at the first launch there:
// the SM count and, per kernel (Kind64), log_w, c and tile, how many blocks
// of it the card runs at once (0 where it does not fit); the kernels'
// shared-memory cap is raised to ST_SMEM_MAX.
enum Kind64 { INV64 = 0, FWD64 = 1, FWD64_DEFER = 2 };

struct St64Device {
  int sms = 0;
  bool ready[3][ST_MAX_LOG_W + 1] = {};
  int wave[3][ST_MAX_LOG_W + 1][ST_MAX_LOG_C + 1][4] = {};
};

const void* kernel64(int kind) {
  return kind == INV64 ? (const void*)stages64_inverse_kernel
         : kind == FWD64 ? (const void*)stages64_forward_kernel<false>
                         : (const void*)stages64_forward_kernel<true>;
}

// Blocks of kernel `kind` at (log_w, c, tile) that the card runs at once:
// the SMs times the blocks an SM holds, or for a cluster launch the
// clusters the card holds times their size.
cudaError_t wave_blocks(int kind, int log_w, int c, int tile, int sms, int* out) {
  const int l = log_w - c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1 << c);
  cfg.blockDim = dim3(st_threads(l));
  cfg.dynamicSmemBytes = st_smem(l, tile);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e;
  if (c == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel64(kind), st_threads(l),
                                                      st_smem(l, tile));
    n *= sms;
  } else {
    e = cudaOccupancyMaxActiveClusters(&n, kernel64(kind), &cfg);
    n <<= c;
  }
  *out = n;
  return e;
}

int st64_device(int kind, int log_w, const St64Device** out) {
  static St64Device cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  St64Device& d = cached[dev];
  if (d.sms == 0) {
    int sms = 0;
    for (int k = 0; k < 3 && e == cudaSuccess; ++k)
      e = cudaFuncSetAttribute(kernel64(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ST_SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    d.sms = sms;
  }
  if (!d.ready[kind][log_w]) {
    for (int c = 0; c <= ST_MAX_LOG_C; ++c)
      for (int i = 0; i < 4; ++i)
        if (grid_ok(log_w, c, 1 << i)) {
          e = wave_blocks(kind, log_w, c, 1 << i, d.sms, &d.wave[kind][log_w][c][i]);
          if (e != cudaSuccess) return (int)e;
        }
    d.ready[kind][log_w] = true;
  }
  *out = &d;
  return 0;
}

// The grid of a launch of `rows` rows: c (clusters of 2^c blocks a row) and
// T (rows a tile) with the fewest waves, then for the forward the fewest
// phases (the slice's passes, and the stages across the cluster as one
// more: at small widths each costs about a pass, so a split pays only where
// it saves a pass), then the most SMs busy, then the largest tile (each
// table entry read once a tile), then the smallest cluster; a row split
// only into slices of at least 2^ST_MIN_SPLIT_LOG words (one more forward).
// The inverse's passes cost more (each stage's cut and x + c q - y), so
// spreading its work pays at smaller widths (cmux_mxu_timing.py --stages
// --grids).  A tile no larger than the rows need.  The only copy of the
// rule.
int pick_grid(const St64Device& d, int kind, int rows, int log_w, int* log_c, int* tile) {
  long best[5] = {0, 0, 0, 0, 0};  // waves, phases, -SMs, -tile, c
  bool found = false;
  for (int c = 0; c <= ST_MAX_LOG_C; ++c) {
    if (c > 0 && log_w - c < ST_MIN_SPLIT_LOG + (kind != INV64)) break;
    for (int i = 0; i < 4; ++i) {
      const int t = 1 << i;
      if (!grid_ok(log_w, c, t) || (i > 0 && t / 2 >= rows)) break;
      const long held = d.wave[kind][log_w][c][i];
      if (held <= 0) continue;
      const long grid = (long)((rows + t - 1) / t) << c;
      const long phases = kind == INV64 ? 0 : (log_w - c + 2) / 3 + (c > 0);
      const long key[5] = {(grid + held - 1) / held, phases, -(grid < d.sms ? grid : d.sms), -t,
                           c};
      bool better = !found;
      for (int k = 0; k < 5 && !better; ++k) {
        if (key[k] != best[k]) {
          better = key[k] < best[k];
          break;
        }
      }
      if (better) {
        for (int k = 0; k < 5; ++k) best[k] = key[k];
        *log_c = c;
        *tile = t;
        found = true;
      }
    }
  }
  return found ? 0 : (int)cudaErrorInvalidConfiguration;
}

bool valid64(uint64_t q, int rows, int log_w) {
  return rows >= 1 && log_w >= 1 && log_w <= ST_MAX_LOG_W && q >= 2 && q < (1ull << 62);
}

int kind64(bool forward, uint64_t q, int log_w) {
  // the TPU kernel's test: (4 + 4 log_w) q < 2^64
  if (!forward) return INV64;
  return q <= (~0ull) / (uint64_t)(4 + 4 * log_w) ? FWD64_DEFER : FWD64;
}

int launch64(bool forward, const void* in, void* out, const void* w, const void* wp, uint64_t q,
             int rows, int log_w, int out_factor, int in_factor, void* stream) {
  if (!valid64(q, rows, log_w) || (((uintptr_t)in | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (forward ? out_factor != 1 && out_factor != 2 && out_factor != 4
              : in_factor < 2 || (in_factor & (in_factor - 1)))
    return (int)cudaErrorInvalidValue;
  const int kind = kind64(forward, q, log_w);
  const St64Device* d = nullptr;
  int err = st64_device(kind, log_w, &d);
  if (err != 0) return err;
  Stages64Args a{};
  a.in = (const uint64_t*)in;
  a.out = (uint64_t*)out;
  a.w = (const uint64_t*)w;
  a.wp = (const uint64_t*)wp;
  a.q = q;
  a.rows = rows;
  a.log_w = log_w;
  a.out_factor = out_factor;
  a.log_in = 0;
  while ((1 << a.log_in) < in_factor) ++a.log_in;
  int lc = a.log_in;  // the inverse's bound through its log_w stages (InvSched's rule)
  for (int s = 0; s < log_w; ++s) {
    if (lc >= 63 || q >= ((1ull << 63) >> lc)) lc = 1;
    lc = lc + 1 > 2 ? lc + 1 : 2;
  }
  a.log_out = lc;
  err = pick_grid(*d, kind, rows, log_w, &a.log_c, &a.tile);
  if (err != 0) return err;
  const int l = log_w - a.log_c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + a.tile - 1) / a.tile) << a.log_c);
  cfg.blockDim = dim3(st_threads(l));
  cfg.dynamicSmemBytes = st_smem(l, a.tile);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << a.log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.log_c > 0 ? 1 : 0;
  cudaError_t e;
  if (kind == INV64)
    e = cudaLaunchKernelEx(&cfg, stages64_inverse_kernel, a);
  else if (kind == FWD64)
    e = cudaLaunchKernelEx(&cfg, stages64_forward_kernel<false>, a);
  else
    e = cudaLaunchKernelEx(&cfg, stages64_forward_kernel<true>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

// The u64 forward: the final log_w stages (log_w 1-16, q < 2^62) of `rows`
// rows (in and out 16-byte aligned), input below 4q, output canonical or
// lazy below out_factor q (2 or 4).
int pft_ntt64_stages_forward(const void* in, void* out, const void* w, const void* wp,
                             uint64_t q, int rows, int log_w, int out_factor, void* stream) {
  return launch64(true, in, out, w, wp, q, rows, log_w, out_factor, 2, stream);
}

// The u64 inverse: the first log_w stages, input below in_factor q (a power
// of two, at least 2), output lazy in [0, 2q).
int pft_ntt64_stages_inverse(const void* in, void* out, const void* w, const void* wp,
                             uint64_t q, int rows, int log_w, int in_factor, void* stream) {
  return launch64(false, in, out, w, wp, q, rows, log_w, 1, in_factor, stream);
}

// The grid a u64 launch takes on the current device (pick_grid): clusters
// of 2^log_c blocks a row and tiles of `tile` rows.
int pft_ntt64_stages_grid(int forward, uint64_t q, int rows, int log_w, int* log_c, int* tile) {
  if (!valid64(q, rows, log_w)) return (int)cudaErrorInvalidValue;
  const int kind = kind64(forward != 0, q, log_w);
  const St64Device* d = nullptr;
  const int err = st64_device(kind, log_w, &d);
  if (err != 0) return err;
  return pick_grid(*d, kind, rows, log_w, log_c, tile);
}

}  // extern "C"
