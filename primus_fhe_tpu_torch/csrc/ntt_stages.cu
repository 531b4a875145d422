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
// What bounds them: each input word is read once and each output written
// once, with the table entries each function reads (the u64 pair and the
// u32 inverse one lane's of each pair, the u32 forward both): phase 15's
// u64 shard, 2 rows of 2^14 words, is 0.52 MB of rows and 1.84 MB of
// tables, 0.0007 ms at 3.35 TB/s (chip_smoke.py's b64), against 229k Shoup
// multiplies, well under a microsecond at the 32-bit multiply peak; the u32
// forward at 2 rows of 2^15 words reads 3.93 MB of tables (b32f).
// The first design ran a row on one SM (one block a row, one radix-2
// butterfly a thread a stage, one block-wide barrier a stage, each table
// entry read from device memory stage by stage, once a row): at 2 rows of
// 2^14 u64 words 2 blocks, 130 SMs idle, and 1.8 MB of tables a block
// through one SM's load path.  It took 45-63x its bound on u64 words.
// This design, the same machinery for both word types W (templates; the
// words, their swizzle and the butterflies differ):
// - a row over a thread-block cluster of C = 2^c blocks (C = 1, 2, 4, 8),
//   each holding one slice of 2^(log_w - c) words of each row of a tile of
//   T rows in shared memory (u64: swz64 on the tile's word, conflict-free a
//   half-warp; u32: SwzNtt within a row, kernels 1-2's, conflict-free a
//   warp), so 2 rows of 2^14 words occupy 16 SMs.  The forward's first c
//   stages pair words of different slices: each block runs them on its
//   share of the groups of C words (offset j in the slices, all C slices)
//   straight from device memory and stores each word into its owner's
//   shared memory through cluster.map_shared_rank; a cluster barrier; then
//   every later stage pairs words of one slice.  The inverse mirrors it:
//   the stages within a slice first, a cluster barrier, then the last c
//   stages on groups gathered from the C slices over distributed shared
//   memory and stored straight to device memory, and a second cluster
//   barrier that keeps every slice alive until its peers' reads are done.
// - the stages within a slice as radix-8 register passes (lane_pass in
//   csrc/ntt_passes.cuh: the slot maps of kernels 1-2 and row 10 with this
//   row's butterflies): ceil((log_w - c) / 3) passes and one block barrier
//   each, not one a stage.  The forward's first pass (c = 0) reads device
//   memory and its last (the remainder, 1-3 stages) stores 2^R adjacent
//   words, 8 or 16 bytes an access; the inverse mirrors it, its first pass
//   (the remainder) loading 2^R adjacent words.
// - each table entry a launch reads once from device memory per tile of T
//   rows, not once a row: a thread reads a group's entries (w and its
//   quotient; the slots the butterfly's policy names: the x slots for the
//   u64 pair, both for the u32 forward, the y slots for the u32 inverse)
//   once and runs the group of every row of the tile with them.  A pass
//   issues its first group's entries before the barrier its input waits on.
// - the C entry picks c and T (pick_grid: the fewest waves, then for the
//   forward the fewest phases, passes and stages across the cluster, then
//   the most SMs, the largest tile, the smallest cluster; the u64 pair's
//   split row's slices at least 2 KB forward, 1 KB inverse, the u32 pair's
//   rows of at least 2^11 words split into slices of at least 2^8; a block's
//   tile at most 128 KB) and launches with the cluster attribute; no caller
//   sets the grid.
//   log_w <= 17: a 1 MB u64 row over 8 blocks of 128 KB (one row a tile), a
//   512 KB u32 row over at least 4.
//
// Regrouping the stages into passes and cluster stages changes no word:
// every butterfly is the plain version's (ops/ntt_stages.py) on the same
// pair with the same lazy range, so the words equal
// ntt32_stages_forward_plain / ntt32_stages_inverse_plain and
// ntt64_stages_forward_plain / ntt64_stages_inverse_plain.

#include <cooperative_groups.h>

#include <type_traits>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int ST_THREADS = 256;
constexpr int ST_MAX_LOG_W = 17;
constexpr int ST_MAX_LOG_C = 3;           // clusters of up to 8 blocks (portable)
constexpr int ST_TILE_LOG_BYTES = 17;      // a block's T rows x 2^l words: at most 128 KB
constexpr int ST_MIN_SPLIT_LOG_BYTES = 10;  // the u64 pick splits a row into slices of >= 1 KB
constexpr int ST32_MIN_SLICE_LOG = 8;      // the u32 pick: slices of >= 2^8 words,
constexpr int ST32_MIN_ROW_LOG = 11;       // of rows of >= 2^11 words
constexpr int ST_SMEM_MAX = 232448;        // 227 KB

template <class W>
struct StagesArgs {
  const W* in;  // (rows, 2^log_w)
  W* out;       // (rows, 2^log_w)
  const W* w;   // (log_w, 2^log_w): stage s's entry of lane i at s 2^log_w + i
  const W* wp;  // their Shoup quotients
  W q;
  int rows, log_w;
  int log_c, tile;  // clusters of 2^log_c blocks a row, tiles of `tile` rows
  int out_factor;   // the forward's: 1, 2 or 4 (u32: 1 or 4)
  int log_in;       // the u64 inverse's: log2(in_factor)
  int log_out;      // the u64 inverse's final bound, 2^log_out q (its output chain)
};

// A launch with 2^log_c blocks a cluster and tiles of `tile` rows of words
// of 2^log_size bytes is possible: slices of at least one word a block's
// share of the first (or last) c stages, a block's tile at most 128 KB.
__host__ __device__ inline bool grid_ok(int log_w, int log_c, int tile, int log_size) {
  const int l = log_w - log_c;
  return log_c >= 0 && log_c <= ST_MAX_LOG_C && l >= 1 && l >= log_c && tile >= 1 && tile <= 8 &&
         ((long)tile << (l + log_size)) <= (1L << ST_TILE_LOG_BYTES);
}

// Threads a block: one a group of the slice's remainder pass (its most
// groups), at least a warp and at most ST_THREADS.
inline int st_threads(int l) {
  const int groups = l > 3 ? 1 << (l - remainder_stages(l)) : 1;
  return groups < 32 ? 32 : groups > ST_THREADS ? ST_THREADS : groups;
}

inline size_t st_smem(int l, int tile, int log_size) { return (size_t)tile << (l + log_size); }

// The tile's rows in shared memory, and the word of slot j of row r: u64
// words swizzled on the tile's word index (swz64), u32 words within each
// row (SwzNtt, kernels 1-2's).
template <class W>
struct StSmem;
template <>
struct StSmem<uint64_t> {
  using Rows = SmemRows64;
  static __device__ __forceinline__ int at(int l, int r, int j) { return swz64((r << l) + j); }
};
template <>
struct StSmem<uint32_t> {
  using Rows = SmemRows<SwzNtt>;
  static __device__ __forceinline__ int at(int l, int r, int j) { return (r << l) + SwzNtt::at(j); }
};

// The block's part: slice `rank` (lanes rank 2^l ..) of the `count` rows of
// its tile from row0.
struct Slice {
  int rank, count, l;
  size_t row0;
};

template <class W>
__device__ __forceinline__ Slice block_slice(const StagesArgs<W>& a) {
  const int rank = (int)blockIdx.x & ((1 << a.log_c) - 1);
  const int row0 = ((int)blockIdx.x >> a.log_c) * a.tile;
  return Slice{rank, min(a.tile, a.rows - row0), a.log_w - a.log_c, (size_t)row0};
}

// ---------------------------------------------------------------------------
// The butterflies and output fixes of each word type

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

// The u64 forward's butterfly on (x, y) with the x lane's entry: deferred (x
// + m, x + 4q - m, m the approximate Shoup product in [0, 4q)) or exact (x
// below 2q first, m in [0, 2q), x + m, x + 2q - m).
template <bool DEFER>
struct FwdBf64 {
  static constexpr Slots slots = Slots::x;
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

// The u64 inverse's bound schedule over R consecutive stages, from the
// words' bound 2^log_c q before the first (advanced past the R stages): a
// stage where 2 c q >= 2^64 first cuts every word below 2q, then after the
// stage c = max(2c, 4).  The cut depends only on the stage, q and
// in_factor, so it is resolved once a pass, and so is its kind: 0 no stage
// cuts, 1 every cut is one subtraction of 2q (from 4q: at q >= 2^61 every
// stage after the first), 2 a longer chain.
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

// The u64 inverse's butterflies of a pass of KIND (InvSched): x + y and
// shoup64_approx(x + c q - y) with the x lane's entry, after the stage's
// cut of all the group's words (words(), outside the butterflies).  A
// runtime branch or loop among the unrolled butterflies costs a third of
// the pass, so the kind is a template: none, one branch-free conditional
// subtraction (of 2q, or of 2^64 - 1 where the stage does not cut: its
// words are below 2^63), or the chain.
template <int R, int KIND>
struct InvBf64 {
  static constexpr Slots slots = Slots::x;
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

// The u64 inverse's butterflies of the next R stages, for
// inv_passes / cross_inverse: with<R>(f) runs f(bf) with their kind
// resolved to a template, advancing log_c past them.
struct InvBfs64 {
  uint64_t q;
  int& log_c;
  template <int R, class F>
  __device__ __forceinline__ void with(const F& f) const {
    const InvSched<R> s(q, log_c);
    if (s.kind == 0)
      f(InvBf64<R, 0>{q, s});
    else if (s.kind == 1)
      f(InvBf64<R, 1>{q, s});
    else
      f(InvBf64<R, 2>{q, s});
  }
};

// The u64 forward's output words: the deferred chain from (4 + 4 log_w) q
// to 4q, then below 2q for out_factor <= 2 and below q for 1.
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

// The u64 inverse's output words: below 2^log_out q to below 2q.
struct InvOut {
  uint64_t q;
  int log_out;
  static __device__ __forceinline__ InvOut of(const StagesArgs<uint64_t>& a) {
    return InvOut{a.q, a.log_out};
  }
  template <int G>
  __device__ __forceinline__ void operator()(uint64_t (&v)[G]) const {
    chain_down(v, q, log_out, 1);
  }
};

// The u32 forward's butterfly, the select form (_make_fwd_kernel32): x
// below 2q, then each word multiplies y by its own lane's entry, x + w_x y
// and x + 2q - w_y y (Shoup products in [0, 2q); words in [0, 4q)).
struct FwdBf32 {
  static constexpr Slots slots = Slots::both;
  uint32_t q;
  template <int G>
  __device__ __forceinline__ void words(int, uint32_t (&)[G]) const {}
  __device__ __forceinline__ void operator()(int, uint32_t& x, uint32_t& y, uint32_t wx,
                                             uint32_t wpx, uint32_t wy, uint32_t wpy) const {
    const uint32_t tx = reduce_once(x, 2 * q);
    const uint32_t mx = shoup_mul_lazy(y, wx, wpx, q);
    const uint32_t my = shoup_mul_lazy(y, wy, wpy, q);
    x = tx + mx;
    y = tx + 2 * q - my;
  }
};

// The u32 inverse's butterfly (_make_inv_stages_kernel32): x + y below 2q,
// Shoup(x + 2q - y) with the y lane's entry; words in [0, 2q).
struct InvBf32 {
  static constexpr Slots slots = Slots::y;
  uint32_t q;
  template <int G>
  __device__ __forceinline__ void words(int, uint32_t (&)[G]) const {}
  __device__ __forceinline__ void operator()(int, uint32_t& x, uint32_t& y, uint32_t w,
                                             uint32_t wp) const {
    const uint32_t sum = x + y;
    y = shoup_mul_lazy(x + 2 * q - y, w, wp, q);
    x = reduce_once(sum, 2 * q);
  }
};

// The u32 inverse's butterflies for inv_passes / cross_inverse: the same
// at every stage.
struct InvBfs32 {
  uint32_t q;
  template <int R, class F>
  __device__ __forceinline__ void with(const F& f) const {
    f(InvBf32{q});
  }
};

// The u32 forward's output words: canonical (two conditional subtractions)
// or as they are, lazy in [0, 4q).
struct FwdOut32 {
  uint32_t q;
  bool canonical;
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&v)[G]) const {
    if (canonical) {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = reduce_once(reduce_once(v[k], 2 * q), q);
    }
  }
};

// The u32 inverse's output words, as they are (lazy in [0, 2q)).
struct InvOut32 {
  static __device__ __forceinline__ InvOut32 of(const StagesArgs<uint32_t>&) { return {}; }
  template <int G>
  __device__ __forceinline__ void operator()(uint32_t (&)[G]) const {}
};

// ---------------------------------------------------------------------------
// The passes, the stages across a cluster and the kernels, on either word

// The tile's rows in device memory from the block's first lane (slot c of
// row r at p + r 2^log_w + c): a group's 2^R adjacent words (ls = 0) in
// 8- or 16-byte accesses, else one word at a time, a warp's words adjacent.
template <class W>
struct GlobalRows {
  const W* p;
  int log_w;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, W (&v)[G]) const {
    const W* r = p + ((size_t)row << log_w) + base;
    if (ls == 0) {
      load_words(r, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = Word<W>::ldg(r + (k << ls));
    }
  }
};

// The same rows as the output, each word through `fix` as it is stored.
template <class W, class FIX>
struct GlobalOut {
  W* p;
  int log_w;
  FIX fix;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const W (&v)[G]) const {
    W o[G];
#pragma unroll
    for (int k = 0; k < G; ++k) o[k] = v[k];
    fix(o);
    W* r = p + ((size_t)row << log_w) + base;
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

// A cluster barrier in halves (barrier.cluster.arrive / .wait): the u32
// pair arrives as early as its part allows and waits as late, so the
// barrier's latency hides behind its loads or stores.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The forward's stages within a slice of 2^l words: radix-8 passes, the
// remainder last; the first reads `src` after sync0, the middle ones the
// shared-memory rows, the last stores to `dst`.
template <class W, class BF, class SRC, class SYNC0, class ROWS, class DST>
__device__ __forceinline__ void fwd_passes(int count, int l, const LaneTable<W>& tab, const BF& bf,
                                           const SRC& src, const SYNC0& sync0, const ROWS& rows,
                                           const DST& dst) {
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
// stages) first, from device memory, the last storing to `dst`; bfs gives
// each pass's butterflies (InvBfs64 advances the words' bound past them).
template <class W, class BFS, class ROWS, class DST>
__device__ __forceinline__ void inv_passes(int count, int l, const LaneTable<W>& tab,
                                           const BFS& bfs, const GlobalRows<W>& src,
                                           const ROWS& rows, const DST& dst) {
  const int r = remainder_stages(l);
  if (r == 3) {
    bfs.template with<3>([&](const auto& bf) {
      if (l == 3) lane_pass<3, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<3, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  } else if (r == 2) {
    bfs.template with<2>([&](const auto& bf) {
      if (l == 2) lane_pass<2, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<2, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  } else {
    bfs.template with<1>([&](const auto& bf) {
      if (l == 1) lane_pass<1, true>(count, l, 0, tab, NoSync{}, src, dst, bf);
      else lane_pass<1, true>(count, l, 0, tab, NoSync{}, src, rows, bf);
    });
  }
  for (int s0 = r; s0 < l; s0 += 3) {
    bfs.template with<3>([&](const auto& bf) {
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
// in registers with the entries the butterfly reads, read once for the
// tile's rows; word k goes to slice k's shared memory (block k of the
// cluster), once every block of the cluster has started (a cluster
// barrier; the u32 pair arrives at once and waits only before its first
// store, behind its first group's loads and stages).
template <int C, class W, class BF>
__device__ __forceinline__ void cross_forward(const StagesArgs<W>& a, const Slice& b, W* sm,
                                              const BF& bf) {
  constexpr int c = C == 2 ? 1 : C == 4 ? 2 : 3;
  constexpr bool SPLIT = sizeof(W) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = 1 << (b.l - c), first = b.rank * per + (int)threadIdx.x;
  const LaneTable<W> tab{a.w, a.wp, (size_t)1 << a.log_w};
  const W* in = a.in + (b.row0 << a.log_w);
  W w[c][C], wp[c][C];
  if (first < (b.rank + 1) * per) tab.template get<c, false, BF::slots>(first, b.l, w, wp);
  bool waiting = SPLIT;
  if constexpr (SPLIT)
    cluster_arrive_relaxed();
  else
    cluster.sync();
  for (int j = first; j < (b.rank + 1) * per; j += blockDim.x) {
    if (j != first) tab.template get<c, false, BF::slots>(j, b.l, w, wp);
    for (int r = 0; r < b.count; ++r) {
      W v[C];
#pragma unroll
      for (int k = 0; k < C; ++k) v[k] = Word<W>::ldg(in + ((size_t)r << a.log_w) + j + (k << b.l));
      lane_stages<c, false>(v, w, wp, bf);
      if (SPLIT && waiting) {
        cluster_wait();
        waiting = false;
      }
      W* word = sm + StSmem<W>::at(b.l, r, j);
#pragma unroll
      for (int k = 0; k < C; ++k) *cluster.map_shared_rank(word, k) = v[k];
    }
  }
  if (SPLIT && waiting) cluster_wait();
}

// The inverse's last c stages of a split row, mirrored: after a cluster
// barrier (every slice's own stages done), group j gathers word j of each
// slice over distributed shared memory, runs the stages and stores the C
// words to device memory through the output fix (FIX::of(a)); a second
// barrier keeps every slice alive until its peers' reads are done (the u32
// pair arrives after its last gather and waits after its stores).
template <int C, class FIX, class W, class BFS>
__device__ __forceinline__ void cross_inverse(const StagesArgs<W>& a, const Slice& b, W* sm,
                                              const BFS& bfs) {
  constexpr int c = C == 2 ? 1 : C == 4 ? 2 : 3;
  constexpr bool SPLIT = sizeof(W) == 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int per = 1 << (b.l - c), first = b.rank * per + (int)threadIdx.x;
  const size_t stride = (size_t)1 << a.log_w;
  const LaneTable<W> tab{a.w + b.l * stride, a.wp + b.l * stride, stride};
  const FIX fix = FIX::of(a);
  W* out = a.out + (b.row0 << a.log_w);
  bool arrived = false;
  bfs.template with<c>([&](const auto& bf) {
    constexpr Slots S = std::decay_t<decltype(bf)>::slots;
    W w[c][C], wp[c][C];
    if (first < (b.rank + 1) * per) tab.template get<c, true, S>(first, b.l, w, wp);
    cluster.sync();  // every slice's stages within it are done
    for (int j = first; j < (b.rank + 1) * per; j += blockDim.x) {
      if (j != first) tab.template get<c, true, S>(j, b.l, w, wp);
      const bool last = j + (int)blockDim.x >= (b.rank + 1) * per;
      for (int r = 0; r < b.count; ++r) {
        W v[C];
        W* word = sm + StSmem<W>::at(b.l, r, j);
#pragma unroll
        for (int k = 0; k < C; ++k) v[k] = *cluster.map_shared_rank(word, k);
        if (SPLIT && last && r == b.count - 1) {
          cluster_arrive();  // this thread's reads of its peers are done
          arrived = true;
        }
        lane_stages<c, true>(v, w, wp, bf);
        fix(v);
#pragma unroll
        for (int k = 0; k < C; ++k) out[((size_t)r << a.log_w) + j + (k << b.l)] = v[k];
      }
    }
  });
  if constexpr (SPLIT) {
    if (!arrived) cluster_arrive();
    cluster_wait();  // keep every slice alive until its peers' reads are done
  } else {
    cluster.sync();  // keep every slice alive until its peers' reads are done
  }
}

// A forward launch's block: its slice of its tile's rows.
template <class W, class BF, class FIX>
__device__ __forceinline__ void forward_block(const StagesArgs<W>& a, W* sm, const BF& bf,
                                              const FIX& fix) {
  const Slice b = block_slice(a);
  const size_t stride = (size_t)1 << a.log_w;
  const size_t lane0 = (size_t)b.rank << b.l;
  const GlobalOut<W, FIX> dst{a.out + (b.row0 << a.log_w) + lane0, a.log_w, fix};
  // the slice's stages: the table's rows log_c .., its lanes from lane0
  const LaneTable<W> tab{a.w + a.log_c * stride + lane0, a.wp + a.log_c * stride + lane0, stride};
  const typename StSmem<W>::Rows rows{sm, b.l};
  if (a.log_c == 0) {
    fwd_passes(b.count, b.l, tab, bf, GlobalRows<W>{a.in + (b.row0 << a.log_w), a.log_w},
               NoSync{}, rows, dst);
    return;
  }
  if (a.log_c == 1) cross_forward<2>(a, b, sm, bf);
  if (a.log_c == 2) cross_forward<4>(a, b, sm, bf);
  if (a.log_c == 3) cross_forward<8>(a, b, sm, bf);
  fwd_passes(b.count, b.l, tab, bf, rows, ClusterSync{}, rows, dst);
}

// An inverse launch's block, mirrored; its output words through FIX::of(a).
template <class FIX, class W, class BFS>
__device__ __forceinline__ void inverse_block(const StagesArgs<W>& a, W* sm, const BFS& bfs) {
  const Slice b = block_slice(a);
  const size_t stride = (size_t)1 << a.log_w;
  const size_t lane0 = (size_t)b.rank << b.l;
  const LaneTable<W> tab{a.w + lane0, a.wp + lane0, stride};  // the slice's stages 0 .. l-1
  const GlobalRows<W> src{a.in + (b.row0 << a.log_w) + lane0, a.log_w};
  const typename StSmem<W>::Rows rows{sm, b.l};
  if (a.log_c == 0) {
    const GlobalOut<W, FIX> dst{a.out + (b.row0 << a.log_w), a.log_w, FIX::of(a)};
    inv_passes(b.count, b.l, tab, bfs, src, rows, dst);
    return;
  }
  inv_passes(b.count, b.l, tab, bfs, src, rows, rows);
  if (a.log_c == 1) cross_inverse<2, FIX>(a, b, sm, bfs);
  if (a.log_c == 2) cross_inverse<4, FIX>(a, b, sm, bfs);
  if (a.log_c == 3) cross_inverse<8, FIX>(a, b, sm, bfs);
}

template <bool DEFER>
__global__ void __launch_bounds__(ST_THREADS, 1) stages64_forward_kernel(const StagesArgs<uint64_t> a) {
  extern __shared__ __align__(16) uint64_t sm[];
  forward_block(a, sm, FwdBf64<DEFER>{a.q},
                FwdOut<DEFER>{a.q, 32 - __clz(4 * a.log_w + 3), a.out_factor});
}

__global__ void __launch_bounds__(ST_THREADS, 1) stages64_inverse_kernel(const StagesArgs<uint64_t> a) {
  extern __shared__ __align__(16) uint64_t sm[];
  int log_c = a.log_in;  // the words' bound, advanced stage by stage
  inverse_block<InvOut>(a, sm, InvBfs64{a.q, log_c});
}

__global__ void __launch_bounds__(ST_THREADS, 1) lane32_forward_kernel(const StagesArgs<uint32_t> a) {
  extern __shared__ __align__(16) uint32_t sm32[];
  forward_block(a, sm32, FwdBf32{a.q}, FwdOut32{a.q, a.out_factor == 1});
}

__global__ void __launch_bounds__(ST_THREADS, 1) lane32_inverse_kernel(const StagesArgs<uint32_t> a) {
  extern __shared__ __align__(16) uint32_t sm32[];
  inverse_block<InvOut32>(a, sm32, InvBfs32{a.q});
}

// ---------------------------------------------------------------------------
// The launches

// What the launches read of a device, set up at the first launch there: the
// SM count and, per kernel (Kind), log_w, c and tile, how many blocks of it
// the card runs at once (0 where it does not fit); the kernels'
// shared-memory cap is raised to ST_SMEM_MAX.
enum Kind { INV64 = 0, FWD64 = 1, FWD64_DEFER = 2, INV32 = 3, FWD32 = 4, KINDS = 5 };

inline bool forward_kind(int kind) { return kind != INV64 && kind != INV32; }
inline int log_size(int kind) { return kind >= INV32 ? 2 : 3; }

struct StDevice {
  int sms = 0;
  bool ready[KINDS][ST_MAX_LOG_W + 1] = {};
  int wave[KINDS][ST_MAX_LOG_W + 1][ST_MAX_LOG_C + 1][4] = {};
};

const void* kernel_of(int kind) {
  switch (kind) {
    case INV64: return (const void*)stages64_inverse_kernel;
    case FWD64: return (const void*)stages64_forward_kernel<false>;
    case FWD64_DEFER: return (const void*)stages64_forward_kernel<true>;
    case INV32: return (const void*)lane32_inverse_kernel;
    default: return (const void*)lane32_forward_kernel;
  }
}

// Blocks of kernel `kind` at (log_w, c, tile) that the card runs at once:
// the SMs times the blocks an SM holds, or for a cluster launch the
// clusters the card holds times their size.
cudaError_t wave_blocks(int kind, int log_w, int c, int tile, int sms, int* out) {
  const int l = log_w - c;
  const size_t smem = st_smem(l, tile, log_size(kind));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1 << c);
  cfg.blockDim = dim3(st_threads(l));
  cfg.dynamicSmemBytes = smem;
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel_of(kind), st_threads(l), smem);
    n *= sms;
  } else {
    e = cudaOccupancyMaxActiveClusters(&n, kernel_of(kind), &cfg);
    n <<= c;
  }
  *out = n;
  return e;
}

int st_device(int kind, int log_w, const StDevice** out) {
  static StDevice cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  StDevice& d = cached[dev];
  if (d.sms == 0) {
    int sms = 0;
    for (int k = 0; k < KINDS && e == cudaSuccess; ++k)
      e = cudaFuncSetAttribute(kernel_of(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ST_SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    d.sms = sms;
  }
  if (!d.ready[kind][log_w]) {
    for (int c = 0; c <= ST_MAX_LOG_C; ++c)
      for (int i = 0; i < 4; ++i)
        if (grid_ok(log_w, c, 1 << i, log_size(kind))) {
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
// table entry read once a tile), then the smallest cluster.  The u64 pair
// splits a row only into slices of at least 2^ST_MIN_SPLIT_LOG_BYTES bytes
// (twice that forward): its inverse's passes cost more (each stage's cut
// and x + c q - y), so spreading its work pays at smaller widths.  The u32
// pair splits only rows of at least 2^ST32_MIN_ROW_LOG words, into slices
// of at least 2^ST32_MIN_SLICE_LOG words: below that, one block a row (a
// warp or two) beats the stages across a cluster in both directions, above
// it 8 blocks a row beat every smaller cluster (cmux_mxu_timing.py --stages
// --grids).  A tile no larger than the rows need.  The only copy of the
// rule.
int pick_grid(const StDevice& d, int kind, int rows, int log_w, int* log_c, int* tile) {
  const bool forward = forward_kind(kind), u32 = kind >= INV32;
  const int min_split = u32 ? ST32_MIN_SLICE_LOG : ST_MIN_SPLIT_LOG_BYTES - 3 + forward;
  long best[5] = {0, 0, 0, 0, 0};  // waves, phases, -SMs, -tile, c
  bool found = false;
  for (int c = 0; c <= ST_MAX_LOG_C; ++c) {
    if (c > 0 && (log_w - c < min_split || (u32 && log_w < ST32_MIN_ROW_LOG))) break;
    for (int i = 0; i < 4; ++i) {
      const int t = 1 << i;
      if (!grid_ok(log_w, c, t, log_size(kind)) || (i > 0 && t / 2 >= rows)) break;
      const long held = d.wave[kind][log_w][c][i];
      if (held <= 0) continue;
      const long grid = (long)((rows + t - 1) / t) << c;
      const long phases = forward ? (log_w - c + 2) / 3 + (c > 0) : 0;
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

bool valid32(int q, int rows, int log_w) {
  return rows >= 1 && log_w >= 1 && log_w <= ST_MAX_LOG_W && q >= 2 && q < (1 << 30);
}

int kind64(bool forward, uint64_t q, int log_w) {
  // the TPU kernel's test: (4 + 4 log_w) q < 2^64
  if (!forward) return INV64;
  return q <= (~0ull) / (uint64_t)(4 + 4 * log_w) ? FWD64_DEFER : FWD64;
}

// Picks the grid of `kind` for a.rows rows of 2^a.log_w words and launches
// it on `stream` (a.in and a.out 16-byte aligned).
template <class W>
int launch(int kind, StagesArgs<W> a, void* stream) {
  if ((((uintptr_t)a.in | (uintptr_t)a.out) & 15) != 0) return (int)cudaErrorInvalidValue;
  const StDevice* d = nullptr;
  int err = st_device(kind, a.log_w, &d);
  if (err != 0) return err;
  err = pick_grid(*d, kind, a.rows, a.log_w, &a.log_c, &a.tile);
  if (err != 0) return err;
  const int l = a.log_w - a.log_c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.rows + a.tile - 1) / a.tile) << a.log_c);
  cfg.blockDim = dim3(st_threads(l));
  cfg.dynamicSmemBytes = st_smem(l, a.tile, log_size(kind));
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << a.log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.log_c > 0 ? 1 : 0;
  cudaError_t e;
  if constexpr (sizeof(W) == 4) {
    e = kind == INV32 ? cudaLaunchKernelEx(&cfg, lane32_inverse_kernel, a)
                      : cudaLaunchKernelEx(&cfg, lane32_forward_kernel, a);
  } else {
    if (kind == INV64)
      e = cudaLaunchKernelEx(&cfg, stages64_inverse_kernel, a);
    else if (kind == FWD64)
      e = cudaLaunchKernelEx(&cfg, stages64_forward_kernel<false>, a);
    else
      e = cudaLaunchKernelEx(&cfg, stages64_forward_kernel<true>, a);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch64(bool forward, const void* in, void* out, const void* w, const void* wp, uint64_t q,
             int rows, int log_w, int out_factor, int in_factor, void* stream) {
  if (!valid64(q, rows, log_w)) return (int)cudaErrorInvalidValue;
  if (forward ? out_factor != 1 && out_factor != 2 && out_factor != 4
              : in_factor < 2 || (in_factor & (in_factor - 1)))
    return (int)cudaErrorInvalidValue;
  StagesArgs<uint64_t> a{};
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
  return launch(kind64(forward, q, log_w), a, stream);
}

int launch32(bool forward, const void* in, void* out, const void* w, const void* wp, int q,
             int rows, int log_w, int canonical, void* stream) {
  if (!valid32(q, rows, log_w)) return (int)cudaErrorInvalidValue;
  StagesArgs<uint32_t> a{};
  a.in = (const uint32_t*)in;
  a.out = (uint32_t*)out;
  a.w = (const uint32_t*)w;
  a.wp = (const uint32_t*)wp;
  a.q = (uint32_t)q;
  a.rows = rows;
  a.log_w = log_w;
  a.out_factor = canonical ? 1 : 4;
  return launch(forward ? FWD32 : INV32, a, stream);
}

int grid_of(int kind, int rows, int log_w, int* log_c, int* tile) {
  const StDevice* d = nullptr;
  const int err = st_device(kind, log_w, &d);
  if (err != 0) return err;
  return pick_grid(*d, kind, rows, log_w, log_c, tile);
}

}  // namespace

extern "C" {

// The u32 forward: the final log_w stages (log_w 1-17, q < 2^30) of `rows`
// rows (in and out 16-byte aligned), input below 4q, output canonical or
// lazy below 4q.
int pft_ntt32_stages_forward(const void* in, void* out, const void* w, const void* wp, int q,
                             int rows, int log_w, int canonical, void* stream) {
  return launch32(true, in, out, w, wp, q, rows, log_w, canonical, stream);
}

// The u32 inverse: the first log_w stages, input and output lazy in [0, 2q).
int pft_ntt32_stages_inverse(const void* in, void* out, const void* w, const void* wp, int q,
                             int rows, int log_w, void* stream) {
  return launch32(false, in, out, w, wp, q, rows, log_w, 0, stream);
}

// The u64 forward: the final log_w stages (log_w 1-17, q < 2^62) of `rows`
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

// The grid a u32 launch takes on the current device (pick_grid): clusters
// of 2^log_c blocks a row and tiles of `tile` rows.
int pft_ntt32_stages_grid(int forward, int q, int rows, int log_w, int* log_c, int* tile) {
  if (!valid32(q, rows, log_w)) return (int)cudaErrorInvalidValue;
  return grid_of(forward ? FWD32 : INV32, rows, log_w, log_c, tile);
}

// The grid a u64 launch takes on the current device (pick_grid).
int pft_ntt64_stages_grid(int forward, uint64_t q, int rows, int log_w, int* log_c, int* tile) {
  if (!valid64(q, rows, log_w)) return (int)cudaErrorInvalidValue;
  return grid_of(kind64(forward != 0, q, log_w), rows, log_w, log_c, tile);
}

}  // extern "C"
