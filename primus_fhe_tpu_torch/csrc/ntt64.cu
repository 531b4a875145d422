// Row 10, kernels ntt64_forward and ntt64_inverse: the 64-bit negacyclic NTT
// and its inverse (q < 2^62, n = 2^1 .. 2^17), every modulus of a DCRT plan
// in one launch.  Below them, kernel E (mxu8_roundtrip64_mul, the product
// by a fixed NTT-domain operand) on the same passes and tiles.
//
// Replace pallas_forward64 / pallas_inverse64
// (primus_fhe_tpu/ops/ntt_pallas.py:486,494; bodies _make_fwd_kernel and
// _make_inv_kernel).  The TPU kernels carry u64 words as u32 pairs with
// pre-split 16-bit limb tables and move the butterfly partner with lane
// rolls; here a word is a uint64_t and a Shoup multiply is three native
// multiplies (__umul64hi).
//
// What bounds them: at n = 4096 a row is 32 KB in and 32 KB out against
// 2048 x 12 Shoup butterflies, so a batch of hundreds of rows could be
// bound by device memory (256 rows, 16.8 MB: 5.0 us at 3.35 TB/s), and a
// batch of a few rows (the DCRT rotation's batch-1 step: 16 rows forward,
// 4 inverse) is bound by the chain of one row through its stages on one SM.
// The first design (one block a row, n/2 threads capped at 1024, one
// radix-2 butterfly a thread a stage, both twiddle words loaded from device
// memory at every butterfly, unswizzled rows) ran 12 barriers and 12 L2
// round trips a row at n = 4096 and took 5.5x its byte bound at 256 rows.
// This one (below) leaves a row's chain issue-bound on its SM: a u64
// Shoup butterfly is three 64 x 64-bit products and its lazy reductions,
// some 27 instructions, and a radix-8 pass of a row takes ~3.2k cycles
// (cmux_mxu_timing.py --ntt64 --phases), 4 of them ~16k cycles at batch 1
// and about as many a row at 256 rows, two rows to an SM.
//
// The design on Hopper is kernels 1-2's (csrc/ntt32.cu) on u64 words:
// - radix-8 register passes (csrc/ntt_passes.cuh, the templates kernels 1-2
//   and the CMux step kernel run at 32 bits): a thread holds 8 words in
//   registers through 3 stages, so a transform is ceil(log_n / 3) passes
//   with a barrier after each (4 at n = 4096).  The forward's last pass and
//   the inverse's first take the remainder, R = 1..3 stages.  The forward's
//   first pass reads its groups straight from device memory with
//   roots[1..7] in registers, and its last pass stores its 2^R adjacent
//   words straight to device memory, 16 bytes an access; the inverse
//   mirrors it (its first pass loads 2^R adjacent words and runs the input
//   chain from [0, in_factor q) down to [0, 2q); its last folds inv_n in and
//   stores a warp's 256 contiguous bytes at a time).  log_n <= 3 is one
//   pass, device memory to device memory.
// - shared memory swizzled for 8-byte words (swz64): a u64 access is served
//   a half-warp at a time, so the swizzle makes the word index mod 16
//   distinct across each half-warp at every pass and every coefficient-
//   order sweep.  It acts on a word's index in the tile, so tiles of short
//   rows, whose half-warps span rows, are conflict free too
//   (tests/test_torch_ntt64_model.py checks both).
// - root tables staged once a block by cp.async under the row loads and the
//   first pass: the forward's whole table and Shoup quotients (16 bytes a
//   word: 64 KB a modulus at n = 4096), the inverse's part that its passes
//   after the first use (the last n / 2^R words), wherever that fits beside
//   one row (the forward up to n = 2^13, the inverse up to 2^14); else the
//   passes read their twiddles from device memory through L1.
// - a tile of T rows of one modulus a block, so that each staged table word
//   serves T rows: grid count x ceil(rows_per_mod / T), a ragged last tile
//   loading and storing only its own rows.  The C entry picks T (pick_tile:
//   the smallest T whose grid runs in one wave); no caller sets it.  256
//   threads a block, fewer where the tile has fewer radix-8 groups.
// - a row of n = 2^15 .. 2^17 words (256 KB - 1 MB) does not fit one
//   block's shared memory, so there a row runs over a cluster of C =
//   2^(log_n - 14) blocks (2, 4 or 8: a portable cluster size), one slice
//   of 2^14 words (128 KB) each, as kernels 1-2 split their rows
//   (csrc/ntt_split.cuh, on u64 words): the forward's first log_n - 14
//   stages run on groups of one word a slice (the radix-C group j: words j +
//   k 2^14), each block taking 1/C of the offsets and storing word k into
//   slice k over distributed shared memory; then every stage pairs words of
//   one slice (SliceTable gives the slice's twiddles); the inverse runs its
//   stages within the slices (SliceInvTable) and its last log_n - 14 on
//   groups gathered from the slices, inv_n folded into the final one.
//   Twiddles are read from device memory through L1 there.
// - past 2^17 (to 2^26) the four-step through device memory
//   (csrc/ntt_columns.cuh): the column launch (four_step_columns,
//   csrc/ntt_columns.cu) runs the stages across sub-rows, and the sub-row
//   launch here the rest: the cluster body on one block a sub-row of 2^14
//   words (split = log_n - 14 blocks a row, no cluster), its words from
//   device memory, SliceTable / SliceInvTable at the sub-row's rank, the
//   inverse's (and kernel E's) lazy words stored for the column launch
//   after it.  Every C entry below issues its column launches itself
//   (kernel E both: three launches), so each stays a whole transform.
//
// The butterflies are the plain version's (transforms/ntt.py forward64 /
// inverse64) with its lazy ranges, applied to the same pairs stage by
// stage, so every output word is bit-equal to it: the forward's bit-reversed
// output lazy in [0, 4q) (past 2^63 for q near 2^62, so every comparison is
// unsigned) or canonical, the inverse's normal-order output lazy in [0, 2q)
// or canonical.  The TPU forward defers its reductions while (4 + 4 log_n) q
// < 2^64 and so reaches other lazy representatives (the same residues).
//
// Values are u64 words (int64 storage on the PyTorch side).

#include <cooperative_groups.h>

#include <type_traits>

#include "ntt_columns.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTT_THREADS = 256;
constexpr int MAX_LOG_N = CLUSTER_MAX_LOG_N;  // past it, the four-step's sub-row launch
constexpr int SLICE_LOG = SUB_LOG;  // past it, a row over 2^(log_n - SLICE_LOG) blocks
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may ask for

struct Ntt64Args {
  const uint64_t* in;   // (count, rows, n)
  uint64_t* out;        // (count, rows, n)
  const uint64_t* tw;   // (count, n): the forward's roots or the inverse's
  const uint64_t* twp;  // their Shoup quotients
  ModSet64 ms;
  int rows, log_n, tile, in_factor;
  const uint64_t* key;  // (count, 2, n): the inverse's IN_KEY load (kernel D's key), else unused
};

// How the inverse's first pass takes its words from device memory: the
// input chain from [0, in_factor q) (row 10's inverse); any u64 word
// brought to [0, 2q) by a lazy Shoup multiply by 1 (row 9's inverse64 at
// log_n 13-26); or any u64 word times the key by a lazy Shoup multiply
// (kernel D at log_n 13-26: E's key step without the forward).  The
// forward's ANY flag is the second: row 9's forward64 takes any u64 word.
enum InLoad { IN_CHAIN = 0, IN_ANY = 1, IN_KEY = 2 };

// Blocks a row is split over (log2): log_n - SLICE_LOG where a row
// overflows one block's shared memory (n = 2^15 .. 2^17: a cluster; past
// MAX_LOG_N the four-step's sub-rows, one a block, no cluster).
__host__ __device__ inline int log_split(int log_n) {
  return log_n > SLICE_LOG ? log_n - SLICE_LOG : 0;
}

// Runs f(std::integral_constant<int, LC>()) for the slices' LC = lc (1-3):
// the cross stages are templates on LC.
template <class F>
__device__ __forceinline__ void with_lc(int lc, const F& f) {
  if (lc == 1) f(std::integral_constant<int, 1>());
  if (lc == 2) f(std::integral_constant<int, 2>());
  if (lc == 3) f(std::integral_constant<int, 3>());
}

// Words of each root table a block stages: none for one pass or a row
// over a cluster; the inverse's part that its passes after the first use (at most
// 4096 words, 64 KB with the quotients, beside a row of at most 128 KB);
// the forward's whole table where it fits beside one row (16 n + 8 n bytes,
// up to n = 2^13).
__host__ __device__ inline int staged_words(bool forward, int log_n) {
  if (log_n <= 3 || log_split(log_n)) return 0;
  if (!forward) return (1 << log_n) >> remainder_stages(log_n);
  return log_n <= 13 ? 1 << log_n : 0;
}

// Threads a block: one a group of a radix-8 pass over the tile (T n / 8
// groups), at least a warp and at most NTT_THREADS, so that a tile of short
// rows (phase 12's n = 256) leaves no thread idle.
inline int tile_threads(int log_n, int tile) {
  const int groups = tile << (log_n > 3 ? log_n - log_split(log_n) - 3 : 0);
  return groups < 32 ? 32 : groups > NTT_THREADS ? NTT_THREADS : groups;
}

inline size_t smem_bytes(bool forward, int log_n, int tile) {
  if (log_n <= 3) return 0;
  return 16 * (size_t)staged_words(forward, log_n) +
         sizeof(uint64_t) * ((size_t)tile << (log_n - log_split(log_n)));
}

// The block's tile: modulus mi, `count` rows from the tile's first, at word
// offset `off`; h is the block's slice of a row over a cluster (its rank
// there; else 0).
struct Tile {
  int mi, count, h;
  size_t off;
};

__device__ __forceinline__ Tile block_tile(const Ntt64Args& a) {
  const int split = log_split(a.log_n);
  const int b = (int)blockIdx.x >> split;
  const int tiles = (a.rows + a.tile - 1) / a.tile;
  const int mi = b / tiles;
  const int row0 = (b - mi * tiles) * a.tile;
  return Tile{mi, min(a.tile, a.rows - row0), (int)blockIdx.x & ((1 << split) - 1),
              ((size_t)mi * a.rows + row0) << a.log_n};
}

// Starts the copy of words [lo, hi) of a modulus's table and quotients into
// tw[0 ..), twp[0 ..) (16 bytes a thread a step).
__device__ __forceinline__ void stage_tables(uint64_t* tw, uint64_t* twp, const uint64_t* g,
                                             const uint64_t* gp, int lo, int hi) {
  for (int i = 2 * threadIdx.x; i < hi - lo; i += 2 * blockDim.x) {
    cp_async16(tw + i, g + lo + i);
    cp_async16(twp + i, gp + lo + i);
  }
  cp_async_commit();
}

// A tile's rows in device memory: a group's words in 16-byte accesses where
// they are adjacent (ls = 0), else one word at a time (a warp's words then
// adjacent).  CHAIN: the inverse's input chain, conditional subtractions
// of in_factor/2 q, ..., 2q taking a word below in_factor q below 2q.
template <bool CHAIN>
struct GlobalIn64 {
  const uint64_t* p;
  int log_n;
  uint64_t q;
  int in_factor;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint64_t (&v)[G]) const {
    const uint64_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      load_words(r, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = Word<uint64_t>::ldg(r + (k << ls));
    }
    if (CHAIN) {
      for (int f = in_factor >> 1; f >= 2; f >>= 1) {
#pragma unroll
        for (int k = 0; k < G; ++k) v[k] = reduce_once64(v[k], (uint64_t)f * q);
      }
    }
  }
};

// A tile's output rows: a group's words in 16-byte stores where they are
// adjacent (the forward's last pass, one pass), else one word at a time
// (the inverse's last pass: slots k n/8 + g, a warp's words adjacent).
// FOLD brings the forward's words from [0, 4q) to canonical.
template <bool FOLD>
struct GlobalOut64 {
  uint64_t* p;
  int log_n;
  uint64_t q;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint64_t (&v)[G]) const {
    uint64_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = FOLD ? reduce_once64(reduce_once64(v[k], 2 * q), q) : v[k];
    uint64_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      store_words(r, w);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) r[k << ls] = w[k];
    }
  }
};

// Slice h's view of the forward's tables (of a row over 2^lc slices): its
// stage s0 is the row's stage s0 + lc, and its group hi there the row's
// group h 2^s0 + hi (csrc/ntt_split.cuh's FwdSliceTable, with TW's 16-byte
// loads of a stage's run of roots).
template <class TW>
struct SliceTable {
  TW t;
  int lc, h;
  template <int R>
  __device__ __forceinline__ void get(int s0, int hi, uint64_t (&tw)[1 << R],
                                      uint64_t (&twp)[1 << R]) const {
    t.template get<R>(s0 + lc, hi + (h << s0), tw, twp);
  }
};

// The words of a tile's rows (p: the first row, rows 2^log_n words apart)
// times the key by a lazy Shoup multiply as they load: any u64 word in,
// [0, 2q) out.  key and key_p: the key's words and quotients at the rows'
// first slot (the key is the same for every row).
struct KeyIn64 {
  const uint64_t* p;
  const uint64_t* key;
  const uint64_t* key_p;
  int log_n;
  uint64_t q;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint64_t (&v)[G]) const {
    const uint64_t* r = p + ((size_t)row << log_n) + base;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = base + (k << ls);
      v[k] = shoup64_lazy(Word<uint64_t>::ldg(r + (k << ls)), Word<uint64_t>::ldg(key + i),
                          Word<uint64_t>::ldg(key_p + i), q);
    }
  }
};

template <bool CANON, bool ANY>
__global__ void __launch_bounds__(NTT_THREADS, 2) ntt64_forward_kernel(const Ntt64Args a) {
  extern __shared__ __align__(16) uint64_t sm[];
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const uint64_t q = a.ms.m[t.mi].q;
  const uint64_t* groots = a.tw + ((size_t)t.mi << log_n);
  const uint64_t* groots_p = a.twp + ((size_t)t.mi << log_n);
  using Src = std::conditional_t<ANY, AnyIn64, GlobalIn64<false>>;
  Src src{};
  if constexpr (ANY)
    src = AnyIn64{a.in + t.off, log_n, q, a.ms.m[t.mi].p1};
  else
    src = GlobalIn64<false>{a.in + t.off, log_n};
  if (log_n <= 3) {  // one pass, device memory to device memory
    const GlobalOut64<CANON> dst{a.out + t.off, log_n, q};
    const FwdFirst first(groots, groots_p, n);
    if (log_n == 3) fwd_pass<3>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 2) fwd_pass<2>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 1) fwd_pass<1>(t.count, log_n, 0, first, q, src, dst);
    return;
  }
  // the block holds 2^l words of each of its rows (a slice of a row over a
  // cluster)
  const int l = log_n - log_split(log_n);
  const int m = staged_words(true, log_n);
  const SmemRows64 rows{sm + 2 * m, l};
  const GlobalOut64<CANON> dst{a.out + t.off + ((size_t)t.h << l), log_n, q};

  // the passes after the first, radix 8 in shared memory; the last (r
  // stages) stores to device memory
  const auto rest = [&](const auto& table) {
    const int r = remainder_stages(l);
    for (int s0 = 3; s0 < l - r; s0 += 3) {
      fwd_pass<3>(t.count, l, s0, table, q, rows, rows);
      __syncthreads();
    }
    if (r == 3) fwd_pass<3>(t.count, l, l - 3, table, q, rows, dst);
    if (r == 2) fwd_pass<2>(t.count, l, l - 2, table, q, rows, dst);
    if (r == 1) fwd_pass<1>(t.count, l, l - 1, table, q, rows, dst);
  };

  if (l < log_n) {  // a row over a cluster: the cross stages, then the slice's
    const SliceTable<FwdTable<uint64_t>> table{{groots, groots_p}, log_n - l, t.h};
    if (log_n > MAX_LOG_N) {  // a sub-row: the column launch ran the first stages
      const GlobalIn64<false> sub{a.in + t.off + ((size_t)t.h << l), l};
      fwd_pass<3>(1, l, 0, table, q, sub, rows);
    } else {
      with_lc(log_n - l, [&](auto lc) {
        cross_forward<decltype(lc)::value, ANY>(a.in + t.off, rows.p, l, t.h, 0, groots,
                                                 groots_p, q, a.ms.m[t.mi].p1);
      });
      fwd_pass<3>(1, l, 0, table, q, rows, rows);
    }
    __syncthreads();
    rest(table);
    return;
  }

  // pass 1 (stages 0-2): the tile's rows from device memory, twiddles in
  // registers, under the table copy
  if (m) stage_tables(sm, sm + m, groots, groots_p, 0, m);
  fwd_pass<3>(t.count, log_n, 0, FwdFirst(groots, groots_p, 8), q, src, rows);
  cp_async_wait<0>();
  __syncthreads();
  if (m)
    rest(FwdTable{(const uint64_t*)sm, (const uint64_t*)sm + m});
  else
    rest(FwdTable{groots, groots_p});
}

// The inverse's last log_n - l stages of a row over a cluster of 2^(log_n -
// l) slices whose own stages are done (each in its block's rows: one row),
// into the row out (csrc/ntt_split.cuh's cross_inverse, inv_n folded into
// the final stage, canonical or lazy in [0, 2q)); a cluster barrier after
// it keeps every slice alive until its peers' reads are done.  Past
// MAX_LOG_N (a sub-row a block) the slice's lazy words go to its place in
// out, for the column launch.
__device__ __forceinline__ void cross_last_stages(const SmemRows64& rows, uint64_t* out,
                                                  int log_n, int l, int h, const uint64_t* w,
                                                  const uint64_t* wp, const Mod64& c,
                                                  bool canonical) {
  if (log_n > MAX_LOG_N) {
    uint64_t* sub = out + ((size_t)h << l);
    for (int i = threadIdx.x; i < (1 << l); i += blockDim.x) sub[i] = rows.p[swz64(i)];
    return;
  }
  with_lc(log_n - l, [&](auto lc) {
    constexpr int LC = decltype(lc)::value;
    const auto store = [&](int j, const uint64_t (&v)[1 << LC]) {
#pragma unroll
      for (int k = 0; k < (1 << LC); ++k) out[j + (k << l)] = v[k];
    };
    if (canonical)
      cross_inverse<LC, Last::canonical>(rows.p, l, log_n, h, 0, w, wp, c, store);
    else
      cross_inverse<LC, Last::lazy>(rows.p, l, log_n, h, 0, w, wp, c, store);
  });
  cg::this_cluster().sync();
}

template <bool CANON, int LOAD>
__global__ void __launch_bounds__(NTT_THREADS, 2) ntt64_inverse_kernel(const Ntt64Args a) {
  extern __shared__ __align__(16) uint64_t sm[];
  constexpr Last LAST = CANON ? Last::canonical : Last::lazy;
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const Mod64 c = a.ms.m[t.mi];
  const uint64_t* groots = a.tw + ((size_t)t.mi << log_n);
  const uint64_t* groots_p = a.twp + ((size_t)t.mi << log_n);
  const InvTable global{groots, groots_p};
  const int l = log_n - log_split(log_n);  // words a block holds of a row: 2^l
  const uint64_t* in = a.in + t.off + ((size_t)t.h << l);
  const GlobalOut64<false> dst{a.out + t.off, log_n, c.q};
  const auto body = [&](const auto& src) {
    if (log_n <= 3) {  // one pass, device memory to device memory
      if (log_n == 3) inv_pass<3, LAST>(t.count, log_n, 0, global, c, src, dst);
      if (log_n == 2) inv_pass<2, LAST>(t.count, log_n, 0, global, c, src, dst);
      if (log_n == 1) inv_pass<1, LAST>(t.count, log_n, 0, global, c, src, dst);
      return;
    }
    const int r = remainder_stages(l);
    const int m = staged_words(false, log_n);  // the later passes' twiddles: [n - m, n)
    const SmemRows64 rows{sm + 2 * m, l};

    if (l < log_n) {  // a row over a cluster: the slice's stages, then the cross stages
      slice_inverse(SliceInvTable{groots, groots_p, l, log_n, t.h}, c, src, rows, l);
      cross_last_stages(rows, a.out + t.off, log_n, l, t.h, groots, groots_p, c, CANON);
      return;
    }

    // pass 1 (r stages): 2^r adjacent words a group from device memory, the
    // twiddles from device memory under the copy of the later passes' part
    stage_tables(sm, sm + m, groots, groots_p, n - m, n);
    if (r == 3) inv_pass<3, Last::no>(t.count, log_n, 0, global, c, src, rows);
    if (r == 2) inv_pass<2, Last::no>(t.count, log_n, 0, global, c, src, rows);
    if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, c, src, rows);
    cp_async_wait<0>();
    __syncthreads();

    // radix-8 passes in shared memory; the last (inv_n folded in) stores to
    // device memory
    const InvTable staged{(const uint64_t*)sm, (const uint64_t*)sm + m, n - m};
    inv_rest<LAST>(rows, t.count, log_n, r, staged, c, dst);
  };
  if constexpr (LOAD == IN_CHAIN) {
    body(GlobalIn64<true>{in, log_n, c.q, a.in_factor});
  } else if constexpr (LOAD == IN_ANY) {
    body(AnyIn64{in, log_n, c.q, c.p1});
  } else {
    const uint64_t* key = a.key + ((size_t)(2 * t.mi) << log_n) + ((size_t)t.h << l);
    body(KeyIn64{in, key, key + n, log_n, c.q});
  }
}

// ---------------------------------------------------------------------------
// Kernel E, mxu8_roundtrip64_mul: INTT(NTT(x) * key), the negacyclic product
// of any u64 words by a fixed NTT-domain operand, in one launch (8 <= log_n
// <= 17, q < 2^62).
//
// Replaces mxu8_fused_roundtrip64_mul (primus_fhe_tpu/ops/ntt_mxu8.py:977,
// body _make_rt_kernel8 :726), which runs the byte-radix four-step forward,
// the key and the four-step inverse in one TPU kernel: int8 byte planes were
// the TPU's way to run 64-bit modular products on its matrix unit.  The
// function stays; the method here is row 10's, above.
//
// What bounds it: the function is 2 x n/2 log n Shoup multiplies a row and
// the key's n (0.0163 ms at 512 rows of n = 4096 by the 32-bit multiply peak
// at 10 a Shoup multiply; 32 KB in and out a row, 0.0100 ms by bytes).  A
// 64-bit Shoup multiply is ~16 IMADs in SASS, not 10, so the IMAD issue rate
// allows ~0.026 ms there at best.  The first design (mma.sync, one block a
// row at n = 4096, every row reading all four plane matrices, ~1.9 MB, from
// L2) took 0.41 ms.  On this card the butterfly wins: row 10's two kernels
// take ~0.074 ms for both transforms at that shape, under half of what
// mxu8_forward64 + D take (0.17 ms).  A byte-radix rebuild (forward64's
// cluster tiles, the key-multiplied pass-2 slices gathered over distributed
// shared memory as the inverse's operand, wi1 and wi2 streamed) could at
// best save forward + D one trip and one launch, so it would stay above the
// butterflies.
//
// The design: row 10's passes (csrc/ntt_passes.cuh), a tile of T rows of
// one modulus a block, both transforms on the same swizzled shared-memory
// rows, so the forward's output never reaches device memory:
// - load: the forward's first pass reads its groups from device memory
//   (roots[1..7] in registers), each word brought to [0, 2q) by a lazy Shoup
//   multiply by 1 as it loads (AnyIn64), since E takes any u64 word and the
//   butterflies take words below 4q;
// - the forward's middle passes in shared memory, radix 8;
// - the forward's last pass (R = 1..3 stages on 2^R adjacent words, lazy in
//   [0, 4q), not folded), the key (a lazy Shoup multiply, any u64 word in,
//   [0, 2q) out) and the inverse's first pass (R stages on the same 2^R
//   words, in_factor 2) are one pass: one thread holds the group in
//   registers through all three (FwdKeyIn), so a round trip at n = 4096 is
//   7 passes and 6 barriers, not 8 and 7.  The key and its quotients (64 KB
//   a modulus at n = 4096, the same for every row, L2-resident) and that
//   pass's inverse twiddles are read from device memory by the thread that
//   needs them, 16 bytes an access for the key;
// - the inverse's later passes in shared memory, the last folding inv_n in
//   and storing canonical words (out_factor 1 and 2 alike): slots k n/8 + g,
//   8 bytes a thread, a warp's 256 bytes contiguous.
// - tables: the forward's whole table and quotients (16n bytes: 64 KB at n =
//   4096) and the inverse's part that its later passes use (the last n / 2^R
//   words: 8 KB) staged once a block by cp.async under the load and the
//   first pass.  Shared memory is 16 n + 16 n / 2^R + 8 T n bytes, so at n =
//   4096 T <= 4 (200 KB).  The C entry picks T as row 10 picks its tiles
//   (pick_tile: the smallest whose grid runs in one wave; 4 at 512 rows).
// - log_n 13-17, row 9's rings past the byte-radix kernels: the forward's
//   table no longer fits beside a row and the inverse's part, so the
//   forward's passes read their twiddles from device memory through L1 (as
//   row 10's forward does at 2^14); at 2^15-2^17 a row runs over a cluster
//   of 2, 4 or 8 blocks as row 10 splits it, all in one launch: the
//   forward's cross stages as the slices load (each word brought to [0, 2q)
//   first), the slice's forward passes, the key and the inverse's first
//   pass on the same groups, the inverse's stages within the slice, then
//   the inverse's cross stages over distributed shared memory.
// - log_n 18-26: three launches from the C entry, the forward's column
//   launch (any u64 word brought to [0, 2q) as it loads), this kernel's
//   slice body on each sub-row (one block a sub-row), the inverse's column
//   launch.
//
// Every stage is the plain version's butterfly on the same pair, and the
// output is canonical, so the words equal mxu8_roundtrip64_mul_plain's (whose
// forward folds to canonical before the key: the lazy representatives
// between differ, the residues do not).
constexpr int RT_MIN_LOG_N = 8, RT_MAX_LOG_N = FOUR_STEP_MAX_LOG_N;

// Words of the forward's table kernel E stages (with its quotients, 16
// bytes a word): all n where they fit beside the inverse's part and a row
// (up to n = 2^12), else none.
__host__ __device__ inline int rt_staged_words(int log_n) { return log_n <= 12 ? 1 << log_n : 0; }

struct Rt64Args {
  Ntt64Args a;              // in, out, the forward's roots (tw, twp), ms, rows, log_n, tile
  const uint64_t* itw;      // (count, n): the inverse's roots
  const uint64_t* itwp;     // their Shoup quotients
  const uint64_t* key;      // (count, 2, n): the key (bit-reversed) and its quotients
};

inline size_t rt_smem_bytes(int log_n, int tile) {
  return 16 * (size_t)rt_staged_words(log_n) + 16 * (size_t)staged_words(false, log_n) +
         sizeof(uint64_t) * ((size_t)tile << (log_n - log_split(log_n)));
}

// The inverse's first pass's load in kernel E: the group's 2^R adjacent
// words from the shared-memory rows, the forward's last pass on them (its
// group is the same 2^R words) and the key multiply.
template <class TW>
struct FwdKeyIn {
  SmemRows64 rows;
  TW table;                  // the forward's table (a slice's view of it over a cluster)
  const uint64_t* key;       // the modulus's key at the rows' first slot
  const uint64_t* key_p;     // its quotients
  int log_n;                 // the rows' words: 2^log_n (a slice over a cluster)
  uint64_t q;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int, uint64_t (&v)[G]) const {
    constexpr int R = G == 8 ? 3 : G == 4 ? 2 : 1;
    uint64_t w[G], wp[G], k[G], kp[G];
    rows.load(row, base, 0, v);
    table.template get<R>(log_n - R, base >> R, w, wp);
    fwd_stages<R>(
        v,
        [&](int e, int j, uint64_t& ww, uint64_t& wwp) {
          ww = w[(1 << e) + j];
          wwp = wp[(1 << e) + j];
        },
        q);
    load_words(key + base, k);
    load_words(key_p + base, kp);
#pragma unroll
    for (int j = 0; j < G; ++j) v[j] = shoup64_lazy(v[j], k[j], kp[j], q);
  }
};

__global__ void __launch_bounds__(NTT_THREADS, 2) ntt64_roundtrip_kernel(const Rt64Args e) {
  extern __shared__ __align__(16) uint64_t sm[];
  const Ntt64Args& a = e.a;
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const Mod64 c = a.ms.m[t.mi];
  const uint64_t q = c.q;
  const size_t mo = (size_t)t.mi << log_n;
  const uint64_t* key = e.key + 2 * mo;  // the key's words, then its quotients n words on
  const int l = log_n - log_split(log_n);  // words a block holds of a row: 2^l
  const int r = remainder_stages(l);

  if (l < log_n) {  // a row over a cluster of 2^(log_n - l) blocks, one slice each
    const SmemRows64 rows{sm, l};
    const SliceTable<FwdTable<uint64_t>> table{{a.tw + mo, a.twp + mo}, log_n - l, t.h};
    int s_first = 0;
    if (log_n > MAX_LOG_N) {  // a sub-row: the column launch ran the first stages
      const GlobalIn64<false> sub{a.in + t.off + ((size_t)t.h << l), l};
      fwd_pass<3>(1, l, 0, table, q, sub, rows);
      __syncthreads();
      s_first = 3;
    } else {
      with_lc(log_n - l, [&](auto lc) {
        cross_forward<decltype(lc)::value, true>(a.in + t.off, sm, l, t.h, 0, a.tw + mo,
                                                  a.twp + mo, q, c.p1);
      });
    }
    for (int s0 = s_first; s0 < l - r; s0 += 3) {
      fwd_pass<3>(1, l, s0, table, q, rows, rows);
      __syncthreads();
    }
    const size_t h0 = (size_t)t.h << l;
    const FwdKeyIn<SliceTable<FwdTable<uint64_t>>> mid{rows, table, key + h0, key + n + h0, l, q};
    slice_inverse(SliceInvTable{e.itw + mo, e.itwp + mo, l, log_n, t.h}, c, mid, rows, l);
    cross_last_stages(rows, a.out + t.off, log_n, l, t.h, e.itw + mo, e.itwp + mo, c, true);
    return;
  }

  const int f = rt_staged_words(log_n);       // the forward's staged table: [0, f)
  const int m = staged_words(false, log_n);  // the inverse's later passes' twiddles: [n - m, n)
  uint64_t* ftw = sm;                        // the forward's table, then its quotients
  uint64_t* itw = sm + 2 * f;                // the inverse's part, then its quotients
  const SmemRows64 rows{sm + 2 * (f + m), log_n};
  // the passes on the forward's table, staged (shared-memory loads the
  // compiler sees as such) or not; a call each, so each is inlined alone
  const auto run = [&](const FwdTable<uint64_t>& table) {
    // pass 1 (stages 0-2): the tile's rows from device memory, reduced as
    // they load, under the copy of the tables
    fwd_pass<3>(t.count, log_n, 0, FwdFirst(a.tw + mo, a.twp + mo, 8), q,
                AnyIn64{a.in + t.off, log_n, q, c.p1}, rows);
    cp_async_wait<0>();
    __syncthreads();
    for (int s0 = 3; s0 < log_n - r; s0 += 3) {
      fwd_pass<3>(t.count, log_n, s0, table, q, rows, rows);
      __syncthreads();
    }
    // the forward's last pass, the key and the inverse's first: one pass
    const FwdKeyIn<FwdTable<uint64_t>> mid{rows, table, key, key + n, log_n, q};
    const InvTable<uint64_t> global{e.itw + mo, e.itwp + mo};
    if (r == 3) inv_pass<3, Last::no>(t.count, log_n, 0, global, c, mid, rows);
    if (r == 2) inv_pass<2, Last::no>(t.count, log_n, 0, global, c, mid, rows);
    if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, c, mid, rows);
    __syncthreads();
    // the inverse's later passes on its staged part; the last stores
    const InvTable staged{(const uint64_t*)itw, (const uint64_t*)itw + m, n - m};
    const GlobalOut64<false> dst{a.out + t.off, log_n, q};
    inv_rest<Last::canonical>(rows, t.count, log_n, r, staged, c, dst);
  };
  if (f) stage_tables(ftw, ftw + f, a.tw + mo, a.twp + mo, 0, f);
  stage_tables(itw, itw + m, e.itw + mo, e.itwp + mo, n - m, n);
  if (f)
    run(FwdTable<uint64_t>{ftw, ftw + f});
  else
    run(FwdTable<uint64_t>{a.tw + mo, a.twp + mo});
}

// What the launches read of a device, set up at the first launch there:
// the SM count and, for each kernel (Kind), row size and tile, how many
// blocks an SM holds at once (0 where the tile does not fit in shared
// memory); the kernels' shared-memory cap is raised to SMEM_MAX.
enum Kind { INVERSE = 0, FORWARD = 1, ROUNDTRIP = 2 };

struct Ntt64Device {
  int sms = 0;
  int resident[3][MAX_LOG_N + 1][4] = {};
};

int ntt64_device(const Ntt64Device** out) {
  static Ntt64Device cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  Ntt64Device& d = cached[dev];
  if (d.sms == 0) {
    Ntt64Device fresh;
    const void* kernels[8] = {(const void*)ntt64_inverse_kernel<true, IN_CHAIN>,
                              (const void*)ntt64_forward_kernel<true, false>,
                              (const void*)ntt64_roundtrip_kernel,
                              (const void*)ntt64_inverse_kernel<false, IN_CHAIN>,
                              (const void*)ntt64_forward_kernel<false, false>,
                              (const void*)ntt64_inverse_kernel<true, IN_ANY>,
                              (const void*)ntt64_inverse_kernel<true, IN_KEY>,
                              (const void*)ntt64_forward_kernel<true, true>};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int kind = 0; kind < 3 && e == cudaSuccess; ++kind)
      for (int log_n = 1; log_n <= MAX_LOG_N && e == cudaSuccess; ++log_n) {
        if (kind == ROUNDTRIP && log_n < RT_MIN_LOG_N) continue;
        for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
          const size_t smem = kind == ROUNDTRIP ? rt_smem_bytes(log_n, 1 << i)
                                                : smem_bytes(kind == FORWARD, log_n, 1 << i);
          if (smem <= (size_t)SMEM_MAX)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &fresh.resident[kind][log_n][i], kernels[kind], tile_threads(log_n, 1 << i),
                smem);
        }
      }
    if (e != cudaSuccess) return (int)e;
    d = fresh;
  }
  *out = &d;
  return 0;
}

// Rows a block: the smallest tile T (1, 2, 4 or 8 rows) whose grid of
// count ceil(rows / T) blocks runs in one wave (the SMs times the blocks an
// SM holds at T), else the largest T that fits (each staged table word then
// serves the most rows).  A smaller tile spreads a transform over more SMs;
// a larger one reads the tables less often.  A row over a cluster (n >=
// 2^15) fits only T = 1.  The only copy of the rule, for the three kernels
// (kind: a Kind; a bool forward is FORWARD or INVERSE).
int pick_tile(int kind, int count, int rows, int log_n, const Ntt64Device& d) {
  if (log_n > MAX_LOG_N) return 1;  // a sub-row a block
  int fit = 1;
  for (int i = 0; i < 4; ++i) {
    const int held = d.resident[kind][log_n][i];
    if (held == 0) break;
    fit = 1 << i;
    if ((long)count * ((rows + fit - 1) / fit) <= (long)d.sms * held) return fit;
  }
  return fit;
}

bool valid(int count, int rows, int log_n) {
  return count >= 1 && count <= PFT_MAX_MOD64 && log_n >= 1 && log_n <= FOUR_STEP_MAX_LOG_N &&
         rows >= 1 && (((long long)count * rows) << log_split(log_n)) <= 0x7fffffffLL;
}

// The launch's shape: a tile of rows a block (pick_tile; 1 where a row
// spans blocks), and a cluster of a row's slices at log_n 15-17.
void shape(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int count, int rows, int log_n,
           int tile) {
  const int split = log_split(log_n);
  cfg.gridDim = dim3((unsigned)(count * ((rows + tile - 1) / tile)) << split);
  cfg.blockDim = dim3(tile_threads(log_n, tile));
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << split;  // a row's slices in one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split && log_n <= MAX_LOG_N ? 1 : 0;
}

// load: the forward's (IN_CHAIN: words below 4q, IN_ANY: any u64 word) or
// the inverse's first-pass load (InLoad; key: IN_KEY's (count, 2, n) key).
int launch(bool forward, const void* in, void* out, const void* tw, const void* twp,
           const void* mod_pack, int count, int rows, int log_n, int canonical, int in_factor,
           int load, const void* key, void* stream) {
  if (!valid(count, rows, log_n) || in_factor < 2 || (in_factor & (in_factor - 1)) ||
      (((uintptr_t)in | (uintptr_t)out | (uintptr_t)key) & 15) != 0 ||
      (load == IN_KEY) != (key != nullptr) || (forward && load == IN_KEY))
    return (int)cudaErrorInvalidValue;
  const Ntt64Device* d = nullptr;
  const int err = ntt64_device(&d);
  if (err != 0) return err;
  Ntt64Args a{};
  a.in = (const uint64_t*)in;
  a.out = (uint64_t*)out;
  a.tw = (const uint64_t*)tw;
  a.twp = (const uint64_t*)twp;
  a.ms = unpack_mod64((const uint64_t*)mod_pack, count);
  a.rows = rows;
  a.log_n = log_n;
  a.in_factor = in_factor;
  a.key = (const uint64_t*)key;
  a.tile = pick_tile(forward, count, rows, log_n, *d);
  const bool four = log_n > MAX_LOG_N;  // the four-step: the forward's columns first
  if (four && forward) {
    const int ce = four_step_columns(64, 0, load == IN_ANY ? 1 : 0, in, out, tw, twp, mod_pack,
                                     count, rows, log_n, stream);
    if (ce != 0) return ce;
    a.in = a.out;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  shape(cfg, attr, count, rows, log_n, a.tile);
  cfg.dynamicSmemBytes = smem_bytes(forward, log_n, a.tile);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t e;
  if (forward && load == IN_ANY)
    e = cudaLaunchKernelEx(&cfg, ntt64_forward_kernel<true, true>, a);
  else if (forward)
    e = canonical ? cudaLaunchKernelEx(&cfg, ntt64_forward_kernel<true, false>, a)
                  : cudaLaunchKernelEx(&cfg, ntt64_forward_kernel<false, false>, a);
  else if (load == IN_ANY)
    e = cudaLaunchKernelEx(&cfg, ntt64_inverse_kernel<true, IN_ANY>, a);
  else if (load == IN_KEY)
    e = cudaLaunchKernelEx(&cfg, ntt64_inverse_kernel<true, IN_KEY>, a);
  else
    e = canonical ? cudaLaunchKernelEx(&cfg, ntt64_inverse_kernel<true, IN_CHAIN>, a)
                  : cudaLaunchKernelEx(&cfg, ntt64_inverse_kernel<false, IN_CHAIN>, a);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess || !four || forward) return (int)e;
  return four_step_columns(64, 1, canonical ? 0 : 1, out, out, tw, twp, mod_pack, count, rows,
                           log_n, stream);  // the inverse's columns last
}

int launch_roundtrip(const void* in, void* out, const void* roots, const void* roots_p,
                     const void* inv_roots, const void* inv_roots_p, const void* key,
                     const void* mod_pack, int count, int rows, int log_n, void* stream) {
  if (!valid(count, rows, log_n) || log_n < RT_MIN_LOG_N || log_n > RT_MAX_LOG_N ||
      ((uintptr_t)key & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Ntt64Device* d = nullptr;
  const int err = ntt64_device(&d);
  if (err != 0) return err;
  Rt64Args e{};
  Ntt64Args& a = e.a;
  a.in = (const uint64_t*)in;
  a.out = (uint64_t*)out;
  a.tw = (const uint64_t*)roots;
  a.twp = (const uint64_t*)roots_p;
  a.ms = unpack_mod64((const uint64_t*)mod_pack, count);
  a.rows = rows;
  a.log_n = log_n;
  a.in_factor = 2;
  e.itw = (const uint64_t*)inv_roots;
  e.itwp = (const uint64_t*)inv_roots_p;
  e.key = (const uint64_t*)key;
  a.tile = pick_tile(ROUNDTRIP, count, rows, log_n, *d);
  const bool four = log_n > MAX_LOG_N;  // the four-step: three launches
  if (four) {
    const int ce = four_step_columns(64, 0, 1, in, out, roots, roots_p, mod_pack, count, rows,
                                     log_n, stream);
    if (ce != 0) return ce;
    a.in = a.out;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  shape(cfg, attr, count, rows, log_n, a.tile);
  cfg.dynamicSmemBytes = rt_smem_bytes(log_n, a.tile);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err2 = cudaLaunchKernelEx(&cfg, ntt64_roundtrip_kernel, e);
  if (err2 != cudaSuccess) return (int)err2;
  err2 = cudaGetLastError();
  if (err2 != cudaSuccess || !four) return (int)err2;
  return four_step_columns(64, 1, 0, out, out, inv_roots, inv_roots_p, mod_pack, count, rows,
                           log_n, stream);
}

}  // namespace

extern "C" {

// Forward NTT of count moduli x rows_per_mod rows of 2^log_n words (log_n
// 1-26, count <= 4; in and out 16-byte aligned): roots, roots_p (count, n)
// the bit-reversed root tables and Shoup quotients; input below 4q,
// bit-reversed output canonical or lazy in [0, 4q).
int pft_ntt64_forward(const void* in, void* out, const void* roots, const void* roots_p,
                      const void* mod_pack, int count, int rows_per_mod, int log_n, int canonical,
                      void* stream) {
  return launch(true, in, out, roots, roots_p, mod_pack, count, rows_per_mod, log_n, canonical, 2,
                IN_CHAIN, nullptr, stream);
}

// Inverse NTT, the same shapes: inv_roots, inv_roots_p the inverse tables;
// bit-reversed input below in_factor q (a power of two, at least 2),
// normal-order output canonical or lazy in [0, 2q).
int pft_ntt64_inverse(const void* in, void* out, const void* inv_roots, const void* inv_roots_p,
                      const void* mod_pack, int count, int rows_per_mod, int log_n, int canonical,
                      int in_factor, void* stream) {
  return launch(false, in, out, inv_roots, inv_roots_p, mod_pack, count, rows_per_mod, log_n,
                canonical, in_factor, IN_CHAIN, nullptr, stream);
}

// Row 9's forward64 at log_n 13-26 on the forward's passes: any u64 words
// in (each brought to [0, 2q) as it loads), canonical bit-reversed words
// out; the shapes and tables of pft_ntt64_forward.
int pft_ntt64_forward_any(const void* in, void* out, const void* roots, const void* roots_p,
                          const void* mod_pack, int count, int rows_per_mod, int log_n,
                          void* stream) {
  return launch(true, in, out, roots, roots_p, mod_pack, count, rows_per_mod, log_n, 1, 2,
                IN_ANY, nullptr, stream);
}

// Kernel D at log_n 13-26 (key: the (count, 2, n) key and its Shoup
// quotients, 16-byte aligned), or row 9's inverse64 there (key null): the
// inverse's passes on any u64 words in bit-reversed order, each multiplied
// by the key (or by 1) as it loads, canonical normal-order words out; the
// shapes and tables of pft_ntt64_inverse.
int pft_ntt64_inverse_mul(const void* in, void* out, const void* inv_roots,
                          const void* inv_roots_p, const void* key, const void* mod_pack,
                          int count, int rows_per_mod, int log_n, void* stream) {
  return launch(false, in, out, inv_roots, inv_roots_p, mod_pack, count, rows_per_mod, log_n, 1,
                2, key ? IN_KEY : IN_ANY, key, stream);
}

// Kernel E: INTT(NTT(in) * key) of count moduli x rows_per_mod rows of
// 2^log_n words (log_n 8-26, count <= 4): any u64 words in, normal order;
// roots, roots_p and inv_roots, inv_roots_p the forward's and the inverse's
// (count, n) tables; key (count, 2, n, 16-byte aligned) the bit-reversed
// key and its Shoup quotients; canonical words out, normal order.
int pft_ntt64_roundtrip_mul(const void* in, void* out, const void* roots, const void* roots_p,
                            const void* inv_roots, const void* inv_roots_p, const void* key,
                            const void* mod_pack, int count, int rows_per_mod, int log_n,
                            void* stream) {
  return launch_roundtrip(in, out, roots, roots_p, inv_roots, inv_roots_p, key, mod_pack, count,
                          rows_per_mod, log_n, stream);
}

// The rows a block the launch takes (pick_tile) on the current device:
// kind 1 the forward, 0 the inverse, 2 kernel E.
int pft_ntt64_tile(int kind, int count, int rows_per_mod, int log_n, int* tile) {
  if (!valid(count, rows_per_mod, log_n) || kind < 0 || kind > 2 ||
      (kind == ROUNDTRIP && (log_n < RT_MIN_LOG_N || log_n > RT_MAX_LOG_N)))
    return (int)cudaErrorInvalidValue;
  const Ntt64Device* d = nullptr;
  const int err = ntt64_device(&d);
  if (err != 0) return err;
  *tile = pick_tile(kind, count, rows_per_mod, log_n, *d);
  return 0;
}

}  // extern "C"
