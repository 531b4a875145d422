// Kernels 1 and 2: 32-bit negacyclic NTT and inverse NTT, all primes in one
// launch.
//
// Replaces pallas_forward32 / pallas_inverse32
// (primus_fhe_tpu/ops/ntt_pallas.py, _make_fwd_kernel32 / _make_inv_kernel32).
//
// What bounds them: a row of n = 2048 words is 8 KB in and 8 KB out against
// n/2 log n = 11k Shoup butterflies, so a large batch is bound by device
// memory (256 rows, 4.2 MB: 1.25 us at 3.35 TB/s) and a batch of a few rows
// by latency: the launch, then the chain of dependent shared-memory round
// trips and barriers through the row's log n stages.  The first design (one
// block a row, n/2 threads, one radix-2 butterfly a thread a stage, twiddles
// loaded from global memory at every butterfly) ran 11 barriers a row at n =
// 2048 and took 10x its byte bound at 256 rows.
//
// The design on Hopper:
// - radix-8 register passes (csrc/ntt_passes.cuh, shared with the CMux
//   step kernel and row 10's u64 kernels): a thread holds 8 words in
//   registers through 3 stages, so a transform is ceil(log_n / 3) passes
//   with a barrier between two passes (4 passes, 3 barriers at n = 1024 and
//   2048).  The forward's last pass and
//   the inverse's first take the remainder, R = 1..3 stages.  The forward's
//   first pass reads its groups straight from global memory (a warp's loads
//   are 128 contiguous bytes), and its last pass, whose groups are 2^R
//   adjacent words, stores them straight to global memory, 8 or 16 bytes a
//   thread; the inverse mirrors it (its first pass loads 2^R adjacent words,
//   its last stores a warp's 128 contiguous bytes at a time).  Only the
//   passes in between touch shared memory, and log_n <= 3 (one pass) none.
// - swizzled shared memory (SwzNtt): each warp of every pass hits 32
//   distinct banks (tests/test_torch_ntt32_model.py checks this).
// - root tables staged once a block: the forward's first pass needs only
//   roots[1..7], read into registers; the prime's table and Shoup quotients
//   (16 KB at n = 2048) are copied into shared memory by cp.async under the
//   row loads and the first pass.  The inverse's first pass takes its
//   twiddles (its stages use most of the table) from global memory while
//   the copy of the part the later passes use (the last n / 2^R words of
//   each table) is in flight.
// - a tile of T rows of one prime a block, so that each staged table word
//   serves T rows: grid kp x ceil(rows_per_prime / T), a ragged last tile
//   loading and storing only its own rows.  The C entry picks T (pick_tile)
//   from the rows, the SM count and the blocks an SM holds; no caller sets
//   it.  256 threads a block, several blocks an SM.
//
// - log_n 15-17: a row over a cluster of C = 2^(log_n - 14) blocks (2, 4
//   or 8, a portable cluster size), one slice of 2^14 words (64 KB) a block
//   (csrc/ntt_split.cuh): the forward's first log_n - 14 stages (at 17 one
//   radix-8 group of 8 words, one a slice) run on groups of one word a slice,
//   loaded from device memory, each word stored into its slice over
//   distributed shared memory; then the slice's stages as the radix-8
//   passes above, on the compact root table read from device memory at the
//   slice's offsets (FwdSliceTable), the last pass storing to device
//   memory.  The inverse mirrors it: the slice's passes from device memory
//   (SliceInvTable), then the last stages on groups gathered from the
//   slices, stored to device memory.  One row a cluster of 1024-thread
//   blocks (a slice's 2048 radix-8 groups, two a thread); the C entry picks
//   the cluster from log_n.
//
// - log_n 18-26: a row is past what a cluster holds (1 MB at 2^18), so it
//   runs the four-step through device memory (csrc/ntt_columns.cuh): the
//   column launch (four_step_columns, csrc/ntt_columns.cu) runs the stages
//   across the 2^(log_n - 14) sub-rows of 2^14 words, and the sub-row
//   launch here, a block a sub-row, the rest: the split kernels' slice body
//   with the slice's words from device memory, FwdSliceTable /
//   SliceInvTable at the sub-row's rank.  The inverse's sub-rows store lazy
//   words for the column launch after them.  The C entries issue both.
//
// The butterflies are the plain version's (transforms/ntt.py) with its lazy
// ranges, applied to the same pairs stage by stage, so every output word is
// bit-equal to it: the forward's bit-reversed output lazy in [0, 4q) or
// canonical, the inverse's normal-order output lazy in [0, 2q) or canonical.
//
// Kernel C (mxu8_forward32, below them): the MXU key preparation's
// canonical forward NTT, kernel 1's function at out_factor 1 on canonical
// residues.  Replaces the u32 tier of mxu8_fused_forward64
// (primus_fhe_tpu/ops/ntt_mxu8.py:917, via ops/mxu_common._natural_call);
// the TPU kernel's byte-plane four-step is a product on the int8 matrix
// unit, and on Hopper the same function on kernel 1's radix-8 passes costs
// a fraction of that.  Its launch is large (prepare_mxu_bsk at BOOLEAN_128:
// 2 x 7560 rows of 8 KB, 124 MB in and out), where the rows' bytes (0.074
// ms at 3.35 TB/s) and the passes' multiplies take comparable time, so the
// design overlaps them:
// - persistent blocks: the grid is the SMs times the blocks an SM holds,
//   capped at the work items (prime, tile of T rows); block b takes a
//   contiguous range of items, so it stages a prime's root table and Shoup
//   quotients (16 KB at n = 2048) once, not once a tile;
// - a ring of three tile slots: one thread bulk-copies tile i+1's rows
//   (cp.async.bulk, completing on the slot's mbarrier) while the block runs
//   tile i's passes, and tile i-1's output drains from its slot to device
//   memory by a bulk store;
// - the passes: the first reads the slot's natural rows (a warp's words
//   adjacent) into a swizzled work tile (SwzNtt), the middle ones run there,
//   and the last writes its canonical words back into the slot in natural
//   order, 2^R adjacent words a thread (the two halves of an 8-word group in
//   the order that keeps each quarter-warp's 16-byte stores on 32 banks),
//   from which the bulk store goes out;
// - compile-time passes: the kernel is a template on log_n, so each pass's
//   index math folds, and its swizzled addresses are one XOR a word
//   (SwzRowsC); the passes are kernel 1's slots, twiddles and butterflies;
// - the tile T: the C entry's c_pick, the only copy of the rule.
// log_n 8-12 and kp 1-4, the byte-radix plan's range.

#include "mxu8.cuh"  // mbarriers and bulk copies
#include "ntt_columns.cuh"

namespace {

constexpr int NTT_THREADS = 256;
constexpr int MAX_TILE = 8;
constexpr int TILE_MAX_LOG_N = 14;  // a row in one block's shared memory
constexpr int MAX_LOG_N = CLUSTER_MAX_LOG_N;  // past TILE_MAX_LOG_N, a row over a cluster (SLICE_LOG words a block)
constexpr int SLICE_LOG = SUB_LOG;
constexpr int SPLIT_THREADS = 1024;  // a slice's 2048 radix-8 groups, two a thread
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may ask for

struct NttArgs {
  const uint32_t* in;   // (kp, rows, n)
  uint32_t* out;        // (kp, rows, n)
  const uint32_t* tw;   // (kp, n): the forward's roots or the inverse's
  const uint32_t* twp;  // their Shoup quotients
  PrimeSet ps;
  int rows, log_n, tile;
};

// Words of each root table a block stages: none for one pass; the
// forward's whole table; the part of the inverse's that its passes after
// the first use.
__host__ __device__ inline int staged_words(bool forward, int log_n) {
  if (log_n <= 3) return 0;
  return forward ? 1 << log_n : (1 << log_n) >> remainder_stages(log_n);
}

inline size_t smem_bytes(bool forward, int log_n, int tile) {
  if (log_n <= 3) return 0;
  return sizeof(uint32_t) * (2 * (size_t)staged_words(forward, log_n) + ((size_t)tile << log_n));
}

// The block's tile: prime pi, rows row0 .. row0 + count - 1 of it.
struct Tile {
  int pi, count;
  size_t off;  // word offset of the tile's first row
};

__device__ __forceinline__ Tile block_tile(const NttArgs& a) {
  const int tiles = (a.rows + a.tile - 1) / a.tile;
  const int pi = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - pi * tiles) * a.tile;
  return Tile{pi, min(a.tile, a.rows - row0), ((size_t)pi * a.rows + row0) << a.log_n};
}

// Starts the copy of words [lo, hi) of a prime's table and quotients into
// tw[0 ..), twp[0 ..) (16 bytes a thread a step).
__device__ __forceinline__ void stage_tables(uint32_t* tw, uint32_t* twp, const uint32_t* g,
                                             const uint32_t* gp, int lo, int hi) {
  for (int i = 4 * threadIdx.x; i < hi - lo; i += 4 * blockDim.x) {
    cp_async16(tw + i, g + lo + i);
    cp_async16(twp + i, gp + lo + i);
  }
  cp_async_commit();
}

// A tile's rows in global memory: a group's words in 8- or 16-byte accesses
// where they are adjacent (ls = 0), else one word at a time (a warp's words
// then adjacent).
struct GlobalIn {
  const uint32_t* p;
  int log_n;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint32_t (&v)[G]) const {
    const uint32_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      load_words(r, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = __ldg(r + (k << ls));
    }
  }
};

// A tile's output rows: a group's words in 8- or 16-byte accesses where
// they are adjacent (the forward's last pass, one pass), else one word at a
// time (the inverse's last pass: slots k n/8 + g, a warp's words adjacent).
// FOLD brings the forward's words from [0, 4q) to canonical.
template <bool FOLD>
struct GlobalOut {
  uint32_t* p;
  int log_n;
  uint32_t q;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
    uint32_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = FOLD ? reduce_once(reduce_once(v[k], 2u * q), q) : v[k];
    uint32_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      store_words(r, w);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) r[k << ls] = w[k];
    }
  }
};

template <bool CANON>
__global__ void __launch_bounds__(NTT_THREADS, 4) ntt32_forward_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const uint32_t q = a.ps.p[t.pi].q;
  const uint32_t* groots = a.tw + ((size_t)t.pi << log_n);
  const uint32_t* groots_p = a.twp + ((size_t)t.pi << log_n);
  const GlobalIn src{a.in + t.off, log_n};
  const GlobalOut<CANON> dst{a.out + t.off, log_n, q};
  if (log_n <= 3) {  // one pass, global memory to global memory
    const FwdFirst first(groots, groots_p, n);
    if (log_n == 3) fwd_pass<3>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 2) fwd_pass<2>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 1) fwd_pass<1>(t.count, log_n, 0, first, q, src, dst);
    return;
  }
  uint32_t* tw = sm;
  uint32_t* twp = sm + n;
  const SmemRows<SwzNtt> rows{sm + 2 * n, log_n};
  stage_tables(tw, twp, groots, groots_p, 0, n);

  // pass 1 (stages 0-2): the tile's rows from global memory, twiddles in
  // registers, under the table copy
  fwd_pass<3>(t.count, log_n, 0, FwdFirst(groots, groots_p, 8), q, src, rows);
  cp_async_wait<0>();
  __syncthreads();

  // the middle passes, radix 8 in shared memory; the last (r stages) stores
  // to global memory
  const int r = remainder_stages(log_n);
  const FwdTable table{tw, twp};
  for (int s0 = 3; s0 < log_n - r; s0 += 3) {
    fwd_pass<3>(t.count, log_n, s0, table, q, rows, rows);
    __syncthreads();
  }
  if (r == 3) fwd_pass<3>(t.count, log_n, log_n - 3, table, q, rows, dst);
  if (r == 2) fwd_pass<2>(t.count, log_n, log_n - 2, table, q, rows, dst);
  if (r == 1) fwd_pass<1>(t.count, log_n, log_n - 1, table, q, rows, dst);
}

template <bool CANON>
__global__ void __launch_bounds__(NTT_THREADS, 4) ntt32_inverse_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr Last LAST = CANON ? Last::canonical : Last::lazy;
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const PrimeConsts pc = a.ps.p[t.pi];
  const InvTable global{a.tw + ((size_t)t.pi << log_n), a.twp + ((size_t)t.pi << log_n)};
  const GlobalIn src{a.in + t.off, log_n};
  const GlobalOut<false> dst{a.out + t.off, log_n, pc.q};
  if (log_n <= 3) {  // one pass, global memory to global memory
    if (log_n == 3) inv_pass<3, LAST>(t.count, log_n, 0, global, pc, src, dst);
    if (log_n == 2) inv_pass<2, LAST>(t.count, log_n, 0, global, pc, src, dst);
    if (log_n == 1) inv_pass<1, LAST>(t.count, log_n, 0, global, pc, src, dst);
    return;
  }
  const int r = remainder_stages(log_n);
  const int m = staged_words(false, log_n);  // the later passes' twiddles: [n - m, n)
  uint32_t* tw = sm;
  uint32_t* twp = sm + m;
  const SmemRows<SwzNtt> rows{sm + 2 * m, log_n};
  stage_tables(tw, twp, global.w, global.wp, n - m, n);

  // pass 1 (r stages): 2^r adjacent words a group from global memory, the
  // twiddles from global memory under the table copy
  if (r == 3) inv_pass<3, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  if (r == 2) inv_pass<2, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  cp_async_wait<0>();
  __syncthreads();

  // radix-8 passes in shared memory; the last (inv_n folded in) stores to
  // global memory
  inv_rest<LAST>(rows, t.count, log_n, r, InvTable{tw, twp, n - m}, pc, dst);
}

// log_n 15-17: one row a cluster of 2^LC blocks (LC = log_n - SLICE_LOG),
// block `rank` holding slice rank of the row (csrc/ntt_split.cuh).  Grid:
// kp rows clusters, cluster i the row i of the (kp, rows) rows.
template <int LC, bool CANON>
__global__ void __launch_bounds__(SPLIT_THREADS, 1) ntt32_forward_split_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = SLICE_LOG;
  const int rank = (int)cg::this_cluster().block_rank();
  const int row = (int)blockIdx.x >> LC;  // prime pi = row / rows
  const int pi = row / a.rows;
  const uint32_t q = a.ps.p[pi].q;
  const uint32_t* groots = a.tw + ((size_t)pi << a.log_n);
  const uint32_t* groots_p = a.twp + ((size_t)pi << a.log_n);
  const size_t off = (size_t)row << a.log_n;
  const SmemRows<SwzNtt> rows{sm, l};
  cross_forward<LC>(a.in + off, sm, l, rank, 0, groots, groots_p, q);
  const FwdSliceTable table{groots, groots_p, (1 << LC) + rank};
  constexpr int r = l - 3 * ((l - 1) / 3);  // the last pass's stages
  for (int s0 = 0; s0 < l - r; s0 += 3) {
    fwd_pass<3>(1, l, s0, table, q, rows, rows);
    __syncthreads();
  }
  const GlobalOut<CANON> dst{a.out + off + ((size_t)rank << l), l, q};
  fwd_pass<r>(1, l, l - r, table, q, rows, dst);
}

template <int LC, bool CANON>
__global__ void __launch_bounds__(SPLIT_THREADS, 1) ntt32_inverse_split_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = SLICE_LOG;
  const int rank = (int)cg::this_cluster().block_rank();
  const int row = (int)blockIdx.x >> LC;
  const int pi = row / a.rows;
  const PrimeConsts pc = a.ps.p[pi];
  const uint32_t* w = a.tw + ((size_t)pi << a.log_n);
  const uint32_t* wp = a.twp + ((size_t)pi << a.log_n);
  const size_t off = (size_t)row << a.log_n;
  const SmemRows<SwzNtt> rows{sm, l};
  slice_inverse(SliceInvTable{w, wp, l, a.log_n, rank}, pc,
                GlobalIn{a.in + off + ((size_t)rank << l), l}, rows, l);
  uint32_t* out = a.out + off;
  cross_inverse<LC, CANON ? Last::canonical : Last::lazy>(
      sm, l, a.log_n, rank, 0, w, wp, pc, [&](int j, const uint32_t (&v)[1 << LC]) {
#pragma unroll
        for (int k = 0; k < (1 << LC); ++k) out[j + (k << l)] = v[k];
      });
  cg::this_cluster().sync();  // keep every slice alive until its peers' reads are done
}

// log_n 18-26, the four-step's sub-row launch (csrc/ntt_columns.cuh): one
// block a sub-row of 2^SLICE_LOG words, sub-row h of row `row` of the (kp,
// rows) rows the block's index h + row 2^lc (lc = log_n - SLICE_LOG); the
// slice body of the kernels above, its words from device memory.  The
// forward's input is the column launch's output, its last pass the row's;
// the inverse stores its lazy [0, 2q) words for the column launch.
template <bool CANON>
__global__ void __launch_bounds__(SPLIT_THREADS, 1) ntt32_forward_sub_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = SLICE_LOG;
  const int lc = a.log_n - l;
  const int h = (int)(blockIdx.x & ((1u << lc) - 1));
  const int row = (int)(blockIdx.x >> lc);
  const int pi = row / a.rows;
  const uint32_t q = a.ps.p[pi].q;
  const uint32_t* groots = a.tw + ((size_t)pi << a.log_n);
  const uint32_t* groots_p = a.twp + ((size_t)pi << a.log_n);
  const size_t off = ((size_t)row << a.log_n) + ((size_t)h << l);
  const SmemRows<SwzNtt> rows{sm, l};
  const FwdSliceTable table{groots, groots_p, (1 << lc) + h};
  constexpr int r = l - 3 * ((l - 1) / 3);  // the last pass's stages
  fwd_pass<3>(1, l, 0, table, q, GlobalIn{a.in + off, l}, rows);
  __syncthreads();
  for (int s0 = 3; s0 < l - r; s0 += 3) {
    fwd_pass<3>(1, l, s0, table, q, rows, rows);
    __syncthreads();
  }
  fwd_pass<r>(1, l, l - r, table, q, rows, GlobalOut<CANON>{a.out + off, l, q});
}

__global__ void __launch_bounds__(SPLIT_THREADS, 1) ntt32_inverse_sub_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = SLICE_LOG;
  const int lc = a.log_n - l;
  const int h = (int)(blockIdx.x & ((1u << lc) - 1));
  const int row = (int)(blockIdx.x >> lc);
  const int pi = row / a.rows;
  const PrimeConsts pc = a.ps.p[pi];
  const uint32_t* w = a.tw + ((size_t)pi << a.log_n);
  const uint32_t* wp = a.twp + ((size_t)pi << a.log_n);
  const size_t off = ((size_t)row << a.log_n) + ((size_t)h << l);
  const SmemRows<SwzNtt> rows{sm, l};
  slice_inverse(SliceInvTable{w, wp, l, a.log_n, h}, pc, GlobalIn{a.in + off, l}, rows, l);
  for (int i = threadIdx.x; i < (1 << l); i += blockDim.x) a.out[off + i] = sm[SwzNtt::at(i)];
}

// The split kernels, [forward][log_n - SLICE_LOG - 1][canonical].
constexpr int SPLIT_LCS = MAX_LOG_N - SLICE_LOG;
const void* const SPLIT_KERNELS[2][SPLIT_LCS][2] = {
    {{(const void*)ntt32_inverse_split_kernel<1, false>,
      (const void*)ntt32_inverse_split_kernel<1, true>},
     {(const void*)ntt32_inverse_split_kernel<2, false>,
      (const void*)ntt32_inverse_split_kernel<2, true>},
     {(const void*)ntt32_inverse_split_kernel<3, false>,
      (const void*)ntt32_inverse_split_kernel<3, true>}},
    {{(const void*)ntt32_forward_split_kernel<1, false>,
      (const void*)ntt32_forward_split_kernel<1, true>},
     {(const void*)ntt32_forward_split_kernel<2, false>,
      (const void*)ntt32_forward_split_kernel<2, true>},
     {(const void*)ntt32_forward_split_kernel<3, false>,
      (const void*)ntt32_forward_split_kernel<3, true>}}};
constexpr size_t SPLIT_SMEM = sizeof(uint32_t) << SLICE_LOG;
// The sub-row kernels: [0] the inverse, [1 + canonical] the forward.
const void* const SUB_KERNELS[3] = {(const void*)ntt32_inverse_sub_kernel,
                                    (const void*)ntt32_forward_sub_kernel<false>,
                                    (const void*)ntt32_forward_sub_kernel<true>};

// ---------------------------------------------------------------------------
// Kernel C: the persistent forward NTT of the MXU key preparation.

constexpr int C_SLOTS = 3;  // the tile computing, the next loading, the last storing
constexpr int C_MIN_LOG_N = 8, C_MAX_LOG_N = 12;

struct ForwardCArgs {
  const uint32_t* in;   // (kp, rows, n) canonical residues
  uint32_t* out;        // (kp, rows, n) canonical, bit-reversed
  const uint32_t* tw;   // (kp, n) the forward roots
  const uint32_t* twp;  // their Shoup quotients
  PrimeSet ps;
  int rows, tile, items;  // items = kp ceil(rows / tile); log_n is the kernel's template
};

// Shared memory of a block: the slots' mbarriers (128 bytes), the prime's
// table and quotients, the work tile, the three slots.
inline size_t c_smem_bytes(int log_n, int tile) {
  return 128 + sizeof(uint32_t) * ((2ull << log_n) + ((size_t)(1 + C_SLOTS) * tile << log_n));
}

// Slot c of a row in natural order (the bulk-copied input tile).
struct SwzNone {
  static __device__ __forceinline__ int at(int i) { return i; }
};

// The last pass's words, brought from [0, 4q) to canonical, into a tile's
// natural rows in shared memory: 2^R adjacent words a group (its slots
// base .. base + 2^R - 1, ls = 0), one 8- or 16-byte store, or two 16-byte
// stores for 8 words, the half (base >> 5) & 1 (bit 2 of the group, of the
// lane in a warp) first: a quarter-warp's 8 stores then cover 32 distinct
// banks (tests/test_torch_keyprep_model.py checks this).
struct StageOut {
  uint32_t* p;
  int log_n;
  uint32_t q;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int, const uint32_t (&v)[G]) const {
    uint32_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = reduce_once(reduce_once(v[k], 2u * q), q);
    uint32_t* r = p + (row << log_n) + base;
    if constexpr (G == 8) {
      const uint4 lo = make_uint4(w[0], w[1], w[2], w[3]);
      const uint4 hi = make_uint4(w[4], w[5], w[6], w[7]);
      const int h = (base >> 5) & 1;
      reinterpret_cast<uint4*>(r)[h] = h ? hi : lo;
      reinterpret_cast<uint4*>(r)[h ^ 1] = h ? lo : hi;
    } else {
      store_words(r, w);
    }
  }
};

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N bulk stores of this thread are still reading their
// shared memory (READ) or still in flight.
template <int N, bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// SwzNtt rows whose pass's slots base + k 2^ls hold base and k 2^ls in
// disjoint bits (every forward pass): SwzNtt is linear over XOR, so the slot
// sits at at(base) ^ at(k 2^ls), the second term a constant where the pass
// is known at compile time (kernel C's): one XOR a word, not the swizzle's
// shifts and masks.
struct SwzRowsC {
  uint32_t* p;
  int log_n;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint32_t (&v)[G]) const {
    const uint32_t* r = p + (row << log_n);
    const int sb = SwzNtt::at(base);
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = r[sb ^ SwzNtt::at(k << ls)];
  }
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
    uint32_t* r = p + (row << log_n);
    const int sb = SwzNtt::at(base);
#pragma unroll
    for (int k = 0; k < G; ++k) r[sb ^ SwzNtt::at(k << ls)] = v[k];
  }
};

// fwd_pass with the row size and the pass's stages known at compile time,
// so every index, shift and mask of the loop folds (kernel C's passes; the
// same slots, twiddles and butterflies).
template <int LOG_N, int S0, int R, class TW, class LOAD, class STORE>
__device__ __forceinline__ void c_pass(int count, const TW& tw, uint32_t q, const LOAD& src,
                                       const STORE& dst) {
  constexpr int LOG_T = LOG_N - S0 - R, LOG_G = LOG_N - R;
  for (int it = threadIdx.x; it < (count << LOG_G); it += NTT_THREADS) {
    const int g = it & ((1 << LOG_G) - 1);
    const int hi = g >> LOG_T;
    const int base = (hi << (LOG_T + R)) + (g & ((1 << LOG_T) - 1));
    uint32_t v[1 << R], w[1 << R], wp[1 << R];
    src.load(it >> LOG_G, base, LOG_T, v);
    tw.template get<R>(S0, hi, w, wp);
    fwd_stages<R>(
        v,
        [&](int e, int j, uint32_t& ww, uint32_t& wwp) {
          ww = w[(1 << e) + j];
          wwp = wp[(1 << e) + j];
        },
        q);
    dst.store(it >> LOG_G, base, LOG_T, v);
  }
}

// The middle passes (radix 8 from stage S0 while more than R_LAST stages
// remain), a barrier after each.
template <int LOG_N, int S0, int R_LAST, class TW, class ROWS>
__device__ __forceinline__ void c_middle(int count, const TW& tw, uint32_t q, const ROWS& rows) {
  if constexpr (S0 < LOG_N - R_LAST) {
    c_pass<LOG_N, S0, 3>(count, tw, q, rows, rows);
    __syncthreads();
    c_middle<LOG_N, S0 + 3, R_LAST>(count, tw, q, rows);
  }
}

template <int LOG_N>
__global__ void __launch_bounds__(NTT_THREADS, 4) mxu8_forward32_kernel(const ForwardCArgs a) {
  extern __shared__ __align__(128) uint8_t c_sm[];
  constexpr int n = 1 << LOG_N;
  constexpr int R = LOG_N - 3 * ((LOG_N - 1) / 3);  // the last pass's stages
  const uint64_t* bars = reinterpret_cast<const uint64_t*>(c_sm);  // one a slot
  uint32_t* tw = reinterpret_cast<uint32_t*>(c_sm + 128);
  uint32_t* twp = tw + n;
  uint32_t* work = twp + n;                                        // T rows, SwzNtt
  uint32_t* slots = work + (a.tile << LOG_N);                      // C_SLOTS x T rows
  const int slot_words = a.tile << LOG_N;
  const int tiles = (a.rows + a.tile - 1) / a.tile;
  // this block's items [first, last): item = prime * tiles + tile
  const int first = (int)((long long)blockIdx.x * a.items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * a.items / gridDim.x);
  const auto count_of = [&](int item) { return min(a.tile, a.rows - (item % tiles) * a.tile); };
  const auto offset_of = [&](int item) {
    return ((size_t)(item / tiles) * a.rows + (size_t)(item % tiles) * a.tile) << LOG_N;
  };
  // thread 0: item's rows into slot s, completing on the slot's barrier
  const auto load = [&](int item, int s) {
    const uint32_t bytes = (uint32_t)count_of(item) << (LOG_N + 2);
    const uint32_t bar = smem_addr(bars + s);
    mbar_expect_tx(bar, bytes);
    bulk_copy(smem_addr(slots + s * slot_words), a.in + offset_of(item), bytes, bar, 0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C_SLOTS; ++s) mbar_init(smem_addr(bars + s), 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && first < last) load(first, 0);

  const SwzRowsC rows{work, LOG_N};
  const FwdTable table{(const uint32_t*)tw, (const uint32_t*)twp};
  int pi = -1;
  for (int item = first, i = 0; item < last; ++item, ++i) {
    const int s = i % C_SLOTS;
    const int count = count_of(item);
    uint32_t* slot = slots + s * slot_words;
    const int ip = item / tiles;
    const uint32_t* groots = a.tw + ((size_t)ip << LOG_N);
    const uint32_t* groots_p = a.twp + ((size_t)ip << LOG_N);
    if (ip != pi) {  // every thread is past the last tile's passes (its store's barrier)
      stage_tables(tw, twp, groots, groots_p, 0, n);
      pi = ip;
    }
    if (threadIdx.x == 0 && item + 1 < last) {
      // the next slot last held tile i + 1 - C_SLOTS, whose store went out
      // before tile i - 1's: all but the newest store have read their slots
      bulk_wait<1, true>();
      load(item + 1, (i + 1) % C_SLOTS);
    }
    const uint32_t q = a.ps.p[ip].q;
    const FwdFirst<uint32_t> first_tw(groots, groots_p, 8);
    mbar_wait(smem_addr(bars + s), (i / C_SLOTS) & 1);

    // pass 1 (stages 0-2): the slot's natural rows into the work tile,
    // twiddles in registers, under a table copy
    c_pass<LOG_N, 0, 3>(count, first_tw, q, SmemRows<SwzNone>{slot, LOG_N}, rows);
    cp_async_wait<0>();
    __syncthreads();
    c_middle<LOG_N, 3, R>(count, table, q, rows);
    // the last pass: canonical words back into the slot, natural order
    c_pass<LOG_N, LOG_N - R, R>(count, table, q, rows, StageOut{slot, LOG_N, q});
    fence_proxy_async();  // the slot's words, for the bulk store
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(a.out + offset_of(item), smem_addr(slot), (uint32_t)count << (LOG_N + 2));
  }
  if (threadIdx.x == 0) bulk_wait<0, false>();
}

// Kernel C's instances, log_n C_MIN_LOG_N .. C_MAX_LOG_N.
const void* const C_KERNELS[C_MAX_LOG_N - C_MIN_LOG_N + 1] = {
    (const void*)mxu8_forward32_kernel<8>, (const void*)mxu8_forward32_kernel<9>,
    (const void*)mxu8_forward32_kernel<10>, (const void*)mxu8_forward32_kernel<11>,
    (const void*)mxu8_forward32_kernel<12>};

// What the launches read of a device, set up at the first launch there:
// the SM count and, for each kernel, row size and tile, how many blocks an
// SM holds at once (0 where the tile does not fit in shared memory; kernel
// C's from C_MIN_LOG_N on); every kernel's shared-memory cap is raised to
// SMEM_MAX (the split kernels' to their slice).
struct NttDevice {
  int sms = 0;
  int resident[2][TILE_MAX_LOG_N + 1][4] = {};
  int c_resident[C_MAX_LOG_N + 1][4] = {};
};

int ntt_device(const NttDevice** out) {
  static NttDevice cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  NttDevice& d = cached[dev];
  if (d.sms == 0) {
    NttDevice fresh;
    const void* kernels[4] = {(const void*)ntt32_forward_kernel<true>,
                              (const void*)ntt32_forward_kernel<false>,
                              (const void*)ntt32_inverse_kernel<true>,
                              (const void*)ntt32_inverse_kernel<false>};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    // kernel C: the largest shared-memory carveout, so that the blocks the
    // occupancy query counts are the blocks an SM runs at once
    for (const void* k : C_KERNELS) {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    for (int i = 0; i < 4 * SPLIT_LCS && e == cudaSuccess; ++i)
      e = cudaFuncSetAttribute((&SPLIT_KERNELS[0][0][0])[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SPLIT_SMEM);
    for (const void* k : SUB_KERNELS)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SPLIT_SMEM);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int f = 0; f < 2 && e == cudaSuccess; ++f)
      for (int log_n = 1; log_n <= TILE_MAX_LOG_N && e == cudaSuccess; ++log_n)
        for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
          const size_t smem = smem_bytes(f == 0, log_n, 1 << i);
          if (smem <= (size_t)SMEM_MAX)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &fresh.resident[f][log_n][i], kernels[2 * f], NTT_THREADS, smem);
        }
    for (int log_n = C_MIN_LOG_N; log_n <= C_MAX_LOG_N && e == cudaSuccess; ++log_n)
      for (int i = 0; i < 4 && e == cudaSuccess; ++i)
        if (c_smem_bytes(log_n, 1 << i) <= (size_t)SMEM_MAX)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &fresh.c_resident[log_n][i], C_KERNELS[log_n - C_MIN_LOG_N], NTT_THREADS,
              c_smem_bytes(log_n, 1 << i));
    if (e != cudaSuccess) return (int)e;
    d = fresh;
  }
  *out = &d;
  return 0;
}

// Rows a block: the smallest tile T (1, 2, 4 or 8 rows) whose grid of kp
// ceil(rows / T) blocks runs in one wave (the SMs times the blocks an SM
// holds at T), else the largest T that fits (each staged table word then
// serves the most rows).  A smaller tile spreads a transform over more
// SMs; a larger one reads the tables less often.  The only copy of the rule.
int pick_tile(bool forward, int kp, int rows, int log_n, const NttDevice& d) {
  int fit = 1;
  for (int i = 0; i < 4; ++i) {
    const int held = d.resident[forward ? 0 : 1][log_n][i];
    if (held == 0) break;
    fit = 1 << i;
    if ((long)kp * ((rows + fit - 1) / fit) <= (long)d.sms * held) return fit;
  }
  return fit;
}

int launch(bool forward, const void* in, void* out, const void* tw, const void* twp,
           const void* prime_pack, int kp, int rows, int log_n, int canonical, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > FOUR_STEP_MAX_LOG_N || rows < 1 ||
      (((uintptr_t)in | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  NttArgs a{};
  a.in = (const uint32_t*)in;
  a.out = (uint32_t*)out;
  a.tw = (const uint32_t*)tw;
  a.twp = (const uint32_t*)twp;
  a.ps = unpack_primes((const uint64_t*)prime_pack, kp);
  a.rows = rows;
  a.log_n = log_n;
  const cudaStream_t s = (cudaStream_t)stream;
  if (log_n > MAX_LOG_N) {  // the four-step: columns, then a block a sub-row (inverse mirrored)
    const long long blocks = ((long long)kp * rows) << (log_n - SLICE_LOG);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (forward) {
      const int ce = four_step_columns(32, 0, 0, in, out, tw, twp, prime_pack, kp, rows, log_n,
                                       stream);
      if (ce != 0) return ce;
      a.in = a.out;
    }
    a.tile = 1;
    void* args[] = {&a};
    const cudaError_t e =
        cudaLaunchKernel(SUB_KERNELS[forward ? 1 + (canonical != 0) : 0], dim3((unsigned)blocks),
                         dim3(SPLIT_THREADS), args, SPLIT_SMEM, s);
    if (e != cudaSuccess) return (int)e;
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess || forward) return (int)le;
    return four_step_columns(32, 1, canonical ? 0 : 1, out, out, tw, twp, prime_pack, kp, rows,
                             log_n, stream);
  }
  if (log_n > TILE_MAX_LOG_N) {  // a row a cluster of 2^(log_n - SLICE_LOG) blocks
    const int lc = log_n - SLICE_LOG;
    a.tile = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((long)kp * rows) << lc);
    cfg.blockDim = dim3(SPLIT_THREADS);
    cfg.dynamicSmemBytes = SPLIT_SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << lc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void* args[] = {&a};
    const cudaError_t e =
        cudaLaunchKernelExC(&cfg, SPLIT_KERNELS[forward][lc - 1][canonical != 0], args);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  a.tile = pick_tile(forward, kp, rows, log_n, *d);
  const dim3 grid(kp * ((rows + a.tile - 1) / a.tile));
  const size_t smem = smem_bytes(forward, log_n, a.tile);
  if (forward && canonical) ntt32_forward_kernel<true><<<grid, NTT_THREADS, smem, s>>>(a);
  if (forward && !canonical) ntt32_forward_kernel<false><<<grid, NTT_THREADS, smem, s>>>(a);
  if (!forward && canonical) ntt32_inverse_kernel<true><<<grid, NTT_THREADS, smem, s>>>(a);
  if (!forward && !canonical) ntt32_inverse_kernel<false><<<grid, NTT_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// Kernel C's tile and grid: T0 = 2^12 / n rows (at most 8) give each
// radix-8 pass of a tile 512 groups, two a thread (a sweep of T = 1-8,
// cmux_mxu_timing.py --keyprep --grids: at 4200 rows of 1024, T = 4 took
// 0.0249 ms against T = 2's 0.0260 and T = 8's 0.0257; at 2 x 7560 rows of
// 2048, T = 2 0.1322 against T = 1's 0.1340); of T = 1, 2, ..., T0, the
// smallest whose kp ceil(rows / T) items run one a block in one wave (the
// SMs times the blocks an SM holds at T), else T0, the largest that fits;
// the grid is that wave, capped at the items, each block a range of them.
// So a few rows spread one tile a block over as many SMs (2 x 12 rows: 24
// blocks of one row), and a key's thousands of rows run several tiles a
// block, their loads and stores in flight under the passes.  The only copy
// of the rule.
void c_pick(int kp, int rows, int log_n, const NttDevice& d, int* tile, int* grid) {
  const int t0 = log_n >= 12 ? 1 : log_n <= 9 ? 8 : 1 << (12 - log_n);
  int t = 1, i = 0;
  for (; t < t0; t *= 2, ++i) {
    const long items = (long)kp * ((rows + t - 1) / t);
    if (d.c_resident[log_n][i + 1] == 0 || items <= (long)d.sms * d.c_resident[log_n][i]) break;
  }
  const long items = (long)kp * ((rows + t - 1) / t);
  const long wave = (long)d.sms * d.c_resident[log_n][i];
  *tile = t;
  *grid = (int)(items < wave ? items : wave);
}

int launch_c(const void* in, void* out, const void* tw, const void* twp, const void* prime_pack,
             int kp, int rows, int log_n, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < C_MIN_LOG_N || log_n > C_MAX_LOG_N || rows < 1 ||
      (((uintptr_t)in | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  ForwardCArgs a{};
  a.in = (const uint32_t*)in;
  a.out = (uint32_t*)out;
  a.tw = (const uint32_t*)tw;
  a.twp = (const uint32_t*)twp;
  a.ps = unpack_primes((const uint64_t*)prime_pack, kp);
  a.rows = rows;
  int grid = 0;
  c_pick(kp, rows, log_n, *d, &a.tile, &grid);
  a.items = kp * ((rows + a.tile - 1) / a.tile);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(C_KERNELS[log_n - C_MIN_LOG_N], dim3(grid),
                                         dim3(NTT_THREADS), args, c_smem_bytes(log_n, a.tile),
                                         (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

const char* pft_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward NTT of kp primes x rows_per_prime rows of 2^log_n words (log_n
// 1-26, kp <= 4; in and out 16-byte aligned, out may be in): roots,
// roots_p (kp, n) the bit-reversed root tables and Shoup quotients;
// canonical output or lazy in [0, 4q).  log_n 15-17 run a row a cluster;
// 18-26 the four-step, two launches: the column launch
// (four_step_columns), then the sub-row launch (the inverse: the sub-row
// launch's lazy words, then the column launch).
int pft_ntt32_forward(const void* in, void* out, const void* roots, const void* roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  return launch(true, in, out, roots, roots_p, prime_pack, kp, rows_per_prime, log_n, canonical,
                stream);
}

// The rows a block the launch takes (pick_tile) on the current device: 1
// at log_n 15-17, where a row spans a cluster.
int pft_ntt32_tile(int forward, int kp, int rows_per_prime, int log_n, int* tile) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > FOUR_STEP_MAX_LOG_N || rows_per_prime < 1)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  *tile = log_n > TILE_MAX_LOG_N ? 1 : pick_tile(forward != 0, kp, rows_per_prime, log_n, *d);
  return 0;
}

// Inverse NTT, the same shapes: inv_roots, inv_roots_p the inverse tables;
// canonical output or lazy in [0, 2q).
int pft_ntt32_inverse(const void* in, void* out, const void* inv_roots, const void* inv_roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  return launch(false, in, out, inv_roots, inv_roots_p, prime_pack, kp, rows_per_prime, log_n,
                canonical, stream);
}

// Kernel C: the canonical forward NTT of kp primes x rows_per_prime rows of
// 2^log_n canonical residues (log_n 8-12, kp <= 4; in and out 16-byte
// aligned), roots and roots_p as for pft_ntt32_forward.
int pft_mxu8_forward32(const void* in, void* out, const void* roots, const void* roots_p,
                       const void* prime_pack, int kp, int rows_per_prime, int log_n,
                       void* stream) {
  return launch_c(in, out, roots, roots_p, prime_pack, kp, rows_per_prime, log_n, stream);
}

// Kernel C's tile of rows and grid (c_pick) on the current device.
int pft_mxu8_forward32_grid(int kp, int rows_per_prime, int log_n, int* tile, int* grid) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < C_MIN_LOG_N || log_n > C_MAX_LOG_N ||
      rows_per_prime < 1)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  c_pick(kp, rows_per_prime, log_n, *d, tile, grid);
  return 0;
}

}  // extern "C"
