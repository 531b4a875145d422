// The four-step through device memory: rows of 2^log_n words past what a
// cluster holds on chip (log_n > CLUSTER_MAX_LOG_N = 17) run as 2^c sub-rows
// of 2^l words (c = log_n - l), each word j + k 2^l of the row at place j
// of sub-row k.
//
// Forward: the first c stages pair words of different sub-rows.  Column j
// is the C = 2^c words j + k 2^l, at the same place in each sub-row, so
// those stages are the first c stages of a transform of C words on the
// row's own root table (stage e, block i: roots[2^e + i]): a column launch
// runs them on tiles of columns read from and written to device memory,
// coalesced along j.  Every later stage pairs words of one sub-row: sub-row
// k is block k of the row at stage c, so a sub-row launch runs it as "slice
// k of 2^c" (csrc/ntt_split.cuh's FwdSliceTable, m = C + k; SliceTable in
// csrc/ntt64.cu), the slice's words loaded from device memory instead of
// from the cluster's cross stages.  The inverse mirrors it: the sub-row
// launch runs stages 0 .. l-1 (SliceInvTable at rank k, none of them the
// row's last) and stores lazy words, then the column launch runs the last c
// stages, inv_n folded into the final one.  The row's stage l + s on column
// j is the column's stage s, its twiddle the row's index ti = 1 + n - (n >>
// (l + s)) + block = the column transform's index + n - C (InvTable's lo).
//
// Each butterfly meets the plain version's twiddle in the plain version's
// lazy range, so the words are the plain version's, canonical or lazy
// (tests/test_torch_four_step_model.py models every index map here).
//
// The transforms' C entries (csrc/ntt32.cu, csrc/ntt64.cu) stay whole
// transforms past CLUSTER_MAX_LOG_N: each issues its column launch itself
// (four_step_columns), before its sub-row launch for the forward and after
// it for the inverse.
#pragma once

#include "ntt_split.cuh"

constexpr int CLUSTER_MAX_LOG_N = 17;    // the widest row a cluster holds on chip
constexpr int FOUR_STEP_MAX_LOG_N = 26;  // columns of up to 2^12 words beside sub-rows of 2^14
constexpr int SUB_LOG = 14;              // kernels 1-2, row 10, D and E: a sub-row a block
constexpr int MAC_SUB_LOG = 13;          // kernels H and J: a sub-row a block, tables staged
constexpr int COL_THREADS = 256;
constexpr int COL_TILE_LOG_WORDS = 12;   // a column tile's words: 2^12 (C words x columns)

// The column launch of a transform's four-step (csrc/ntt_columns.cu), on
// `count` moduli x `rows` rows of 2^log_n words (log_n past
// CLUSTER_MAX_LOG_N), sub-rows of 2^SUB_LOG: bits 32 (pack
// NttTables32.prime_pack) or 64 (pack mod_pack64); inverse 0 the forward's
// first stages (mode 0: words below 4q; 1: any u64 word), 1 the inverse's
// last (mode 0: canonical out; 1: lazy [0, 2q)).  out may be in.  Each
// launch it makes is counted for pft_ntt_columns_taken.
int four_step_columns(int bits, int inverse, int mode, const void* in, void* out, const void* tw,
                      const void* twp, const void* pack, int count, int rows, int log_n,
                      void* stream);

// Columns a tile of a column launch (log2): 2^12 words a tile, at most the
// sub-row's 2^l columns and at least one.
__host__ __device__ inline int col_log_tile(int c, int l) {
  const int t = COL_TILE_LOG_WORDS - c;
  return t < 0 ? 0 : t > l ? l : t;
}

// A tile's columns in shared memory: column jj's slot k (the row's word j0
// + jj + k 2^l) at p[jj pitch + k], pitch = C + 1 (odd: the loads along jj
// and a pass's groups along k both spread over the banks).  The passes of
// csrc/ntt_passes.cuh run on it with a column as a "row" of C words.
template <class W>
struct ColRows {
  W* p;
  int pitch;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, W (&v)[G]) const {
    const W* r = p + row * pitch + base;
#pragma unroll
    for (int k = 0; k < G; ++k) v[k] = r[k << ls];
  }
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const W (&v)[G]) const {
    W* r = p + row * pitch + base;
#pragma unroll
    for (int k = 0; k < G; ++k) r[k << ls] = v[k];
  }
};

// Columns j0 .. j0 + 2^log_tj - 1 of the row at `row` (its word 0) into
// the tile, each word through f as it loads; a warp's loads adjacent.
template <class W, class F>
__device__ __forceinline__ void col_load(const ColRows<W>& t, int log_tj, int c, const W* row,
                                         int l, int j0, const F& f) {
  for (int i = threadIdx.x; i < (1 << (log_tj + c)); i += blockDim.x) {
    const int k = i >> log_tj, jj = i & ((1 << log_tj) - 1);
    t.p[jj * t.pitch + k] = f(Word<W>::ldg(row + ((size_t)k << l) + j0 + jj));
  }
}

// The tile back into the row at `row`, the stores adjacent along j.
template <class W>
__device__ __forceinline__ void col_store(const ColRows<W>& t, int log_tj, int c, W* row, int l,
                                          int j0) {
  for (int i = threadIdx.x; i < (1 << (log_tj + c)); i += blockDim.x) {
    const int k = i >> log_tj, jj = i & ((1 << log_tj) - 1);
    row[((size_t)k << l) + j0 + jj] = t.p[jj * t.pitch + k];
  }
}

// The forward's first c stages on the tile's 2^log_tj columns: radix-8
// passes (the last 1-3 stages), the row's root table read from device
// memory (FwdTable: stage e's block i at roots[2^e + i]); a barrier after
// each.  Words below 4q in, lazy [0, 4q) out.
template <class W>
__device__ __forceinline__ void col_forward(const ColRows<W>& t, int log_tj, int c,
                                            const W* roots, const W* roots_p, W q) {
  const FwdTable<W> table{roots, roots_p};
  for (int s0 = 0; s0 < c; s0 += 3) {
    const int r = c - s0;
    if (r >= 3)
      fwd_pass<3>(1 << log_tj, c, s0, table, q, t, t);
    else if (r == 2)
      fwd_pass<2>(1 << log_tj, c, s0, table, q, t, t);
    else
      fwd_pass<1>(1 << log_tj, c, s0, table, q, t, t);
    __syncthreads();
  }
}

// The inverse's last c stages of a row of 2^log_n words on the tile's
// columns (lazy [0, 2q) in): radix-8 passes, the last holding the row's
// final stage (inv_n folded in, LAST's range) and handing its words to
// `last` (ColRows, or a functor of the same form); twiddles from the
// row's inverse table (w, wp) in device memory.  No barrier after the
// last pass.
template <Last LAST, class W, class PC, class STORE>
__device__ __forceinline__ void col_inverse(const ColRows<W>& t, int log_tj, int c, int log_n,
                                            const W* w, const W* wp, const PC& pc,
                                            const STORE& last) {
  const InvTable<W> table{w, wp, (1 << c) - (1 << log_n)};
  inv_rest<LAST>(t, 1 << log_tj, c, 0, table, pc, last);
}

// A sub-row's inverse stages 0 .. l-1 (none of them the row's last) on the
// MAC's words in shared memory (SwzNtt rows of 2^l), then its lazy [0, 2q)
// words to device memory at out[0 .. 2^l), a warp's stores adjacent: the
// first launch of kernels H and J past CLUSTER_MAX_LOG_N.
template <class TW>
__device__ __forceinline__ void sub_inverse_store(const TW& tw, const PrimeConsts& pc,
                                                  uint32_t* sm, int l, uint32_t* out) {
  const SmemRows<SwzNtt> rows{sm, l};
  slice_inverse(tw, pc, rows, rows, l);
  for (int i = threadIdx.x; i < (1 << l); i += blockDim.x) out[i] = sm[SwzNtt::at(i)];
}
