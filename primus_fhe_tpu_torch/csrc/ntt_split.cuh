// A row of 2^log_n words split over a thread-block cluster of C = 2^c
// blocks: slice k (one block) holds words k 2^l .. (k+1) 2^l - 1 of the row
// (l = log_n - c) in its shared memory, word i of the slice at slice_at<W>(i)
// (SwzNtt::at for u32 words, swz64 for u64 ones).  Kernels 1-2 at log_n
// 15-17 (csrc/ntt32.cu) and kernels H and J (csrc/cmux_stage2.cu,
// csrc/ntru_stage.cu: C = 1-16, pick_slices) run on it on u32 words, row 10
// and kernel E at log_n 15-17 (csrc/ntt64.cu) on u64 words, each with its
// own tables: the compact bit-reversed roots (forward) or inverse roots and
// their Shoup quotients, (count, n) words read from device memory.
//
// The forward's first c stages pair words of different slices: group j is
// the C words j + k 2^l, one a slice, at the same place in each, so its c
// stages are a radix-C group at stage 0 (twiddles roots[1 .. C-1]) and word
// k goes to slice k over distributed shared memory.  Every later stage
// pairs words of one slice: the slice runs the radix-8 passes (fwd_pass) as
// a row of 2^l words, on FwdSliceTable.  The inverse mirrors it: the
// slice's stages first (inv_pass on SliceInvTable, none of them the last),
// then the last c stages on groups gathered from the C slices, the final
// stage folding inv_n in.  Each pair meets the plain version's butterfly
// with its twiddle in the plain version's lazy range, so the words are the
// plain version's (tests/test_torch_ntt_split_model.py,
// tests/test_torch_ntt64_cluster.py).  Past 2^17 the same slice bodies run
// one block a sub-row of the four-step through device memory
// (csrc/ntt_columns.cuh), the cross stages there a column launch.
#pragma once

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

// The slice's shared-memory word of its word i.
template <class W>
__device__ __forceinline__ int slice_at(int i) {
  if constexpr (sizeof(W) == 4)
    return SwzNtt::at(i);
  else
    return swz64(i);
}

// Forward twiddles of slice `rank` of C: at the row's stage c + s (the
// slice's stage s) the slice's block j is the row's block rank 2^s + j,
// whose root is roots[2^(c+s) + rank 2^s + j] = roots[(m << s) + j] with m =
// C + rank (FwdTable is m = 1).  get<R> as FwdTable's: w[2^e + j] is block
// j's at stage s0 + e of a group in block `hi` of stage s0.
struct FwdSliceTable {
  const uint32_t* w;
  const uint32_t* wp;
  int m;
  template <int R>
  __device__ __forceinline__ void get(int s0, int hi, uint32_t (&tw)[1 << R],
                                      uint32_t (&twp)[1 << R]) const {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int base = (m << (s0 + e)) + (hi << e);
#pragma unroll
      for (int j = 0; j < (1 << e); ++j) {
        tw[(1 << e) + j] = __ldg(w + base + j);
        twp[(1 << e) + j] = __ldg(wp + base + j);
      }
    }
  }
};

// Inverse twiddles of slice `rank` of a row of 2^log_n words split into
// slices of 2^l: inv_pass on the slice (log_n = l) asks for the slice's
// twiddle ti = 1 + 2^l - 2^(l-s) + j of its stage s, block j; the row's
// block at stage s is rank 2^(l-s-1) + j, at 1 + n - n 2^-s + rank
// 2^(l-s-1) + j of the row's table.  l - s = ceil(log2(2^l + 1 - ti)).
template <class W>
struct SliceInvTable {
  const W* w;
  const W* wp;
  int l, log_n, rank;
  __device__ __forceinline__ int index(int ti) const {
    const int ls = 32 - __clz((1 << l) - ti);  // l - s
    const int j = ti - 1 - (1 << l) + (1 << ls);
    return 1 + (1 << log_n) - (1 << (log_n - l + ls)) + (rank << (ls - 1)) + j;
  }
  __device__ __forceinline__ void operator()(int ti, W& tw, W& twp) const {
    const int g = index(ti);
    tw = Word<W>::ldg(w + g);
    twp = Word<W>::ldg(wp + g);
  }
};
template <class W>
SliceInvTable(const W*, const W*, int, int, int) -> SliceInvTable<W>;

// Starts copying the slice's inverse twiddles and their quotients (t's
// words for ti = 1 .. 2^l - 1; at l = log_n, rank 0 the row's own table)
// into tw[ti], twp[ti] in shared memory, 4 bytes a cp.async (not
// committed): the passes then read them through InvTable{tw, twp} after
// cp_async_wait and a block barrier, not from device memory.
__device__ __forceinline__ void stage_slice_table(const SliceInvTable<uint32_t>& t, uint32_t* tw,
                                                  uint32_t* twp) {
  for (int ti = 1 + (int)threadIdx.x; ti < (1 << t.l); ti += blockDim.x) {
    const int g = t.index(ti);
    cp_async4(tw + ti, t.w + g);
    cp_async4(twp + ti, t.wp + g);
  }
}

// The forward's first LC stages of a row (in: its words in device memory,
// below 4q; ANY: any u64 words, each brought to [0, 2q) first by a lazy
// Shoup multiply by 1, p1 = floor(2^64 / q)) split over slices rank0 ..
// rank0 + C - 1 of the cluster: this block (slice `rank`) takes the offsets
// j of its share, 2^(l - LC) of them, and stores word k of each group into
// slice k at j.  Cluster barriers before (every slice's block has started)
// and after (every word is in its slice).
template <int LC, bool ANY = false, class W>
__device__ __forceinline__ void cross_forward(const W* in, W* sm, int l, int rank, int rank0,
                                              const W* roots, const W* roots_p, W q, W p1 = 0) {
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const FwdFirst<W> first(roots, roots_p, C);
  const int per = 1 << (l - LC);
  cluster.sync();
  for (int j = rank * per + (int)threadIdx.x; j < (rank + 1) * per; j += blockDim.x) {
    W v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      v[k] = Word<W>::ldg(in + j + (k << l));
      if constexpr (ANY) v[k] = Word<W>::shoup(v[k], 1, p1, q);
    }
    fwd_stages<LC>(
        v,
        [&](int e, int jj, W& w, W& wp) {
          w = first.w[(1 << e) + jj];
          wp = first.wp[(1 << e) + jj];
        },
        q);
    W* word = sm + slice_at<W>(j);
#pragma unroll
    for (int k = 0; k < C; ++k) *cluster.map_shared_rank(word, rank0 + k) = v[k];
  }
  cluster.sync();
}

// The inverse's stages 0 .. l-1 on a slice of 2^l words, none of them the
// row's last: the remainder pass (1-3 stages) from src, the radix-8 passes
// in the slice's rows, a block barrier after each.
template <class TW, class PC, class SRC, class ROWS>
__device__ __forceinline__ void slice_inverse(const TW& tw, const PC& pc, const SRC& src,
                                              const ROWS& rows, int l) {
  const int r = remainder_stages(l);
  if (r == 3) inv_pass<3, Last::no>(1, l, 0, tw, pc, src, rows);
  if (r == 2) inv_pass<2, Last::no>(1, l, 0, tw, pc, src, rows);
  if (r == 1) inv_pass<1, Last::no>(1, l, 0, tw, pc, src, rows);
  __syncthreads();
  for (int s0 = r; s0 < l; s0 += 3) {
    inv_pass<3, Last::no>(1, l, s0, tw, pc, rows, rows);
    __syncthreads();
  }
}

// The inverse's last LC stages of a row over slices rank0 .. rank0 + C - 1:
// after a cluster barrier (every slice's own stages done), this block's
// groups j gather word j of each slice, run the stages (the last folding
// inv_n in: canonical or lazy in [0, 2q) as LAST says) with the row's
// inverse table w, wp, and hand the C words to store(j, v).  Group j is
// this block's alone, so store may write the words back into the slices.
// The caller holds a cluster barrier after it before a slice may end.
template <int LC, Last LAST, class W, class PC, class STORE>
__device__ __forceinline__ void cross_inverse(W* sm, int l, int log_n, int rank, int rank0,
                                              const W* w, const W* wp, const PC& pc,
                                              const STORE& store) {
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << log_n, per = 1 << (l - LC);
  const W q = pc.q, two_q = W(2) * q;
  cluster.sync();
  for (int j = rank * per + (int)threadIdx.x; j < (rank + 1) * per; j += blockDim.x) {
    W v[C];
    const W* word = sm + slice_at<W>(j);
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = *cluster.map_shared_rank(word, rank0 + k);
#pragma unroll
    for (int e = 0; e < LC; ++e) {
      const int h = 1 << e;
      const int start = 1 + n - (n >> (l + e));
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (k & h) continue;
        if (e == LC - 1) {
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
          const int ti = start + (k >> (e + 1));
          inv_bf(v[k], v[k + h], Word<W>::ldg(w + ti), Word<W>::ldg(wp + ti), q);
        }
      }
    }
    store(j, v);
  }
}

// ---------------------------------------------------------------------------
// Kernels H and J: the MAC of a slice, the threads a block and the slices a
// row.

constexpr int MAC_RUN = 16;    // products summed between two reductions
constexpr int MAC_DEPTH = 4;   // rows whose 16-byte loads are issued together
constexpr int SLICE_THREADS = 512;
constexpr int MAX_CLUSTER_BLOCKS = 16;  // past 8: a non-portable cluster size
// Slices of up to 2^13 words also hold their inverse twiddles and acc's
// words in shared memory (at most 128 KB a block); larger ones cannot.
constexpr int STAGE_MAX_LOG = 13;

// Threads a block of a slice of 2^l words: a group of 4 words each for the
// MAC, 32 to 512.
inline int slice_threads(int l) {
  const int t = (1 << l) >> 2;
  return t < 32 ? 32 : t > SLICE_THREADS ? SLICE_THREADS : t;
}

__device__ __forceinline__ void mac4(uint64_t (&sum)[4], uint4 f, uint4 k, uint32_t q) {
  const uint32_t two_q = 2u * q;
  sum[0] += (uint64_t)reduce_once(reduce_once(f.x, two_q), q) * k.x;
  sum[1] += (uint64_t)reduce_once(reduce_once(f.y, two_q), q) * k.y;
  sum[2] += (uint64_t)reduce_once(reduce_once(f.z, two_q), q) * k.z;
  sum[3] += (uint64_t)reduce_once(reduce_once(f.w, two_q), q) * k.w;
}

// The MAC of a slice of 2^l coefficients (l >= 2) into shared memory: word c
// sums the `rows` products f[t][c] key[t][c] (row t of the digits at f + t
// fs, of the key at key + t ks; the digits lazy in [0, 4q), each brought
// into [0, q) first, the key canonical) mod q, Barrett-reduced after every
// MAC_RUN products (16 products below 2^60 and a remainder below 2q stay
// below 2^64, so any count sums exactly), canonical at sm[SwzNtt::at(c)].
// A thread takes a group of 4 words: one 16-byte load of digits and one of
// key a row, MAC_DEPTH rows' loads issued before their products.  f, key
// and the row strides on 16 bytes.
__device__ __forceinline__ void slice_mac(const uint32_t* f, size_t fs, const uint32_t* key,
                                          size_t ks, int rows, int l, const PrimeConsts& pc,
                                          uint32_t* sm) {
  const uint32_t q = pc.q;
  for (int c = (int)threadIdx.x << 2; c < (1 << l); c += (int)blockDim.x << 2) {
    uint64_t sum[4] = {0, 0, 0, 0};
    int run = 0;
    for (int t0 = 0; t0 < rows; t0 += MAC_DEPTH) {
      uint4 fv[MAC_DEPTH], kv[MAC_DEPTH];
#pragma unroll
      for (int d = 0; d < MAC_DEPTH; ++d) {
        const size_t t = (size_t)min(t0 + d, rows - 1);  // past the last row: read, not summed
        fv[d] = __ldg(reinterpret_cast<const uint4*>(f + t * fs + c));
        kv[d] = __ldg(reinterpret_cast<const uint4*>(key + t * ks + c));
      }
#pragma unroll
      for (int d = 0; d < MAC_DEPTH; ++d) {
        if (t0 + d < rows) {
          mac4(sum, fv[d], kv[d], q);
          if (++run == MAC_RUN) {
#pragma unroll
            for (int u = 0; u < 4; ++u) sum[u] = barrett_lazy_wide(sum[u], pc.ratio, q);
            run = 0;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      sm[SwzNtt::at(c + u)] = reduce_once(barrett_lazy_wide(sum[u], pc.ratio, q), q);
  }
}

// The slices a row, 2^lc, of a kernel that runs each of `clusters` rows over
// a cluster of kp 2^lc blocks, a slice of 2^(log_n - lc) words a block
// (kernels H and J; the only copy of their rule).  held(lc, &count) gives
// the clusters the card holds at once (cudaOccupancyMaxActiveClusters; 0:
// the launch does not fit) and returns 0 or a CUDA error.  The candidates:
// lc from lo = max(0, log_n - max_log) up, while kp 2^lc <= 16 and the
// slice keeps 2^min_log words or more (lo itself always).  Of those the
// card holds, the one whose waves ceil(clusters / held) times a block's
// slice, 2^-lc, is least (the work of a block-wave); a tie goes to the
// fewer waves, then to the larger lc.  A shape no candidate fits is
// refused (cudaErrorInvalidConfiguration).
template <class HELD>
inline int pick_slices(long long clusters, int kp, int log_n, int min_log, int max_log,
                       const HELD& held, int* lc_out, int* held_out) {
  const int lo = log_n > max_log ? log_n - max_log : 0;
  int best = -1, best_held = 0;
  long long best_waves = 0;
  for (int lc = lo; (kp << lc) <= MAX_CLUSTER_BLOCKS && (lc == lo || log_n - lc >= min_log);
       ++lc) {
    int count = 0;
    const int err = held(lc, &count);
    if (err != 0) return err;
    if (count < 1) continue;
    const long long waves = (clusters + count - 1) / count;
    // waves 2^-lc against the best's, both scaled by 2^(lc + best)
    const long long cost = best < 0 ? 0 : waves << best, best_cost = best_waves << lc;
    if (best < 0 || cost < best_cost || (cost == best_cost && waves <= best_waves)) {
      best = lc;
      best_held = count;
      best_waves = waves;
    }
  }
  if (best < 0) return (int)cudaErrorInvalidConfiguration;
  *lc_out = best;
  *held_out = best_held;
  return 0;
}
