// A u32 row of 2^log_n words split over a thread-block cluster of C = 2^c
// blocks: slice k (one block) holds words k 2^l .. (k+1) 2^l - 1 of the row
// (l = log_n - c) in its shared memory, word i of the slice at SwzNtt::at(i).
// Kernels 1-2 at log_n 15-16 (csrc/ntt32.cu) and kernel H at log_n 16
// (csrc/cmux_stage2.cu) run on it, with kernels 1-2's own tables: the
// compact bit-reversed roots (forward) or inverse roots and their Shoup
// quotients, (kp, n) words read from device memory.
//
// The forward's first c stages pair words of different slices: group j is
// the C words j + k 2^l, one a slice, at the same place in each, so its c
// stages are a radix-C group at stage 0 (twiddles roots[1 .. C-1]) and word
// k goes to slice k over distributed shared memory.  Every later stage
// pairs words of one slice: the slice runs kernel 1's radix-8 passes
// (fwd_pass) as a row of 2^l words, on FwdSliceTable.  The inverse mirrors
// it: the slice's stages first (inv_pass on SliceInvTable, none of them the
// last), then the last c stages on groups gathered from the C slices, the
// final stage folding inv_n in.  Each pair meets the plain version's
// butterfly with its twiddle in the plain version's lazy range, so the
// words are the plain version's (tests/test_torch_ntt_split_model.py).
#pragma once

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

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
struct SliceInvTable {
  const uint32_t* w;
  const uint32_t* wp;
  int l, log_n, rank;
  __device__ __forceinline__ void operator()(int ti, uint32_t& tw, uint32_t& twp) const {
    const int ls = 32 - __clz((1 << l) - ti);  // l - s
    const int j = ti - 1 - (1 << l) + (1 << ls);
    const int g = 1 + (1 << log_n) - (1 << (log_n - l + ls)) + (rank << (ls - 1)) + j;
    tw = __ldg(w + g);
    twp = __ldg(wp + g);
  }
};

// The forward's first LC stages of a row (in: its words in device memory,
// below 4q) split over slices rank0 .. rank0 + C - 1 of the cluster: this
// block (slice `rank`) takes the offsets j of its share, 2^(l - LC) of them,
// and stores word k of each group into slice k at j.  Cluster barriers
// before (every slice's block has started) and after (every word is in its
// slice).
template <int LC>
__device__ __forceinline__ void cross_forward(const uint32_t* in, uint32_t* sm, int l, int rank,
                                              int rank0, const uint32_t* roots,
                                              const uint32_t* roots_p, uint32_t q) {
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const FwdFirst<uint32_t> first(roots, roots_p, C);
  const int per = 1 << (l - LC);
  cluster.sync();
  for (int j = rank * per + (int)threadIdx.x; j < (rank + 1) * per; j += blockDim.x) {
    uint32_t v[C];
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = __ldg(in + j + (k << l));
    fwd_stages<LC>(
        v,
        [&](int e, int jj, uint32_t& w, uint32_t& wp) {
          w = first.w[(1 << e) + jj];
          wp = first.wp[(1 << e) + jj];
        },
        q);
    uint32_t* word = sm + SwzNtt::at(j);
#pragma unroll
    for (int k = 0; k < C; ++k) *cluster.map_shared_rank(word, rank0 + k) = v[k];
  }
  cluster.sync();
}

// The inverse's stages 0 .. l-1 on a slice of 2^l words, none of them the
// row's last: the remainder pass (1-3 stages) from src, the radix-8 passes
// in the slice's rows, a block barrier after each.
template <class TW, class SRC>
__device__ __forceinline__ void slice_inverse(const TW& tw, const PrimeConsts& pc, const SRC& src,
                                              const SmemRows<SwzNtt>& rows, int l) {
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
template <int LC, Last LAST, class STORE>
__device__ __forceinline__ void cross_inverse(uint32_t* sm, int l, int log_n, int rank, int rank0,
                                              const uint32_t* w, const uint32_t* wp,
                                              const PrimeConsts& pc, const STORE& store) {
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = 1 << log_n, per = 1 << (l - LC);
  const uint32_t q = pc.q, two_q = 2u * q;
  cluster.sync();
  for (int j = rank * per + (int)threadIdx.x; j < (rank + 1) * per; j += blockDim.x) {
    uint32_t v[C];
    const uint32_t* word = sm + SwzNtt::at(j);
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
          const int ti = start + (k >> (e + 1));
          inv_bf(v[k], v[k + h], __ldg(w + ti), __ldg(wp + ti), q);
        }
      }
    }
    store(j, v);
  }
}
