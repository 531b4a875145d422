// Kernels ntt64_forward and ntt64_inverse: the 64-bit negacyclic NTT and its
// inverse (q < 2^62, n <= 2^15), every modulus of a DCRT plan in one launch.
//
// Replace pallas_forward64 / pallas_inverse64
// (primus_fhe_tpu/ops/ntt_pallas.py:486,494; bodies _make_fwd_kernel and
// _make_inv_kernel).  The TPU kernels carry u64 words as u32 pairs with
// pre-split 16-bit limb tables and move the butterfly partner with lane
// rolls; here a word is a uint64_t, a Shoup multiply is three native
// multiplies (__umul64hi), and the partner is an index into shared memory.
//
// One thread block per polynomial row (modulus index = row / rows_per_mod);
// the row (n words, 32 KB at n = 4096) sits in shared memory through all
// log_n stages, one butterfly per thread per pass.  Twiddles come from the
// compact bit-reversed root tables (count, n).  A row of 2^15 words
// (256 KB) does not fit in one block's shared memory, so there each row is
// split over 2 blocks ("parts"), each holding one half: the forward runs
// its first stage (pairs i, i + n/2) while loading, after which every stage
// pairs words of one half; the inverse's stages pair words of one half
// until the last, which the 2 blocks of a thread-block cluster run by
// reading each other's half (distributed shared memory).
//
// Schedule: the plain version's (transforms/ntt.py forward64/inverse64),
// a reduction every stage, so canonical AND lazy outputs are bit-equal to
// it.  The TPU forward defers its reductions while (4 + 4 log_n) q < 2^64
// and reaches other lazy representatives (the same residues mod q).
//
// What bounds it: at n = 4096 a row is 32 KB in and out against 12 stages
// of 2048 butterflies, so a batch of a few rows is bound by launch latency
// and a large batch by device memory.
//
// Values are u64 words (int64 storage on the PyTorch side).

#include <cooperative_groups.h>

#include "modarith64.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void ntt64_forward_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ roots,
                                     const uint64_t* __restrict__ roots_p, ModSet64 ms,
                                     int rows_per_mod, int log_n, int canonical, int log_split) {
  extern __shared__ uint64_t sv[];
  const int n = 1 << log_n, part = n >> log_split;
  const int h = blockIdx.x & ((1 << log_split) - 1);  // which part of the row
  const size_t row = blockIdx.x >> log_split;
  const int mi = (int)(row / rows_per_mod);
  const uint64_t q = ms.m[mi].q, two_q = 2 * q;
  const uint64_t* w = roots + (size_t)mi * n;
  const uint64_t* wp = roots_p + (size_t)mi * n;
  const uint64_t* src = in + row * n;
  if (log_split == 0) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) sv[i] = src[i];
  } else {  // stage 0 (t = n/2, root w[1]) while loading; keep half h
    for (int i = threadIdx.x; i < part; i += blockDim.x) {
      const uint64_t tx = reduce_once64(src[i], two_q);
      const uint64_t ty = shoup64_lazy(src[i + part], w[1], wp[1], q);
      sv[i] = h == 0 ? tx + ty : tx + two_q - ty;
    }
  }
  __syncthreads();
  for (int s = log_split; s < log_n; ++s) {
    const int log_t = log_n - 1 - s, t = 1 << log_t;
    const int r0 = (1 << s) + (h << (s - log_split));  // root of this part's first block
    for (int i = threadIdx.x; i < part / 2; i += blockDim.x) {
      const int j = i >> log_t;
      const int xi = (j << (log_t + 1)) + (i & (t - 1)), yi = xi + t;
      const uint64_t tx = reduce_once64(sv[xi], two_q);
      const uint64_t ty = shoup64_lazy(sv[yi], w[r0 + j], wp[r0 + j], q);
      sv[xi] = tx + ty;
      sv[yi] = tx + two_q - ty;
    }
    __syncthreads();
  }
  uint64_t* dst = out + row * n + (size_t)h * part;
  for (int i = threadIdx.x; i < part; i += blockDim.x) {
    uint64_t v = sv[i];
    if (canonical) v = reduce_once64(reduce_once64(v, two_q), q);
    dst[i] = v;
  }
}

__device__ __forceinline__ void inverse_last_stage(uint64_t x, uint64_t y, const Mod64& c,
                                                   bool canonical, uint64_t* ox, uint64_t* oy) {
  const uint64_t q = c.q, two_q = 2 * q;
  uint64_t a = shoup64_lazy(reduce_once64(x + y, two_q), c.inv_n, c.inv_n_p, q);
  uint64_t b = shoup64_lazy(x + two_q - y, c.inv_n_w, c.inv_n_w_p, q);
  *ox = canonical ? reduce_once64(a, q) : a;
  *oy = canonical ? reduce_once64(b, q) : b;
}

__global__ void ntt64_inverse_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ inv_roots,
                                     const uint64_t* __restrict__ inv_roots_p, ModSet64 ms,
                                     int rows_per_mod, int log_n, int canonical, int in_factor,
                                     int log_split) {
  extern __shared__ uint64_t sv[];
  const int n = 1 << log_n, half = n >> 1, part = n >> log_split;
  const int h = blockIdx.x & ((1 << log_split) - 1);
  const size_t row = blockIdx.x >> log_split;
  const int mi = (int)(row / rows_per_mod);
  const Mod64 c = ms.m[mi];
  const uint64_t q = c.q, two_q = 2 * q;
  const uint64_t* w = inv_roots + (size_t)mi * n;
  const uint64_t* wp = inv_roots_p + (size_t)mi * n;
  const uint64_t* src = in + row * n + (size_t)h * part;
  for (int i = threadIdx.x; i < part; i += blockDim.x) {
    uint64_t x = src[i];
    for (int f = in_factor >> 1; f >= 2; f >>= 1) x = reduce_once64(x, (uint64_t)f * q);
    sv[i] = x;  // now in [0, 2q)
  }
  __syncthreads();
  for (int s = 0; s < log_n - 1; ++s) {
    const int log_t = s, t = 1 << log_t;
    // inv_roots are consumed in order: stage s starts at 1 + n - (n >> s)
    const int r0 = 1 + n - (n >> s) + h * ((n >> (s + 1)) >> log_split);
    for (int i = threadIdx.x; i < part / 2; i += blockDim.x) {
      const int j = i >> log_t;
      const int xi = (j << (log_t + 1)) + (i & (t - 1)), yi = xi + t;
      const uint64_t x = sv[xi], y = sv[yi];
      sv[xi] = reduce_once64(x + y, two_q);
      sv[yi] = shoup64_lazy(x + two_q - y, w[r0 + j], wp[r0 + j], q);
    }
    __syncthreads();
  }
  uint64_t* dst = out + row * n;
  if (log_split == 0) {
    for (int i = threadIdx.x; i < half; i += blockDim.x)
      inverse_last_stage(sv[i], sv[i + half], c, canonical != 0, dst + i, dst + i + half);
    return;
  }
  // the last stage pairs the two halves: each block of the cluster finishes
  // half of the pairs, reading x from part 0 and y from part 1
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const uint64_t* xs = cluster.map_shared_rank(sv, 0);
  const uint64_t* ys = cluster.map_shared_rank(sv, 1);
  for (int i = h * (half / 2) + threadIdx.x; i < (h + 1) * (half / 2); i += blockDim.x)
    inverse_last_stage(xs[i], ys[i], c, canonical != 0, dst + i, dst + i + half);
  cluster.sync();  // keep both halves alive until every read is done
}

// Parts a row is split into (log2): 1 when a row overflows one block's
// shared memory (n = 2^15).
inline int log_split_for(int log_n) { return log_n > 14 ? 1 : 0; }

template <class K>
int prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool valid(int count, int rows_per_mod, int log_n) {
  return count >= 1 && count <= PFT_MAX_MOD64 && log_n >= 1 && log_n <= 15 && rows_per_mod >= 1;
}

}  // namespace

extern "C" {

int pft_ntt64_forward(const void* in, void* out, const void* roots, const void* roots_p,
                      const void* mod_pack, int count, int rows_per_mod, int log_n, int canonical,
                      void* stream) {
  if (!valid(count, rows_per_mod, log_n)) return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  const int ls = log_split_for(log_n);
  const size_t smem = sizeof(uint64_t) << (log_n - ls);
  const int err = prepare(ntt64_forward_kernel, smem);
  if (err) return err;
  ntt64_forward_kernel<<<(count * rows_per_mod) << ls, block_threads64(log_n - ls), smem,
                         (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)roots, (const uint64_t*)roots_p, ms,
      rows_per_mod, log_n, canonical, ls);
  return (int)cudaGetLastError();
}

int pft_ntt64_inverse(const void* in, void* out, const void* inv_roots, const void* inv_roots_p,
                      const void* mod_pack, int count, int rows_per_mod, int log_n, int canonical,
                      int in_factor, void* stream) {
  if (!valid(count, rows_per_mod, log_n) || in_factor < 2 || (in_factor & (in_factor - 1)))
    return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  const int ls = log_split_for(log_n);
  const size_t smem = sizeof(uint64_t) << (log_n - ls);
  int err = prepare(ntt64_inverse_kernel, smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((count * rows_per_mod) << ls);
  cfg.blockDim = dim3(block_threads64(log_n - ls));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << ls;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ls ? 1 : 0;
  err = (int)cudaLaunchKernelEx(&cfg, ntt64_inverse_kernel, (const uint64_t*)in, (uint64_t*)out,
                                (const uint64_t*)inv_roots, (const uint64_t*)inv_roots_p, ms,
                                rows_per_mod, log_n, canonical, in_factor, ls);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
