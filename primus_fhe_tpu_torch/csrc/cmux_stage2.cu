// Kernel H: the CMux step's second half on its own, for every shape the
// one-launch step (csrc/cmux_fused.cu) cannot hold:
//   acc[b, j] += CRT_i( INTT_i( sum_{r,l} f[i, b k1 + r, l] key[i, r, l, j] ) ).
//
// Replaces cmux_stage2 (primus_fhe_tpu/ops/cmux_fused.py:226) where the
// staged route runs (ops/cmux_fused.step_route): kernel G and kernel 1 at
// out_factor 4 write the lazy NTT-domain digits f (kp, B k1, L, n), in
// [0, 4p); this kernel reads them, the canonical key slice (kp, k1, L, k1,
// n), and adds into acc (B, k1, n) in place.
//
// Design (a simple one that is right; its times are in PERF.md):
// - one cluster of kp C blocks for each (ciphertext b, output component j):
//   block (prime i, slice s), cluster rank i C + s.  C = 1 up to log_n 15
//   (a row of up to 128 KB in one block's shared memory); C = 2 at log_n 16,
//   a row over 2 blocks (csrc/ntt_split.cuh);
// - the MAC: each coefficient of the block's slice sums its k1 L products
//   mod its prime, each digit brought into [0, p) first (the products are
//   below 2^60), the sum Barrett-reduced after every 16 products (16
//   products and a remainder below 2p stay below 2^64), so any L sums
//   exactly; the canonical sum goes into shared memory (SwzNtt);
// - the inverse NTT of the row on kernel 2's radix-8 passes
//   (csrc/ntt_passes.cuh), twiddles from the inverse table in device memory;
//   at C = 2 the slice's stages first, then the last stage across the two
//   slices; each canonical output times (P/p_i)^-1 mod p_i (the fused
//   kernel's CRT constants, conv.crt_pack) stays in its slice;
// - a cluster barrier; block (i, s) then takes 1/kp of slice s's
//   coefficients, reads their kp residues from the kp blocks of slice s over
//   distributed shared memory, runs the fused kernel's exact integer CRT
//   and adds into acc; a cluster barrier keeps every slice alive until its
//   peers' reads are done.
// Block (b, j) reads and writes only row acc[b, j], each coefficient by one
// thread, so out may be acc.  The output is the exact CRT of canonical
// residues: bit-equal to cmux_stage2_plain
// (tests/test_torch_cmux_stage2_model.py models the index maps and the
// reduction schedule).

#include "ntt_split.cuh"

namespace {

constexpr int H_MAX_THREADS = 512;
constexpr int H_MAX_LEVEL = 32;
constexpr int H_MIN_LOG_N = 4, H_MAX_LOG_N = 16;
constexpr int H_SLICE_MAX_LOG = 15;  // a block's slice: at most 128 KB
constexpr int H_MAC_RUN = 16;        // products summed between two reductions

struct Stage2Args {
  const uint32_t* f;    // (kp, bsz k1, L, n), lazy in [0, 4p)
  const uint32_t* key;  // (kp, k1, L, k1, n), canonical
  const uint32_t* acc;  // (bsz, k1, n); may alias out
  uint32_t* out;
  const uint32_t* inv_roots;  // (kp, n) each
  const uint32_t* inv_roots_p;
  PrimeSet ps;
  CrtConsts crt;
  int kp, k1, level, log_n, bsz;
};

inline int h_threads(int l) {
  const int t = (1 << l) >> 3;
  return t < 32 ? 32 : t > H_MAX_THREADS ? H_MAX_THREADS : t;
}

template <int LC>
__global__ void __launch_bounds__(H_MAX_THREADS, 1) cmux_stage2_kernel(const Stage2Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pi = rank >> LC, s = rank & (C - 1);
  const int bj = (int)blockIdx.x / (a.kp << LC);  // b k1 + j
  const int b = bj / a.k1, j = bj - b * a.k1;
  const int log_n = a.log_n, l = log_n - LC, nl = 1 << l;
  const int k1 = a.k1, L = a.level;
  const PrimeConsts pc = a.ps.p[pi];
  const uint32_t q = pc.q;
  const size_t n = (size_t)1 << log_n;
  const size_t lane0 = (size_t)s << l;

  // 1. the MAC of the slice's coefficients, U at a time (their loads issued
  //    together): f[pi, b k1 + r, lv] x key[pi, r, lv, j]
  const uint32_t* fb = a.f + (((size_t)pi * a.bsz * k1 + (size_t)b * k1) * L << log_n) + lane0;
  const uint32_t* kb = a.key + (((size_t)pi * k1 * L * k1 + j) << log_n) + lane0;
  constexpr int U = 4;
  for (int c0 = threadIdx.x; c0 < nl; c0 += U * blockDim.x) {
    uint64_t sum[U] = {};
    int run = 0;
    for (int r = 0; r < k1; ++r) {
      for (int lv = 0; lv < L; ++lv) {
        const size_t frow = (size_t)(r * L + lv) << log_n;
        const size_t krow = (size_t)((r * L + lv) * k1) << log_n;
        uint32_t fv[U], kv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = min(c0 + u * (int)blockDim.x, nl - 1);  // past the end: not stored
          fv[u] = __ldg(fb + frow + c);
          kv[u] = __ldg(kb + krow + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          sum[u] += (uint64_t)reduce_once(reduce_once(fv[u], 2u * q), q) * kv[u];
        if (++run == H_MAC_RUN) {
#pragma unroll
          for (int u = 0; u < U; ++u) sum[u] = barrett_lazy_wide(sum[u], pc.ratio, q);
          run = 0;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * (int)blockDim.x;
      if (c < nl) sm[SwzNtt::at(c)] = reduce_once(barrett_lazy_wide(sum[u], pc.ratio, q), q);
    }
  }
  __syncthreads();

  // 2. the inverse NTT; each canonical output y times (P/p_i)^-1 mod p_i,
  //    canonical, back into its slot
  const uint32_t* w = a.inv_roots + ((size_t)pi << log_n);
  const uint32_t* wp = a.inv_roots_p + ((size_t)pi << log_n);
  const uint32_t iw = a.crt.iw[pi], ipq = a.crt.ipq[pi];
  const SmemRows<SwzNtt> rows{sm, l};
  if constexpr (LC == 0) {
    const InvTable<uint32_t> tw{w, wp};
    const int r = remainder_stages(l);
    if (r == 3) inv_pass<3, Last::no>(1, l, 0, tw, pc, rows, rows);
    if (r == 2) inv_pass<2, Last::no>(1, l, 0, tw, pc, rows, rows);
    if (r == 1) inv_pass<1, Last::no>(1, l, 0, tw, pc, rows, rows);
    __syncthreads();
    inv_rest<Last::canonical>(rows, 1, l, r, tw, pc, slot_store([&](int, int c, uint32_t v) {
                                sm[SwzNtt::at(c)] = reduce_once(shoup_mul_lazy(v, iw, ipq, q), q);
                              }));
  } else {
    slice_inverse(SliceInvTable{w, wp, l, log_n, s}, pc, rows, rows, l);
    cross_inverse<LC, Last::canonical>(
        sm, l, log_n, s, pi << LC, w, wp, pc, [&](int c, const uint32_t (&v)[C]) {
#pragma unroll
          for (int k = 0; k < C; ++k)
            *cluster.map_shared_rank(sm + SwzNtt::at(c), (pi << LC) + k) =
                reduce_once(shoup_mul_lazy(v[k], iw, ipq, q), q);
        });
  }
  cluster.sync();

  // 3. block (pi, s) takes coefficients [pi chunk, (pi + 1) chunk) of slice
  //    s: the kp residues from the blocks (i, s), the integer CRT, the
  //    wrapping add to acc
  const int chunk = (nl + a.kp - 1) / a.kp;
  const int c_end = min(nl, (pi + 1) * chunk);
  const size_t row = (size_t)bj * n + lane0;
  for (int c = pi * chunk + threadIdx.x; c < c_end; c += blockDim.x) {
    const uint32_t* word = sm + SwzNtt::at(c);
    uint32_t y[PFT_MAX_KP];
#pragma unroll
    for (int i = 0; i < PFT_MAX_KP; ++i)
      if (i < a.kp) y[i] = *cluster.map_shared_rank(word, (i << LC) + s);
    const uint32_t av = a.acc[row + c];
    uint64_t fix = 0;    // sum y_i floor(2^64 / p_i), mod 2^64
    uint32_t over = 0;   // its carries out of 2^64
    uint32_t total = 0;  // sum y_i (P/p_i), mod 2^32
#pragma unroll
    for (int i = 0; i < PFT_MAX_KP; ++i)
      if (i < a.kp) {
        const uint64_t nf = fix + (uint64_t)y[i] * a.crt.afix[i];
        over += nf < fix;
        fix = nf;
        total += y[i] * a.crt.pmod[i];
      }
    const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
    a.out[row + c] = av + (total - alpha * a.crt.pmt);
  }
  cluster.sync();  // keep every slice alive until its peers' reads are done
}

const void* const H_KERNELS[2] = {(const void*)cmux_stage2_kernel<0>,
                                  (const void*)cmux_stage2_kernel<1>};

// Clusters of kernel H the card holds at once, by (kp, log_n), on each
// device: set at the first launch of the shape (-1 before); a shape the
// card cannot hold (0) is refused.
int held_clusters(int kp, int log_n, int lc, int threads, size_t smem, int* held) {
  static int cached[64][PFT_MAX_KP + 1][H_MAX_LOG_N + 1];
  static bool init[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!init[dev]) {
    for (const void* k : H_KERNELS) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(sizeof(uint32_t) << H_SLICE_MAX_LOG));
      if (e != cudaSuccess) return (int)e;
    }
    for (auto& per_kp : cached[dev])
      for (int& v : per_kp) v = -1;
    init[dev] = true;
  }
  int& v = cached[dev][kp][log_n];
  if (v < 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kp << lc);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kp << lc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    e = cudaOccupancyMaxActiveClusters(&count, H_KERNELS[lc], &cfg);
    if (e != cudaSuccess) return (int)e;
    v = count;
  }
  *held = v;
  return 0;
}

}  // namespace

extern "C" {

// Kernel H on bsz ciphertexts.  plan: the host pack of
// ops/cmux_fused.stage2_pack (kp, k1, L, log_n, the inverse table and its
// quotients' device addresses, then NttTables32.prime_pack and
// conv.crt_pack).  kp 1-4, any k1, L 1-32, log_n 4-16; out may be acc.
int pft_cmux_stage2(const void* f, const void* key, const void* acc, void* out, int bsz,
                    const void* plan, void* stream) {
  const uint64_t* h = (const uint64_t*)plan;
  Stage2Args a{};
  a.kp = (int)h[0];
  a.k1 = (int)h[1];
  a.level = (int)h[2];
  a.log_n = (int)h[3];
  if (a.kp < 1 || a.kp > PFT_MAX_KP || a.k1 < 1 || a.level < 1 || a.level > H_MAX_LEVEL ||
      a.log_n < H_MIN_LOG_N || a.log_n > H_MAX_LOG_N || bsz < 1 ||
      (long long)bsz * a.k1 * a.kp * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.inv_roots = (const uint32_t*)h[4];
  a.inv_roots_p = (const uint32_t*)h[5];
  a.ps = unpack_primes(h + 6, a.kp);
  a.crt = unpack_crt(h + 6 + 7 * a.kp, a.kp);
  a.f = (const uint32_t*)f;
  a.key = (const uint32_t*)key;
  a.acc = (const uint32_t*)acc;
  a.out = (uint32_t*)out;
  a.bsz = bsz;
  const int lc = a.log_n > H_SLICE_MAX_LOG ? a.log_n - H_SLICE_MAX_LOG : 0;
  const int l = a.log_n - lc;
  const int threads = h_threads(l);
  const size_t smem = sizeof(uint32_t) << l;
  int held = 0;
  int err = held_clusters(a.kp, a.log_n, lc, threads, smem, &held);
  if (err != 0) return err;
  if (held < 1) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)bsz * a.k1 * a.kp) << lc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.kp << lc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, H_KERNELS[lc], args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel H's launch on the current device for (kp, log_n): out[0..3] = the
// blocks a row (C), threads a block, shared bytes a block, clusters the
// card holds at once.
int pft_cmux_stage2_grid(int kp, int log_n, int* out) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < H_MIN_LOG_N || log_n > H_MAX_LOG_N)
    return (int)cudaErrorInvalidValue;
  const int lc = log_n > H_SLICE_MAX_LOG ? log_n - H_SLICE_MAX_LOG : 0;
  const int l = log_n - lc;
  int held = 0;
  const int err = held_clusters(kp, log_n, lc, h_threads(l), sizeof(uint32_t) << l, &held);
  if (err != 0) return err;
  out[0] = 1 << lc;
  out[1] = h_threads(l);
  out[2] = (int)(sizeof(uint32_t) << l);
  out[3] = held;
  return 0;
}

}  // extern "C"
