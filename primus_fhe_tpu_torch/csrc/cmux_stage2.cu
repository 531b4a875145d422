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
// What bounds it: the bytes of f and the key slice (4 kp k1 L n each a
// ciphertext and a key row) at a large batch; at batch 1 the latency of
// one row's chain (MAC, inverse passes, CRT), which a row over many SMs
// shortens.  Design (redesigned for the card; times in PERF.md):
// - one cluster of kp C blocks for each (ciphertext b, output component j):
//   block (prime i, slice s), cluster rank i C + s, each holding a slice of
//   2^l = n / C words in shared memory (csrc/ntt_split.cuh).  The host picks
//   C = 1-16 (pick_slices, kp C <= 16) from the clusters the card holds:
//   the least work a block-wave, so a small batch spreads a row over up to
//   16 SMs (C = 8 at log_n 15, kp 2: 32 blocks at batch 1) and slices stay
//   at 2^11 words or more and at most 2^15 (128 KB: C >= 4 at log_n 17); blocks of up to 512 threads, two an SM (one at
//   C = 16, whose cross stages need the registers);
// - while the MAC runs, a slice of up to 2^13 words copies its inverse
//   twiddles and quotients (the row table's words SliceInvTable reads) and
//   acc's words of its CRT chunk into shared memory by cp.async, so the
//   passes and the CRT read neither from device memory;
// - the MAC (slice_mac): each coefficient sums its k1 L products mod its
//   prime, a thread a group of 4 coefficients with one 16-byte load of
//   digits and one of key a product, 4 products' loads in flight at once;
//   each digit brought into [0, p) first, the sum Barrett-reduced after
//   every 16 products, so any L sums exactly; canonical into shared memory
//   (SwzNtt);
// - the inverse NTT of the row: the slice's stages on kernel 2's radix-8
//   passes (slice_inverse; at C = 1 the row's own passes), the last lc
//   stages across the C slices over distributed shared memory
//   (cross_inverse, their few twiddles from device memory); each canonical
//   output times (P/p_i)^-1 mod p_i (the fused kernel's CRT constants,
//   conv.crt_pack) stays in its slice;
// - a cluster barrier; block (i, s) then takes 1/kp of slice s's
//   coefficients, reads their kp residues from the kp blocks of slice s over
//   distributed shared memory, runs the fused kernel's exact integer CRT
//   and adds into acc; a cluster barrier keeps every slice alive until its
//   peers' reads are done.
// Cluster (b, j) reads and writes only row acc[b, j], each coefficient by
// one thread, so out may be acc.  The output is the exact CRT of canonical
// residues: bit-equal to cmux_stage2_plain
// (tests/test_torch_cmux_stage2_model.py models the index maps, every C and
// the reduction schedule).  Past H_MAX_LOG_N the row no longer fits a
// cluster, and H is two launches around the four-step (below, and
// tests/test_torch_four_step_model.py).

#include "ntt_columns.cuh"

namespace {

constexpr int H_MAX_LEVEL = 32;
constexpr int H_MIN_LOG_N = 4, H_MAX_LOG_N = 17;
constexpr int H_SLICE_MAX_LOG = 15;  // a block's slice: at most 128 KB
constexpr int H_SLICE_MIN_LOG = 11;  // split a row only into slices of 2^11 words or more
constexpr int H_MAX_LC = 4;          // C <= 16

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

// Shared words of a block of kernel H on a slice of 2^l words over kp
// primes: the slice; where it stages (l <= STAGE_MAX_LOG) also the slice's
// inverse twiddles and quotients (2^l each) and acc's words of its CRT
// chunk (ceil(2^l / kp)).
inline size_t h_smem(int l, int kp) {
  const size_t nl = (size_t)1 << l;
  return sizeof(uint32_t) * (l <= STAGE_MAX_LOG ? 3 * nl + (nl + kp - 1) / kp : nl);
}

template <int LC, bool STAGE>
__global__ void __launch_bounds__(SLICE_THREADS, LC < 4 ? 2 : 1)
    cmux_stage2_kernel(const Stage2Args a) {
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
  const size_t row = (size_t)bj * n + lane0;  // this slice of acc[b, j]
  const int chunk = (nl + a.kp - 1) / a.kp;  // the CRT's coefficients a block
  const int c0 = pi * chunk, c_end = min(nl, c0 + chunk);
  const uint32_t* w = a.inv_roots + ((size_t)pi << log_n);
  const uint32_t* wp = a.inv_roots_p + ((size_t)pi << log_n);
  uint32_t* const tws = sm + nl;  // STAGE: the slice's inverse twiddles,
  uint32_t* const twps = tws + nl;  // their quotients,
  uint32_t* const accs = twps + nl;  // acc's words c0 .. c_end - 1
  if constexpr (STAGE) {  // in flight during the MAC
    stage_slice_table(SliceInvTable{w, wp, l, log_n, s}, tws, twps);
    for (int c = c0 + (int)threadIdx.x; c < c_end; c += blockDim.x)
      cp_async4(accs + c - c0, a.acc + row + c);
    cp_async_commit();
  }

  // 1. the MAC of the slice's coefficients: row t = r L + lv of the digits
  //    f[pi, b k1 + r, lv] times the key's row t k1 + j, key[pi, r, lv, j]
  slice_mac(a.f + (((size_t)pi * a.bsz * k1 + (size_t)b * k1) * L << log_n) + lane0, n,
            a.key + (((size_t)pi * k1 * L * k1 + j) << log_n) + lane0, (size_t)k1 << log_n,
            k1 * L, l, pc, sm);
  if constexpr (STAGE) cp_async_wait<0>();
  __syncthreads();

  // 2. the inverse NTT; each canonical output y times (P/p_i)^-1 mod p_i,
  //    canonical, back into its slot
  const uint32_t iw = a.crt.iw[pi], ipq = a.crt.ipq[pi];
  const SmemRows<SwzNtt> rows{sm, l};
  const auto inverse = [&](const auto& tw) {
    if constexpr (LC == 0) {
      const int r = remainder_stages(l);
      if (r == 3) inv_pass<3, Last::no>(1, l, 0, tw, pc, rows, rows);
      if (r == 2) inv_pass<2, Last::no>(1, l, 0, tw, pc, rows, rows);
      if (r == 1) inv_pass<1, Last::no>(1, l, 0, tw, pc, rows, rows);
      __syncthreads();
      inv_rest<Last::canonical>(rows, 1, l, r, tw, pc, slot_store([&](int, int c, uint32_t v) {
                                  sm[SwzNtt::at(c)] =
                                      reduce_once(shoup_mul_lazy(v, iw, ipq, q), q);
                                }));
    } else {
      slice_inverse(tw, pc, rows, rows, l);
      cross_inverse<LC, Last::canonical>(
          sm, l, log_n, s, pi << LC, w, wp, pc, [&](int c, const uint32_t (&v)[C]) {
#pragma unroll
            for (int k = 0; k < C; ++k)
              *cluster.map_shared_rank(sm + SwzNtt::at(c), (pi << LC) + k) =
                  reduce_once(shoup_mul_lazy(v[k], iw, ipq, q), q);
          });
    }
  };
  if constexpr (STAGE)
    inverse(InvTable<uint32_t>{tws, twps});
  else if constexpr (LC == 0)
    inverse(InvTable<uint32_t>{w, wp});
  else
    inverse(SliceInvTable{w, wp, l, log_n, s});
  cluster.sync();

  // 3. block (pi, s) takes coefficients [c0, c_end) of slice s: the kp
  //    residues from the blocks (i, s), the integer CRT, the wrapping add
  //    to acc
  for (int c = c0 + threadIdx.x; c < c_end; c += blockDim.x) {
    const uint32_t* word = sm + SwzNtt::at(c);
    uint32_t y[PFT_MAX_KP];
#pragma unroll
    for (int i = 0; i < PFT_MAX_KP; ++i)
      if (i < a.kp) y[i] = *cluster.map_shared_rank(word, (i << LC) + s);
    const uint32_t av = STAGE ? accs[c - c0] : a.acc[row + c];
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

// [lc][stage]
const void* const H_KERNELS[H_MAX_LC + 1][2] = {
    {(const void*)cmux_stage2_kernel<0, false>, (const void*)cmux_stage2_kernel<0, true>},
    {(const void*)cmux_stage2_kernel<1, false>, (const void*)cmux_stage2_kernel<1, true>},
    {(const void*)cmux_stage2_kernel<2, false>, (const void*)cmux_stage2_kernel<2, true>},
    {(const void*)cmux_stage2_kernel<3, false>, (const void*)cmux_stage2_kernel<3, true>},
    {(const void*)cmux_stage2_kernel<4, false>, (const void*)cmux_stage2_kernel<4, true>}};

// Clusters of kernel H the card holds at once, by (kp, log_n, lc), on each
// device: asked at the first pick of the shape (-1 before); 0 where the
// launch does not fit.
int held_clusters(int kp, int log_n, int lc, int* held) {
  static int cached[64][PFT_MAX_KP + 1][H_MAX_LOG_N + 1][H_MAX_LC + 1];
  static bool init[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!init[dev]) {
    for (const auto& per_lc : H_KERNELS)
      for (const void* k : per_lc) {
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(sizeof(uint32_t) << H_SLICE_MAX_LOG));
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
      }
    for (auto& per_kp : cached[dev])
      for (auto& per_n : per_kp)
        for (int& v : per_n) v = -1;
    init[dev] = true;
  }
  int& v = cached[dev][kp][log_n][lc];
  if (v < 0) {
    const int l = log_n - lc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kp << lc);
    cfg.blockDim = dim3(slice_threads(l));
    cfg.dynamicSmemBytes = h_smem(l, kp);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kp << lc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    e = cudaOccupancyMaxActiveClusters(&count, H_KERNELS[lc][l <= STAGE_MAX_LOG], &cfg);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // a size the card refuses: holds none
      count = 0;
    }
    v = count;
  }
  *held = v;
  return 0;
}

// Past H_MAX_LOG_N kernel H is split around the four-step
// (csrc/ntt_columns.cuh): mac_sub (csrc/ntt_columns.cu) runs H's MAC and
// the inverse's stages within each sub-row of 2^13 words, a block a sub-row
// of a (prime, ciphertext, component), and writes each prime's lazy words
// to device memory; this column launch then reads the same tile of columns
// of all kp primes of a row acc[b, j], runs each prime's last log_n - 13
// stages (inv_n folded in, canonical) times (P/p_i)^-1 mod p_i into its own
// tile, and runs H's integer CRT and the wrapping add to acc on every word
// of the tile: kp tiles of shared memory, each word of acc read and written
// by one thread, so out may be acc.
struct ColsArgs {
  const uint32_t* part;  // (kp, bsz k1, n), lazy in [0, 2p)
  const uint32_t* acc;   // (bsz k1, n); may alias out
  uint32_t* out;
  const uint32_t* inv_roots;  // (kp, n) each
  const uint32_t* inv_roots_p;
  PrimeSet ps;
  CrtConsts crt;
  int kp, rows, log_n, log_tj;  // rows: bsz k1
};

// The last pass's words of a prime, times (P/p_i)^-1 mod p_i, canonical,
// into its column tile.
struct CrtScaleStore {
  ColRows<uint32_t> t;
  uint32_t iw, ipq, q;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
    uint32_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = reduce_once(shoup_mul_lazy(v[k], iw, ipq, q), q);
    t.store(row, base, ls, w);
  }
};

__global__ void __launch_bounds__(COL_THREADS) cmux_stage2_cols_kernel(const ColsArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = MAC_SUB_LOG;
  const int log_n = a.log_n, c = log_n - l, pitch = (1 << c) + 1;
  const int tiles = 1 << (l - a.log_tj);
  const int bj = (int)(blockIdx.x / tiles), j0 = (int)(blockIdx.x % tiles) << a.log_tj;
  const size_t tile_words = (size_t)pitch << a.log_tj;
  for (int pi = 0; pi < a.kp; ++pi) {
    const ColRows<uint32_t> t{sm + pi * tile_words, pitch};
    col_load(t, a.log_tj, c, a.part + (((size_t)pi * a.rows + bj) << log_n), l, j0,
             [](uint32_t v) { return v; });
    __syncthreads();
    const PrimeConsts pc = a.ps.p[pi];
    col_inverse<Last::canonical>(t, a.log_tj, c, log_n, a.inv_roots + ((size_t)pi << log_n),
                                 a.inv_roots_p + ((size_t)pi << log_n), pc,
                                 CrtScaleStore{t, a.crt.iw[pi], a.crt.ipq[pi], pc.q});
    __syncthreads();
  }
  const size_t row = (size_t)bj << log_n;
  for (int i = threadIdx.x; i < (1 << (a.log_tj + c)); i += blockDim.x) {
    const int k = i >> a.log_tj, jj = i & ((1 << a.log_tj) - 1);
    const size_t at = row + ((size_t)k << l) + j0 + jj;
    uint64_t fix = 0;    // sum y_i floor(2^64 / p_i), mod 2^64
    uint32_t over = 0;   // its carries out of 2^64
    uint32_t total = 0;  // sum y_i (P/p_i), mod 2^32
#pragma unroll
    for (int pi = 0; pi < PFT_MAX_KP; ++pi)
      if (pi < a.kp) {
        const uint32_t y = sm[pi * tile_words + jj * pitch + k];
        const uint64_t nf = fix + (uint64_t)y * a.crt.afix[pi];
        over += nf < fix;
        fix = nf;
        total += y * a.crt.pmod[pi];
      }
    const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
    a.out[at] = a.acc[at] + (total - alpha * a.crt.pmt);
  }
}

// Kernel H's slices a row for bsz ciphertexts of k1 components over kp
// primes at log_n: pick_slices over the clusters the card holds.
int h_pick(int kp, int k1, int bsz, int log_n, int* lc, int* held) {
  return pick_slices(
      (long long)bsz * k1, kp, log_n, H_SLICE_MIN_LOG, H_SLICE_MAX_LOG,
      [&](int c, int* count) { return held_clusters(kp, log_n, c, count); }, lc, held);
}

}  // namespace

extern "C" {

// Kernel H on bsz ciphertexts.  plan: the host pack of
// ops/cmux_fused.stage2_pack (kp, k1, L, log_n, the inverse table and its
// quotients' device addresses, then NttTables32.prime_pack and
// conv.crt_pack).  kp 1-4, any k1, L 1-32, log_n 4-17; f and key on 16
// bytes; out may be acc.
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
      (long long)bsz * a.k1 * a.kp * 16 > 0x7fffffffLL ||
      (((uintptr_t)f | (uintptr_t)key) & 15) != 0)
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
  int lc = 0, held = 0;
  const int err = h_pick(a.kp, a.k1, bsz, a.log_n, &lc, &held);
  if (err != 0) return err;
  const int l = a.log_n - lc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)bsz * a.k1 * a.kp) << lc);
  cfg.blockDim = dim3(slice_threads(l));
  cfg.dynamicSmemBytes = h_smem(l, a.kp);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.kp << lc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, H_KERNELS[lc][l <= STAGE_MAX_LOG], args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel H's column launch past H_MAX_LOG_N (log_n 18-26), after mac_sub
// (pft_mac_sub) wrote the (kp, bsz k1, n) lazy words `part`: acc + the CRT
// of the inverse NTT of each prime's row, into out (may be acc).  plan:
// pft_cmux_stage2's pack.
int pft_cmux_stage2_cols(const void* part, const void* acc, void* out, int bsz, const void* plan,
                         void* stream) {
  const uint64_t* h = (const uint64_t*)plan;
  ColsArgs a{};
  a.kp = (int)h[0];
  const int k1 = (int)h[1];
  a.log_n = (int)h[3];
  if (a.kp < 1 || a.kp > PFT_MAX_KP || k1 < 1 || bsz < 1 || a.log_n <= H_MAX_LOG_N ||
      a.log_n > FOUR_STEP_MAX_LOG_N || (long long)bsz * k1 > (1 << 24))
    return (int)cudaErrorInvalidValue;
  a.rows = bsz * k1;
  a.inv_roots = (const uint32_t*)h[4];
  a.inv_roots_p = (const uint32_t*)h[5];
  a.ps = unpack_primes(h + 6, a.kp);
  a.crt = unpack_crt(h + 6 + 7 * a.kp, a.kp);
  a.part = (const uint32_t*)part;
  a.acc = (const uint32_t*)acc;
  a.out = (uint32_t*)out;
  const int c = a.log_n - MAC_SUB_LOG;
  a.log_tj = col_log_tile(c, MAC_SUB_LOG) - (a.kp > 2 ? 2 : a.kp > 1 ? 1 : 0);
  if (a.log_tj < 0) a.log_tj = 0;
  const size_t smem = sizeof(uint32_t) * (size_t)a.kp * (((size_t)1 << c) + 1) << a.log_tj;
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && !raised[dev]) {
    e = cudaFuncSetAttribute((const void*)cmux_stage2_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    raised[dev] = e == cudaSuccess;
  }
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)a.rows << (MAC_SUB_LOG - a.log_tj);
  cmux_stage2_cols_kernel<<<(unsigned)blocks, COL_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel H's launch on the current device for bsz ciphertexts of k1
// components over kp primes at log_n: out[0..3] = the blocks a row (C),
// threads a block, shared bytes a block, clusters the card holds at once.
int pft_cmux_stage2_grid(int kp, int k1, int bsz, int log_n, int* out) {
  if (kp < 1 || kp > PFT_MAX_KP || k1 < 1 || bsz < 1 || log_n < H_MIN_LOG_N ||
      log_n > H_MAX_LOG_N)
    return (int)cudaErrorInvalidValue;
  int lc = 0, held = 0;
  const int err = h_pick(kp, k1, bsz, log_n, &lc, &held);
  if (err != 0) return err;
  out[0] = 1 << lc;
  out[1] = slice_threads(log_n - lc);
  out[2] = (int)h_smem(log_n - lc, kp);
  out[3] = held;
  return 0;
}

}  // extern "C"
