// The u64 byte-radix kernels mxu8_forward64 and mxu8_inverse64 (7 and 8
// byte planes) and kernel D: the inverse with a fused key multiply.  Kernel
// E, the fused round trip, runs on row 10's butterfly passes
// (csrc/ntt64.cu); kernel C, the u32 tier's forward, on kernel 1's
// (csrc/ntt32.cu).

#include <cooperative_groups.h>

#include "mxu8_64.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// mxu8_forward64 / mxu8_inverse64: the 7- and 8-plane tiers (q < 2^62)
//
// Replace the q >= 2^30 tiers of mxu8_fused_forward64 / mxu8_fused_inverse64
// (primus_fhe_tpu/ops/ntt_mxu8.py:917,959; bodies _make_fwd_kernel8 and
// _make_inv_kernel8).  Table-driven: q, the plane matrices and the twiddle
// tables are run-time arguments, P (output planes) a template parameter.
//
// Operands are the 8 unsigned bytes of each u64 word (mma u8 x s8), so any
// u64 input is taken whole and no XOR-0x80 bias table exists; the matrices
// hold P balanced base-256 digits of M * 2^(8l) mod q for l = 0..7.  Each
// plane sum is exact in int32 (|d_c| < 1024 * 255 * 128 < 2^25), but
// sum_c d_c 2^(8c) spans ~2^81, so fold_planes (mxu8_64.cuh) splits it at 2^32:
//   L = sum_{c<4} d_c 2^(8c), H = sum_{c>=4} d_c 2^(8(c-4))   (|L|, |H| < 2^49.1)
//   y = (L + off) + Shoup(H + off, 2^32 mod q)   (off: a multiple of q >= 2^50)
// a u64 word congruent to the value (y < 2^51 + 3q < 2^64).  The TPU kernels'
// Solinas and u32-pair folds are not needed: one path serves every q.
//
// Forward (its own kernel below): pass 1, words transposed to [(row,
// k0)][k1] x w1 -> X[row][r0][k0], times tw[r0][k0] (Shoup, [0, 2q)) ->
// [(row, r0)][k0]; pass 2, x w2 -> canonical NTT values, bit-reversed, in
// the natural (A, 128) view.
// Inverse (its own kernel below, the forward mirrored): pass 1 on the
// natural rows [(row, r0)][r1] x wi1, times twi[r0][k0] -> [(row, k0)][r0];
// pass 2 x wi2 (inv_n folded in) -> canonical values in normal order.
//
// Kernel D, mxu8_inverse64_mul (mxu8_fused_inverse64_mul, ntt_mxu8.py:968;
// body _make_inv_kernel8 with mul=True): the inverse kernel with a lazy
// Shoup multiply by the fixed operand's word at the same flat index as each
// input word is loaded; the product (< 2q) is a u64 word like any other for
// the unsigned-byte feed.
//
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// mxu8_forward64 on Hopper (replaces the q >= 2^30 tiers of
// mxu8_fused_forward64, primus_fhe_tpu/ops/ntt_mxu8.py:917, body
// _make_fwd_kernel8 :548, through ops/mxu_common._natural_call :302).
//
// What bounds it: pass 2 is 29.4M of a row's 36.7M int8 MACs (n = 4096, P =
// 7), against a plane matrix w2 of P x 128 x 1024 bytes (917 KB a modulus)
// and 64 KB in and out a row.  Read by every row from L2, w2 is 235 MB a
// launch at 256 rows, which set the one-row-a-block design's pace.  So a
// block here takes a tile of R rows (R A <= 128 operand rows) and a slice of
// S of pass 2's 128 output columns, and every w2 byte that reaches its SM
// serves the tile's R A operand rows: (modulus, tile, slice) blocks, one
// block an SM, the S slices of a tile one thread-block cluster, R and S
// picked from the rows, the SM count and the card's cluster occupancy
// (fwd_pick).  Past that (clock64 stamps, cmux_mxu_timing.py --ntt
// --phases): both passes' epilogues, whose 64-bit folds take about as many
// cycles as the products, and the w2 stream into an SM (~13 bytes a cycle)
// under pass 2.
//
// Threads: eight consumer warps (two warpgroups) and one producer warp.
// The producer's lane 0 streams, in the consumers' order, pass 1's w1 and
// the slice's w2 as wgmma N-side stages (k-steps of 16 P rows, plane-major
// groups of 8 rows, 512 P bytes each; mxu8_64.cuh), one cp.async.bulk a
// stage, through a ring of 16 KB slots with full/empty mbarriers; the host
// keeps both tables in that order (kernel_tables()["w1s"], ["w2s"]).  Both
// passes are m64n(16 P)k32 wgmma (u8 operand rows x s8 plane rows, both in
// shared memory), their N rows ordered so that each thread holds every
// plane of its outputs and folds them without an exchange.
//
// Pass 1 (w1 stays in the ring until the block's last chunk): chunks of 64
// (row, k0) operand rows (a row's k0 half, the halves outer so that a
// thread loads its twiddles once a half), chunk ch taken by the cluster's
// block ch % C; M = the chunk's rows, warpgroup wg's N = the planes of r0 in
// [16 wg, 16 wg + 16).  The block's next chunk is copied into the chunk
// buffer by cp.async while the warps fold, twiddle and store this one's
// outputs into the operand rows (row, r0) of every block of the cluster
// (distributed shared memory), then one cluster barrier.  Pass 2:
// warpgroup wg takes the 64 operand rows of M tile wg (a tile of 64 or
// fewer rows: both take its one M tile and split each stage's k-steps, then
// swap partial sums) and accumulates a column group of 16 outputs r1 over
// its 8 stages, then folds and stores canonical words at out[row0 * n + m *
// 128 + r1]; rows past a partial tile are stored nowhere.
//
// Shared memory: the ring (5-8 slots), the pass-2 operand (round_up(R A,
// 64) rows of 1024 bytes, core matrices), the pass-1 chunk (64 rows of kb1
// bytes, core matrices), for one M tile the swapped partial sums, the
// barriers: R = 4 at n = 4096 takes 5 slots, 229,456 bytes.
// ---------------------------------------------------------------------------

constexpr int FWD_CONSUMERS = 256;
constexpr int FWD_THREADS = FWD_CONSUMERS + 32;
constexpr int FWD_SLOT = 16384;
constexpr int FWD_MAX_SLOTS = 8;
constexpr int FWD_SMEM_MAX = 232448;
constexpr int FWD_GROUPS = 8;                 // column groups of 16 outputs r1
constexpr int FWD_KCHUNKS = 8;                // stages a column group (128 bytes of k each)
constexpr int FWD_OPERAND_ROWS = 128;         // pass-2 operand rows a tile holds at most
constexpr int FWD_LOADS = 8;                  // input words a thread copies for a chunk

struct FwdGeometry {
  int n, A, C, np1, kb1, nw1, rows2, slots, stages, groups;
  int g1, kbc, k1c;        // pass 1: r0 groups of 16 (warpgroups at work), k-chunk bytes, k-chunks
  int mtiles;              // pass 2's 64-row M tiles: 2, or 1 split over k by the warpgroups
  int w1_bytes, w2_bytes;  // one stage of each
  size_t sr_off, sc_off, red_off, bar_off, smem;
};

// The cluster width of an (R, S) grid: the S slices of a tile share pass 1
// in clusters of C blocks, no more than the tile's 2 R chunks.
__host__ __device__ inline int fwd_cluster(int R, int S) { return S < 2 * R ? S : 2 * R; }

__host__ __device__ inline FwdGeometry fwd_geometry(int log_n, int P, int R, int S) {
  FwdGeometry g;
  g.n = 1 << log_n;
  g.A = g.n / PFT_MXU_B;
  g.np1 = round_up(g.A, 8);
  g.kb1 = round_up(8 * g.A, 32);
  g.g1 = (g.np1 + 15) / 16;
  g.kbc = g.kb1 < 128 ? g.kb1 : 128;
  g.k1c = g.kb1 / g.kbc;
  g.nw1 = g.g1 * g.k1c;
  g.C = fwd_cluster(R, S);
  g.rows2 = round_up(R * g.A, 64);
  g.mtiles = g.rows2 / 64;
  g.groups = FWD_GROUPS / S;
  g.stages = g.nw1 + g.groups * FWD_KCHUNKS;
  g.w1_bytes = 512 * P * (g.kbc / 32);
  g.w2_bytes = P * 16 * 128;
  // one M tile: each warpgroup's partial sums of the other's outputs, 4 P
  // int32 a thread
  const size_t red = g.mtiles == 1 ? (size_t)FWD_CONSUMERS * 4 * P * 4 : 0;
  const size_t fixed = (size_t)g.rows2 * 1024 + (size_t)64 * g.kb1 + red;
  g.slots = FWD_MAX_SLOTS;
  while (g.slots > g.nw1 && (size_t)g.slots * (FWD_SLOT + 16) + fixed > FWD_SMEM_MAX) --g.slots;
  g.sr_off = (size_t)g.slots * FWD_SLOT;
  g.sc_off = g.sr_off + (size_t)g.rows2 * 1024;
  g.red_off = g.sc_off + (size_t)64 * g.kb1;
  g.bar_off = g.red_off + red;
  g.smem = g.bar_off + (size_t)16 * g.slots;
  return g;
}

// The grid of count moduli x rows: the largest tile (R A <= 128) with the
// slices doubled while all of the grid's clusters run at once (fits[k]:
// clusters of 2^k blocks the card holds), unless that leaves more than
// three quarters of the SMs idle; then the tile halves (a full tile's two
// 64-row wgmma M tiles do more for each SM than a smaller tile on more
// SMs).  R and S are powers of two, so C = min(S, 2R) divides S and no
// cluster straddles two tiles.
inline void fwd_pick(int count, int rows, int log_n, int sms, const int* fits, int* R, int* S) {
  int r = FWD_OPERAND_ROWS >> (log_n - 7);
  for (;;) {
    const int tiles = count * ((rows + r - 1) / r);
    int s = 1;
    while (s < FWD_GROUPS) {
      const int c = fwd_cluster(r, 2 * s);
      if (tiles * (2 * s / c) > fits[31 - __builtin_clz(c)]) break;
      s *= 2;
    }
    if (tiles * s * 4 > sms || r == 1) {
      *R = r;
      *S = s;
      return;
    }
    r /= 2;
  }
}

// Starts the copy of a chunk's words (one row's k0 half: word e = (k1 = e /
// 64, k0 = e % 64) of `src`) into the chunk buffer `sc`, pass 1's wgmma
// operand: row k0 of kb bytes, K-major core matrices (word k1 of row k0 at
// ((k0 / 8) (kb / 16) + k1 / 2) 128 + (k0 % 8) 16 + (k1 % 2) 8), one 8-byte
// cp.async a word, no registers held.
__device__ __forceinline__ void copy_chunk(uint8_t* sc, int kb, const uint64_t* src, int words) {
#pragma unroll
  for (int u = 0; u < FWD_LOADS; ++u) {
    const int e = threadIdx.x + u * FWD_CONSUMERS;
    if (e < words) {
      const int w = e >> 6, k0 = e & 63;
      const uint32_t dst = smem_addr(sc + ((k0 >> 3) * (kb >> 4) + (w >> 1)) * 128 +
                                     (k0 & 7) * 16 + (w & 1) * 8);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                   "l"(src + (size_t)w * PFT_MXU_B + k0)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int P>
__global__ void __launch_bounds__(FWD_THREADS, 1) ntt_mxu8_forward64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ w1s,
    const int8_t* __restrict__ w2s, const uint64_t* __restrict__ tw, ModSet64 ms, int rows,
    int log_n, int R, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  const FwdGeometry geo = fwd_geometry(log_n, P, R, S);
  const int n = geo.n, A = geo.A;
  const int tiles = (rows + R - 1) / R;
  const int sl = (int)blockIdx.x % S, tile = ((int)blockIdx.x / S) % tiles, rank = sl % geo.C;
  const int mi = (int)blockIdx.x / (S * tiles);
  const int row0 = tile * R, g_rows = rows - row0 < R ? rows - row0 : R;
  const Mod64 mc = ms.m[mi];
  uint8_t* sr = smem + geo.sr_off;  // pass-2 operand rows (row, r0)
  uint8_t* sc = smem + geo.sc_off;  // a pass-1 chunk: rows (row, k0)
  const uint32_t full = smem_addr(smem + geo.bar_off), empty = full + 8 * geo.slots;
  const size_t base = ((size_t)mi * rows + row0) * n;

  if (threadIdx.x == 0) {
    for (int i = 0; i < geo.slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, FWD_CONSUMERS / 32);
    }
    fence_mbarrier_init();
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block of the cluster runs: peers may store into its operand rows

  if (threadIdx.x >= FWD_CONSUMERS) {  // the producer warp
    // it arrives at the consumers' cluster barrier after pass 1 at once:
    // its lane 0 waits on ring slots that only that barrier frees
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    if (threadIdx.x == FWD_CONSUMERS) {
      const int8_t* w1m = w1s + (size_t)mi * geo.nw1 * geo.w1_bytes;
      const int8_t* w2m = w2s + ((size_t)mi * FWD_GROUPS * FWD_KCHUNKS +
                                 (size_t)sl * geo.groups * FWD_KCHUNKS) * geo.w2_bytes;
      for (int i = 0; i < geo.stages; ++i) {
        const int slot = i % geo.slots;
        mbar_wait(empty + 8 * slot, ((uint32_t)(i / geo.slots) & 1u) ^ 1u);
        const bool first = i < geo.nw1;
        const uint32_t bytes = first ? geo.w1_bytes : geo.w2_bytes;
        const int8_t* src = first ? w1m + (size_t)i * geo.w1_bytes
                                  : w2m + (size_t)(i - geo.nw1) * geo.w2_bytes;
        mbar_expect_tx(full + 8 * slot, bytes);
        bulk_copy(smem_addr(smem + (size_t)slot * FWD_SLOT), src, bytes, full + 8 * slot, 0);
      }
    }
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto stage = [&](int i) { return (const int8_t*)(smem + (size_t)(i % geo.slots) * FWD_SLOT); };
  auto wait_full = [&](int i) {
    mbar_wait(full + 8 * (i % geo.slots), (uint32_t)(i / geo.slots) & 1u);
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i % geo.slots));
  };

  // pass 1: chunk ch = (k0 half h = ch / g_rows, row ch % g_rows), 64 A
  // words, taken by the cluster's block ch % C and stored into the operand
  // rows of every block of the cluster.  On wgmma like pass 2: M = the
  // chunk's 64 rows k0, warpgroup wg's N = planes x r0 in [16 wg, 16 wg +
  // 16) (its w1 stages wg * k1c ..); a thread's twiddles depend on the half
  // only
  constexpr int NW = 16 * P;  // a stage's rows (c, r): n = 8 (c + P half) + r % 8
  const int wg = warp >> 2, wt = tid & 127, ww = wt >> 5;
  const uint64_t* tws = tw + (size_t)mi * 4 * n;
  const int words = 64 * A, chunks = 2 * g_rows;
  const uint32_t sc_addr = smem_addr(sc);
  if (rank < chunks) {
    const int h0 = rank / g_rows;
    copy_chunk(sc, geo.kb1, in + base + (size_t)(rank - h0 * g_rows) * n + 64 * h0, words);
  }
  if (wg < geo.g1)
    for (int kk = 0; kk < geo.k1c; ++kk) wait_full(wg * geo.k1c + kk);
  uint64_t tv[2][4], tp[2][4];  // the twiddles of this thread's outputs in half th
  int th = -1;
  for (int ch = rank; ch < chunks; ch += geo.C) {
    const int h = ch / g_rows, r = ch - h * g_rows, k0b = 64 * h;
    if (wg < geo.g1 && h != th) {
      th = h;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * ww + ((wt & 31) >> 2) + ((e >> 1) << 3);
          const int r0 = 16 * wg + 8 * hh + 2 * (wt & 3) + (e & 1);
          const int idx = (r0 < A ? r0 : A - 1) * B + k0b + m;
          tv[hh][e] = __ldg(tws + idx);
          tp[hh][e] = __ldg(tws + n + idx);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_proxy_async();
    bar_sync(1, FWD_CONSUMERS);  // chunk ch is in sc
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    if (wg < geo.g1) {
      wg_fence_regs(d);
      wgmma_fence();
      for (int kk = 0; kk < geo.k1c; ++kk) {
        const uint32_t b_stage = smem_addr(stage(wg * geo.k1c + kk));
        for (int s = 0; s < geo.kbc / 32; ++s)
          WgmmaUS<NW>::mma(d, wg_desc(sc_addr + (kk * geo.kbc / 16 + 2 * s) * 128, 128, 8 * geo.kb1),
                           wg_desc(b_stage + s * 512 * P, 128, 256));
      }
      wgmma_commit();
      wgmma_wait<0>();
      wg_fence_regs(d);
    }
    bar_sync(1, FWD_CONSUMERS);  // every warp is done with sc (and, at the last chunk, with w1)
    if (ch + geo.C >= chunks)
      for (int i = 0; i < geo.nw1; ++i) release(i);  // w2 streams during the epilogue
    if (ch + geo.C < chunks) {
      const int hn = (ch + geo.C) / g_rows, rn = ch + geo.C - hn * g_rows;
      copy_chunk(sc, geo.kb1, in + base + (size_t)rn * n + 64 * hn, words);
    }
    if (wg < geo.g1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 16 * ww + ((wt & 31) >> 2) + ((e >> 1) << 3);
          const int r0 = 16 * wg + 8 * hh + 2 * (wt & 3) + (e & 1);
          if (r0 < A) {
            int dp[P];
#pragma unroll
            for (int c = 0; c < P; ++c) dp[c] = d[4 * (c + P * hh) + e];
            const uint64_t y = shoup64_lazy(fold_planes<P>(dp, mc), tv[hh][e], tp[hh][e], mc.q);
            const uint32_t at = wg_op_offset64(r * A + r0, k0b + m);
            for (int q = 0; q < geo.C; ++q) *(uint64_t*)(cluster.map_shared_rank(sr, q) + at) = y;
          }
        }
    }
  }
  if (rank >= chunks)
    for (int i = 0; i < geo.nw1; ++i) release(i);  // a block without a chunk of this tile
  asm volatile("fence.proxy.async;\n" ::: "memory");  // the operand rows, for wgmma
  cluster.sync();  // every operand row of every block of the cluster is written
  fence_proxy_async();

  // pass 2 on wgmma: warpgroup wg multiplies M tile wg (rows 64 wg ..) by
  // each stage, or, when the tile has one M tile, both multiply it and
  // split each stage's four k-steps (wg: 2 wg, 2 wg + 1) and then each
  // other's outputs (half wg of each thread's eight)
  const int mt = geo.mtiles == 2 ? wg : 0;
  const int s_lo = geo.mtiles == 2 ? 0 : 2 * wg, s_hi = geo.mtiles == 2 ? 4 : 2 * wg + 2;
  const uint32_t a_tile = smem_addr(sr) + mt * 8 * PFT_WG_OP_GROUP64;
  const int m_real = g_rows * A;
  int* red = (int*)(smem + geo.red_off);
  int it = geo.nw1;
  for (int cgl = 0; cgl < geo.groups; ++cgl) {
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    wg_fence_regs(d);
    wgmma_fence();
#pragma unroll 1
    for (int kc = 0; kc < FWD_KCHUNKS; ++kc, ++it) {
      wait_full(it);
      const uint32_t b_stage = smem_addr(stage(it));
      for (int s = s_lo; s < s_hi; ++s)
        WgmmaUS<NW>::mma(d, wg_desc(a_tile + (kc * 8 + 2 * s) * 128, 128, PFT_WG_OP_GROUP64),
                         wg_desc(b_stage + s * 512 * P, 128, 256));
      wgmma_commit();
      if (kc > 0) {
        wgmma_wait<1>();
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    wg_fence_regs(d);
    release(it - 1);
    if (geo.mtiles == 1) {  // swap the halves' partial sums through shared memory
      int* mine = red + (size_t)wg * 4 * P * 128 + wt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (h != wg)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < P; ++c) mine[(e * P + c) * 128] = d[4 * (c + P * h) + e];
      bar_sync(1, FWD_CONSUMERS);
      const int* theirs = red + (size_t)(1 - wg) * 4 * P * 128 + wt;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (h == wg)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < P; ++c) d[4 * (c + P * h) + e] += theirs[(e * P + c) * 128];
      bar_sync(1, FWD_CONSUMERS);  // read before the next group's partials
    }
    const int r1b = 16 * (sl * geo.groups + cgl) + 2 * (wt & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (geo.mtiles == 2 || h == wg)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 64 * mt + 16 * ww + ((wt & 31) >> 2) + ((e >> 1) << 3);
          if (m < m_real) {
            int dp[P];
#pragma unroll
            for (int c = 0; c < P; ++c) dp[c] = d[4 * (c + P * h) + e];
            out[base + (size_t)m * B + r1b + 8 * h + (e & 1)] =
                canonical64(fold_planes<P>(dp, mc), mc);
          }
        }
  }
}

// The launch of a (R, S) grid: clusters of C slices of a tile.
template <int P>
int configure_forward64(int count, int rows, int log_n, int R, int S, void* stream,
                        cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const FwdGeometry geo = fwd_geometry(log_n, P, R, S);
  if (geo.smem > FWD_SMEM_MAX || geo.slots < geo.nw1 || geo.slots < 2 || S % geo.C != 0)
    return (int)cudaErrorInvalidValue;
  *cfg = {};
  cfg->gridDim = dim3(count * ((rows + R - 1) / R) * S);
  cfg->blockDim = dim3(FWD_THREADS);
  cfg->dynamicSmemBytes = geo.smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = geo.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <int P>
int launch_forward64(const void* in, void* out, const void* w1s, const void* w2s, const void* tw,
                     const ModSet64& ms, int rows, int log_n, int R, int S, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure_forward64<P>(ms.count, rows, log_n, R, S, stream, &cfg, &attr);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, ntt_mxu8_forward64_kernel<P>, (const uint64_t*)in,
                                (uint64_t*)out, (const int8_t*)w1s, (const int8_t*)w2s,
                                (const uint64_t*)tw, ms, rows, log_n, R, S);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// mxu8_inverse64 and kernel D on Hopper (replace the q >= 2^30 tiers of
// mxu8_fused_inverse64 and mxu8_fused_inverse64_mul,
// primus_fhe_tpu/ops/ntt_mxu8.py:959,968, body _make_inv_kernel8 :630,
// through ops/mxu_common._natural_call :302): the forward's design mirrored.
//
// What bounds it: the function, 16 bytes a word through device memory (D
// adds its key; 0.0100 ms at D's 512 rows of n = 4096, by bytes), is far
// below the method.  Pass 1 is the method's large pass here, the natural
// rows [(row, r0)][r1] (1024 bytes each) times wi1, P x 128 x 1024 bytes
// (917 KB a modulus at P = 7).  Read by every row from L2, as the
// one-row-a-block kernel did, that is 470 MB a launch at kernel D's 512
// rows (0.2131 ms; this kernel 0.1004, cmux_mxu_timing.py --ntt
// --compare on an H100).  So a block
// takes a tile of R rows (R A <= 128 operand rows) and a slice of S of pass
// 1's 128 output columns k0, and every wi1 byte that reaches its SM serves
// the tile's R A operand rows: (modulus, tile, slice) blocks, one block an
// SM, R and S powers of two picked from the rows, the SM count and the
// shared memory each (R, S) needs (inv_pick).  A slice's pass 2 needs only
// its own pass-1 outputs (a pass-2 operand row is one (row, k0)), so no
// output crosses blocks and there is no cluster; the S slices of a tile each
// read the tile's words from L2 (R x 32 KB at n = 4096, against the slice's
// 1/S of wi1 and all of wi2): at 64 rows, (R, S) = (4, 8) runs in 0.0204 ms
// and (4, 4) in 0.0284 (cmux_mxu_timing.py --grids), so twice the reads of
// each tile cost less than they save, and a multicast of the tile is not
// what this kernel waits on.  Past the tile (clock64 stamps,
// cmux_mxu_timing.py --ntt --phases): at D's 512 rows a block's ~106k
// cycles are the load ~20k, wi1 stage waits ~27k (two ring slots fit beside
// the tile at S = 2), pass 1's wgmma ~24k, the two epilogues ~27k.
//
// Threads: eight consumer warps (two warpgroups) and one producer warp,
// whose lane 0 streams the slice's wi1 stages (column group of 16 k0,
// k-chunk of 128 bytes: P x 2 KB, the forward's w2 layout) through a ring of
// 16 KB slots on full/empty mbarriers, then, once the consumers are done
// with the tile's words, the whole wi2 (the forward's w1 layout) into their
// place; the host keeps both in that order (kernel_tables()["wi1s"],
// ["wi2s"]).  Both passes are wgmma u8 x s8 from shared memory, N rows
// ordered so that each thread holds every plane of its outputs.
//
// Load: the tile's words, times the key by a lazy Shoup multiply for D, into
// pass 1's operand rows (row, r0) at wg_op_offset64 (16 bytes a thread a
// step, eight row-neighbours a phase: no bank conflict, whole sectors); for
// D at A >= 8 a thread takes one (r0, word pair) in every row of the tile,
// so each key word is read once a block, not once a row.  (A cp.async copy
// of the keyless tile, every copy in flight at once, was slower: 0.0232
// against 0.0207 ms at 64 rows.)
// Pass 1: for each column group, eight stages; two M tiles (R A > 64): each
// warpgroup multiplies its tile by the stage's 16 P plane rows
// (m64n(16P)k32); one M tile: both multiply it, warpgroup wg by half wg of
// the stage's rows (m64n64k32, at P = 7 one n-group of the other half
// read and dropped).  Epilogue: fold, Shoup by twi[r0][k0], stored as word
// r0 of pass 2's operand row (row, k0) (kb1 bytes, K-major core matrices).
// Pass 2: tasks (64-row M tile, 16 outputs k1) shared out over the
// warpgroups, each m64n(16P)k32 over the resident wi2 (inv_n folded in),
// canonical words stored at out[row n + k1 128 + k0]; rows past a partial
// tile are stored nowhere.
//
// Shared memory: the ring (2-8 slots), the tile's operand rows (round_up(R
// A, 64) x 1024 bytes, later wi2), pass 2's operand (round_up(R 128 / S, 64)
// rows of kb1 bytes), two barriers a slot and two more: at n = 4096, R = 4
// takes S >= 2 (S = 2: 2 slots, 229,424 bytes); R 128 / A and S = 1 never
// fit.
// ---------------------------------------------------------------------------

constexpr int INV_GROUPS = 8;   // column groups of 16 pass-1 outputs k0 (so at most 8 slices)
constexpr int INV_KCHUNKS = 8;  // wi1 stages a column group (128 bytes of k each)
constexpr int INV_LOADS = 8;    // 16-byte input loads a thread keeps in flight

struct InvGeometry {
  int n, A, np1, kb1, g1, kbc, k1c, nw2;  // pass 2: k1 groups of 16, k-chunk bytes, k-chunks, stages
  int cols, groups, stages;               // the slice's k0, its column groups, its wi1 stages
  int rows1, mtiles1, rows2, mtiles2;     // operand rows (rounded to 64) and M tiles of each pass
  int w1_bytes, w2_bytes, slots;          // one stage of wi1 and of wi2; ring slots
  size_t x_off, y_off, bar_off, smem;
};

__host__ __device__ inline InvGeometry inv_geometry(int log_n, int P, int R, int S) {
  InvGeometry g;
  g.n = 1 << log_n;
  g.A = g.n / PFT_MXU_B;
  g.np1 = round_up(g.A, 8);
  g.kb1 = round_up(8 * g.A, 32);
  g.g1 = (g.np1 + 15) / 16;
  g.kbc = g.kb1 < 128 ? g.kb1 : 128;
  g.k1c = g.kb1 / g.kbc;
  g.nw2 = g.g1 * g.k1c;
  g.cols = PFT_MXU_B / S;
  g.groups = INV_GROUPS / S;
  g.stages = g.groups * INV_KCHUNKS;
  g.rows1 = round_up(R * g.A, 64);
  g.mtiles1 = g.rows1 / 64;
  g.rows2 = round_up(R * g.cols, 64);
  g.mtiles2 = g.rows2 / 64;
  g.w1_bytes = P * 16 * 128;
  g.w2_bytes = 512 * P * (g.kbc / 32);
  const size_t x = (size_t)g.rows1 * 1024 > (size_t)g.nw2 * g.w2_bytes
                       ? (size_t)g.rows1 * 1024 : (size_t)g.nw2 * g.w2_bytes;
  const size_t fixed = x + (size_t)g.rows2 * g.kb1 + 16;  // + the xfree and w2full barriers
  g.slots = FWD_MAX_SLOTS;
  while (g.slots > 2 && (size_t)g.slots * (FWD_SLOT + 16) + fixed > FWD_SMEM_MAX) --g.slots;
  g.x_off = (size_t)g.slots * FWD_SLOT;
  g.y_off = g.x_off + x;
  g.bar_off = g.y_off + (size_t)g.rows2 * g.kb1;
  g.smem = g.bar_off + (size_t)16 * g.slots + 16;
  return g;
}

__host__ __device__ inline bool inv_fits(const InvGeometry& g, int R) {
  return R * g.A <= 128 && g.smem <= FWD_SMEM_MAX;
}

// The grid of count moduli x rows: the largest tile (R A <= 128) with the
// slices doubled while every block runs at once (one an SM) or while the
// tile's pass-2 operand does not fit (at the largest tile, S = 1 never
// does), unless that leaves more than three quarters of the SMs idle; then
// the tile halves.  Fitted at 8 planes, so one pick serves both.
inline void inv_pick(int count, int rows, int log_n, int sms, int* R, int* S) {
  int r = FWD_OPERAND_ROWS >> (log_n - 7);
  for (;;) {
    const int tiles = count * ((rows + r - 1) / r);
    int s = 1;
    while (s < INV_GROUPS &&
           (!inv_fits(inv_geometry(log_n, 8, r, s), r) || tiles * 2 * s <= sms))
      s *= 2;
    if (r == 1 || tiles * s * 4 > sms) {
      *R = r;
      *S = s;
      return;
    }
    r /= 2;
  }
}

template <int P, bool MUL>
__global__ void __launch_bounds__(FWD_THREADS, 1) ntt_mxu8_inverse64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ wi1s,
    const int8_t* __restrict__ wi2s, const uint64_t* __restrict__ tw,
    const uint64_t* __restrict__ key, ModSet64 ms, int rows, int log_n, int R, int S) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  constexpr int NW = 16 * P;  // a stage's rows (c, k): n = 8 (c + P half) + k % 8
  const InvGeometry geo = inv_geometry(log_n, P, R, S);
  const int n = geo.n, A = geo.A, cols = geo.cols;
  const int tiles = (rows + R - 1) / R;
  const int sl = (int)blockIdx.x % S, tile = ((int)blockIdx.x / S) % tiles;
  const int mi = (int)blockIdx.x / (S * tiles);
  const int row0 = tile * R, g_rows = rows - row0 < R ? rows - row0 : R;
  const Mod64 mc = ms.m[mi];
  uint8_t* sx = smem + geo.x_off;  // pass 1's operand rows (row, r0); then wi2
  uint8_t* sy = smem + geo.y_off;  // pass 2's operand rows (row, k0 of the slice)
  const uint32_t full = smem_addr(smem + geo.bar_off), empty = full + 8 * geo.slots;
  const uint32_t xfree = empty + 8 * geo.slots, w2full = xfree + 8;
  const size_t base = ((size_t)mi * rows + row0) * n;

  if (threadIdx.x == 0) {
    for (int i = 0; i < geo.slots; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, FWD_CONSUMERS / 32);
    }
    mbar_init(xfree, FWD_CONSUMERS / 32);
    mbar_init(w2full, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= FWD_CONSUMERS) {  // the producer warp
    if (threadIdx.x == FWD_CONSUMERS) {
      const int8_t* w1m = wi1s + ((size_t)mi * INV_GROUPS * INV_KCHUNKS +
                                  (size_t)sl * geo.stages) * geo.w1_bytes;
      for (int i = 0; i < geo.stages; ++i) {
        const int slot = i % geo.slots;
        mbar_wait(empty + 8 * slot, ((uint32_t)(i / geo.slots) & 1u) ^ 1u);
        mbar_expect_tx(full + 8 * slot, geo.w1_bytes);
        bulk_copy(smem_addr(smem + (size_t)slot * FWD_SLOT), w1m + (size_t)i * geo.w1_bytes,
                  geo.w1_bytes, full + 8 * slot, 0);
      }
      mbar_wait(xfree, 0);  // pass 1 has read the tile's words for the last time
      const int8_t* w2m = wi2s + (size_t)mi * geo.nw2 * geo.w2_bytes;
      mbar_expect_tx(w2full, geo.nw2 * geo.w2_bytes);
      for (int i = 0; i < geo.nw2; ++i)
        bulk_copy(smem_addr(sx + (size_t)i * geo.w2_bytes), w2m + (size_t)i * geo.w2_bytes,
                  geo.w2_bytes, w2full, 0);
    }
    return;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wt = tid & 127, ww = wt >> 5;
  auto stage = [&](int i) { return smem_addr(smem + (size_t)(i % geo.slots) * FWD_SLOT); };
  auto wait_full = [&](int i) {
    mbar_wait(full + 8 * (i % geo.slots), (uint32_t)(i / geo.slots) & 1u);
  };
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  // the tile's words (times the key for D) -> operand rows m = (row, r0);
  // unit u = (8-row group u / 512, word pair 4 ((u / 32) % 16) + (u / 8) % 4,
  // row u % 8 of the group)
  const int m_real1 = g_rows * A;
  const int units = round_up(m_real1, 8) * 64;
  const uint64_t* kt = MUL ? key + (size_t)mi * 2 * n : nullptr;
  auto unit_row = [](int u) { return ((u >> 9) << 3) + (u & 7); };
  auto unit_word = [](int u) { return 2 * ((((u >> 5) & 15) << 2) + ((u >> 3) & 3)); };
  if (MUL && A % 8 == 0) {  // D: the units of the first row, each key pair loaded once a tile
    for (int u0 = 0; u0 < A * 64; u0 += FWD_CONSUMERS * 2) {
      ulonglong2 kv[2], kp[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int u = u0 + k * FWD_CONSUMERS + tid;
        const int c = unit_row(u) * B + unit_word(u);
        if (u < A * 64) {
          kv[k] = __ldg((const ulonglong2*)(kt + c));
          kp[k] = __ldg((const ulonglong2*)(kt + n + c));
        }
      }
      for (int j0 = 0; j0 < g_rows; j0 += 4) {
        ulonglong2 v[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + k * FWD_CONSUMERS + tid;
            const int m = unit_row(u) + (j0 + j) * A, w = unit_word(u);
            if (u < A * 64 && j0 + j < g_rows)
              v[k][j] = __ldg((const ulonglong2*)(in + base + (size_t)m * B + w));
          }
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + k * FWD_CONSUMERS + tid;
            const int m = unit_row(u) + (j0 + j) * A, w = unit_word(u);
            if (u < A * 64 && j0 + j < g_rows) {
              v[k][j].x = shoup64_lazy(v[k][j].x, kv[k].x, kp[k].x, mc.q);
              v[k][j].y = shoup64_lazy(v[k][j].y, kv[k].y, kp[k].y, mc.q);
              *(ulonglong2*)(sx + wg_op_offset64(m, w)) = v[k][j];
            }
          }
      }
    }
  } else {
    for (int u0 = 0; u0 < units; u0 += FWD_CONSUMERS * INV_LOADS) {
      ulonglong2 v[INV_LOADS], kv[MUL ? INV_LOADS : 1], kp[MUL ? INV_LOADS : 1];
#pragma unroll
      for (int k = 0; k < INV_LOADS; ++k) {  // every load of the batch in flight at once
        const int u = u0 + k * FWD_CONSUMERS + tid;
        const int m = unit_row(u), w = unit_word(u);
        if (u < units && m < m_real1) {
          v[k] = __ldg((const ulonglong2*)(in + base + (size_t)m * B + w));
          if constexpr (MUL) {
            kv[k] = __ldg((const ulonglong2*)(kt + (m % A) * B + w));
            kp[k] = __ldg((const ulonglong2*)(kt + n + (m % A) * B + w));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < INV_LOADS; ++k) {
        const int u = u0 + k * FWD_CONSUMERS + tid;
        const int m = unit_row(u), w = unit_word(u);
        if (u < units && m < m_real1) {
          if constexpr (MUL) {
            v[k].x = shoup64_lazy(v[k].x, kv[k].x, kp[k].x, mc.q);
            v[k].y = shoup64_lazy(v[k].y, kv[k].y, kp[k].y, mc.q);
          }
          *(ulonglong2*)(sx + wg_op_offset64(m, w)) = v[k];
        }
      }
    }
  }
  fence_proxy_async();
  bar_sync(1, FWD_CONSUMERS);  // every operand row of pass 1 is written

  // pass 1, column group by column group; the epilogue stores word r0 of
  // pass 2's operand row m2 = (row, k0 - the slice's first)
  const uint64_t* twi = tw + (size_t)mi * 4 * n + 2 * n;
  const int k0s = sl * cols;
  const uint32_t x_addr = smem_addr(sx), y_addr = smem_addr(sy);
  auto emit1 = [&](int m, int k0, const int (&dp)[P], uint64_t t, uint64_t tp) {
    if (m < m_real1) {
      const int row = m / A, r0 = m - row * A;
      const uint64_t y = shoup64_lazy(fold_planes<P>(dp, mc), t, tp, mc.q);
      const int m2 = row * cols + k0 - k0s;
      *(uint64_t*)(sy + ((m2 >> 3) * (geo.kb1 >> 4) + (r0 >> 1)) * 128 + (m2 & 7) * 16 +
                   (r0 & 1) * 8) = y;
    }
  };
  const int mr = 16 * ww + ((wt & 31) >> 2), kq = 2 * (wt & 3);  // a thread's first row, column
  // the twiddle of output (row m, column k0): loaded before the group's
  // products, so that their latency hides under them
  auto twiddle = [&](int m, int k0, uint64_t& t, uint64_t& tp) {
    const int idx = (m % A) * B + k0;
    t = __ldg(twi + idx);
    tp = __ldg(twi + n + idx);
  };
  // a stage's slot is freed as soon as its products are done, so that the
  // ring's other slots all have copies in flight (at S = 2 there are two
  // slots): faster at every shape than issuing the next stage's products
  // first and freeing the slot one stage later
  int it = 0;
  for (int cg = 0; cg < geo.groups; ++cg) {
    const int k0g = 16 * (sl * geo.groups + cg);
    const bool last = cg + 1 == geo.groups;
    if (geo.mtiles1 == 2) {  // warpgroup wg: M tile wg, all 16 P rows of each stage
      int d[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) d[i] = 0;
      wg_fence_regs(d);
      wgmma_fence();
      const uint32_t a_tile = x_addr + wg * 8 * PFT_WG_OP_GROUP64;
      uint64_t tv[2][4], tp[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          twiddle(64 * wg + mr + ((e >> 1) << 3), k0g + 8 * h + kq + (e & 1), tv[h][e], tp[h][e]);
#pragma unroll 1
      for (int kc = 0; kc < INV_KCHUNKS; ++kc, ++it) {
        wait_full(it);
        const uint32_t b_stage = stage(it);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          WgmmaUS<NW>::mma(d, wg_desc(a_tile + (kc * 8 + 2 * s) * 128, 128, PFT_WG_OP_GROUP64),
                           wg_desc(b_stage + s * 512 * P, 128, 256));
        wgmma_commit();
        wgmma_wait<0>();
        release(empty + 8 * (it % geo.slots));
      }
      wg_fence_regs(d);
      if (last) release(xfree);  // wi2 streams into sx during the last epilogue
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int dp[P];
#pragma unroll
          for (int c = 0; c < P; ++c) dp[c] = d[4 * (c + P * h) + e];
          emit1(64 * wg + mr + ((e >> 1) << 3), k0g + 8 * h + kq + (e & 1), dp, tv[h][e],
                tp[h][e]);
        }
    } else {  // one M tile: warpgroup wg takes half wg of each stage's rows
      int d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0;
      wg_fence_regs(d);
      wgmma_fence();
      const uint32_t b_off = wg * (2 * P - 8) * 256;  // n-groups 2P - 8 .. 2P - 1 for wg 1
      uint64_t tv[4], tp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        twiddle(mr + ((e >> 1) << 3), k0g + 8 * wg + kq + (e & 1), tv[e], tp[e]);
#pragma unroll 1
      for (int kc = 0; kc < INV_KCHUNKS; ++kc, ++it) {
        wait_full(it);
        const uint32_t b_stage = stage(it) + b_off;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          WgmmaUS<64>::mma(d, wg_desc(x_addr + (kc * 8 + 2 * s) * 128, 128, PFT_WG_OP_GROUP64),
                           wg_desc(b_stage + s * 512 * P, 128, 256));
        wgmma_commit();
        wgmma_wait<0>();
        release(empty + 8 * (it % geo.slots));
      }
      wg_fence_regs(d);
      if (last) release(xfree);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int dp[P];
#pragma unroll
        for (int c = 0; c < P; ++c) dp[c] = d[4 * (c + wg * (8 - P)) + e];
        emit1(mr + ((e >> 1) << 3), k0g + 8 * wg + kq + (e & 1), dp, tv[e], tp[e]);
      }
    }
  }
  fence_proxy_async();
  bar_sync(1, FWD_CONSUMERS);  // every operand row of pass 2 is written
  mbar_wait(w2full, 0);

  // pass 2: task t = (M tile t / g1, k1 group t % g1) on warpgroup t % 2
  const int m_real2 = g_rows * cols;
  const int tasks = geo.mtiles2 * geo.g1;
  for (int t = wg; t < tasks; t += 2) {
    const int mt = t / geo.g1, g = t - mt * geo.g1;
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    wg_fence_regs(d);
    wgmma_fence();
    const uint32_t a_tile = y_addr + mt * 64 * geo.kb1;
    for (int kk = 0; kk < geo.k1c; ++kk) {
      const uint32_t b_stage = x_addr + (g * geo.k1c + kk) * geo.w2_bytes;
      for (int s = 0; s < geo.kbc / 32; ++s)
        WgmmaUS<NW>::mma(d, wg_desc(a_tile + (kk * geo.kbc / 16 + 2 * s) * 128, 128, 8 * geo.kb1),
                         wg_desc(b_stage + s * 512 * P, 128, 256));
    }
    wgmma_commit();
    wgmma_wait<0>();
    wg_fence_regs(d);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 64 * mt + mr + ((e >> 1) << 3), k1 = 16 * g + 8 * h + kq + (e & 1);
        if (m < m_real2 && k1 < A) {
          int dp[P];
#pragma unroll
          for (int c = 0; c < P; ++c) dp[c] = d[4 * (c + P * h) + e];
          const int row = m / cols;
          out[base + (size_t)row * n + k1 * B + k0s + m - row * cols] =
              canonical64(fold_planes<P>(dp, mc), mc);
        }
      }
  }
}

template <int P, bool MUL>
int launch_inverse64(const void* in, void* out, const void* wi1s, const void* wi2s,
                     const void* tw, const void* key, const ModSet64& ms, int rows, int log_n,
                     int R, int S, void* stream) {
  const InvGeometry geo = inv_geometry(log_n, P, R, S);
  if (!inv_fits(geo, R)) return (int)cudaErrorInvalidValue;
  const int grid = ms.count * ((rows + R - 1) / R) * S;
  ntt_mxu8_inverse64_kernel<P, MUL><<<grid, FWD_THREADS, geo.smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const int8_t*)wi1s, (const int8_t*)wi2s,
      (const uint64_t*)tw, (const uint64_t*)key, ms, rows, log_n, R, S);
  return (int)cudaGetLastError();
}

// What the tiled launches read of a device, set up at the first launch of
// either there: the SM count, fits[k] = how many clusters of 2^k blocks (k <
// 4) the card holds at once at the forward's largest block (log_n 12, 8
// planes, R = 4, S = C = 2^k; every shape runs one block an SM), and the
// shared-memory cap of the forward's two instances and the inverse's four
// raised to FWD_SMEM_MAX (a launch asks for its own size below it).
struct U64Device {
  int sms = 0, fits[4] = {0, 0, 0, 0};
};

int u64_device(const U64Device** out) {
  static U64Device cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  U64Device& d = cached[dev];
  if (d.sms == 0) {
    U64Device fresh;
    const void* kernels[6] = {(const void*)ntt_mxu8_forward64_kernel<7>,
                              (const void*)ntt_mxu8_forward64_kernel<8>,
                              (const void*)ntt_mxu8_inverse64_kernel<7, false>,
                              (const void*)ntt_mxu8_inverse64_kernel<7, true>,
                              (const void*)ntt_mxu8_inverse64_kernel<8, false>,
                              (const void*)ntt_mxu8_inverse64_kernel<8, true>};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, FWD_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    for (int k = 0; k < 4; ++k) {
      cudaLaunchConfig_t cfg;
      cudaLaunchAttribute attr;
      const int err = configure_forward64<8>(1, 1 << k, 12, FWD_OPERAND_ROWS / 32, 1 << k,
                                             nullptr, &cfg, &attr);
      if (err != 0) return err;
      e = cudaOccupancyMaxActiveClusters(&fresh.fits[k], ntt_mxu8_forward64_kernel<8>, &cfg);
      if (e != cudaSuccess) return (int)e;
    }
    d = fresh;
  }
  *out = &d;
  return 0;
}

int forward64_any(const void* in, void* out, const void* w1s, const void* w2s, const void* tw,
                  const void* mod_pack, int count, int rows, int log_n, int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 12 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const U64Device* d = nullptr;
  const int err = u64_device(&d);
  if (err != 0) return err;
  int R, S;
  fwd_pick(count, rows, log_n, d->sms, d->fits, &R, &S);
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (planes == 7) return launch_forward64<7>(in, out, w1s, w2s, tw, ms, rows, log_n, R, S, stream);
  if (planes == 8) return launch_forward64<8>(in, out, w1s, w2s, tw, ms, rows, log_n, R, S, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool MUL>
int inverse64_any(const void* in, void* out, const void* wi1s, const void* wi2s, const void* tw,
                  const void* key, const void* mod_pack, int count, int rows, int log_n,
                  int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 12 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const U64Device* d = nullptr;
  const int err = u64_device(&d);
  if (err != 0) return err;
  int R, S;
  inv_pick(count, rows, log_n, d->sms, &R, &S);
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (planes == 7)
    return launch_inverse64<7, MUL>(in, out, wi1s, wi2s, tw, key, ms, rows, log_n, R, S, stream);
  if (planes == 8)
    return launch_inverse64<8, MUL>(in, out, wi1s, wi2s, tw, key, ms, rows, log_n, R, S, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// w1, w2: the stream-order tables (kernel_tables()["w1s"], ["w2s"]).
int pft_ntt_mxu8_forward64(const void* in, void* out, const void* w1, const void* w2,
                           const void* tw, const void* mod_pack, int count, int rows, int log_n,
                           int planes, void* stream) {
  return forward64_any(in, out, w1, w2, tw, mod_pack, count, rows, log_n, planes, stream);
}

// wi1, wi2: the stream-order tables (kernel_tables()["wi1s"], ["wi2s"]).
int pft_ntt_mxu8_inverse64(const void* in, void* out, const void* wi1, const void* wi2,
                           const void* tw, const void* mod_pack, int count, int rows, int log_n,
                           int planes, void* stream) {
  return inverse64_any<false>(in, out, wi1, wi2, tw, nullptr, mod_pack, count, rows, log_n,
                              planes, stream);
}

int pft_ntt_mxu8_inverse64_mul(const void* in, void* out, const void* wi1, const void* wi2,
                               const void* tw, const void* key, const void* mod_pack, int count,
                               int rows, int log_n, int planes, void* stream) {
  return inverse64_any<true>(in, out, wi1, wi2, tw, key, mod_pack, count, rows, log_n, planes,
                             stream);
}

}  // extern "C"
