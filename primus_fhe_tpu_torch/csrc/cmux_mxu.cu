// Kernels A and B: one blind-rotation CMux step per launch, its NTTs as
// byte-radix four-step products on the int8 tensor cores (mxu8.cuh).
//
// A replaces mxu_cmux_step_nat (primus_fhe_tpu/ops/cmux_mxu.py, kernel body
//   _make_cmux_kernel): the TFHE step acc + (acc * X^d - acc) [ext. product]
//   GGSW over the 2^32 torus, CRT over kp primes.
// B replaces ntru_cmux_step_nat (primus_fhe_tpu/ops/ntru_cmux_mxu.py, body
//   _make_ntru_kernel): the NGS step acc + rot(delta, d) - delta mod one
//   prime q, delta = INTT(acc [ext. product] EVK_i).
//
// Per block, one (ciphertext, prime), with P = k1 * L forward polys, A = n /
// 128, B = 128:
//   1. rotate-diff (A only) and signed gadget digits of every coefficient,
//      written as byte planes [(poly, k0)][(k1, plane)];
//   2. forward pass 1 (mma.sync): [(poly, k0)] x w1 -> X[poly][r0][k0],
//      times the twiddle tw[r0][k0] (Shoup), as u32 words, operand rows
//      (poly, r0) of the next pass;
//   3. forward pass 2 (wgmma): their bytes x w2 -> NTT values F[poly][r0 *
//      B + r1], canonical (bit-reversed order, viewed (A, B));
//   4. MAC against the key rows with Shoup precons, canonical, operand rows
//      (j, r0) of the next pass;
//   5. inverse pass 1 (wgmma, wi1) and twiddle twi; 6. inverse pass 2
//      (mma.sync, wi2, with inv_n and (P/p_i)^-1 folded in) -> canonical y
//      in natural order;
//   7. A: integer CRT across the kp prime blocks of the ciphertext
//      (distributed shared memory) + wrapping add; B: acc + rot(y, d) - y.
//
// The two large passes (3 and 5) are 512 x 512-byte plane matrices against
// P * A (resp. k1 * A) operand rows: 25.2M + 8.4M of the 35.4M int8 MACs of
// a BOOLEAN_128 block.  They run on wgmma.m64nNk32 (s8 plane x u8 operand
// -> s32), both operands in shared memory: the plane matrix is the M side
// (8 tiles of 64 rows), the operand rows the N side (N = 96 for A, 48 for B
// at their profiles; chunks of at most 96, widths 8-96).  The host orders
// the plane rows (ops/cmux_mxu.py:wgmma_layout) so that tile 2u + s, row
// 16w + 8h + g is plane c = 2s + h of output r1 = 32u + 8w + g: the thread
// of warpgroup s of pair u that holds planes 2s, 2s + 1 of an output, and
// the thread of the other warpgroup that holds the other two, sit at the
// same place in their warpgroups; they swap 32-bit partial residues through
// shared memory and each finishes half the outputs.  Forward pass 1 and
// inverse pass 2 (small K) stay on mma.sync, their plane matrices read from
// the ring.
//
// Threads: four consumer warpgroups (512 threads) do every phase; one
// producer warp (one elected lane) streams, in the order of use, w1 (one
// stage), w2 (16 stages a pass chunk), the key (one stage a (j, r, l) row
// of n <= 2048 words: values, then Shoup quotients at +8 KB), wi1 and wi2
// through a ring of S = 2-8 stages of 16 KB with full/empty mbarriers, each
// stage one cp.async.bulk.  The first stages land while the digits run.
// Blocks are launched in clusters of kp x C (C ciphertexts, each with its
// kp primes; the wrapper picks C from the batch and the card's cluster
// occupancy); the C blocks of one prime receive every stage from one bulk
// copy multicast by the first of them, and each consumer warp releases a
// stage in all C blocks.  A partial last cluster's spare blocks run on a
// copy of the batch's last ciphertext and store nothing, so every barrier
// and multicast sees all C blocks.  The digit, MAC, CRT and epilogue loops
// keep their arithmetic free of branches (clamped or wrapped indices,
// guarded stores only): a guarded body makes a warp run its iterations one
// after another.
//
// Shared memory: the ring S * 16 KB; the wgmma operands (padded P * A rows,
// then k1 * A, of 512 bytes in core-matrix order, see mxu8.cuh), later y;
// the digit planes (P * B rows of kb1 + 16 bytes), later F (P * n words),
// later the inverse pass-2 operand; 24 KB of swapped residues; the
// barriers.  BOOLEAN_128 (k1 = 2, L = 3, n = 2048): 64 + 48 + 48 + 24 KB =
// 188,480 bytes; NTRU_128 (L = 6, n = 1024): 128 + 24 + 36 + 24 KB = 217,216
// bytes.  Shapes whose plan exceeds 227 KB are refused (e.g. log_n 12 with
// k1 * L = 6); the blind rotations ask pft_cmux_mxu_clusters before the
// loop and route such shapes, and log_n 13-16, elsewhere
// (ops/cmux_mxu.mxu_step_route, ops/ntru_cmux_mxu.ntru_step_route).
// ptxas (sm_90a, 544 threads a block): 96 registers, 228-276 bytes of
// spills.
//
// What bounds it, measured with clock64() per phase in block 0
// (cmux_mxu_timing.py --phases, H100 80GB HBM3, 700 W): a BOOLEAN_128 block takes
// 76k cycles (the mma.sync design before it: 119k): digits 7.0k, pass 1 12.0k,
// forward pass 2 19.8k, MAC 13.9k, inverse pass 1 13.0k, inverse pass 2
// 5.0k, CRT 5.4k; the same at batch 1 and 64.  Pass 2 streams 256 KB in
// 19.8k cycles (13 bytes a cycle) where its 25.2M MACs need ~6k at the
// int8 peak, and the MAC 192 KB in 13.9k: the streamed passes run at the
// pace of the bulk copies into one SM, and the ring (64 KB) sits full through
// the 29k cycles of CUDA-core phases.  Batch 1 uses kp of 132 SMs.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include <cooperative_groups.h>

#include "mxu8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CONSUMERS = 512;               // four warpgroups
constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
constexpr int PASS_STAGES = 16;              // 512 x 512 bytes / 16 KB
constexpr int KEY_WORDS = PFT_WG_STAGE / 8;  // key words a stage (values + quotients)
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;
constexpr int LOAD_BATCH = 8;                // global loads a thread issues before using them
// partial residues the two warpgroups of a tile pair swap: per pair and
// direction, (J + 1) / 2 * 2 words a thread, J = PFT_WG_MAX_N / 8
constexpr int XCHG_SLOTS = (PFT_WG_MAX_N / 8 + 1) / 2 * 2;
constexpr size_t XCHG_BYTES = (size_t)2 * 2 * XCHG_SLOTS * 128 * 4;

struct CmuxMxuArgs {
  const uint32_t* acc;    // (bsz, k1, n)
  const int32_t* degrees; // (bsz,)
  const uint32_t* kv;     // (kp, k1, L, k1, n) or, for B, (L, n)
  const uint32_t* kpre;   // Shoup precons of kv
  uint32_t* out;          // like acc
  const int8_t* w1;       // (kp, 4 * np1, kb1) forward pass 1, digit planes
  const int8_t* w2g;      // (kp, 16, 16 KB) forward pass 2, stream order
  const int8_t* wi1g;     // (kp, 16, 16 KB) inverse pass 1, stream order
  const int8_t* wi2;      // (kp, 4 * np1, kb4) inverse pass 2
  const uint32_t* tw;     // (kp, 4, n): tw, tw precon, twi, twi precon
  PrimeSet ps;
  CrtConsts crt;
  MxuBasis bc;
  int kp, k1, log_n, dp, bsz, cl;  // cl: ciphertexts a cluster (C)
};

struct Geometry {
  int n, A, P, np1, kb1, kb4, lda1, lda4;
  int nf, ni;            // operand rows of the wgmma passes: P * A, k1 * A
  int kw, halves;        // key words a stage, stages a key row
  int sf, sk, si;        // stages of pass 2, of the MAC, of inverse pass 1
  int total;             // stages a step: w1, pass 2, MAC, inverse pass 1, wi2
  int stages;            // ring depth S, a power of two
  size_t op_off, x_off, xg_off, bar_off, smem;
};

__host__ __device__ inline Geometry geometry(int k1, int level, int log_n, int dp) {
  Geometry g;
  g.n = 1 << log_n;
  g.A = g.n / PFT_MXU_B;
  g.P = k1 * level;
  g.np1 = round_up(g.A, 8);
  g.kb1 = round_up(g.A * dp, 32);
  g.kb4 = round_up(4 * g.A, 32);
  g.lda1 = g.kb1 + 16;
  g.lda4 = g.kb4 + 16;
  g.nf = g.P * g.A;
  g.ni = k1 * g.A;
  g.kw = g.n < KEY_WORDS ? g.n : KEY_WORDS;
  g.halves = g.n / g.kw;
  g.sf = PASS_STAGES * ((g.nf + PFT_WG_MAX_N - 1) / PFT_WG_MAX_N);
  g.sk = k1 * g.halves * g.P;
  g.si = PASS_STAGES * ((g.ni + PFT_WG_MAX_N - 1) / PFT_WG_MAX_N);
  const size_t opf = (size_t)wg_padded_rows(g.nf) * 512, opi = (size_t)wg_padded_rows(g.ni) * 512;
  const size_t y = (size_t)k1 * g.n * 4;
  const size_t dig = (size_t)g.P * PFT_MXU_B * g.lda1, f = (size_t)g.P * g.n * 4;
  const size_t inv = (size_t)k1 * PFT_MXU_B * g.lda4;
  const size_t op = opf > opi ? (opf > y ? opf : y) : (opi > y ? opi : y);
  const size_t x = round_up((int)(dig > f ? (dig > inv ? dig : inv) : (f > inv ? f : inv)), 16);
  g.total = 1 + g.sf + g.sk + g.si + 1;
  const size_t room = SMEM_MAX > op + x + XCHG_BYTES ? SMEM_MAX - op - x - XCHG_BYTES : 0;
  g.stages = 2;
  while (g.stages < MAX_STAGES && (size_t)2 * g.stages * (PFT_WG_STAGE + 16) <= room) g.stages *= 2;
  g.op_off = (size_t)g.stages * PFT_WG_STAGE;
  g.x_off = g.op_off + op;
  g.xg_off = g.x_off + x;
  g.bar_off = g.xg_off + XCHG_BYTES;
  g.smem = g.bar_off + 16 * g.stages;
  return g;
}

// The ring as the consumers see it: stage i lives in slot i % S.
struct Ring {
  uint8_t* base;
  uint32_t full, empty;  // shared addresses of the barrier arrays
  int log_s, cl, kp, pi;  // S = 2^log_s

  __device__ int slot(int i) const { return i & ((1 << log_s) - 1); }
  __device__ uint32_t round(int i) const { return (uint32_t)(i >> log_s) & 1u; }
  __device__ uint8_t* stage(int i) const { return base + (size_t)slot(i) * PFT_WG_STAGE; }
  __device__ void wait_full(int i) const { mbar_wait(full + 8 * slot(i), round(i)); }
  // Called by every thread of a consumer warp once the warp is done with
  // stage i: lane 0 frees its slot in all C blocks of this prime.
  __device__ void release(int i) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      for (int c = 0; c < cl; ++c) mbar_arrive_cluster(empty + 8 * slot(i), c * kp + pi);
  }
};

// One wgmma pass over an operand chunk of NW rows at shared address `op`,
// in two rounds of all K (16 k-steps, 8 stages a round).  In round r,
// warpgroup wg accumulates tile s = wg & 1 of pair u = 2r + (wg >> 1):
// planes 2s and 2s + 1 of outputs r1 = 32u + 8w + g (warp w, lane 4g + t).
// The pair's two warpgroups swap the partial residues of planes 2s, 2s + 1
// (plane_pair) of half their outputs through `xchg`, and each finishes the
// other half: epi(m, r1, v) gets v = sum_c 2^(8c) d_c mod q (canonical) of
// output r1 of chunk row m, for every row of the chunk (its padding
// included: epi keeps its stores in bounds without branching around its
// arithmetic).
template <int NW, class Epi>
__device__ __forceinline__ void wg_pass_chunk(uint32_t op, uint32_t* xchg, const PlaneShoup& ps,
                                              const Ring& ring, int& it, Epi epi) {
  const int wg = threadIdx.x >> 7, pw = wg >> 1, s = wg & 1, wtid = threadIdx.x & 127;
  const int warp = wtid >> 5, g = (wtid & 31) >> 2, t = wtid & 3;
  uint32_t* mine = xchg + (size_t)(pw * 2 + s) * XCHG_SLOTS * 128 + wtid;
  const uint32_t* theirs = xchg + (size_t)(pw * 2 + (s ^ 1)) * XCHG_SLOTS * 128 + wtid;
#pragma unroll 1
  for (int round = 0; round < 2; ++round) {
    int d[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) d[i] = 0;
    wg_fence_regs(d);
    wgmma_fence();
#pragma unroll 1
    for (int ks = 0; ks < PASS_STAGES / 2; ++ks) {
      ring.wait_full(it);
      const uint32_t st = smem_addr(ring.stage(it)) + pw * 8192 + s * 4096;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        Wgmma<NW>::mma(d, wg_desc(st + kk * 2048, 128, 256),
                       wg_desc(op + (2 * ks + kk) * 256, 128, PFT_WG_OP_GROUP));
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        ring.release(it - 1);
      }
      ++it;
    }
    wgmma_wait<0>();
    wg_fence_regs(d);
    ring.release(it - 1);
    // d[4j + e]: row g (plane 2s), d[4j + 2 + e]: row g + 8 (plane 2s + 1),
    // column m = 8j + 2t + e; outputs with j % 2 == s are finished here
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((j & 1) != s)
          mine[((j >> 1) * 2 + e) * 128] = plane_pair(d[4 * j + e], d[4 * j + 2 + e], 2 * s, ps);
    bar_sync(2 + pw, 256);
    const int r1 = 32 * (2 * round + pw) + 8 * warp + g;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if ((j & 1) == s) {
          const uint32_t p = plane_pair(d[4 * j + e], d[4 * j + 2 + e], 2 * s, ps);
          epi(8 * j + 2 * t + e, r1, plane_finish(p, theirs[((j >> 1) * 2 + e) * 128], ps));
        }
    bar_sync(2 + pw, 256);  // the partner has read this round's sums
  }
}

// A wgmma pass over `rows` operand rows in chunks of at most 96;
// epi(m, r1, v) as above, m < rows rounded up to the chunk widths.
template <class Epi>
__device__ __forceinline__ void wg_pass(uint32_t op, int rows, uint32_t* xchg,
                                        const PlaneShoup& ps, const Ring& ring, int& it, Epi epi) {
  for (int m0 = 0; m0 < rows; m0 += PFT_WG_MAX_N) {
    const uint32_t opc = op + (m0 >> 3) * PFT_WG_OP_GROUP;
    auto e = [&](int m, int r1, uint32_t v) { epi(m0 + m, r1, v); };
    switch (wg_chunk_width(rows - m0)) {
      case 8: wg_pass_chunk<8>(opc, xchg, ps, ring, it, e); break;
      case 16: wg_pass_chunk<16>(opc, xchg, ps, ring, it, e); break;
      case 32: wg_pass_chunk<32>(opc, xchg, ps, ring, it, e); break;
      case 48: wg_pass_chunk<48>(opc, xchg, ps, ring, it, e); break;
      case 64: wg_pass_chunk<64>(opc, xchg, ps, ring, it, e); break;
      default: wg_pass_chunk<96>(opc, xchg, ps, ring, it, e); break;
    }
  }
}

// The producer's lane: every stage of the step in the consumers' order.
__device__ __forceinline__ void produce(const CmuxMxuArgs& args, const Geometry& geo,
                                        const Ring& ring, int pi, bool leader, uint16_t mask) {
  const int8_t* w2 = args.w2g + (size_t)pi * PASS_STAGES * PFT_WG_STAGE;
  const int8_t* wi1 = args.wi1g + (size_t)pi * PASS_STAGES * PFT_WG_STAGE;
  const int k1 = args.k1, L = args.bc.level, n = geo.n, kw = geo.kw;
  const size_t kbase = (size_t)pi * k1 * L * k1 * n;
  const uint32_t w1_bytes = 4 * geo.np1 * geo.kb1, wi2_bytes = 4 * geo.np1 * geo.kb4;
  for (int i = 0; i < geo.total; ++i) {
    const int p = i - 1;  // the stage within passes 2..inverse 1
    mbar_wait(ring.empty + 8 * ring.slot(i), ring.round(i) ^ 1u);
    const uint32_t full = ring.full + 8 * ring.slot(i), dst = smem_addr(ring.stage(i));
    if (i == 0 || i == geo.total - 1) {  // the mma.sync passes' small plane matrices
      const uint32_t bytes = i == 0 ? w1_bytes : wi2_bytes;
      mbar_expect_tx(full, bytes);
      const int8_t* src =
          i == 0 ? args.w1 + (size_t)pi * w1_bytes : args.wi2 + (size_t)pi * wi2_bytes;
      if (leader) bulk_copy(dst, src, bytes, full, mask);
    } else if (p < geo.sf || p >= geo.sf + geo.sk) {
      mbar_expect_tx(full, PFT_WG_STAGE);
      const int8_t* src = p < geo.sf ? w2 + (size_t)(p % PASS_STAGES) * PFT_WG_STAGE
                                     : wi1 + (size_t)((p - geo.sf - geo.sk) % PASS_STAGES) *
                                                 PFT_WG_STAGE;
      if (leader) bulk_copy(dst, src, PFT_WG_STAGE, full, mask);
    } else {  // key stage (j, h, r, l): row (r, l, j), words [h * kw, (h + 1) * kw)
      const int s = p - geo.sf;
      const int l = s % L, r = (s / L) % k1, h = (s / (L * k1)) % geo.halves;
      const int j = s / (L * k1 * geo.halves);
      const size_t ki = kbase + (size_t)((r * L + l) * k1 + j) * n + (size_t)h * kw;
      mbar_expect_tx(full, 8 * kw);
      if (leader) {
        bulk_copy(dst, args.kv + ki, 4 * kw, full, mask);
        bulk_copy(dst + PFT_WG_STAGE / 2, args.kpre + ki, 4 * kw, full, mask);
      }
    }
  }
}

template <bool NTRU>
__global__ void __launch_bounds__(THREADS, 1) cmux_mxu_kernel(const CmuxMxuArgs args) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int k1 = args.k1, L = args.bc.level, dp = args.dp;
  const Geometry geo = geometry(k1, L, args.log_n, dp);
  const int n = geo.n, A = geo.A, P = geo.P;
  const int log_n = args.log_n, log_a = log_n - 7;  // n = 2^log_n, A = 2^log_a
  constexpr int B = PFT_MXU_B;
  cg::cluster_group cluster = cg::this_cluster();
  const int kp = NTRU ? 1 : args.kp;
  const int rank = (int)cluster.block_rank();
  const int pi = rank % kp, cx = rank / kp;  // prime, ciphertext within the cluster
  const int b = (int)blockIdx.x / kp;
  const bool real = b < args.bsz;
  const int bb = real ? b : args.bsz - 1;
  const PrimeConsts pc = args.ps.p[pi];
  const uint32_t q = pc.q;
  const PlaneShoup ps = plane_shoup(pc);

  uint8_t* opr = smem + geo.op_off;  // wgmma operands, then y
  uint8_t* xr = smem + geo.x_off;    // digit planes, then F, then the inverse pass-2 operand
  uint32_t* xw = (uint32_t*)xr;
  uint32_t* y = (uint32_t*)opr;
  uint32_t* xchg = (uint32_t*)(smem + geo.xg_off);  // the wgmma passes' partial residues
  const Ring ring{smem, smem_addr(smem + geo.bar_off),
                  smem_addr(smem + geo.bar_off + 8 * geo.stages),
                  31 - __clz(geo.stages), args.cl, kp, pi};

  if (threadIdx.x == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, CONSUMERS / 32 * args.cl);
    }
    fence_mbarrier_init();
  }
  cluster.sync();

  const uint32_t* acc = args.acc + (size_t)bb * k1 * n;
  int d = args.degrees[bb] % (2 * n);
  if (d < 0) d += 2 * n;
  const int tid = threadIdx.x;

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      uint16_t mask = 0;
      for (int c = 0; c < args.cl; ++c) mask |= (uint16_t)(1u << (c * kp + pi));
      produce(args, geo, ring, pi, cx == 0, args.cl > 1 ? mask : 0);
    }
    __syncwarp();
  } else {
    const int warp = tid >> 5;
    int it = 0;
    // 1. digits of (acc * X^d - acc) [A] or of acc [B]; a thread's loads of
    //    LOAD_BATCH coefficients are all in flight before the first is used
    for (int base = tid; base < k1 * n; base += LOAD_BATCH * CONSUMERS) {
      uint32_t v[LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {  // past the end: a repeat, not written
        const int i = min(base + u * CONSUMERS, k1 * n - 1);
        v[u] = __ldg(acc + i);
        if (!NTRU) {
          bool neg;
          const uint32_t src = __ldg(acc + (i >> log_n) * n + rot_source(i & (n - 1), d, n, &neg));
          v[u] = (neg ? 0u - src : src) - v[u];
        }
      }
#pragma unroll
      for (int u = 0; u < LOAD_BATCH; ++u) {
        const int i = base + u * CONSUMERS, r = i >> log_n, c = i & (n - 1);
        if (i < k1 * n)
          write_digits(v[u], args.bc, dp,
                       (int8_t*)xr + ((size_t)(r * L) * B + (c & (B - 1))) * geo.lda1 +
                           (c / B) * dp,
                       B * geo.lda1);
      }
    }
    bar_sync(1, CONSUMERS);

    const uint32_t* tw = args.tw + (size_t)pi * 4 * n;
    // 2. forward pass 1 + twiddle -> operand rows (poly, r0); w1 is ring stage 0
    ring.wait_full(it);
    mm_planes_w<false, 2, true>(xr, geo.lda1, P * B, (const int8_t*)ring.stage(it),
                          geo.np1, A, geo.kb1, warp, CONSUMERS / 32,
                          [&](int m, int r0i, int d0, int d1, int d2, int d3) {
                            const int poly = m / B, k0 = m % B, idx = (r0i * B + k0) & (n - 1);
                            const uint32_t x = reduce_planes32(d0, d1, d2, d3, ps);
                            const uint32_t y0 = shoup_mul_lazy(x, tw[idx], tw[n + idx], q);
                            if (r0i < A) *(uint32_t*)(opr + wg_op_offset(poly * A + r0i, k0)) = y0;
                          });
    ring.release(it++);
    fence_proxy_async();
    bar_sync(1, CONSUMERS);
    // 3. forward pass 2 -> canonical NTT values, natural (bit-reversed) order
    wg_pass(smem_addr(opr), geo.nf, xchg, ps, ring, it, [&](int m, int r1, uint32_t v) {
      if (m < geo.nf) xw[m * B + r1] = v;
    });
    bar_sync(1, CONSUMERS);
    // 4. MAC: out_j = sum_{r, l} F[r, l] * key[r, l, j], one key stage a
    //    (j, h, r, l); a thread keeps up to kw / 512 coefficients in registers
    for (int j = 0; j < k1; ++j)
      for (int h = 0; h < geo.halves; ++h) {
        uint32_t s[KEY_WORDS / CONSUMERS];
#pragma unroll
        for (int u = 0; u < KEY_WORDS / CONSUMERS; ++u) s[u] = 0;
        for (int r = 0; r < k1; ++r)
          for (int l = 0; l < L; ++l) {
            ring.wait_full(it);
            const uint32_t* kvs = (const uint32_t*)ring.stage(it);
            const uint32_t* kps = kvs + PFT_WG_STAGE / 8;
            const uint32_t* f = xw + (r * L + l) * n + h * geo.kw;
#pragma unroll
            for (int u = 0; u < KEY_WORDS / CONSUMERS; ++u) {
              // below 2048 words the index wraps: repeated words, stored once
              const int i = (tid + u * CONSUMERS) & (geo.kw - 1);
              const uint32_t t = shoup_mul_lazy(f[i], kvs[i], kps[i], q);
              s[u] = reduce_once(s[u] + reduce_once(t, q), q);
            }
            ring.release(it);
            ++it;
          }
#pragma unroll
        for (int u = 0; u < KEY_WORDS / CONSUMERS; ++u)
          if (tid + u * CONSUMERS < geo.kw) {
            const int c = h * geo.kw + tid + u * CONSUMERS;
            *(uint32_t*)(opr + wg_op_offset((j << log_a) + (c >> 7), c & (B - 1))) = s[u];
          }
      }
    fence_proxy_async();
    bar_sync(1, CONSUMERS);
    // 5. inverse pass 1 + inverse twiddle -> inverse pass-2 operand
    const int w4 = geo.lda4 / 4;
    wg_pass(smem_addr(opr), geo.ni, xchg, ps, ring, it, [&](int m, int k0, uint32_t v) {
      const int j = m >> log_a, r0i = m & (A - 1), idx = r0i * B + k0;
      const uint32_t z = shoup_mul_lazy(v, tw[2 * n + idx], tw[3 * n + idx], q);
      if (m < geo.ni) xw[(j * B + k0) * w4 + r0i] = z;
    });
    bar_sync(1, CONSUMERS);
    // 6. inverse pass 2 -> canonical y, natural order; wi2 is the last stage
    ring.wait_full(it);
    mm_planes_w<true, 2, true>(xr, geo.lda4, k1 * B, (const int8_t*)ring.stage(it),
                         geo.np1, A, geo.kb4, warp, CONSUMERS / 32,
                         [&](int m, int k1i, int d0, int d1, int d2, int d3) {
                           const int j = m / B, k0 = m % B;
                           const uint32_t v = reduce_planes32(d0, d1, d2, d3, ps);
                           if (k1i < A) y[(j << log_n) + k1i * B + k0] = v;
                         });
    ring.release(it++);
    bar_sync(1, CONSUMERS);
  }

  uint32_t* out = args.out + (size_t)b * k1 * n;
  if constexpr (NTRU) {
    // 7B. acc + rot(delta, d) - delta mod q (mod-q negation keeps 0 at 0)
    if (real && tid < CONSUMERS)
      for (int base = tid; base < n; base += LOAD_BATCH * CONSUMERS) {
        uint32_t a[LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) a[u] = __ldg(acc + min(base + u * CONSUMERS, n - 1));
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
          const int c = base + u * CONSUMERS;
          if (c < n) {
            bool neg;
            const uint32_t src = y[rot_source(c, d, n, &neg)];
            const uint32_t rot = (neg && src != 0u) ? q - src : src;
            out[c] = reduce_once(reduce_once(a[u] + rot, q) + (q - y[c]), q);
          }
        }
      }
    cluster.sync();  // no block leaves while a cluster peer may still signal it
  } else {
    // 7A. integer CRT of the kp blocks' y_i, then the wrapping add
    cluster.sync();
    if (real && tid < CONSUMERS) {
      const uint32_t* ys[PFT_MAX_KP];
      for (int i = 0; i < PFT_MAX_KP; ++i)
        ys[i] = cluster.map_shared_rank(y, cx * kp + (i < kp ? i : 0));
      const int step = kp * CONSUMERS;
      for (int base = pi * CONSUMERS + tid; base < k1 * n; base += LOAD_BATCH * step) {
        uint32_t a[LOAD_BATCH], yv[LOAD_BATCH][PFT_MAX_KP];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {  // past the end: a repeat, not written
          const int i = min(base + u * step, k1 * n - 1);
          a[u] = __ldg(acc + i);
#pragma unroll
          for (int j = 0; j < PFT_MAX_KP; ++j) yv[u][j] = ys[j][i];
        }
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
          const int i = base + u * step;
          if (i >= k1 * n) break;
          uint64_t fix = 0;    // sum y_i * floor(2^64 / p_i), mod 2^64
          uint32_t over = 0;   // ... and its carries out of 2^64
          uint32_t total = 0;  // sum y_i * (P/p_i), mod 2^32
#pragma unroll
          for (int j = 0; j < PFT_MAX_KP; ++j)
            if (j < kp) {
              const uint64_t nf = fix + (uint64_t)yv[u][j] * args.crt.afix[j];
              over += nf < fix;
              fix = nf;
              total += yv[u][j] * args.crt.pmod[j];
            }
          const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
          out[i] = a[u] + (total - alpha * args.crt.pmt);
        }
      }
    }
    cluster.sync();  // keep every block's y alive until all reads are done
  }
}

// The launch of a batch of a.bsz (a.cl ciphertexts a cluster); attr holds
// the cluster dimension.
template <bool NTRU>
int configure(const CmuxMxuArgs& a, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
              void* stream) {
  const Geometry geo = geometry(a.k1, a.bc.level, a.log_n, a.dp);
  const int kp = NTRU ? 1 : a.kp;
  if (geo.smem > SMEM_MAX || a.cl < 1 || a.cl * kp > 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cmux_mxu_kernel<NTRU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  *cfg = {};
  cfg->gridDim = dim3((a.bsz + a.cl - 1) / a.cl * a.cl * kp);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = geo.smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a.cl * kp;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

template <bool NTRU>
int launch(const CmuxMxuArgs& a, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure<NTRU>(a, &cfg, &attr, stream);
  if (err != 0) return err;
  err = (int)cudaLaunchKernelEx(&cfg, cmux_mxu_kernel<NTRU>, a);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// How many clusters of this launch the card holds at once.
template <bool NTRU>
int max_clusters(const CmuxMxuArgs& a, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int err = configure<NTRU>(a, &cfg, &attr, nullptr);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveClusters(out, cmux_mxu_kernel<NTRU>, &cfg);
}

bool valid(int kp, int log_n, int dp, int level, int bsz) {
  return kp >= 1 && kp <= PFT_MAX_KP && log_n >= 8 && log_n <= 12 && (dp == 1 || dp == 2) &&
         level >= 1 && bsz >= 1;
}

}  // namespace

extern "C" {

int pft_cmux_mxu(const void* acc, const void* degrees, const void* kv, const void* kpre, void* out,
                 const void* w1, const void* w2g, const void* wi1g, const void* wi2, const void* tw,
                 const void* prime_pack, const void* crt_pack, const void* basis_pack, int kp,
                 int bsz, int k1, int log_n, int dp, int cl, void* stream) {
  const MxuBasis bc = unpack_mxu_basis((const uint64_t*)basis_pack);
  if (!valid(kp, log_n, dp, bc.level, bsz)) return (int)cudaErrorInvalidValue;
  CmuxMxuArgs a{(const uint32_t*)acc, (const int32_t*)degrees, (const uint32_t*)kv,
                (const uint32_t*)kpre, (uint32_t*)out, (const int8_t*)w1, (const int8_t*)w2g,
                (const int8_t*)wi1g, (const int8_t*)wi2, (const uint32_t*)tw,
                unpack_primes((const uint64_t*)prime_pack, kp),
                unpack_crt((const uint64_t*)crt_pack, kp), bc, kp, k1, log_n, dp, bsz, cl};
  return launch<false>(a, stream);
}

int pft_ntru_cmux_mxu(const void* acc, const void* degrees, const void* kv, const void* kpre,
                      void* out, const void* w1, const void* w2g, const void* wi1g, const void* wi2,
                      const void* tw, const void* prime_pack, const void* basis_pack, int bsz,
                      int log_n, int dp, int cl, void* stream) {
  const MxuBasis bc = unpack_mxu_basis((const uint64_t*)basis_pack);
  if (!valid(1, log_n, dp, bc.level, bsz)) return (int)cudaErrorInvalidValue;
  CmuxMxuArgs a{(const uint32_t*)acc, (const int32_t*)degrees, (const uint32_t*)kv,
                (const uint32_t*)kpre, (uint32_t*)out, (const int8_t*)w1, (const int8_t*)w2g,
                (const int8_t*)wi1g, (const int8_t*)wi2, (const uint32_t*)tw,
                unpack_primes((const uint64_t*)prime_pack, 1), CrtConsts{}, bc, 1, 1, log_n, dp,
                bsz, cl};
  return launch<true>(a, stream);
}

// Clusters of kp * cl blocks (one for kernel B) the card runs at once at
// this shape, into *out.
int pft_cmux_mxu_clusters(int ntru, int kp, int k1, int log_n, int dp, int level, int cl,
                          int* out) {
  MxuBasis bc{};
  bc.level = level;
  if (!valid(kp, log_n, dp, level, 1)) return (int)cudaErrorInvalidValue;
  CmuxMxuArgs a{};
  a.bc = bc;
  a.kp = ntru ? 1 : kp;
  a.k1 = ntru ? 1 : k1;
  a.log_n = log_n;
  a.dp = dp;
  a.bsz = cl;
  a.cl = cl;
  return ntru ? max_clusters<true>(a, out) : max_clusters<false>(a, out);
}

}  // extern "C"
