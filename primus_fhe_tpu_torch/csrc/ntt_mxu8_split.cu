// Row 13: the four half-transforms of the coefficient-sharded byte-radix NTT
// (7 and 8 byte planes, q < 2^62), one all_to_all apart.
//
// Replace _k1_forward, _k2_forward, _ki1_inverse and _ki2_inverse
// (primus_fhe_tpu/parallel/coeff_sharded_mxu.py:131,184,229,297; pallas_call
// at :174, :219, :287, :332):
//
//   K1  = forward pass 1 + twiddle: each lane's A-point negacyclic transform,
//   K2  = forward pass 2: each row's 128-point cyclic transform,
//   Ki1 = inverse pass 1 + twiddle, with kernel D's key multiply at load as
//         an option: each row's inverse 128-point cyclic transform,
//   Ki2 = inverse pass 2, inv_n folded in: each lane's inverse A-point
//         negacyclic transform.
//
// The TPU kernels run each pass as a product with a byte-plane matrix on
// its matrix unit; here every half runs butterflies on u64 words (the radix
// passes' butterflies and table layout, csrc/ntt_passes.cuh), no byte plane:
// the column halves on the A-point root tables "col" / "col_inv"
// (split_col_kernel, below), the row halves on the 128-point cyclic ones
// "cyclic" / "cyclic_inv" (split_row_kernel), all in
// Mxu8Tables64.split_tables.  n = A x 128 for 8 <= log_n <= 14 (A = 2 ..
// 128), the JAX ShardedMxuPlan64's range.
//
// Layouts (one modulus a leading index; words are u64 bit patterns):
//   column passes K1, Ki2: (A, L), word [k][lane] at k * L + lane, a lane
//     being a (k0, batch) pair of the shard's B/D lanes: the pass runs over
//     the A axis of each lane.
//   row passes K2, Ki1: (rows, 128), a row being an (r0, batch) pair of the
//     shard's A/D rows: the pass runs over the 128 words of each row.
// A lane's global k0 is k0_off + lane / batch, a row's global r0 is
// r0_off + row / batch: the twiddles are read from the (A, B) tables at
// those indices, where the TPU kernels read copies expanded over the batch.
// Ki1's key is the shard's rows of the fixed operand, (2, (rows / batch) *
// 128): values, then their Shoup quotients.
//
// Inputs: any u64 word (each brought to [0, 2q) as it loads).  Outputs: K1
// and Ki1 lazy (the Shoup twiddle: [0, 2q), congruent to the canonical
// pass); K2 and Ki2 canonical.
//
// One launch covers every modulus of the tables (the grid's leading index).

#include "mxu8.cuh"  // PFT_MXU_B
#include "ntt_passes.cuh"

namespace {

// ---------------------------------------------------------------------------
// The row halves K2 and Ki1: each row's 128-point cyclic transform, on the
// radix passes' butterflies (csrc/ntt_passes.cuh).
//
// K2's pass matrix m2[r1, k0] = om_b^(brv7(r1) k0) (om_b a primitive 128th
// root) is the cyclic NTT of 128 words with bit-reversed output: 7
// Cooley-Tukey stages, stage s's block k by om_b^brv6(k) (the table
// "cyclic" holds it at [2^s + k]).  Ki1's m2i is its Gentleman-Sande
// mirror: bit-reversed in, natural out, no 1/128 (inv_n is folded into
// Ki2's m1i); stage s's block j by om_b^-brv6(j) ("cyclic_inv", at [129 -
// (128 >> s) + j]).
//
// What bounds them: at phase 16.2's D = 2 shard (8192 rows of 128 words),
// 16.8 MB in and out, 0.0050 ms at 3.35 TB/s; their Shoup multiplies,
// 448 a row for K2 and 704 for Ki1 with the key and the twiddle (0.0022 /
// 0.0035 ms at the 32-bit multiply peak, 10 a Shoup; chip_smoke.py
// split_bounds), sit under it.  The first kernel here multiplied each row's
// 8 byte planes by a 128 x 128 plane matrix on mma.sync and folded every
// output's P planes: 7.5e9 int8 MACs at that shard, 0.0076 ms at the int8
// peak alone, and 16x the byte bound as built.  Byte planes were the TPU's
// way to run 64-bit modular products on its matrix unit; Hopper multiplies
// 64-bit words natively, and on this word type the butterflies beat the
// byte-radix kernels at every shape (row 10, kernel E), so the planes are
// gone: a row is 7 stages of 64 Shoup butterflies.
//
// The design: a row of 128 words lives in 8 lanes of a warp, 16 words a
// lane; a warp holds a quad of 4 rows (lane 4t + r: lane t of row r); a
// block a tile of T = 4, 8, 16 or 32 rows of one modulus, T / 4 warps (the
// C entry picks T: pick_rows, one block an SM).
// - K2, 3 + 4 stages: pass A runs stages 0-2 on the lane's radix-8 groups
//   2t and 2t + 1 (words 2t + 16k and 2t + 1 + 16k: the 16-byte chunks t +
//   8k, which the row's 8 lanes read as 128 contiguous bytes at each k),
//   each word brought to [0, 2q) as it loads (AnyIn64), so that stage 0,
//   whose root is 1, is the butterfly's adds alone; the chunks go to the
//   row's slice of shared memory; pass B
//   runs stages 3-6 on the lane's 16 adjacent words (chunks 8t + j) as one
//   radix-16 group, twiddles read as runs from the staged table; the
//   canonical words go back to the same chunks and leave as chunks t + 8k.
// - Ki1, 4 + 3 stages, mirrors it: chunks t + 8k load, each word times its
//   key word (a lazy Shoup multiply) or reduced by AnyIn64, into the slice;
//   pass A' runs stages 0-3 on the lane's 16 adjacent words; pass B' reads
//   chunks t + 8k back and runs stages 4-5 on the groups 2t, 2t + 1, then
//   stage 6, whose root is 1, with the twiddle twi[r0][c] in the root's
//   place (inv_bf_scaled: one Shoup multiply a word where a separate
//   twiddle would cost two), and stores chunks t + 8k.
// - a warp's 4 KB of slices are its own, so between passes it syncs only
//   itself (__syncwarp); the one block barrier, after the loads are issued,
//   waits for the table (128 roots and quotients, 2 KB), staged by cp.async
//   under them (the inverse's one word on, so that every run a lane reads
//   is 16-byte aligned).
// - chunk (a, b) (words 16a + 2b, +1) of row r's slice lies at chunk 8a +
//   (a ^ b ^ 2r): each quarter-warp (lanes t = 2p, 2p + 1 of the 4 rows) of
//   every 16-byte access, and of the table's runs, hits 8 distinct bank
//   groups (tests/test_torch_split_rows_model.py models the whole flow).
// Every word goes through device memory once each way, 16 bytes a lane.

constexpr int ROW_TQ = 136;            // the staged table's quotients, words on
constexpr int ROW_TABLE = 2 * ROW_TQ;  // words of the staged table
constexpr int ROW_TILES = 4;           // tiles of 4, 8, 16, 32 rows

inline size_t row_smem(int tile) {
  return sizeof(uint64_t) * ((size_t)ROW_TABLE + (size_t)tile * PFT_MXU_B);
}

struct RowArgs {
  const uint64_t* in;   // (count, rows, 128)
  uint64_t* out;        // (count, rows, 128)
  const uint64_t* tab;  // (count, 2, 128): the cyclic roots, their quotients
  const uint64_t* tw;   // (count, 4, n): twi at 2n, its quotients at 3n
  const uint64_t* key;  // (count, 2, rows / batch * 128) or null
  ModSet64 ms;
  int rows, batch, r0_off, log_n, tile;
};

// The 16-byte chunk (a, b) of a row's slice (slice r of its quad).
__device__ __forceinline__ uint64_t* row_chunk(uint64_t* slice, int r, int a, int b) {
  return slice + 2 * (8 * a + (a ^ b ^ (2 * r)));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Gentleman-Sande's last stage (root 1) with a factor on each output: x + y
// times fx, x - y times fy; x, y below 2q in, [0, 2q) out.
__device__ __forceinline__ void inv_bf_scaled(uint64_t& x, uint64_t& y, uint64_t fx,
                                              uint64_t fxp, uint64_t fy, uint64_t fyp,
                                              uint64_t q) {
  const uint64_t two_q = 2 * q, s = x + y, d = x + two_q - y;
  x = shoup64_lazy(s >= two_q ? s - two_q : s, fx, fxp, q);
  y = shoup64_lazy(d, fy, fyp, q);
}

// Pass A''s twiddles, group hi at stages 0-3: stage e's run of 8 >> e roots
// from [129 - (128 >> e) + (hi << (3 - e))] of the inverse table staged at
// p + 1 (quotients ROW_TQ words on) into w[(8 >> e) + j], FwdTable's layout
// mirrored.
__device__ __forceinline__ void inv_runs16(const uint64_t* p, int hi, uint64_t (&w)[16],
                                           uint64_t (&wp)[16]) {
  uint64_t a8[8], b8[8], a4[4], b4[4], a2[2], b2[2];
  load_words(p + 2 + 8 * hi, a8);
  load_words(p + ROW_TQ + 2 + 8 * hi, b8);
  load_words(p + 66 + 4 * hi, a4);
  load_words(p + ROW_TQ + 66 + 4 * hi, b4);
  load_words(p + 98 + 2 * hi, a2);
  load_words(p + ROW_TQ + 98 + 2 * hi, b2);
  w[1] = p[114 + hi];
  wp[1] = p[ROW_TQ + 114 + hi];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[8 + j] = a8[j], wp[8 + j] = b8[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[4 + j] = a4[j], wp[4 + j] = b4[j];
  w[2] = a2[0], w[3] = a2[1], wp[2] = b2[0], wp[3] = b2[1];
}

template <bool INVERSE, bool MUL>
__global__ void __launch_bounds__(256) split_row_kernel(const RowArgs a) {
  extern __shared__ __align__(16) uint64_t sm[];
  constexpr int B = PFT_MXU_B;
  const int tiles = (a.rows + a.tile - 1) / a.tile;
  const int mi = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - mi * tiles) * a.tile;
  const int lane = threadIdx.x & 31, t = lane >> 2, r = lane & 3;
  const int tr = 4 * (threadIdx.x >> 5) + r;  // the lane's row in the tile
  const bool live = tr < min(a.tile, a.rows - row0);
  const int row = row0 + (live ? tr : 0);  // a dead lane runs on a live row and stores nothing
  const Mod64 c = a.ms.m[mi];
  const uint64_t q = c.q;
  const size_t moff = (size_t)mi * a.rows * B;
  const uint64_t* g = a.tab + (size_t)mi * 2 * B;
  uint64_t* slice = sm + ROW_TABLE + tr * B;

  // the table, by cp.async under the loads: the forward's word i at [i],
  // the inverse's at [i + 1]; quotients ROW_TQ words on
  if constexpr (INVERSE) {
    for (int i = threadIdx.x; i < 2 * B; i += blockDim.x)
      cp_async8(sm + (i / B) * ROW_TQ + 1 + i % B, g + i);
  } else {
    for (int i = threadIdx.x; i < B; i += blockDim.x)
      cp_async16(sm + (i / (B / 2)) * ROW_TQ + 2 * (i % (B / 2)), g + 2 * i);
  }
  cp_async_commit();

  // the load: chunks t + 8k, words 2t + 16k (v0) and 2t + 1 + 16k (v1)
  uint64_t v0[8], v1[8];
  if constexpr (MUL) {
    const int kw = a.rows / a.batch * B;
    const uint64_t* kv = a.key + (size_t)mi * 2 * kw + (size_t)(row / a.batch) * B;
    const uint64_t* x = a.in + moff + (size_t)row * B;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t xv[2], w[2], wp[2];
      load_words(x + 2 * (t + 8 * k), xv);
      load_words(kv + 2 * (t + 8 * k), w);
      load_words(kv + kw + 2 * (t + 8 * k), wp);
      v0[k] = shoup64_lazy(xv[0], w[0], wp[0], q);
      v1[k] = shoup64_lazy(xv[1], w[1], wp[1], q);
    }
  } else {
    const AnyIn64 any{a.in + moff, 7, q, c.p1};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t xv[2];
      any.load_adjacent(row, 2 * (t + 8 * k), xv);
      v0[k] = xv[0], v1[k] = xv[1];
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the table

  if constexpr (!INVERSE) {
    // pass A on the groups 2t, 2t + 1: stage 0, whose root is 1, as the
    // butterfly's adds (AnyIn64 took every word below 2q: a Shoup multiply
    // by 1 would change no residue), then stages 1-2 on each half of the
    // group (stage 1's block h) with the staged table's roots
    const FwdTable<uint64_t> table{sm, sm + ROW_TQ};
    uint64_t w[2][4], wp[2][4];
    table.get<2>(1, 0, w[0], wp[0]);
    table.get<2>(1, 1, w[1], wp[1]);
    const auto pass_a = [&](uint64_t(&v)[8]) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t x = v[k], y = v[k + 4];
        v[k] = x + y;
        v[k + 4] = x + 2 * q - y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fwd_stages<2>(*reinterpret_cast<uint64_t(*)[4]>(v + 4 * h),
                      [&](int e, int j, uint64_t& ww, uint64_t& wwp) {
                        ww = w[h][(1 << e) + j];
                        wwp = wp[h][(1 << e) + j];
                      },
                      q);
    };
    pass_a(v0);
    pass_a(v1);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t x[2] = {v0[k], v1[k]};
    store_words(row_chunk(slice, r, k, t), x);
  }
  __syncwarp();

  // the lane's 16 adjacent words 16t .. 16t + 15: chunks 8t + j
  uint64_t u[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t x[2];
    load_words(row_chunk(slice, r, t, j), x);
    u[2 * j] = x[0], u[2 * j + 1] = x[1];
  }
  {
    uint64_t w[16], wp[16];
    const auto tw4 = [&](int e, int j, uint64_t& ww, uint64_t& wwp) {
      ww = w[(INVERSE ? 8 >> e : 1 << e) + j];
      wwp = wp[(INVERSE ? 8 >> e : 1 << e) + j];
    };
    if constexpr (INVERSE) {  // pass A': stages 0-3
      inv_runs16(sm, t, w, wp);
      inv_stages<4>(u, tw4, q);
    } else {  // pass B: stages 3-6, canonical out
      FwdTable<uint64_t>{sm, sm + ROW_TQ}.get<4>(3, t, w, wp);
      fwd_stages<4>(u, tw4, q);
#pragma unroll
      for (int j = 0; j < 16; ++j) u[j] = reduce_once64(reduce_once64(u[j], 2 * q), q);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t x[2] = {u[2 * j], u[2 * j + 1]};
    store_words(row_chunk(slice, r, t, j), x);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint64_t x[2];
    load_words(row_chunk(slice, r, k, t), x);
    v0[k] = x[0], v1[k] = x[1];
  }

  if constexpr (INVERSE) {
    // pass B': stages 4-5 (the same twiddles for every lane: [121, 127)),
    // then stage 6 with the twiddle twi[r0][c] in its root's place
    const uint64_t* it = sm + 1;
    const auto tw2 = [&](int e, int j, uint64_t& ww, uint64_t& wwp) {
      ww = it[B + 1 - (8 >> e) + j];
      wwp = it[ROW_TQ + B + 1 - (8 >> e) + j];
    };
    inv_stages<3, 2>(v0, tw2, q);
    inv_stages<3, 2>(v1, tw2, q);
    const size_t n = (size_t)1 << a.log_n;
    const uint64_t* twi = a.tw + 4 * n * mi + 2 * n + (size_t)(a.r0_off + row / a.batch) * B;
    uint64_t f0[8], f1[8], fp0[8], fp1[8];  // columns 2t + 16k, 2t + 1 + 16k
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint64_t f[2], fp[2];
      load_words(twi + 2 * (t + 8 * k), f);
      load_words(twi + n + 2 * (t + 8 * k), fp);
      f0[k] = f[0], f1[k] = f[1], fp0[k] = fp[0], fp1[k] = fp[1];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      inv_bf_scaled(v0[k], v0[k + 4], f0[k], fp0[k], f0[k + 4], fp0[k + 4], q);
      inv_bf_scaled(v1[k], v1[k + 4], f1[k], fp1[k], f1[k + 4], fp1[k + 4], q);
    }
  }
  // the store: chunks t + 8k, 16 bytes a lane
  if (live) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t x[2] = {v0[k], v1[k]};
      store_words(a.out + moff + (size_t)row * B + 2 * (t + 8 * k), x);
    }
  }
}

// The SM count of the current device, read at its first row launch.
int row_sms(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    e = cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *sms = cached[dev];
  return 0;
}

// Rows a block: the smallest tile T (4, 8, 16 or 32 rows) whose grid of
// count ceil(rows / T) blocks has at most one block an SM, else 32.  Every
// SM then runs one block's share: a grid of many small blocks under one
// full wave lands unevenly (the SMs that take more blocks set the time),
// and a tile of more rows than that leaves SMs idle
// (cmux_mxu_timing.py --split --grids: within 5% of the best tile at every
// phase-16 shape).
int pick_rows(int count, int rows, int sms) {
  for (int i = 0; i < ROW_TILES; ++i)
    if ((long)count * ((rows + (4 << i) - 1) / (4 << i)) <= sms) return 4 << i;
  return 4 << (ROW_TILES - 1);
}

int launch_rows(bool inverse, const void* in, void* out, const void* tab, const void* tw,
                const void* key, const ModSet64& ms, int rows, int batch, int r0_off, int log_n,
                void* stream) {
  if ((((uintptr_t)in | (uintptr_t)out | (uintptr_t)tab | (uintptr_t)tw | (uintptr_t)key) & 15) !=
      0)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = row_sms(&sms);
  if (err != 0) return err;
  const int kind = !inverse ? 0 : key != nullptr ? 1 : 2;
  RowArgs a{(const uint64_t*)in, (uint64_t*)out, (const uint64_t*)tab, (const uint64_t*)tw,
            (const uint64_t*)key, ms, rows, batch, r0_off, log_n, 0};
  a.tile = pick_rows(ms.count, rows, sms);
  const dim3 grid(ms.count * ((rows + a.tile - 1) / a.tile)), block(8 * a.tile);
  const size_t smem = row_smem(a.tile);
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0) split_row_kernel<false, false><<<grid, block, smem, st>>>(a);
  if (kind == 1) split_row_kernel<true, true><<<grid, block, smem, st>>>(a);
  if (kind == 2) split_row_kernel<true, false><<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The column halves K1 and Ki2: each lane's A-point negacyclic transform, on
// the radix passes' butterflies (csrc/ntt_passes.cuh).
//
// K1's pass matrix m1[r0, k1] = psi_A^k1 om_a^(brv(r0) k1) (psi_A = psi^128,
// a primitive 2A-th root) is the A-point negacyclic NTT with bit-reversed
// output: log A Cooley-Tukey stages, natural in, on row 10's root table of
// psi_A ("col": stage s's block k at [2^s + k]), lazy in [0, 4q), then the
// twiddle tw[r0][k0] as a lazy Shoup multiply.  Ki2's m1i is its
// Gentleman-Sande mirror (bit-reversed in, natural out; "col_inv": stage
// s's block j at [1 + A - (A >> s) + j]) with 1/n, not 1/A, folded into the
// last stage: x + y times Mod64.inv_n (1/n of the n-point plan), x - y
// times col_inv's word 0 (1/n times that stage's root), canonical out.
//
// What bounds them: at phase 16.2's D = 2 shard (32768 lanes of 32 words)
// 16.8 MB in and out, 0.0050 ms at 3.35 TB/s; their Shoup multiplies (80 a
// lane for the transform, 32 for K1's twiddle, 16 for Ki2's 1/n: 0.0022 ms
// at the 32-bit multiply peak, 10 a Shoup; chip_smoke.py split_bounds) sit
// under it.  The first kernel here split each word into 8 byte planes,
// staged them transposed in shared memory and multiplied them by the P A x
// 8 A int8 plane matrix on mma.sync, folding every output's P planes: a
// method of the TPU's matrix unit, issue-bound well above the bytes; on u64
// words the butterflies beat it (rows 10, 13's row halves, E).
//
// The design: a lane's column is split over T threads of a warp (T = 1 for
// A <= 16, 4 for A = 32, A / 16 above), W = A / T words each (at most 16),
// held in registers through the stages:
// - layout L2, thread u holding words u W + r (r < W): the stages whose
//   pairs lie within a thread's W words (the forward's last log W, the
//   inverse's first log W) run on them (fwd_stages / inv_stages, fully
//   unrolled);
// - layout L1, thread u holding words j W + u G + i (j < T, i < G = W / T):
//   the stages whose pairs lie W apart or more (the forward's first log T,
//   the inverse's last log T) run on each of the thread's G groups of T
//   words;
// - the one change of layout goes through the warp's slice of shared
//   memory (W words a thread), with a __syncwarp: a column's threads are
//   one warp's.  Word k of the warp's column c lies at ((k ^ f(k)) 32 / T
//   + c), f(k) = ((k >> log G) ^ (k >> log W)) mod T / 2, so that each
//   half-warp of the 8-byte accesses in either layout hits 16 distinct
//   8-byte bank pairs (tests/test_torch_split_cols_model.py).
// So a column goes through no barrier between stages and no stage costs
// more than its butterflies.  Splitting it gives the SMs more warps to hide
// the butterflies' multiply latency: on an H100 at phase 16.4's D = 2 shard
// one thread a lane (8 warps an SM) spent 2.5x the IMAD issue of its
// butterflies (cmux_mxu_timing.py --split --phases), and K1 took 0.0157 ms,
// 2 threads a lane 0.0153, 4 threads 0.0146 (in turns).
// - a warp takes 32 / T adjacent lanes: each load and store at index k is
//   T runs of 256 / T contiguous bytes.  Each word is brought to [0, 2q) as
//   it loads (AnyIn64's lazy Shoup multiply by 1), but for the forward's
//   y words of stage 0, whose Shoup multiply takes any word.
// - the root table (2A words, at most 2 KB) is staged once a block by
//   cp.async under the loads; at each step the threads of a lane part read
//   one entry (a broadcast).  K1's twiddles (tw[r0][k0], shared by a lane's
//   batch: a broadcast where batch >= 32) are read ahead of the L2 stages,
//   in flight under them: on an H100 (cmux_mxu_timing.py --split in turns)
//   read after the stages they cost 5-10% of K1's time at n = 4096, read
//   with the words (held in registers through the L1 stages too) 1-3%.
// - 128 threads a block (COL_THREADS), at most 18 KB of shared memory.
// Every word goes through device memory once each way.

struct ColArgs {
  const uint64_t* in;   // (count, A, lanes)
  uint64_t* out;        // (count, A, lanes)
  const uint64_t* tab;  // (count, 2, A): the column roots, their quotients
  const uint64_t* tw;   // (count, 4, n): tw at 0, its quotients at n
  ModSet64 ms;
  int lanes, batch, k0_off, log_n;
};

// log2 T, the threads a lane: W = A / T words a thread, at most 16; 8 at
// A = 32 (the most threads the slot swizzle allows, W >= 2T).
__host__ __device__ constexpr int col_log_t(int log_a) {
  return log_a <= 4 ? 0 : log_a == 5 ? 2 : log_a - 4;
}

// Words of shared memory a block: the table, then (T > 1) W words a thread.
inline size_t col_smem(int log_a, int threads) {
  const int t = col_log_t(log_a);
  return sizeof(uint64_t) * (2 * ((size_t)1 << log_a) +
                             (t ? (size_t)threads << (log_a - t) : 0));
}

// The warp's slice of the layout change: word k of column c (of 32 / T).
template <int LOG_T, int LOG_G, int LOG_W>
__device__ __forceinline__ int col_slot(int k, int c) {
  const int f = ((k >> LOG_G) ^ (k >> LOG_W)) & ((1 << LOG_T) / 2 - 1);
  return ((k ^ f) << (5 - LOG_T)) + c;
}

template <int LOG_A, bool INVERSE>
__global__ void __launch_bounds__(256) split_col_kernel(const ColArgs a) {
  constexpr int A = 1 << LOG_A;
  constexpr int LOG_T = col_log_t(LOG_A), T = 1 << LOG_T;
  constexpr int LOG_W = LOG_A - LOG_T, W = 1 << LOG_W;  // words a thread
  constexpr int LOG_G = LOG_W - LOG_T, G = 1 << LOG_G;  // L1: groups of T words
  constexpr int CPW = 32 >> LOG_T;                       // lanes a warp
  static_assert(LOG_T <= 1 || LOG_G >= 1, "the slot swizzle needs W >= 2 T");
  extern __shared__ __align__(16) uint64_t sm[];
  const int per_block = (blockDim.x >> 5) * CPW;
  const int blocks = (a.lanes + per_block - 1) / per_block;
  const int mi = blockIdx.x / blocks;
  const int lane = threadIdx.x & 31, u = lane / CPW, cw = lane % CPW;
  const int col = (blockIdx.x - mi * blocks) * per_block + (threadIdx.x >> 5) * CPW + cw;
  const bool live = col < a.lanes;
  const int c = live ? col : a.lanes - 1;  // a dead thread runs on a live lane, stores nothing
  const Mod64 m = a.ms.m[mi];
  const uint64_t q = m.q, two_q = 2 * q;
  const size_t base = (size_t)mi * A * a.lanes;
  uint64_t* slots = sm + 2 * A + (threadIdx.x >> 5) * 32 * W;  // the warp's slice
  // word k of a thread's register r: L1 k(r) = (r / G) W + u G + r % G, L2 u W + r
  const auto l1 = [&](int r) { return ((r >> LOG_G) << LOG_W) + (u << LOG_G) + (r & (G - 1)); };
  const auto l2 = [&](int r) { return (u << LOG_W) + r; };

  // the table, by cp.async under the loads: roots at [i], quotients at [A + i]
  const uint64_t* g = a.tab + (size_t)mi * 2 * A;
  for (int i = threadIdx.x; i < 2 * A; i += blockDim.x) cp_async8(sm + i, g + i);
  cp_async_commit();
  // the loads: the forward in L1, the inverse in L2 (the same where T = 1)
  uint64_t v[W];
#pragma unroll
  for (int r = 0; r < W; ++r)
    v[r] = Word<uint64_t>::ldg(a.in + base + (size_t)(INVERSE ? l2(r) : l1(r)) * a.lanes + c);
#pragma unroll
  for (int r = 0; r < W; ++r)
    if (INVERSE || r < W / 2) v[r] = shoup64_lazy(v[r], 1, m.p1, q);
  cp_async_wait<0>();
  __syncthreads();  // the table

  if constexpr (!INVERSE) {
    if constexpr (LOG_T > 0) {
      // stages 0 .. log T - 1 in L1, group i = words j W + u G + i (j < T):
      // stage e's block j >> (log T - e), root [2^e + that]
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint64_t x[T];
#pragma unroll
        for (int j = 0; j < T; ++j) x[j] = v[j * G + i];
        fwd_stages<LOG_T>(
            x,
            [&](int e, int jj, uint64_t& w, uint64_t& wp) {
              w = sm[(1 << e) + jj];
              wp = sm[A + (1 << e) + jj];
            },
            q);
#pragma unroll
        for (int j = 0; j < T; ++j) v[j * G + i] = x[j];
      }
      // L1 -> L2 through the warp's slice
#pragma unroll
      for (int r = 0; r < W; ++r) slots[col_slot<LOG_T, LOG_G, LOG_W>(l1(r), cw)] = v[r];
      __syncwarp();
#pragma unroll
      for (int r = 0; r < W; ++r) v[r] = slots[col_slot<LOG_T, LOG_G, LOG_W>(l2(r), cw)];
    }
    // K1's twiddles tw[r0][k0] (r0 = u W + r, the bit-reversed output
    // index), in flight under the L2 stages
    const size_t n = (size_t)1 << a.log_n;
    const uint64_t* t = a.tw + 4 * n * mi + a.k0_off + c / a.batch;
    uint64_t f[W], fp[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      const size_t idx = (size_t)l2(r) * PFT_MXU_B;
      f[r] = Word<uint64_t>::ldg(t + idx);
      fp[r] = Word<uint64_t>::ldg(t + n + idx);
    }
    // stages log T .. log A - 1 in L2: global stage log T + e, block (u << e) + j
    fwd_stages<LOG_W>(
        v,
        [&](int e, int j, uint64_t& w, uint64_t& wp) {
          const int ti = (1 << (LOG_T + e)) + (u << e) + j;
          w = sm[ti];
          wp = sm[A + ti];
        },
        q);
    // the twiddle tw[r0][k0]
#pragma unroll
    for (int r = 0; r < W; ++r) v[r] = shoup64_lazy(v[r], f[r], fp[r], q);
  } else {
    // stages 0 .. log W - 1 in L2 (all but the last where T = 1): stage e's
    // block u (W >> (e + 1)) + j
    inv_stages<LOG_W, (LOG_T > 0 ? LOG_W : LOG_W - 1)>(
        v,
        [&](int e, int j, uint64_t& w, uint64_t& wp) {
          const int ti = 1 + A - (A >> e) + u * (W >> (e + 1)) + j;
          w = sm[ti];
          wp = sm[A + ti];
        },
        q);
    const uint64_t fy = sm[0], fyp = sm[A];  // the last stage's x - y factor
    if constexpr (LOG_T > 0) {
      // L2 -> L1 through the warp's slice
#pragma unroll
      for (int r = 0; r < W; ++r) slots[col_slot<LOG_T, LOG_G, LOG_W>(l2(r), cw)] = v[r];
      __syncwarp();
#pragma unroll
      for (int r = 0; r < W; ++r) v[r] = slots[col_slot<LOG_T, LOG_G, LOG_W>(l1(r), cw)];
      // stages log W .. log A - 1 in L1 on each group: stage log W + e's
      // block j >> (e + 1); the last, 1/n folded in, x + y times inv_n and
      // x - y times word 0
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint64_t x[T];
#pragma unroll
        for (int j = 0; j < T; ++j) x[j] = v[j * G + i];
        inv_stages<LOG_T, LOG_T - 1>(
            x,
            [&](int e, int jj, uint64_t& w, uint64_t& wp) {
              const int ti = 1 + A - (A >> (LOG_W + e)) + jj;
              w = sm[ti];
              wp = sm[A + ti];
            },
            q);
#pragma unroll
        for (int j = 0; j < T / 2; ++j) {
          const uint64_t xx = x[j], yy = x[j + T / 2];
          v[j * G + i] = shoup64_lazy(reduce_once64(xx + yy, two_q), m.inv_n, m.inv_n_p, q);
          v[(j + T / 2) * G + i] = shoup64_lazy(xx + two_q - yy, fy, fyp, q);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < W / 2; ++k) {
        const uint64_t x = v[k], y = v[k + W / 2];
        v[k] = shoup64_lazy(reduce_once64(x + y, two_q), m.inv_n, m.inv_n_p, q);
        v[k + W / 2] = shoup64_lazy(x + two_q - y, fy, fyp, q);
      }
    }
#pragma unroll
    for (int r = 0; r < W; ++r) v[r] = reduce_once64(v[r], q);
  }
  // the store: the forward from L2, the inverse from L1
  if (live) {
#pragma unroll
    for (int r = 0; r < W; ++r)
      a.out[base + (size_t)(INVERSE ? l1(r) : l2(r)) * a.lanes + col] = v[r];
  }
}

// Threads a block: 128 at every shape (cmux_mxu_timing.py --split --grids on
// an H100: within 1% of the best of 64, 128 and 256 at phase 16's shards,
// where one block an SM, the rule of pick_rows, was up to 6% slower).
constexpr int COL_THREADS = 128;

template <int LOG_A>
int col_launch(bool inverse, int grid, const ColArgs& a, cudaStream_t st) {
  const size_t smem = col_smem(LOG_A, COL_THREADS);
  if (inverse)
    split_col_kernel<LOG_A, true><<<grid, COL_THREADS, smem, st>>>(a);
  else
    split_col_kernel<LOG_A, false><<<grid, COL_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The column passes K1 and Ki2 on `lanes` lanes of each modulus.
int launch_cols(bool inverse, const void* in, void* out, const void* tab, const void* tw,
                const ModSet64& ms, int lanes, int batch, int k0_off, int log_n, void* stream) {
  if ((((uintptr_t)in | (uintptr_t)out | (uintptr_t)tab | (uintptr_t)tw) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const int log_a = log_n - 7;
  const ColArgs a{(const uint64_t*)in, (uint64_t*)out, (const uint64_t*)tab, (const uint64_t*)tw,
                  ms, lanes, batch, k0_off, log_n};
  const int per_block = COL_THREADS >> col_log_t(log_a);
  const int grid = ms.count * ((lanes + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (log_a) {
    case 1: return col_launch<1>(inverse, grid, a, st);
    case 2: return col_launch<2>(inverse, grid, a, st);
    case 3: return col_launch<3>(inverse, grid, a, st);
    case 4: return col_launch<4>(inverse, grid, a, st);
    case 5: return col_launch<5>(inverse, grid, a, st);
    case 6: return col_launch<6>(inverse, grid, a, st);
    case 7: return col_launch<7>(inverse, grid, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

enum class Split { kK1, kK2, kKi1, kKi2 };

// `extent`: L lanes (column passes) or rows (row passes) of each modulus;
// `w`: the column root table (column passes) or the cyclic one (row
// passes).  `planes` (7 or 8) is checked: every half runs the same kernel
// on either tier.
int launch_split64_any(Split kind, const void* in, void* out, const void* w, const void* tw,
                       const void* key, const void* mod_pack, int count, int extent, int batch,
                       int off, int log_n, int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 14 || extent < 1 || batch < 1 ||
      off < 0 || (planes != 7 && planes != 8))
    return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (kind == Split::kK2 || kind == Split::kKi1)
    return launch_rows(kind == Split::kKi1, in, out, w, tw, key, ms, extent, batch, off, log_n,
                       stream);
  return launch_cols(kind == Split::kKi2, in, out, w, tw, ms, extent, batch, off, log_n, stream);
}

}  // namespace

extern "C" {

// K1 and Ki2: col / col_inv are the tables' A-point column root tables
// ("col" / "col_inv", (count, 2, A)); K2 and Ki1: cyclic / cyclic_inv the
// 128-point cyclic ones ((count, 2, 128)); planes is checked, not used.
int pft_ntt_mxu8_split_k1(const void* in, void* out, const void* col, const void* tw,
                          const void* mod_pack, int count, int lanes, int batch, int k0_off,
                          int log_n, int planes, void* stream) {
  return launch_split64_any(Split::kK1, in, out, col, tw, nullptr, mod_pack, count, lanes, batch,
                            k0_off, log_n, planes, stream);
}

int pft_ntt_mxu8_split_k2(const void* in, void* out, const void* cyclic, const void* tw,
                          const void* mod_pack, int count, int rows, int log_n, int planes,
                          void* stream) {
  return launch_split64_any(Split::kK2, in, out, cyclic, tw, nullptr, mod_pack, count, rows, 1, 0,
                            log_n, planes, stream);
}

int pft_ntt_mxu8_split_ki1(const void* in, void* out, const void* cyclic_inv, const void* tw,
                           const void* key, const void* mod_pack, int count, int rows, int batch,
                           int r0_off, int log_n, int planes, void* stream) {
  return launch_split64_any(Split::kKi1, in, out, cyclic_inv, tw, key, mod_pack, count, rows, batch,
                            r0_off, log_n, planes, stream);
}

int pft_ntt_mxu8_split_ki2(const void* in, void* out, const void* col_inv, const void* tw,
                           const void* mod_pack, int count, int lanes, int log_n, int planes,
                           void* stream) {
  return launch_split64_any(Split::kKi2, in, out, col_inv, tw, nullptr, mod_pack, count, lanes, 1, 0,
                            log_n, planes, stream);
}

}  // extern "C"
