// Row 13: the four half-transforms of the coefficient-sharded byte-radix NTT
// (7 and 8 byte planes, q < 2^62), one all_to_all apart.
//
// Replace _k1_forward, _k2_forward, _ki1_inverse and _ki2_inverse
// (primus_fhe_tpu/parallel/coeff_sharded_mxu.py:131,184,229,297; pallas_call
// at :174, :219, :287, :332):
//
//   K1  = forward pass 1 + twiddle (ntt_mxu8_forward64_kernel's first half),
//   K2  = forward pass 2: each row's 128-point cyclic transform,
//   Ki1 = inverse pass 1 + twiddle, with kernel D's key multiply at load as
//         an option: each row's inverse 128-point cyclic transform,
//   Ki2 = inverse pass 2, inv_n folded into wi2 (ntt_mxu8.cu's second half).
//
// K1 and Ki2, the column halves, run the fused kernels' plane matrices,
// twiddles and fold (mxu8_64.cuh) on the same Mxu8Tables64 tables.  K2 and
// Ki1, the row halves, run butterflies (split_row_kernel, below), on the
// tables' 128-point cyclic root tables ("cyclic", "cyclic_inv").
//
// Layouts (one modulus a leading index; words are u64 bit patterns):
//   column passes K1, Ki2: (A, L), word [k][lane] at k * L + lane, a lane
//     being a (k0, batch) pair of the shard's B/D lanes: the pass contracts
//     over the A axis of each lane.  A block loads G * 128 lanes, transposed
//     to [lane][k] in shared memory, as the fused kernels' pass 1 does.
//   row passes K2, Ki1: (rows, 128), a row being an (r0, batch) pair of the
//     shard's A/D rows: the pass contracts over the 128 words of each row.
// A lane's global k0 is k0_off + lane / batch, a row's global r0 is
// r0_off + row / batch: the twiddles are read from the (A, B) tables at
// those indices, where the TPU kernels read copies expanded over the batch.
// Ki1's key is the shard's rows of the fixed operand, (2, (rows / batch) *
// 128): values, then their Shoup quotients.
//
// Outputs: K1 and Ki1 lazy (the Shoup twiddle: [0, 2q), congruent to the
// canonical pass); K2 and Ki2 canonical.  The next half takes any u64 word.
//
// What bounds the column halves, per transform of `rows` polynomials of n =
// A x 128 words: pass 1 is P x 8 x n x A int8 MACs a row against 16 n bytes
// in and out of device memory a row per half: at n = 4096, 7 planes, bound
// by bytes; a simple mma.sync kernel is issue-bound well above it.
//
// One launch covers every modulus of the tables (the grid's leading index).

#include "mxu8_64.cuh"
#include "ntt_passes.cuh"

namespace {

template <int P, bool TWIDDLE>
__global__ void __launch_bounds__(256) split_col64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ w,
    const uint64_t* __restrict__ tw, ModSet64 ms, int L, int batch, int k0_off, int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry64 geo = geometry64(log_n);
  const int n = geo.n, A = geo.A, LB = geo.G * PFT_MXU_B;
  const int blocks = (L + LB - 1) / LB;
  const int mi = blockIdx.x / blocks;
  const int lane0 = (blockIdx.x % blocks) * LB;
  const int m_rows = L - lane0 < LB ? L - lane0 : LB;
  const Mod64 mc = ms.m[mi];
  const size_t base = (size_t)mi * A * L;

  for (int i = threadIdx.x; i < A * m_rows; i += blockDim.x) {
    const int k = i / m_rows, m = i % m_rows;
    *(uint64_t*)(smem + (size_t)m * geo.lda1 + k * 8) = in[base + (size_t)k * L + lane0 + m];
  }
  __syncthreads();
  const uint64_t* t = tw + (size_t)mi * 4 * n;  // the forward twiddles and quotients
  mm_planes_n<true, 2, P>(smem, geo.lda1, m_rows, w + (size_t)mi * P * geo.np1 * geo.kb1, geo.np1,
                          A, geo.kb1, [&](int m, int r, const int (&d)[P]) {
                            const int lane = lane0 + m;
                            uint64_t y = fold_planes<P>(d, mc);
                            if constexpr (TWIDDLE) {
                              const int idx = r * PFT_MXU_B + k0_off + lane / batch;
                              y = shoup64_lazy(y, t[idx], t[n + idx], mc.q);
                            } else {
                              y = canonical64(y, mc);
                            }
                            out[base + (size_t)r * L + lane] = y;
                          });
}

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

enum class Split { kK1, kK2, kKi1, kKi2 };

template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The column passes K1 and Ki2 on `lanes` lanes of each modulus.
template <int P>
int launch_cols(Split kind, const void* in, void* out, const void* w, const void* tw,
                const ModSet64& ms, int lanes, int batch, int k0_off, int log_n, void* stream) {
  const Geometry64 geo = geometry64(log_n);
  const int per_block = geo.G * PFT_MXU_B;
  const size_t smem = geo.s_cols;
  const int grid = ms.count * ((lanes + per_block - 1) / per_block);
  const auto i64 = (const uint64_t*)in;
  const auto o64 = (uint64_t*)out;
  const auto w8 = (const int8_t*)w;
  const auto t64 = (const uint64_t*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  if (kind == Split::kK1) {
    if ((err = set_smem(split_col64_kernel<P, true>, smem))) return err;
    split_col64_kernel<P, true><<<grid, 256, smem, st>>>(i64, o64, w8, t64, ms, lanes, batch,
                                                         k0_off, log_n);
  } else {
    if ((err = set_smem(split_col64_kernel<P, false>, smem))) return err;
    split_col64_kernel<P, false><<<grid, 256, smem, st>>>(i64, o64, w8, t64, ms, lanes, 1, 0,
                                                          log_n);
  }
  return (int)cudaGetLastError();
}

// `extent`: L lanes (column passes) or rows (row passes) of each modulus;
// `w`: the plane matrix (column passes) or the cyclic root table (row
// passes).
int launch_split64_any(Split kind, const void* in, void* out, const void* w, const void* tw,
                       const void* key, const void* mod_pack, int count, int extent, int batch,
                       int off, int log_n, int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 12 || extent < 1 || batch < 1 ||
      off < 0 || (planes != 7 && planes != 8))
    return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (kind == Split::kK2 || kind == Split::kKi1)
    return launch_rows(kind == Split::kKi1, in, out, w, tw, key, ms, extent, batch, off, log_n,
                       stream);
  if (planes == 7)
    return launch_cols<7>(kind, in, out, w, tw, ms, extent, batch, off, log_n, stream);
  return launch_cols<8>(kind, in, out, w, tw, ms, extent, batch, off, log_n, stream);
}

}  // namespace

extern "C" {

int pft_ntt_mxu8_split_k1(const void* in, void* out, const void* w1, const void* tw,
                          const void* mod_pack, int count, int lanes, int batch, int k0_off,
                          int log_n, int planes, void* stream) {
  return launch_split64_any(Split::kK1, in, out, w1, tw, nullptr, mod_pack, count, lanes, batch,
                            k0_off, log_n, planes, stream);
}

// K2 and Ki1: w2 / wi1 are the tables' 128-point cyclic root tables
// ("cyclic" / "cyclic_inv", (count, 2, 128)); planes is checked, not used.
int pft_ntt_mxu8_split_k2(const void* in, void* out, const void* w2, const void* tw,
                          const void* mod_pack, int count, int rows, int log_n, int planes,
                          void* stream) {
  return launch_split64_any(Split::kK2, in, out, w2, tw, nullptr, mod_pack, count, rows, 1, 0,
                            log_n, planes, stream);
}

int pft_ntt_mxu8_split_ki1(const void* in, void* out, const void* wi1, const void* tw,
                           const void* key, const void* mod_pack, int count, int rows, int batch,
                           int r0_off, int log_n, int planes, void* stream) {
  return launch_split64_any(Split::kKi1, in, out, wi1, tw, key, mod_pack, count, rows, batch,
                            r0_off, log_n, planes, stream);
}

int pft_ntt_mxu8_split_ki2(const void* in, void* out, const void* wi2, const void* tw,
                           const void* mod_pack, int count, int lanes, int log_n, int planes,
                           void* stream) {
  return launch_split64_any(Split::kKi2, in, out, wi2, tw, nullptr, mod_pack, count, lanes, 1, 0,
                            log_n, planes, stream);
}

}  // extern "C"
