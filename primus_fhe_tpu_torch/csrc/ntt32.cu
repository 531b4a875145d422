// Kernels 1 and 2: 32-bit negacyclic NTT and inverse NTT, all primes in one
// launch.
//
// Replaces pallas_forward32 / pallas_inverse32
// (primus_fhe_tpu/ops/ntt_pallas.py, _make_fwd_kernel32 / _make_inv_kernel32).
//
// What bounds them: a row of n = 2048 words is 8 KB in and 8 KB out against
// n/2 log n = 11k Shoup butterflies, so a large batch is bound by device
// memory (256 rows, 4.2 MB: 1.25 us at 3.35 TB/s) and a batch of a few rows
// by latency: the launch, then the chain of dependent shared-memory round
// trips and barriers through the row's log n stages.  The first design (one
// block a row, n/2 threads, one radix-2 butterfly a thread a stage, twiddles
// loaded from global memory at every butterfly) ran 11 barriers a row at n =
// 2048 and took 10x its byte bound at 256 rows.
//
// The design on Hopper:
// - radix-8 register passes (csrc/ntt_passes.cuh, shared with the CMux
//   step kernel and row 10's u64 kernels): a thread holds 8 words in
//   registers through 3 stages, so a transform is ceil(log_n / 3) passes
//   with a barrier between two passes (4 passes, 3 barriers at n = 1024 and
//   2048).  The forward's last pass and
//   the inverse's first take the remainder, R = 1..3 stages.  The forward's
//   first pass reads its groups straight from global memory (a warp's loads
//   are 128 contiguous bytes), and its last pass, whose groups are 2^R
//   adjacent words, stores them straight to global memory, 8 or 16 bytes a
//   thread; the inverse mirrors it (its first pass loads 2^R adjacent words,
//   its last stores a warp's 128 contiguous bytes at a time).  Only the
//   passes in between touch shared memory, and log_n <= 3 (one pass) none.
// - swizzled shared memory (SwzNtt): each warp of every pass hits 32
//   distinct banks (tests/test_torch_ntt32_model.py checks this).
// - root tables staged once a block: the forward's first pass needs only
//   roots[1..7], read into registers; the prime's table and Shoup quotients
//   (16 KB at n = 2048) are copied into shared memory by cp.async under the
//   row loads and the first pass.  The inverse's first pass takes its
//   twiddles (its stages use most of the table) from global memory while
//   the copy of the part the later passes use (the last n / 2^R words of
//   each table) is in flight.
// - a tile of T rows of one prime a block, so that each staged table word
//   serves T rows: grid kp x ceil(rows_per_prime / T), a ragged last tile
//   loading and storing only its own rows.  The C entry picks T (pick_tile)
//   from the rows, the SM count and the blocks an SM holds; no caller sets
//   it.  256 threads a block, several blocks an SM.
//
// The butterflies are the plain version's (transforms/ntt.py) with its lazy
// ranges, applied to the same pairs stage by stage, so every output word is
// bit-equal to it: the forward's bit-reversed output lazy in [0, 4q) or
// canonical, the inverse's normal-order output lazy in [0, 2q) or canonical.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "ntt_passes.cuh"

namespace {

constexpr int NTT_THREADS = 256;
constexpr int MAX_TILE = 8;
constexpr int MAX_LOG_N = 14;
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may ask for

struct NttArgs {
  const uint32_t* in;   // (kp, rows, n)
  uint32_t* out;        // (kp, rows, n)
  const uint32_t* tw;   // (kp, n): the forward's roots or the inverse's
  const uint32_t* twp;  // their Shoup quotients
  PrimeSet ps;
  int rows, log_n, tile;
};

// Words of each root table a block stages: none for one pass; the
// forward's whole table; the part of the inverse's that its passes after
// the first use.
__host__ __device__ inline int staged_words(bool forward, int log_n) {
  if (log_n <= 3) return 0;
  return forward ? 1 << log_n : (1 << log_n) >> remainder_stages(log_n);
}

inline size_t smem_bytes(bool forward, int log_n, int tile) {
  if (log_n <= 3) return 0;
  return sizeof(uint32_t) * (2 * (size_t)staged_words(forward, log_n) + ((size_t)tile << log_n));
}

// The block's tile: prime pi, rows row0 .. row0 + count - 1 of it.
struct Tile {
  int pi, count;
  size_t off;  // word offset of the tile's first row
};

__device__ __forceinline__ Tile block_tile(const NttArgs& a) {
  const int tiles = (a.rows + a.tile - 1) / a.tile;
  const int pi = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - pi * tiles) * a.tile;
  return Tile{pi, min(a.tile, a.rows - row0), ((size_t)pi * a.rows + row0) << a.log_n};
}

// Starts the copy of words [lo, hi) of a prime's table and quotients into
// tw[0 ..), twp[0 ..) (16 bytes a thread a step).
__device__ __forceinline__ void stage_tables(uint32_t* tw, uint32_t* twp, const uint32_t* g,
                                             const uint32_t* gp, int lo, int hi) {
  for (int i = 4 * threadIdx.x; i < hi - lo; i += 4 * blockDim.x) {
    cp_async16(tw + i, g + lo + i);
    cp_async16(twp + i, gp + lo + i);
  }
  cp_async_commit();
}

// A tile's rows in global memory: a group's words in 8- or 16-byte accesses
// where they are adjacent (ls = 0), else one word at a time (a warp's words
// then adjacent).
struct GlobalIn {
  const uint32_t* p;
  int log_n;
  template <int G>
  __device__ __forceinline__ void load(int row, int base, int ls, uint32_t (&v)[G]) const {
    const uint32_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      load_words(r, v);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) v[k] = __ldg(r + (k << ls));
    }
  }
};

// A tile's output rows: a group's words in 8- or 16-byte accesses where
// they are adjacent (the forward's last pass, one pass), else one word at a
// time (the inverse's last pass: slots k n/8 + g, a warp's words adjacent).
// FOLD brings the forward's words from [0, 4q) to canonical.
template <bool FOLD>
struct GlobalOut {
  uint32_t* p;
  int log_n;
  uint32_t q;
  template <int G>
  __device__ __forceinline__ void store(int row, int base, int ls, const uint32_t (&v)[G]) const {
    uint32_t w[G];
#pragma unroll
    for (int k = 0; k < G; ++k) w[k] = FOLD ? reduce_once(reduce_once(v[k], 2u * q), q) : v[k];
    uint32_t* r = p + ((size_t)row << log_n) + base;
    if (ls == 0) {
      store_words(r, w);
    } else {
#pragma unroll
      for (int k = 0; k < G; ++k) r[k << ls] = w[k];
    }
  }
};

template <bool CANON>
__global__ void __launch_bounds__(NTT_THREADS, 4) ntt32_forward_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const uint32_t q = a.ps.p[t.pi].q;
  const uint32_t* groots = a.tw + ((size_t)t.pi << log_n);
  const uint32_t* groots_p = a.twp + ((size_t)t.pi << log_n);
  const GlobalIn src{a.in + t.off, log_n};
  const GlobalOut<CANON> dst{a.out + t.off, log_n, q};
  if (log_n <= 3) {  // one pass, global memory to global memory
    const FwdFirst first(groots, groots_p, n);
    if (log_n == 3) fwd_pass<3>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 2) fwd_pass<2>(t.count, log_n, 0, first, q, src, dst);
    if (log_n == 1) fwd_pass<1>(t.count, log_n, 0, first, q, src, dst);
    return;
  }
  uint32_t* tw = sm;
  uint32_t* twp = sm + n;
  const SmemRows<SwzNtt> rows{sm + 2 * n, log_n};
  stage_tables(tw, twp, groots, groots_p, 0, n);

  // pass 1 (stages 0-2): the tile's rows from global memory, twiddles in
  // registers, under the table copy
  fwd_pass<3>(t.count, log_n, 0, FwdFirst(groots, groots_p, 8), q, src, rows);
  cp_async_wait<0>();
  __syncthreads();

  // the middle passes, radix 8 in shared memory; the last (r stages) stores
  // to global memory
  const int r = remainder_stages(log_n);
  const FwdTable table{tw, twp};
  for (int s0 = 3; s0 < log_n - r; s0 += 3) {
    fwd_pass<3>(t.count, log_n, s0, table, q, rows, rows);
    __syncthreads();
  }
  if (r == 3) fwd_pass<3>(t.count, log_n, log_n - 3, table, q, rows, dst);
  if (r == 2) fwd_pass<2>(t.count, log_n, log_n - 2, table, q, rows, dst);
  if (r == 1) fwd_pass<1>(t.count, log_n, log_n - 1, table, q, rows, dst);
}

template <bool CANON>
__global__ void __launch_bounds__(NTT_THREADS, 4) ntt32_inverse_kernel(const NttArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr Last LAST = CANON ? Last::canonical : Last::lazy;
  const int log_n = a.log_n, n = 1 << log_n;
  const Tile t = block_tile(a);
  const PrimeConsts pc = a.ps.p[t.pi];
  const InvTable global{a.tw + ((size_t)t.pi << log_n), a.twp + ((size_t)t.pi << log_n)};
  const GlobalIn src{a.in + t.off, log_n};
  const GlobalOut<false> dst{a.out + t.off, log_n, pc.q};
  if (log_n <= 3) {  // one pass, global memory to global memory
    if (log_n == 3) inv_pass<3, LAST>(t.count, log_n, 0, global, pc, src, dst);
    if (log_n == 2) inv_pass<2, LAST>(t.count, log_n, 0, global, pc, src, dst);
    if (log_n == 1) inv_pass<1, LAST>(t.count, log_n, 0, global, pc, src, dst);
    return;
  }
  const int r = remainder_stages(log_n);
  const int m = staged_words(false, log_n);  // the later passes' twiddles: [n - m, n)
  uint32_t* tw = sm;
  uint32_t* twp = sm + m;
  const SmemRows<SwzNtt> rows{sm + 2 * m, log_n};
  stage_tables(tw, twp, global.w, global.wp, n - m, n);

  // pass 1 (r stages): 2^r adjacent words a group from global memory, the
  // twiddles from global memory under the table copy
  if (r == 3) inv_pass<3, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  if (r == 2) inv_pass<2, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  if (r == 1) inv_pass<1, Last::no>(t.count, log_n, 0, global, pc, src, rows);
  cp_async_wait<0>();
  __syncthreads();

  // radix-8 passes in shared memory; the last (inv_n folded in) stores to
  // global memory
  inv_rest<LAST>(rows, t.count, log_n, r, InvTable{tw, twp, n - m}, pc, dst);
}

// What the launches read of a device, set up at the first launch there:
// the SM count and, for each kernel, row size and tile, how many blocks an
// SM holds at once (0 where the tile does not fit in shared memory); both
// kernels' shared-memory cap is raised to SMEM_MAX.
struct NttDevice {
  int sms = 0;
  int resident[2][MAX_LOG_N + 1][4] = {};
};

int ntt_device(const NttDevice** out) {
  static NttDevice cached[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  NttDevice& d = cached[dev];
  if (d.sms == 0) {
    NttDevice fresh;
    const void* kernels[4] = {(const void*)ntt32_forward_kernel<true>,
                              (const void*)ntt32_forward_kernel<false>,
                              (const void*)ntt32_inverse_kernel<true>,
                              (const void*)ntt32_inverse_kernel<false>};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&fresh.sms, cudaDevAttrMultiProcessorCount, dev);
    for (int f = 0; f < 2 && e == cudaSuccess; ++f)
      for (int log_n = 1; log_n <= MAX_LOG_N && e == cudaSuccess; ++log_n)
        for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
          const size_t smem = smem_bytes(f == 0, log_n, 1 << i);
          if (smem <= (size_t)SMEM_MAX)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &fresh.resident[f][log_n][i], kernels[2 * f], NTT_THREADS, smem);
        }
    if (e != cudaSuccess) return (int)e;
    d = fresh;
  }
  *out = &d;
  return 0;
}

// Rows a block: the smallest tile T (1, 2, 4 or 8 rows) whose grid of kp
// ceil(rows / T) blocks runs in one wave (the SMs times the blocks an SM
// holds at T), else the largest T that fits (each staged table word then
// serves the most rows).  A smaller tile spreads a transform over more
// SMs; a larger one reads the tables less often.  The only copy of the rule.
int pick_tile(bool forward, int kp, int rows, int log_n, const NttDevice& d) {
  int fit = 1;
  for (int i = 0; i < 4; ++i) {
    const int held = d.resident[forward ? 0 : 1][log_n][i];
    if (held == 0) break;
    fit = 1 << i;
    if ((long)kp * ((rows + fit - 1) / fit) <= (long)d.sms * held) return fit;
  }
  return fit;
}

int launch(bool forward, const void* in, void* out, const void* tw, const void* twp,
           const void* prime_pack, int kp, int rows, int log_n, int canonical, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > MAX_LOG_N || rows < 1 ||
      (((uintptr_t)in | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  NttArgs a{};
  a.in = (const uint32_t*)in;
  a.out = (uint32_t*)out;
  a.tw = (const uint32_t*)tw;
  a.twp = (const uint32_t*)twp;
  a.ps = unpack_primes((const uint64_t*)prime_pack, kp);
  a.rows = rows;
  a.log_n = log_n;
  a.tile = pick_tile(forward, kp, rows, log_n, *d);
  const dim3 grid(kp * ((rows + a.tile - 1) / a.tile));
  const size_t smem = smem_bytes(forward, log_n, a.tile);
  const cudaStream_t s = (cudaStream_t)stream;
  if (forward && canonical) ntt32_forward_kernel<true><<<grid, NTT_THREADS, smem, s>>>(a);
  if (forward && !canonical) ntt32_forward_kernel<false><<<grid, NTT_THREADS, smem, s>>>(a);
  if (!forward && canonical) ntt32_inverse_kernel<true><<<grid, NTT_THREADS, smem, s>>>(a);
  if (!forward && !canonical) ntt32_inverse_kernel<false><<<grid, NTT_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pft_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Forward NTT of kp primes x rows_per_prime rows of 2^log_n words (log_n
// 1-14, kp <= 4; in and out 16-byte aligned): roots, roots_p (kp, n) the
// bit-reversed root tables and Shoup quotients; canonical output or lazy in
// [0, 4q).
int pft_ntt32_forward(const void* in, void* out, const void* roots, const void* roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  return launch(true, in, out, roots, roots_p, prime_pack, kp, rows_per_prime, log_n, canonical,
                stream);
}

// The rows a block the launch takes (pick_tile) on the current device.
int pft_ntt32_tile(int forward, int kp, int rows_per_prime, int log_n, int* tile) {
  if (kp < 1 || kp > PFT_MAX_KP || log_n < 1 || log_n > MAX_LOG_N || rows_per_prime < 1)
    return (int)cudaErrorInvalidValue;
  const NttDevice* d = nullptr;
  const int err = ntt_device(&d);
  if (err != 0) return err;
  *tile = pick_tile(forward != 0, kp, rows_per_prime, log_n, *d);
  return 0;
}

// Inverse NTT, the same shapes: inv_roots, inv_roots_p the inverse tables;
// canonical output or lazy in [0, 2q).
int pft_ntt32_inverse(const void* in, void* out, const void* inv_roots, const void* inv_roots_p,
                      const void* prime_pack, int kp, int rows_per_prime, int log_n,
                      int canonical, void* stream) {
  return launch(false, in, out, inv_roots, inv_roots_p, prime_pack, kp, rows_per_prime, log_n,
                canonical, stream);
}

}  // extern "C"
