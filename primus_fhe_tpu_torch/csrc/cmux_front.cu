// Kernels F and G: the standalone torus rotation and the CMux front end.
//
// Kernel F, rotate: out[j] = +-v[(j - d) mod N] (negacyclic sign), optionally
//   minus v[j], in u32 words, one degree per ciphertext.  Replaces
//   pallas_rotate (primus_fhe_tpu/ops/rotate_pallas.py:29); its chain of
//   log2(2N) conditional rolls becomes index arithmetic.  The blind
//   rotation runs it once a bootstrap, for the accumulator's initial
//   rotation v * X^-b of the test polynomial: one row broadcast to every
//   ciphertext, written straight into the accumulator's last component.
//   So the kernel takes the source's row stride (0: one broadcast row) and
//   the destination's, and the caller copies nothing around it.
//   - A thread makes 4 output words c .. c+3 at a time and stores them in
//     one 16-byte access.  Their sources e .. e+3 (e = c - d mod 2N) lie in
//     the 8-word window of two aligned 16-byte loads at e - e mod 4 and 4
//     words on (mod 2N); each load's 4 words share one sign (N is a
//     multiple of 4), and the window's shift e mod 4 is the same for every
//     group of a row (c is a multiple of 4), so the wrap and the sign flip
//     cost two loads, two negations and selects on a row-uniform shift.
//   - The source is read in place at its row stride, the one test row
//     (stride 0) from L2 for every block.  A variant that first bulk-copied
//     a block's source rows, or the one broadcast row, into shared memory
//     was slower at every shape timed, so it is not kept.
//   - A block takes max(1, 1024 / N) rows and a thread for each group of 4
//     words, 256 to 1024 (several groups a thread past N = 4096): short
//     rows fill a block, a thread's groups share one row and one degree,
//     loaded first, and phase 13's rows of 2048 make one group a thread.
//   A row shorter than 4 words or a source or destination off 16-byte
//   alignment takes a word at a time (rotated_at).
// Kernel G, cmux_front: the CMux step's front end without its NTT.  The rotate-diff
//   acc * X^d - acc, the signed gadget digits of every level (one carry
//   chain per coefficient, digit_step) and the centered lift of each digit
//   mod each prime, written out as (kp, B, k1, L, N) canonical residues.
//   Replaces pallas_cmux_front (primus_fhe_tpu/ops/cmux_pallas.py:74).
//   - A thread takes a group of 4 coefficients c .. c+3 of a row: F's
//     window read (rotated4) less its own 16-byte load of c .. c+3, four
//     carry chains side by side, and for each level the 4 digits lifted mod
//     each prime (lift_signed: 32-bit Barrett, no branch) and written as
//     one streaming 16-byte store at ((pi rows + row) L + l) N + c: kp L
//     stores a group.  kp is a template parameter, so the prime loop
//     unrolls and each prime's constants are read from the kernel's
//     parameter bank, not from local memory; L stays a runtime loop.
//   - The grid is flat over the groups, a thread each, 128 a block: short
//     rows share a block, long rows span blocks, and phase 13's 128 rows
//     of 2048 make 65,536 threads (the first design ran one block of 256
//     a row, 8 coefficients a thread).  Two or more groups a thread, of one
//     row with one degree load, were slower at every shape timed; blocks
//     of 128 were as fast as 256 but at batch 1, where they spread the
//     work over twice the SMs.
//   Rows shorter than 4 words, or a source off 16-byte alignment, take a
//   coefficient a thread (rotated_at), by F's rule.
//
// What bounds them: both are elementwise over rows in device memory.  F
// reads N words and writes N a row (a broadcast row from L2 after its first
// read); G reads N and writes kp * L * N (6x at BOOLEAN_128), so
// device-memory bytes, not arithmetic, set their time at a large batch.
// Both read and write 16 bytes a thread; at a small batch G's time is one
// thread's chain: the degree's load, the window's, the digits and lifts.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "modarith32.cuh"

namespace {

constexpr int kThreads = 256;  // a word at a time (F)
constexpr int kFrontThreads = 128;  // kernel G
constexpr int kMaxThreads = 1024;  // a block at most
// Rows of up to 2^29 words: every index (a word's source e in [0, 2n), a
// degree mod 2n, a row's groups) stays below 2^30 in an int, and a row's
// offset is a size_t or long long product.  The kernels are elementwise,
// so no ring needs more than that.
constexpr int FG_MAX_LOG_N = 29;

struct RotateArgs {
  const uint32_t* in;
  long long in_stride;  // words from a row to the next; 0: one broadcast row
  uint32_t* out;
  long long out_stride;
  const int32_t* degrees;  // one a ciphertext
  int rows;                // rows a ciphertext
  int total;               // rows in all
  int log_n, block_rows;
};

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Words c .. c+3 of row `src` times X^d (d in [0, 2n), c a multiple of 4,
// src on 16 bytes, n >= 4): their sources e .. e+3, e = c - d mod 2n, lie
// in the 8-word window of the aligned 16-byte loads at e - e mod 4 and 4
// words on (mod 2n); each load's words share one sign (negated at or past
// n), and the shift e mod 4 is the same for every group of a row.
__device__ __forceinline__ uint4 rotated4(const uint32_t* src, int c, int d, int n) {
  int e = c - d;
  if (e < 0) e += 2 * n;  // the source of word c, in [0, 2n)
  const int sh = e & 3, e0 = e - sh;
  const int e1 = e0 + 4 < 2 * n ? e0 + 4 : e0 + 4 - 2 * n;
  const uint4 x = load4(src + (e0 >= n ? e0 - n : e0));
  const uint4 y = load4(src + (e1 >= n ? e1 - n : e1));
  const uint32_t sx = e0 >= n ? ~0u : 0u, sy = e1 >= n ? ~0u : 0u;  // negate: (w ^ s) - s
  const uint32_t w[8] = {(x.x ^ sx) - sx, (x.y ^ sx) - sx, (x.z ^ sx) - sx, (x.w ^ sx) - sx,
                         (y.x ^ sy) - sy, (y.y ^ sy) - sy, (y.z ^ sy) - sy, (y.w ^ sy) - sy};
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = sh == 0 ? w[j] : sh == 1 ? w[j + 1] : sh == 2 ? w[j + 2] : w[j + 3];
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// GROUPS: 4 words a thread in 16-byte accesses, else a word at a time.
template <bool SUB, bool GROUPS>
__global__ void __launch_bounds__(kMaxThreads) rotate_kernel(const RotateArgs a) {
  const int log_n = a.log_n, n = 1 << log_n;
  const int r0 = blockIdx.x * a.block_rows;
  const int count = min(a.block_rows, a.total - r0);
  if constexpr (!GROUPS) {
    for (int it = threadIdx.x; it < (count << log_n); it += blockDim.x) {
      const int row = r0 + (it >> log_n), c = it & (n - 1);
      const int d = degree_mod(__ldg(a.degrees + row / a.rows), n);
      const uint32_t* src = a.in + row * a.in_stride;
      const uint32_t v = rotated_at(src, c, d, n);
      a.out[row * a.out_stride + c] = SUB ? v - src[c] : v;
    }
  } else {
    // A block's 256 or more groups, one a thread up to 1024: one row from
    // n = 1024 on, else 256 groups of 1024 / n rows, so each thread's
    // groups share one row and one degree.
    const int lg = log_n - 2;  // groups of 4 words a row
    const int d = degree_mod(
        __ldg(a.degrees + min(r0 + (int)(threadIdx.x >> lg), a.total - 1) / a.rows), n);
    for (int it = threadIdx.x; it < (count << lg); it += blockDim.x) {
      const int row = r0 + (it >> lg), c = (it & ((1 << lg) - 1)) << 2;
      const uint32_t* src = a.in + row * a.in_stride;
      uint4 v = rotated4(src, c, d, n);
      if constexpr (SUB) {
        const uint4 own = load4(src + c);
        v.x -= own.x, v.y -= own.y, v.z -= own.z, v.w -= own.w;
      }
      *reinterpret_cast<uint4*>(a.out + row * a.out_stride + c) = v;
    }
  }
}

// Kernel F's launch: groups of 4 words where the rows hold them and every
// row starts on 16 bytes, max(1, 1024 / n) rows a block, a thread for each
// group up to 1024 (256 threads a word at a time otherwise).
int launch_rotate(RotateArgs a, int subtract, cudaStream_t stream) {
  const bool groups = a.log_n >= 2 && ((((uintptr_t)a.in | (uintptr_t)a.out) & 15) == 0) &&
                      a.in_stride % 4 == 0 && a.out_stride % 4 == 0;
  a.block_rows = a.log_n >= 10 ? 1 : 1 << (10 - a.log_n);
  const int grid = (a.total + a.block_rows - 1) / a.block_rows;
  const int group_count = (a.block_rows << a.log_n) / 4;
  const int threads = !groups ? kThreads : group_count < kMaxThreads ? group_count : kMaxThreads;
  void (*kernels[2][2])(const RotateArgs) = {
      {rotate_kernel<false, false>, rotate_kernel<false, true>},
      {rotate_kernel<true, false>, rotate_kernel<true, true>}};
  kernels[subtract ? 1 : 0][groups ? 1 : 0]<<<grid, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

struct FrontArgs {
  const uint32_t* acc;     // rows of n words, one after another
  const int32_t* degrees;  // one a ciphertext
  uint32_t* out;           // (kp, rows, L, n)
  PrimeSet ps;
  BasisConsts bc;
  int rows;                // B * k1
  int log_n;
  uint32_t k1_m;           // row / k1 as a multiply: ciphertext_of
  int k1_s1, k1_s2;
};

// A row's ciphertext, row / k1, by Granlund and Montgomery's multiply for
// an invariant divisor (exact for every 32-bit row): t = hi(row m), then
// (t + ((row - t) >> s1)) >> s2, with l = ceil(log2 k1), m = floor(2^32
// (2^l - k1) / k1) + 1, s1 = min(l, 1), s2 = max(l - 1, 0).  It puts a
// multiply in place of the integer division ahead of the degree's load.
__device__ __forceinline__ int ciphertext_of(int row, const FrontArgs& a) {
  const uint32_t t = __umulhi((uint32_t)row, a.k1_m);
  return (int)((t + (((uint32_t)row - t) >> a.k1_s1)) >> a.k1_s2);
}

// lift_mod_p's function, a torus word's centered value v = (int32)x mod
// q, on 32-bit words: |v| mod q by Barrett with m = floor(2^32 / q) (the
// high word of floor(2^64 / q)); |v| <= 2^31 leaves the quotient at most
// one short, so one subtraction; then q - r for v < 0.  The same words for
// every x in about two thirds of lift_mod_p's instructions, and no branch
// (lift_mod_p's compiles to a divergent jump a word).
__device__ __forceinline__ uint32_t lift_signed(uint32_t x, const PrimeConsts& c) {
  const bool neg = (int32_t)x < 0;
  const uint32_t a = neg ? 0u - x : x;
  const uint32_t r = reduce_once(a - __umulhi(a, (uint32_t)(c.ratio >> 32)) * c.q, c.q);
  return neg && r != 0u ? c.q - r : r;
}

// G's stores stream (st.global.cs): its output is read once, by kernel 1.
__device__ __forceinline__ void store4(uint32_t* p, uint4 v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// GROUPS: a thread takes a group of 4 coefficients, written as kp L
// 16-byte stores; else a coefficient a thread.
template <int KP, bool GROUPS>
__global__ void __launch_bounds__(kMaxThreads) cmux_front_kernel(const FrontArgs a) {
  const int log_n = a.log_n, n = 1 << log_n, L = a.bc.level;
  const size_t plane = (size_t)a.rows * L << log_n;  // words a prime
  if constexpr (!GROUPS) {
    const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (it >= ((long long)a.rows << log_n)) return;
    const int row = (int)(it >> log_n), c = (int)(it & (n - 1));
    const int d = __ldg(a.degrees + ciphertext_of(row, a)) & (2 * n - 1);  // mod 2n, any sign
    const uint32_t* src = a.acc + ((size_t)row << log_n);
    const uint32_t diff = rotated_at(src, c, d, n) - src[c];
    uint32_t carry = (diff & a.bc.init_mask) != 0u;
    uint32_t* o = a.out + ((size_t)row * L << log_n) + c;
    for (int l = 0; l < L; ++l, o += n) {
      const uint32_t digit = digit_step(diff, a.bc, l, carry);
#pragma unroll
      for (int pi = 0; pi < KP; ++pi) __stcs(o + pi * plane, lift_signed(digit, a.ps.p[pi]));
    }
  } else {
    const int lg = log_n - 2;  // groups of 4 words a row
    const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (it >= ((long long)a.rows << lg)) return;
    const int row = (int)(it >> lg), c = (int)(it & ((1 << lg) - 1)) << 2;
    const int d = __ldg(a.degrees + ciphertext_of(row, a)) & (2 * n - 1);  // mod 2n, any sign
    const uint32_t* src = a.acc + ((size_t)row << log_n);
    const uint4 own = load4(src + c);
    const uint4 r = rotated4(src, c, d, n);
    const uint32_t diff[4] = {r.x - own.x, r.y - own.y, r.z - own.z, r.w - own.w};
    uint32_t carry[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) carry[k] = (diff[k] & a.bc.init_mask) != 0u;
    uint32_t* o = a.out + ((size_t)row * L << log_n) + c;
    for (int l = 0; l < L; ++l, o += n) {
      uint32_t digit[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) digit[k] = digit_step(diff[k], a.bc, l, carry[k]);
#pragma unroll
      for (int pi = 0; pi < KP; ++pi) {
        const PrimeConsts& p = a.ps.p[pi];
        store4(o + pi * plane, make_uint4(lift_signed(digit[0], p), lift_signed(digit[1], p),
                                          lift_signed(digit[2], p), lift_signed(digit[3], p)));
      }
    }
  }
}

using FrontKernel = void (*)(const FrontArgs);

FrontKernel front_kernel(int kp, bool groups) {
  const FrontKernel kernels[PFT_MAX_KP][2] = {
      {cmux_front_kernel<1, false>, cmux_front_kernel<1, true>},
      {cmux_front_kernel<2, false>, cmux_front_kernel<2, true>},
      {cmux_front_kernel<3, false>, cmux_front_kernel<3, true>},
      {cmux_front_kernel<4, false>, cmux_front_kernel<4, true>}};
  return kernels[kp - 1][groups ? 1 : 0];
}

struct FrontLaunch {
  int groups;  // 1: groups of 4 words, 0: a coefficient a thread
  int threads;
  long long grid;
};

// Kernel G's launch, the only copy of the rule: groups of 4 words where
// the rows hold them and the source starts on 16 bytes, else a
// coefficient a thread (F's rule); kFrontThreads threads a block, one
// group or coefficient each.
FrontLaunch front_pick(int rows, int log_n, bool aligned) {
  const bool groups = log_n >= 2 && aligned;
  const long long items = (long long)rows << (groups ? log_n - 2 : log_n);
  const long long grid = (items + kFrontThreads - 1) / kFrontThreads;
  return FrontLaunch{groups ? 1 : 0, kFrontThreads, grid};
}

}  // namespace

extern "C" {

// Kernel F on bsz ciphertexts of `rows` rows of 2^log_n words (log_n
// 1-29): row r of the source at in + r in_stride (in_stride 0: one row for
// all), of the output at out + r out_stride (the two must not overlap),
// degree degrees[r / rows] of any sign.
int pft_rotate(const void* in, long long in_stride, const void* degrees, void* out,
               long long out_stride, int bsz, int rows, int log_n, int subtract, void* stream) {
  if (bsz < 1 || rows < 1 || log_n < 1 || log_n > FG_MAX_LOG_N || in_stride < 0 || out_stride < 1 ||
      (long long)bsz * rows > (1 << 30))
    return (int)cudaErrorInvalidValue;
  RotateArgs a{};
  a.in = (const uint32_t*)in;
  a.in_stride = in_stride;
  a.out = (uint32_t*)out;
  a.out_stride = out_stride;
  a.degrees = (const int32_t*)degrees;
  a.rows = rows;
  a.total = bsz * rows;
  a.log_n = log_n;
  return launch_rotate(a, subtract, (cudaStream_t)stream);
}

int pft_cmux_front(const void* acc, const void* degrees, void* out, const void* prime_pack,
                   const void* basis_pack, int kp, int bsz, int k1, int log_n, void* stream) {
  if (kp < 1 || kp > PFT_MAX_KP || bsz < 1 || k1 < 1 || log_n < 1 || log_n > FG_MAX_LOG_N ||
      (long long)bsz * k1 > (1 << 30) || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  FrontArgs a{};
  a.acc = (const uint32_t*)acc;
  a.degrees = (const int32_t*)degrees;
  a.out = (uint32_t*)out;
  a.ps = unpack_primes((const uint64_t*)prime_pack, kp);
  a.bc = unpack_basis((const uint64_t*)basis_pack);
  a.rows = bsz * k1;
  a.log_n = log_n;
  int l = 0;
  while ((1 << l) < k1) ++l;
  a.k1_m = (uint32_t)((((1ULL << l) - k1) << 32) / k1 + 1);
  a.k1_s1 = l < 1 ? l : 1;
  a.k1_s2 = l > 1 ? l - 1 : 0;
  const FrontLaunch f = front_pick(a.rows, log_n, ((uintptr_t)acc & 15) == 0);
  if (f.grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  front_kernel(kp, f.groups)<<<(unsigned)f.grid, f.threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernels F and G's largest ring: rows of up to 2^FG_MAX_LOG_N words.
int pft_rotate_max_log_n() { return FG_MAX_LOG_N; }

// Kernel G's launch (front_pick): out[0..2] = groups (1) or a coefficient
// a thread (0), threads a block, blocks.
int pft_cmux_front_grid(int rows, int log_n, int aligned, int* out) {
  if (rows < 1 || rows > (1 << 30) || log_n < 1 || log_n > FG_MAX_LOG_N)
    return (int)cudaErrorInvalidValue;
  const FrontLaunch f = front_pick(rows, log_n, aligned != 0);
  out[0] = f.groups;
  out[1] = f.threads;
  out[2] = f.grid > 0x7fffffff ? -1 : (int)f.grid;
  return 0;
}

}  // extern "C"
