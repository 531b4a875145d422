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
//   Replaces pallas_cmux_front (primus_fhe_tpu/ops/cmux_pallas.py:74).  One
//   block per accumulator row (ciphertext, component).
//
// What bounds them: both are elementwise over rows in device memory.  F
// reads N words and writes N a row (a broadcast row from L2 after its first
// read);
// G reads N and writes kp * L * N (6x at BOOLEAN_128), so device-memory
// bytes, not arithmetic, set their time; the source row stays in L1/L2 for
// the gathered reads.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "modarith32.cuh"

namespace {

constexpr int kThreads = 256;     // kernel G's block
constexpr int kRotateMaxThreads = 1024;

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

// GROUPS: 4 words a thread in 16-byte accesses, else a word at a time.
template <bool SUB, bool GROUPS>
__global__ void __launch_bounds__(kRotateMaxThreads) rotate_kernel(const RotateArgs a) {
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
      if constexpr (SUB) {
        const uint4 own = load4(src + c);
        v[0] -= own.x, v[1] -= own.y, v[2] -= own.z, v[3] -= own.w;
      }
      *reinterpret_cast<uint4*>(a.out + row * a.out_stride + c) = make_uint4(v[0], v[1], v[2], v[3]);
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
  const int threads = !groups ? kThreads : group_count < kRotateMaxThreads ? group_count
                                                                           : kRotateMaxThreads;
  void (*kernels[2][2])(const RotateArgs) = {
      {rotate_kernel<false, false>, rotate_kernel<false, true>},
      {rotate_kernel<true, false>, rotate_kernel<true, true>}};
  kernels[subtract ? 1 : 0][groups ? 1 : 0]<<<grid, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads) cmux_front_kernel(const uint32_t* __restrict__ acc,
                                                              const int32_t* __restrict__ degrees,
                                                              uint32_t* __restrict__ out,
                                                              PrimeSet ps, BasisConsts bc,
                                                              int rows, int k1, int log_n) {
  const int n = 1 << log_n;
  const int L = bc.level;
  const int row = blockIdx.x;  // b * k1 + j
  const int d = degree_mod(degrees[row / k1], n);
  const uint32_t* a = acc + (size_t)row * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const uint32_t diff = rotated_at(a, c, d, n) - a[c];
    uint32_t carry = (diff & bc.init_mask) != 0u;
    for (int l = 0; l < L; ++l) {
      const uint32_t digit = digit_step(diff, bc, l, carry);
      for (int pi = 0; pi < ps.kp; ++pi)
        out[(((size_t)pi * rows + row) * L + l) * n + c] = lift_mod_p(digit, ps.p[pi]);
    }
  }
}

}  // namespace

extern "C" {

// Kernel F on bsz ciphertexts of `rows` rows of 2^log_n words (log_n
// 1-16): row r of the source at in + r in_stride (in_stride 0: one row for
// all), of the output at out + r out_stride (the two must not overlap),
// degree degrees[r / rows] of any sign.
int pft_rotate(const void* in, long long in_stride, const void* degrees, void* out,
               long long out_stride, int bsz, int rows, int log_n, int subtract, void* stream) {
  if (bsz < 1 || rows < 1 || log_n < 1 || log_n > 16 || in_stride < 0 || out_stride < 1 ||
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
  if (kp < 1 || kp > PFT_MAX_KP || bsz < 1 || k1 < 1 || log_n < 1 || log_n > 16)
    return (int)cudaErrorInvalidValue;
  const PrimeSet ps = unpack_primes((const uint64_t*)prime_pack, kp);
  const BasisConsts bc = unpack_basis((const uint64_t*)basis_pack);
  const int threads = (1 << log_n) < kThreads ? (1 << log_n) : kThreads;
  cmux_front_kernel<<<bsz * k1, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)acc, (const int32_t*)degrees, (uint32_t*)out, ps, bc, bsz * k1, k1, log_n);
  return (int)cudaGetLastError();
}

}  // extern "C"
