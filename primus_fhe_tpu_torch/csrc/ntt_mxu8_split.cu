// Row 13: the four half-transforms of the coefficient-sharded byte-radix NTT
// (7 and 8 byte planes, q < 2^62), one all_to_all apart.
//
// Replace _k1_forward, _k2_forward, _ki1_inverse and _ki2_inverse
// (primus_fhe_tpu/parallel/coeff_sharded_mxu.py:131,184,229,297).  Each is
// one half of a fused kernel of ntt_mxu8.cu, with a device-memory load or
// store where the fused kernel keeps the other half in shared memory:
//
//   K1  = forward pass 1 + twiddle (ntt_mxu8_forward64_kernel, first half),
//   K2  = forward pass 2           (ntt_mxu8_forward64_kernel, second half),
//   Ki1 = inverse pass 1 + twiddle, with kernel D's key multiply at load as
//         an option (ntt_mxu8_inverse64_kernel, first half),
//   Ki2 = inverse pass 2, inv_n folded into wi2 (its second half).
//
// The same plane matrices, twiddles and fold (mxu8_64.cuh) as those kernels,
// on the same Mxu8Tables64 tables: the halves need no table of their own.
//
// Layouts (one modulus a leading index; words are u64 bit patterns):
//   column passes K1, Ki2: (A, L), word [k][lane] at k * L + lane, a lane
//     being a (k0, batch) pair of the shard's B/D lanes: the pass contracts
//     over the A axis of each lane.  A block loads G * 128 lanes, transposed
//     to [lane][k] in shared memory, as the fused kernels' pass 1 does.
//   row passes K2, Ki1: (rows, 128), a row being an (r0, batch) pair of the
//     shard's A/D rows: the pass contracts over the 128 words of each row.
//     A block takes 32 rows.
// A lane's global k0 is k0_off + lane / batch, a row's global r0 is
// r0_off + row / batch: the twiddles are read from the (A, B) tables at
// those indices, where the TPU kernels read copies expanded over the batch.
// Ki1's key is the shard's rows of the fixed operand, (2, (rows / batch) *
// 128): values, then their Shoup quotients.
//
// Outputs: K1 and Ki1 lazy (the Shoup twiddle: [0, 2q), congruent to the
// canonical pass); K2 and Ki2 canonical.  The next half takes any u64 word.
//
// What bounds them, per transform of `rows` polynomials of n = A x 128 words:
// pass 1 is P x 8 x n x A int8 MACs a row, pass 2 P x 8 x n x 128, against
// 16 n bytes in and out of device memory a row per half.  At n = 4096, 7
// planes, the column passes (A = 32) are bound by bytes and the row passes
// by the tensor cores; a simple mma.sync kernel is issue-bound well above
// either (the fused kernels run at ~11x their bound).
//
// One launch covers every modulus of the tables (the grid's leading index).

#include "mxu8_64.cuh"

namespace {

constexpr int SPLIT_ROWS = 32;  // rows of a row-pass block
constexpr size_t SPLIT_ROW_SMEM = (size_t)SPLIT_ROWS * LDA64;

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

template <int P, bool MUL, bool TWIDDLE>
__global__ void __launch_bounds__(256) split_row64_kernel(
    const uint64_t* __restrict__ in, uint64_t* __restrict__ out, const int8_t* __restrict__ w,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ key, ModSet64 ms, int rows,
    int batch, int r0_off, int log_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int B = PFT_MXU_B;
  const int n = 1 << log_n;
  const int blocks = (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const int mi = blockIdx.x / blocks;
  const int row0 = (blockIdx.x % blocks) * SPLIT_ROWS;
  const int m_rows = rows - row0 < SPLIT_ROWS ? rows - row0 : SPLIT_ROWS;
  const Mod64 mc = ms.m[mi];
  const size_t base = ((size_t)mi * rows + row0) * B;

  const int key_words = rows / batch * B;
  const uint64_t* kt = MUL ? key + (size_t)mi * 2 * key_words : nullptr;
  for (int i = threadIdx.x; i < m_rows * B; i += blockDim.x) {
    uint64_t x = in[base + i];
    if constexpr (MUL) {
      const int c = (row0 + i / B) / batch * B + i % B;
      x = shoup64_lazy(x, kt[c], kt[key_words + c], mc.q);
    }
    *(uint64_t*)(smem + (size_t)(i / B) * LDA64 + (i % B) * 8) = x;
  }
  __syncthreads();
  const uint64_t* t = tw + (size_t)mi * 4 * n + 2 * n;  // the inverse twiddles and quotients
  mm_planes_n<true, 2, P>(smem, LDA64, m_rows, w + (size_t)mi * P * B * 8 * B, B, B, 8 * B,
                          [&](int m, int c, const int (&d)[P]) {
                            uint64_t y = fold_planes<P>(d, mc);
                            if constexpr (TWIDDLE) {
                              const int idx = (r0_off + (row0 + m) / batch) * B + c;
                              y = shoup64_lazy(y, t[idx], t[n + idx], mc.q);
                            } else {
                              y = canonical64(y, mc);
                            }
                            out[base + (size_t)m * B + c] = y;
                          });
}

enum class Split { kK1, kK2, kKi1, kKi2 };

template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// `extent`: L lanes (column passes) or rows (row passes) of each modulus.
template <int P>
int launch_split64(Split kind, const void* in, void* out, const void* w, const void* tw,
                   const void* key, const ModSet64& ms, int extent, int batch, int off, int log_n,
                   void* stream) {
  const Geometry64 geo = geometry64(log_n);
  const bool col = kind == Split::kK1 || kind == Split::kKi2;
  const int per_block = col ? geo.G * PFT_MXU_B : SPLIT_ROWS;
  const size_t smem = col ? geo.s_cols : SPLIT_ROW_SMEM;
  const int grid = ms.count * ((extent + per_block - 1) / per_block);
  const auto i64 = (const uint64_t*)in;
  const auto o64 = (uint64_t*)out;
  const auto w8 = (const int8_t*)w;
  const auto t64 = (const uint64_t*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  int err = 0;
  switch (kind) {
    case Split::kK1:
      if ((err = set_smem(split_col64_kernel<P, true>, smem))) return err;
      split_col64_kernel<P, true><<<grid, 256, smem, st>>>(i64, o64, w8, t64, ms, extent, batch,
                                                           off, log_n);
      break;
    case Split::kKi2:
      if ((err = set_smem(split_col64_kernel<P, false>, smem))) return err;
      split_col64_kernel<P, false><<<grid, 256, smem, st>>>(i64, o64, w8, t64, ms, extent, 1, 0,
                                                            log_n);
      break;
    case Split::kK2:
      if ((err = set_smem(split_row64_kernel<P, false, false>, smem))) return err;
      split_row64_kernel<P, false, false><<<grid, 256, smem, st>>>(i64, o64, w8, t64, nullptr, ms,
                                                                   extent, 1, 0, log_n);
      break;
    case Split::kKi1:
      if (key != nullptr) {
        if ((err = set_smem(split_row64_kernel<P, true, true>, smem))) return err;
        split_row64_kernel<P, true, true><<<grid, 256, smem, st>>>(
            i64, o64, w8, t64, (const uint64_t*)key, ms, extent, batch, off, log_n);
      } else {
        if ((err = set_smem(split_row64_kernel<P, false, true>, smem))) return err;
        split_row64_kernel<P, false, true><<<grid, 256, smem, st>>>(i64, o64, w8, t64, nullptr,
                                                                    ms, extent, batch, off, log_n);
      }
      break;
  }
  return (int)cudaGetLastError();
}

int launch_split64_any(Split kind, const void* in, void* out, const void* w, const void* tw,
                       const void* key, const void* mod_pack, int count, int extent, int batch,
                       int off, int log_n, int planes, void* stream) {
  if (count < 1 || count > PFT_MAX_MOD64 || log_n < 8 || log_n > 12 || extent < 1 || batch < 1 ||
      off < 0)
    return (int)cudaErrorInvalidValue;
  const ModSet64 ms = unpack_mod64((const uint64_t*)mod_pack, count);
  if (planes == 7)
    return launch_split64<7>(kind, in, out, w, tw, key, ms, extent, batch, off, log_n, stream);
  if (planes == 8)
    return launch_split64<8>(kind, in, out, w, tw, key, ms, extent, batch, off, log_n, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int pft_ntt_mxu8_split_k1(const void* in, void* out, const void* w1, const void* tw,
                          const void* mod_pack, int count, int lanes, int batch, int k0_off,
                          int log_n, int planes, void* stream) {
  return launch_split64_any(Split::kK1, in, out, w1, tw, nullptr, mod_pack, count, lanes, batch,
                            k0_off, log_n, planes, stream);
}

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
