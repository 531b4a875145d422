// The four-step's own launches (csrc/ntt_columns.cuh): the column launch of
// every transform past CLUSTER_MAX_LOG_N on u32 and u64 words (kernels 1-2,
// row 10, row 9's four functions, D and E issue it from their own C entries
// through four_step_columns; J's inverse columns come through
// pft_ntt_columns), and the sub-row launch of kernels H and J there
// (mac_sub: the MAC and the sub-row's inverse stages).
//
// Column launch.  A block takes a tile of 2^log_tj adjacent columns of one
// row (col_log_tile: 2^12 words a tile), loads its C 2^log_tj words from
// device memory (a warp's loads adjacent along j), runs the forward's first
// c stages or the inverse's last c on kernel 1's radix-8 passes in shared
// memory (ColRows: a column a padded row), and stores the tile back in
// place, so `out` may be `in`.  The forward takes words below 4q (MODE 0)
// or any u64 word, each brought to [0, 2q) by a lazy Shoup multiply by 1 as
// it loads (MODE 1: row 9's forward64, kernel E), and leaves them lazy in
// [0, 4q) for the sub-row launch; the inverse takes the sub-row launch's
// lazy [0, 2q) words and writes canonical (MODE 0) or lazy [0, 2q) (MODE 1)
// words.  What bounds it: the row's bytes in and out once (8 B a u32 word),
// beside c Shoup butterflies a word pair.
//
// mac_sub (kernels H and J past 2^17): a block a sub-row of 2^13 words of
// one (prime, ciphertext, output component): the MAC of kernel H's
// slice_mac over its `macs` rows into shared memory, the inverse's stages 0
// .. 12 of the row on the sub-row (SliceInvTable at rank h; its twiddles
// and quotients copied into shared memory by cp.async under the MAC, as H
// stages them), and the lazy words out.  The column launch (H's CRT
// epilogue in csrc/cmux_stage2.cu, J's plain inverse columns here) follows.

#include "ntt_columns.cuh"

namespace {

struct ColArgs {
  const void* in;
  void* out;
  const void* tw;   // (count, n) the forward's roots or the inverse's
  const void* twp;  // their Shoup quotients
  int rows, log_n, l, log_tj;  // rows a modulus
};

template <class W>
struct Mods;
template <>
struct Mods<uint32_t> {
  PrimeSet s;
  __device__ __forceinline__ const PrimeConsts& at(int i) const { return s.p[i]; }
  __device__ __forceinline__ uint32_t reduce_any(uint32_t v, int) const { return v; }
};
template <>
struct Mods<uint64_t> {
  ModSet64 s;
  __device__ __forceinline__ const Mod64& at(int i) const { return s.m[i]; }
  __device__ __forceinline__ uint64_t reduce_any(uint64_t v, int i) const {
    return shoup64_lazy(v, 1, s.m[i].p1, s.m[i].q);
  }
};

// The block's tile: the row (over count x rows), its modulus and first column.
struct ColTile {
  long long row;
  int mi, j0;
};

__device__ __forceinline__ ColTile col_tile(const ColArgs& a) {
  const int tiles = 1 << (a.l - a.log_tj);
  const long long row = (long long)blockIdx.x / tiles;
  return ColTile{row, (int)(row / a.rows), (int)(blockIdx.x % tiles) << a.log_tj};
}

template <class W, int MODE>
__global__ void __launch_bounds__(COL_THREADS) columns_forward_kernel(const ColArgs a,
                                                                      const Mods<W> m) {
  extern __shared__ __align__(16) uint8_t col_sm[];
  const ColTile t = col_tile(a);
  const int c = a.log_n - a.l;
  const ColRows<W> tile{reinterpret_cast<W*>(col_sm), (1 << c) + 1};
  const W q = m.at(t.mi).q;
  const size_t off = (size_t)t.row << a.log_n;
  col_load(tile, a.log_tj, c, (const W*)a.in + off, a.l, t.j0,
           [&](W v) { return MODE == 1 ? m.reduce_any(v, t.mi) : v; });
  __syncthreads();
  const size_t mo = (size_t)t.mi << a.log_n;
  col_forward(tile, a.log_tj, c, (const W*)a.tw + mo, (const W*)a.twp + mo, q);
  col_store(tile, a.log_tj, c, (W*)a.out + off, a.l, t.j0);
}

template <class W, int MODE>
__global__ void __launch_bounds__(COL_THREADS) columns_inverse_kernel(const ColArgs a,
                                                                      const Mods<W> m) {
  extern __shared__ __align__(16) uint8_t col_sm[];
  const ColTile t = col_tile(a);
  const int c = a.log_n - a.l;
  const ColRows<W> tile{reinterpret_cast<W*>(col_sm), (1 << c) + 1};
  const size_t off = (size_t)t.row << a.log_n;
  col_load(tile, a.log_tj, c, (const W*)a.in + off, a.l, t.j0, [](W v) { return v; });
  __syncthreads();
  const size_t mo = (size_t)t.mi << a.log_n;
  col_inverse<MODE == 0 ? Last::canonical : Last::lazy>(
      tile, a.log_tj, c, a.log_n, (const W*)a.tw + mo, (const W*)a.twp + mo, m.at(t.mi), tile);
  __syncthreads();
  col_store(tile, a.log_tj, c, (W*)a.out + off, a.l, t.j0);
}

// Shared bytes of a column tile.
inline size_t col_smem(int c, int log_tj, int word_bytes) {
  return (size_t)word_bytes * (((size_t)1 << c) + 1) << log_tj;
}

struct MacSubArgs {
  const uint32_t* f;    // the digits, lazy in [0, 4p)
  const uint32_t* key;  // the key rows, canonical
  uint32_t* out;        // (kp, bsz, k1, n): lazy [0, 2p)
  const uint32_t* w;    // (kp, n) the inverse tables
  const uint32_t* wp;
  PrimeSet ps;
  // word offsets: the digits of (prime, ciphertext) at f + pi f_pi + b f_b,
  // their `macs` rows fs apart; the key rows of (prime, component) at key +
  // pi k_pi + j k_j, ks apart
  size_t f_pi, f_b, fs, k_pi, k_j, ks;
  int k1, bsz, macs, log_n;
};

inline size_t mac_sub_smem() { return sizeof(uint32_t) * (3u << MAC_SUB_LOG); }

// Block ((pi bsz + b) k1 + j) 2^c + h: sub-row h of (prime pi, ciphertext
// b, output component j).
__global__ void __launch_bounds__(SLICE_THREADS, 2) mac_sub_kernel(const MacSubArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int l = MAC_SUB_LOG;
  const int c = a.log_n - l;
  const int h = (int)(blockIdx.x & ((1u << c) - 1));
  const long long r = (long long)(blockIdx.x >> c);  // (pi, b, j)
  const int j = (int)(r % a.k1);
  const long long pb = r / a.k1;
  const int b = (int)(pb % a.bsz), pi = (int)(pb / a.bsz);
  const PrimeConsts pc = a.ps.p[pi];
  const size_t lane0 = (size_t)h << l;
  const SliceInvTable<uint32_t> tab{a.w + ((size_t)pi << a.log_n), a.wp + ((size_t)pi << a.log_n),
                                    l, a.log_n, h};
  uint32_t* const tws = sm + (1 << l);
  uint32_t* const twps = tws + (1 << l);
  stage_slice_table(tab, tws, twps);  // in flight during the MAC
  cp_async_commit();
  slice_mac(a.f + pi * a.f_pi + b * a.f_b + lane0, a.fs, a.key + pi * a.k_pi + j * a.k_j + lane0,
            a.ks, a.macs, l, pc, sm);
  cp_async_wait<0>();
  __syncthreads();
  sub_inverse_store(InvTable<uint32_t>{tws, twps}, pc, sm, l,
                    a.out + ((size_t)r << a.log_n) + lane0);
}

// Column launches the transforms' C entries made, [forward, inverse], since
// pft_ntt_columns_taken last read them.
unsigned long long col_taken[2] = {};

// Raises the kernels' shared-memory cap once a device.
int col_setup() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    const void* kernels[] = {
        (const void*)columns_forward_kernel<uint32_t, 0>,
        (const void*)columns_forward_kernel<uint64_t, 0>,
        (const void*)columns_forward_kernel<uint64_t, 1>,
        (const void*)columns_inverse_kernel<uint32_t, 0>,
        (const void*)columns_inverse_kernel<uint32_t, 1>,
        (const void*)columns_inverse_kernel<uint64_t, 0>,
        (const void*)columns_inverse_kernel<uint64_t, 1>,
        (const void*)mac_sub_kernel};
    for (const void* k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

int columns_launch(int bits, int inverse, int mode, const void* in, void* out, const void* tw,
                   const void* twp, const void* pack, int count, int rows_per_mod, int log_n,
                   int l, void* stream) {
  if ((bits != 32 && bits != 64) || count < 1 || count > 4 || rows_per_mod < 1 ||
      log_n <= CLUSTER_MAX_LOG_N || log_n > FOUR_STEP_MAX_LOG_N || (l != SUB_LOG && l !=
      MAC_SUB_LOG) || mode < 0 || mode > 1 || (bits == 32 && !inverse && mode == 1))
    return (int)cudaErrorInvalidValue;
  const int err = col_setup();
  if (err != 0) return err;
  ColArgs a{in, out, tw, twp, rows_per_mod, log_n, l, col_log_tile(log_n - l, l)};
  const long long blocks = ((long long)count * rows_per_mod) << (l - a.log_tj);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem(log_n - l, a.log_tj, bits / 8);
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks);
  if (bits == 32) {
    const Mods<uint32_t> m{unpack_primes((const uint64_t*)pack, count)};
    if (!inverse)
      columns_forward_kernel<uint32_t, 0><<<grid, COL_THREADS, smem, s>>>(a, m);
    else if (mode == 0)
      columns_inverse_kernel<uint32_t, 0><<<grid, COL_THREADS, smem, s>>>(a, m);
    else
      columns_inverse_kernel<uint32_t, 1><<<grid, COL_THREADS, smem, s>>>(a, m);
  } else {
    const Mods<uint64_t> m{unpack_mod64((const uint64_t*)pack, count)};
    if (!inverse && mode == 0)
      columns_forward_kernel<uint64_t, 0><<<grid, COL_THREADS, smem, s>>>(a, m);
    else if (!inverse)
      columns_forward_kernel<uint64_t, 1><<<grid, COL_THREADS, smem, s>>>(a, m);
    else if (mode == 0)
      columns_inverse_kernel<uint64_t, 0><<<grid, COL_THREADS, smem, s>>>(a, m);
    else
      columns_inverse_kernel<uint64_t, 1><<<grid, COL_THREADS, smem, s>>>(a, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

int four_step_columns(int bits, int inverse, int mode, const void* in, void* out, const void* tw,
                      const void* twp, const void* pack, int count, int rows, int log_n,
                      void* stream) {
  const int err = columns_launch(bits, inverse, mode, in, out, tw, twp, pack, count, rows, log_n,
                                 SUB_LOG, stream);
  if (err == 0) ++col_taken[inverse != 0];
  return err;
}

extern "C" {

// A column launch of the four-step (csrc/ntt_columns.cuh) on count moduli
// x rows_per_mod rows of 2^log_n words (log_n 18-26), sub-rows of 2^l (l
// 13 or 14): bits 32 (u32 words, pack NttTables32.prime_pack, count <= 4)
// or 64 (u64 words, pack mod_pack64, count <= 4); inverse 0 the forward's
// first log_n - l stages (mode 0: words below 4q; 1: any u64 word), 1 the
// inverse's last (mode 0: canonical out; 1: lazy [0, 2q)); tw, twp the
// (count, n) root or inverse tables.  out may be in.  (Kernel J's inverse
// columns; the transforms' C entries issue their own.)
int pft_ntt_columns(int bits, int inverse, int mode, const void* in, void* out, const void* tw,
                    const void* twp, const void* pack, int count, int rows_per_mod, int log_n,
                    int l, void* stream) {
  return columns_launch(bits, inverse, mode, in, out, tw, twp, pack, count, rows_per_mod, log_n,
                        l, stream);
}

// The column launches the transforms' C entries made since the last call
// (inverse 0: the forward's, 1: the inverse's), and zero again.
unsigned long long pft_ntt_columns_taken(int inverse) {
  const int i = inverse != 0;
  const unsigned long long n = col_taken[i];
  col_taken[i] = 0;
  return n;
}

// mac_sub on kp primes x bsz ciphertexts x k1 output components at log_n
// 18-26: pack = kp, k1, bsz, macs, log_n, the six word offsets of
// MacSubArgs (f_pi, f_b, fs, k_pi, k_j, ks), the (kp, n) inverse table and
// quotients' device addresses, then NttTables32.prime_pack.  f, key on 16
// bytes and the row offsets multiples of 4 words.
int pft_mac_sub(const void* f, const void* key, void* out, const void* pack, void* stream) {
  const uint64_t* h = (const uint64_t*)pack;
  MacSubArgs a{};
  const int kp = (int)h[0];
  a.k1 = (int)h[1];
  a.bsz = (int)h[2];
  a.macs = (int)h[3];
  a.log_n = (int)h[4];
  a.f_pi = h[5], a.f_b = h[6], a.fs = h[7], a.k_pi = h[8], a.k_j = h[9], a.ks = h[10];
  if (kp < 1 || kp > PFT_MAX_KP || a.k1 < 1 || a.bsz < 1 || a.macs < 1 ||
      a.log_n <= CLUSTER_MAX_LOG_N || a.log_n > FOUR_STEP_MAX_LOG_N ||
      (((uintptr_t)f | (uintptr_t)key) & 15) != 0 ||
      ((a.f_pi | a.f_b | a.fs | a.k_pi | a.k_j | a.ks) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)kp * a.bsz * a.k1) << (a.log_n - MAC_SUB_LOG);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.w = (const uint32_t*)h[11];
  a.wp = (const uint32_t*)h[12];
  a.ps = unpack_primes(h + 13, kp);
  a.f = (const uint32_t*)f;
  a.key = (const uint32_t*)key;
  a.out = (uint32_t*)out;
  const int err = col_setup();
  if (err != 0) return err;
  mac_sub_kernel<<<(unsigned)blocks, slice_threads(MAC_SUB_LOG), mac_sub_smem(),
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
