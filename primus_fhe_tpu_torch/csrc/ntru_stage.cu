// Kernels I and J: the NGS (NTRU) CMux step on the staged route, for every
// shape kernel B (csrc/cmux_mxu.cu) cannot hold (ops/ntru_cmux_mxu.
// ntru_step_route: log_n 13-16, or a block's plan past 227 KB).  A step is
//   acc <- acc + rot(delta, d) - delta mod q,
//   delta = INTT( sum_l F(digit_l(acc)) evk_i[l] ),
// the function of kernel B and of the JAX's ntru_cmux_step_nat
// (primus_fhe_tpu/ops/ntru_cmux_mxu.py:259, body _make_ntru_kernel).  A
// rotation runs kernel I once, for its first step, then two launches a
// step: kernel 1 (csrc/ntt32.cu) at out_factor 4 in place on the digit
// buffer, and kernel J, which writes the new accumulator and, over the
// buffer, its digits: the next step's kernel-I words.
//
// The digits (chain_start, digit_step in csrc/modarith32.cuh): the mod-q
// signed gadget digits of a canonical word, written as [0, q) residues.
// The JAX body's chain: the pre-adjust above wrap_threshold (v +
// adjust_add), the initial carry, then per level digit_step, whose signed
// branch is temp + (q - B).  The JAX body then subtracts q from a digit
// above B - 1 to feed its int8 planes a signed digit; the residue of that
// digit mod q, which kernel 1 reads, is the chain's own word, so I and J
// store it as it is: the same words as basis.decompose (the plain version).
//
// Kernel I, ntru_digits: the digits of acc (B, n) canonical, L rows of
//   (L, B, n).  Elementwise: a thread takes 4 adjacent words in one 16-byte
//   load and stores each level's 4 digits in one 16-byte streaming store
//   (read once, by kernel 1), 128 threads a block; device-memory bytes
//   bound it (4 bytes in, 4 L out a word).  Alone it ran within ~1 us of an
//   empty launch; a rotation now launches it once.
//
// Kernel J, ntru_stage2: per ciphertext b, a cluster of C blocks, each
// holding a slice of 2^l = n / C words of the row in shared memory
// (csrc/ntt_split.cuh; C = 1-16 from the host's pick_slices, as kernel H:
// the least work a block-wave, slices of 2^10 words or more, so a small
// batch spreads a row over up to 8 SMs at log_n 13):
//   - the MAC (slice_mac): each coefficient sums its L products f[l, b]
//     evk[l] mod q, each lazy digit (kernel 1's [0, 4q)) brought to [0, q)
//     first, the sum Barrett-reduced after every 16 products (kernel H's
//     schedule), a thread a group of 4 coefficients with 16-byte loads, 4
//     levels' loads in flight at once; into shared memory (SwzNtt);
//   - the inverse NTT of the row, canonical: delta.  The slice's stages on
//     kernel 2's radix-8 passes (slice_inverse; at C = 1 the row's own
//     passes), the last lc stages across the slices over distributed
//     shared memory (cross_inverse); a slice of up to 2^13 words copies its
//     twiddles and quotients and acc's words of the slice into shared
//     memory by cp.async while the MAC runs (kernel H's staging), else the
//     passes read their twiddles from device memory;
//   - the rotation: out[g] = acc[g] + (+-delta[(g - d) mod n]) - delta[g]
//     mod q, negated where (g - d) mod 2n >= n.  The rotation needs the
//     whole row of delta: after a cluster barrier each word of the slice
//     reads its source from whichever slice holds it, over distributed
//     shared memory, so delta never goes through device memory;
//   - where the launch asks for digits, each output word's L digits, by
//     the thread that writes the word, as soon as it has it in a register.
//     They may go over f: block (b, s) writes digits only at f's indices
//     [l, b, slice s], which it alone read, in its MAC, before the barrier
//     after the MAC (each read once, so the read-only path's cache serves
//     no word after its write; the next launch reads them).
//   A block reads and writes only its slice of row acc[b], each word by one
//   thread after every read of delta is done, so out may be acc.  What
//   bounds it: at a large batch the bytes of f (4 L n a ciphertext in, as
//   many out with the digits); at a small one the latency of a row's
//   chain, which the slices shorten.  The MAC of a 2^30 prime: every
//   product of a canonical digit and a canonical key word is below 2^60, 16
//   of them and a remainder below 2q stay below 2^64.
// Both are bit-equal to their plain versions (ops/ntru_cmux_mxu.py;
// tests/test_torch_ntru_staged.py models J's index maps and the digits'
// writes over f).  Past J_MAX_LOG_N J is three launches around the
// four-step (below; tests/test_torch_four_step_model.py).
//
// Values are u32 words (int32 storage on the PyTorch side).

#include "ntt_columns.cuh"

namespace {

constexpr int I_THREADS = 128;
constexpr int J_MAX_LEVEL = 32;
constexpr int J_MIN_LOG_N = 4, J_MAX_LOG_N = 17;
constexpr int J_SLICE_MAX_LOG = 15;  // a block's slice: at most 128 KB
constexpr int J_SLICE_MIN_LOG = 10;  // split a row only into slices of 2^10 words or more
constexpr int J_MAX_LC = 4;          // C <= 16

// The digits' chain: the basis and the pre-adjust (wrap_thr 0: none).
struct DigitChain {
  BasisConsts bc;
  uint32_t wrap_thr, adj_add;
};

// From the host pack of ops/cmux_fused._basis_pack (mod-q mode).
inline DigitChain unpack_chain(const uint64_t* h) {
  return DigitChain{unpack_basis(h), (uint32_t)h[7], (uint32_t)h[8]};
}

// The chain's start on canonical word v: the pre-adjust (in place), then
// the initial carry; digit_step(v, bc, l, carry) gives level l's digit.
__device__ __forceinline__ uint32_t chain_start(uint32_t& v, const DigitChain& dc) {
  if (dc.wrap_thr != 0u && v >= dc.wrap_thr) v += dc.adj_add;
  return (v & dc.bc.init_mask) != 0u;
}

struct DigitArgs {
  const uint32_t* acc;  // (words) canonical mod q
  uint32_t* out;        // (L, words)
  DigitChain dc;
  long long groups;  // words / 4
};

__global__ void __launch_bounds__(I_THREADS) ntru_digits_kernel(const DigitArgs a) {
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= a.groups) return;
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(a.acc) + it);
  uint32_t v[4] = {x.x, x.y, x.z, x.w}, carry[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) carry[k] = chain_start(v[k], a.dc);
  uint4* o = reinterpret_cast<uint4*>(a.out) + it;
  for (int l = 0; l < a.dc.bc.level; ++l, o += a.groups) {
    uint32_t d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = digit_step(v[k], a.dc.bc, l, carry[k]);
    __stcs(o, make_uint4(d[0], d[1], d[2], d[3]));
  }
}

struct Stage2Args {
  const uint32_t* f;        // (L, bsz, n), lazy in [0, 4q)
  const uint32_t* evk;      // (L, n), canonical
  const uint32_t* acc;      // (bsz, n), canonical; may alias out
  const int32_t* degrees;   // (bsz,), any sign
  uint32_t* out;
  uint32_t* digits;  // (L, bsz, n): the output's digits, or nullptr; may be f
  const uint32_t* inv_roots;  // (n,) each
  const uint32_t* inv_roots_p;
  PrimeConsts pc;
  DigitChain dc;  // where digits: L levels mod q
  int level, log_n, bsz;
};

// Shared words of a block of kernel J on a slice of 2^l words: the slice;
// where it stages (l <= STAGE_MAX_LOG) also the slice's inverse twiddles
// and quotients and acc's words of the slice (2^l each).
inline size_t j_smem(int l) {
  return sizeof(uint32_t) << (l <= STAGE_MAX_LOG ? l + 2 : l);
}

template <int LC, bool STAGE>
__global__ void __launch_bounds__(SLICE_THREADS, LC < 4 ? 2 : 1)
    ntru_stage2_kernel(const Stage2Args a) {
  extern __shared__ __align__(16) uint32_t sm[];
  constexpr int C = 1 << LC;
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // this block's slice of the row
  const int b = (int)blockIdx.x >> LC;
  const int log_n = a.log_n, l = log_n - LC, nl = 1 << l, n = 1 << log_n;
  const PrimeConsts pc = a.pc;
  const uint32_t q = pc.q;
  const size_t lane0 = (size_t)s << l;
  const size_t row = ((size_t)b << log_n) + lane0;  // this slice of acc[b]
  uint32_t* const tws = sm + nl;  // STAGE: the slice's inverse twiddles,
  uint32_t* const twps = tws + nl;  // their quotients,
  uint32_t* const accs = twps + nl;  // acc's words of the slice
  if constexpr (STAGE) {  // in flight during the MAC
    stage_slice_table(SliceInvTable{a.inv_roots, a.inv_roots_p, l, log_n, s}, tws, twps);
    for (int c = threadIdx.x; c < nl; c += blockDim.x) cp_async4(accs + c, a.acc + row + c);
    cp_async_commit();
  }

  // 1. the MAC of the slice's coefficients: f[lv, b] x evk[lv]
  slice_mac(a.f + ((size_t)b << log_n) + lane0, (size_t)a.bsz << log_n, a.evk + lane0,
            (size_t)1 << log_n, a.level, l, pc, sm);
  if constexpr (STAGE) cp_async_wait<0>();
  __syncthreads();

  // 2. the inverse NTT, canonical, back into the slice: delta
  const SmemRows<SwzNtt> rows{sm, l};
  const auto inverse = [&](const auto& tw) {
    if constexpr (LC == 0) {
      const int r = remainder_stages(l);
      if (r == 3) inv_pass<3, Last::no>(1, l, 0, tw, pc, rows, rows);
      if (r == 2) inv_pass<2, Last::no>(1, l, 0, tw, pc, rows, rows);
      if (r == 1) inv_pass<1, Last::no>(1, l, 0, tw, pc, rows, rows);
      __syncthreads();
      inv_rest<Last::canonical>(rows, 1, l, r, tw, pc, rows);
      __syncthreads();
    } else {
      slice_inverse(tw, pc, rows, rows, l);
      cross_inverse<LC, Last::canonical>(
          sm, l, log_n, s, 0, a.inv_roots, a.inv_roots_p, pc,
          [&](int c, const uint32_t (&v)[C]) {
#pragma unroll
            for (int k = 0; k < C; ++k) *cluster.map_shared_rank(sm + SwzNtt::at(c), k) = v[k];
          });
      cluster.sync();  // every slice's delta in place
    }
  };
  if constexpr (STAGE)
    inverse(InvTable<uint32_t>{tws, twps});
  else if constexpr (LC == 0)
    inverse(InvTable<uint32_t>{a.inv_roots, a.inv_roots_p});
  else
    inverse(SliceInvTable{a.inv_roots, a.inv_roots_p, l, log_n, s});

  // 3. the rotation: word g of this slice takes +-delta[(g - d) mod n] from
  //    the slice that holds it, less delta[g], plus acc[g], mod q
  int d = __ldg(a.degrees + b) % (2 * n);
  if (d < 0) d += 2 * n;
  for (int c = threadIdx.x; c < nl; c += blockDim.x) {
    const int g = (int)lane0 + c;
    int e = g - d;
    if (e < 0) e += 2 * n;
    const bool neg = e >= n;
    const int src = neg ? e - n : e;
    uint32_t r;
    if constexpr (LC == 0)
      r = sm[SwzNtt::at(src)];
    else
      r = *cluster.map_shared_rank(sm + SwzNtt::at(src & (nl - 1)), src >> l);
    if (neg && r != 0u) r = q - r;
    const uint32_t own = sm[SwzNtt::at(c)];
    const uint32_t t = r >= own ? r - own : r + q - own;
    uint32_t v = reduce_once((STAGE ? accs[c] : a.acc[row + c]) + t, q);
    a.out[row + c] = v;
    if (a.digits != nullptr) {  // 4. the next step's digits of the word
      uint32_t carry = chain_start(v, a.dc);
      uint32_t* o = a.digits + row + c;
      for (int lv = 0; lv < a.level; ++lv, o += (size_t)a.bsz << log_n)
        *o = digit_step(v, a.dc.bc, lv, carry);
    }
  }
  if constexpr (LC != 0) cluster.sync();  // keep every slice alive until its peers' reads are done
}

// [lc][stage]
const void* const J_KERNELS[J_MAX_LC + 1][2] = {
    {(const void*)ntru_stage2_kernel<0, false>, (const void*)ntru_stage2_kernel<0, true>},
    {(const void*)ntru_stage2_kernel<1, false>, (const void*)ntru_stage2_kernel<1, true>},
    {(const void*)ntru_stage2_kernel<2, false>, (const void*)ntru_stage2_kernel<2, true>},
    {(const void*)ntru_stage2_kernel<3, false>, (const void*)ntru_stage2_kernel<3, true>},
    {(const void*)ntru_stage2_kernel<4, false>, (const void*)ntru_stage2_kernel<4, true>}};

// Clusters of kernel J the card holds at once, by (log_n, lc), on each
// device: asked at the first pick of the shape (-1 before); 0 where the
// launch does not fit.
int j_held(int log_n, int lc, int* held) {
  static int cached[64][J_MAX_LOG_N + 1][J_MAX_LC + 1];
  static bool init[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!init[dev]) {
    for (const auto& per_lc : J_KERNELS)
      for (const void* k : per_lc) {
        e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(sizeof(uint32_t) << J_SLICE_MAX_LOG));
        if (e == cudaSuccess)
          e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
      }
    for (auto& per_n : cached[dev])
      for (int& v : per_n) v = -1;
    init[dev] = true;
  }
  int& v = cached[dev][log_n][lc];
  if (v < 0) {
    const int l = log_n - lc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1 << lc);
    cfg.blockDim = dim3(slice_threads(l));
    cfg.dynamicSmemBytes = j_smem(l);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1 << lc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    e = cudaOccupancyMaxActiveClusters(&count, J_KERNELS[lc][l <= STAGE_MAX_LOG], &cfg);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();  // a size the card refuses: holds none
      count = 0;
    }
    v = count;
  }
  *held = v;
  return 0;
}

// Past J_MAX_LOG_N kernel J is split around the four-step
// (csrc/ntt_columns.cuh) into three launches: mac_sub (csrc/ntt_columns.cu:
// J's MAC and the inverse's stages within each sub-row of 2^13 words, lazy
// words to device memory), the inverse's column launch (pft_ntt_columns:
// the last log_n - 13 stages, canonical: delta), and this one, which the
// rotation needs alone since its source words cross sub-rows: word g of
// row b, out = acc + (+-delta[(g - d) mod n]) - delta[g] mod q (negated
// where (g - d) mod 2n >= n), and its L digits where the launch asks for
// them (chain_start, digit_step: kernel J's), at (L, bsz, n) (which may be
// the digits the MAC read: mac_sub ran before).  A thread a word; each
// word of acc read and written by one thread, so out may be acc.
struct FinishArgs {
  const uint32_t* delta;   // (bsz, n) canonical
  const uint32_t* acc;     // (bsz, n) canonical; may alias out
  const int32_t* degrees;  // (bsz,), any sign
  uint32_t* out;
  uint32_t* digits;  // (L, bsz, n), or nullptr
  uint32_t q;
  DigitChain dc;
  int log_n, bsz;
};

__global__ void __launch_bounds__(I_THREADS) ntru_finish_kernel(const FinishArgs a) {
  const long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long words = (long long)a.bsz << a.log_n;
  if (it >= words) return;
  const int n = 1 << a.log_n;
  const int b = (int)(it >> a.log_n), g = (int)(it & (n - 1));
  const int d = degree_mod(__ldg(a.degrees + b), n);
  const uint32_t* row = a.delta + ((size_t)b << a.log_n);
  int e = g - d;
  if (e < 0) e += 2 * n;
  const bool neg = e >= n;
  uint32_t r = __ldg(row + (neg ? e - n : e));
  if (neg && r != 0u) r = a.q - r;
  const uint32_t own = __ldg(row + g);
  const uint32_t t = r >= own ? r - own : r + a.q - own;
  uint32_t v = reduce_once(a.acc[it] + t, a.q);
  a.out[it] = v;
  if (a.digits != nullptr) {
    uint32_t carry = chain_start(v, a.dc);
    uint32_t* o = a.digits + it;
    for (int lv = 0; lv < a.dc.bc.level; ++lv, o += words) *o = digit_step(v, a.dc.bc, lv, carry);
  }
}

// Kernel J's slices a row for bsz ciphertexts at log_n: pick_slices over
// the clusters the card holds.
int j_pick(int bsz, int log_n, int* lc, int* held) {
  return pick_slices(
      bsz, 1, log_n, J_SLICE_MIN_LOG, J_SLICE_MAX_LOG,
      [&](int c, int* count) { return j_held(log_n, c, count); }, lc, held);
}

}  // namespace

extern "C" {

// Kernel I on `words` canonical words mod q (a multiple of 4; acc and out
// on 16 bytes): out (L, words) the residues of the digits.  basis_pack: the
// host pack of ops/cmux_fused._basis_pack (10 words, mod-q mode).
int pft_ntru_digits(const void* acc, void* out, const void* basis_pack, long long words,
                    void* stream) {
  const uint64_t* h = (const uint64_t*)basis_pack;
  if (words < 4 || words % 4 != 0 || (((uintptr_t)acc | (uintptr_t)out) & 15) != 0 || h[0] < 1 ||
      h[0] > 64 || h[9] == 0)
    return (int)cudaErrorInvalidValue;
  DigitArgs a{};
  a.acc = (const uint32_t*)acc;
  a.out = (uint32_t*)out;
  a.dc = unpack_chain(h);
  a.groups = words / 4;
  const long long grid = (a.groups + I_THREADS - 1) / I_THREADS;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ntru_digits_kernel<<<(unsigned)grid, I_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel J on bsz ciphertexts.  plan: the host pack of
// ops/ntru_cmux_mxu.stage2_pack (L, log_n, the inverse table and its
// quotients' device addresses, NttTables32.prime_pack of q, then the
// digits' basis pack).  L 1-32, log_n 4-17; f and evk on 16 bytes; out may
// be acc; digits (L, bsz, n) or nullptr, may be f (a basis mod q of L
// levels in the pack).
int pft_ntru_stage2(const void* f, const void* evk, const void* acc, const void* degrees,
                    void* out, void* digits, int bsz, const void* plan, void* stream) {
  const uint64_t* h = (const uint64_t*)plan;
  Stage2Args a{};
  a.level = (int)h[0];
  a.log_n = (int)h[1];
  if (a.level < 1 || a.level > J_MAX_LEVEL || a.log_n < J_MIN_LOG_N || a.log_n > J_MAX_LOG_N ||
      bsz < 1 || bsz > (1 << 24) || (((uintptr_t)f | (uintptr_t)evk) & 15) != 0 ||
      (digits != nullptr && (h[11] != h[0] || h[20] != h[4])))
    return (int)cudaErrorInvalidValue;
  a.inv_roots = (const uint32_t*)h[2];
  a.inv_roots_p = (const uint32_t*)h[3];
  a.pc = unpack_primes(h + 4, 1).p[0];
  a.digits = (uint32_t*)digits;
  a.dc = unpack_chain(h + 11);
  a.f = (const uint32_t*)f;
  a.evk = (const uint32_t*)evk;
  a.acc = (const uint32_t*)acc;
  a.degrees = (const int32_t*)degrees;
  a.out = (uint32_t*)out;
  a.bsz = bsz;
  int lc = 0, held = 0;
  const int err = j_pick(bsz, a.log_n, &lc, &held);
  if (err != 0) return err;
  const int l = a.log_n - lc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bsz << lc);
  cfg.blockDim = dim3(slice_threads(l));
  cfg.dynamicSmemBytes = j_smem(l);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << lc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, J_KERNELS[lc][l <= STAGE_MAX_LOG], args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel J's last launch past J_MAX_LOG_N (log_n 18-26), after mac_sub and
// the inverse's column launch wrote delta (bsz, n) canonical: acc +
// rot(delta, d) - delta into out (may be acc), and with digits (L, bsz, n)
// the output's digits.  plan: pft_ntru_stage2's pack (its basis with the
// digits).
int pft_ntru_finish(const void* delta, const void* acc, const void* degrees, void* out,
                    void* digits, int bsz, const void* plan, void* stream) {
  const uint64_t* h = (const uint64_t*)plan;
  FinishArgs a{};
  a.log_n = (int)h[1];
  if (a.log_n <= J_MAX_LOG_N || a.log_n > FOUR_STEP_MAX_LOG_N || bsz < 1 || bsz > (1 << 24) ||
      (digits != nullptr && (h[11] != h[0] || h[20] != h[4])))
    return (int)cudaErrorInvalidValue;
  a.q = (uint32_t)h[4];
  a.dc = unpack_chain(h + 11);
  a.delta = (const uint32_t*)delta;
  a.acc = (const uint32_t*)acc;
  a.degrees = (const int32_t*)degrees;
  a.out = (uint32_t*)out;
  a.digits = (uint32_t*)digits;
  a.bsz = bsz;
  const long long blocks = (((long long)bsz << a.log_n) + I_THREADS - 1) / I_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntru_finish_kernel<<<(unsigned)blocks, I_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Kernel J's launch on the current device for bsz ciphertexts at log_n:
// out[0..3] = the blocks a row (a cluster), threads a block, shared bytes
// a block, clusters the card holds at once.
int pft_ntru_stage2_grid(int log_n, int bsz, int* out) {
  if (log_n < J_MIN_LOG_N || log_n > J_MAX_LOG_N || bsz < 1 || bsz > (1 << 24))
    return (int)cudaErrorInvalidValue;
  int lc = 0, held = 0;
  const int err = j_pick(bsz, log_n, &lc, &held);
  if (err != 0) return err;
  out[0] = 1 << lc;
  out[1] = slice_threads(log_n - lc);
  out[2] = (int)j_smem(log_n - lc);
  out[3] = held;
  return 0;
}

}  // extern "C"
