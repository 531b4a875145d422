// Kernels 3-4: one blind-rotation CMux step in one launch,
// acc <- acc + (acc * X^d - acc) [external product] GGSW.
//
// Replaces cmux_stage1 and cmux_stage2 (primus_fhe_tpu/ops/cmux_fused.py,
// composed by fused_cmux_step there): one cluster of kp x k1 blocks per
// ciphertext does what the two TPU kernels do, and nothing reaches device
// memory between the phases.
//
// What bounds it: at BOOLEAN_128 and batch 64 the step reads 1.05 MB of
// accumulators and 0.20 MB of key slice and writes 1.05 MB (~0.7 us at
// 3.35 TB/s), against ~37.7 M 32-bit multiplies (768 forward and 256
// inverse NTTs of 2048, 3 a Shoup butterfly, plus the MAC): ~2.3 us, so
// operations.  At batch 1 it is the key slice read (0.2 MB) and, in
// practice, the latency of 4 blocks on 4 SMs (~28k cycles a block on an
// H100: ~10k the digits and forward passes, ~4.5k the MAC, ~9k the inverse
// and the CRT push, ~1.3k each cluster barrier, whose release ptxas lowers
// to MEMBAR.ALL.GPU).  The two-launch version lost
// its time to a round trip of the NTT-domain digits through device memory
// (6.3 MB at batch 64), one barrier per butterfly stage, twiddles loaded
// from global memory per butterfly, and a stage 2 of only bsz * k1 blocks
// running its kp inverse NTTs one after another.
//
// Block (prime pi, accumulator row r) of ciphertext b, cluster rank
// pi * k1 + r:
//   0. starts a bulk load (cp.async) of the prime's forward root table and
//      Shoup quotients into shared memory, and an L2 prefetch of its own key
//      rows key[pi, r], so the key slice streams in behind the forward NTTs;
//   1. reads row r once, rotated by index arithmetic and sign, and runs the
//      signed-digit carry chain once per coefficient: level l's digit is
//      lifted mod p_pi and goes straight into the first radix pass of
//      transform l (its twiddles from global memory, the tables still
//      loading);
//   2. runs the remaining forward passes of all L transforms: each thread
//      holds 8 coefficients of one transform in registers through 3
//      butterfly stages, so a transform takes ceil(log_n / 3) passes with a
//      barrier after each (4 at N = 2048, not 11); then the inverse tables
//      load over the forward ones;
//   3. MAC: partial[j] = sum_l f_l * key[pi, r, l, j] mod p_pi, f_l brought
//      into [0, p) first, the L products (each < 2^60) summed in 64 bits and
//      reduced once per sum, the key words of 4 coefficients loaded
//      together (from L2); partial[j] is stored straight into row r of the
//      partials inbox of block (pi, j) (distributed shared memory);
//   4. cluster barrier; the block owns output component j = r: its first
//      inverse pass adds the k1 inbox rows mod p, and the inverse NTT of the
//      sum runs in its own shared memory, canonical;
//   5. the kp owners of component r split its coefficients n / kp each:
//      the last inverse pass multiplies every output by (P/p_pi)^-1 and
//      stores it into the CRT inbox of the block that owns the coefficient;
//      a cluster barrier, after which no block touches a
//      peer's shared memory; then the exact integer CRT of the kp residues
//      and the wrapping add to acc.
// Peers are written, never read: a store to distributed shared memory does
// not stall the thread, where a load waits out the round trip (on an H100
// the first inverse pass took 5.2k cycles reading the partials from the
// peers, 2.8k summing the pushed ones).
// A block holds 256 threads and at most 80 registers a thread, and its
// shared memory ((2 + kp + L + k1) rows of n words, 72 KB at BOOLEAN_128)
// leaves room for three blocks an SM: the card holds 92 clusters of 4 at
// once, so batch 64 runs in one wave (with the key rows staged in shared
// memory it held 62, and batch 64 took two).
// Shared memory holds rows at a swizzled word index (swz): every 8-word
// radix pass and every coefficient-order sweep of a warp hits 32 distinct
// banks (tests/test_torch_cmux_step_model.py checks the passes, the index
// maps and the ownership against the plain versions).  The radix passes,
// butterflies and swizzle are csrc/ntt_passes.cuh's, shared with kernels
// 1-2 and row 10.
//
// The output is the exact CRT of canonical residues, so it is bit-equal to
// the plain composition whatever the lazy schedule inside (all words stay
// below 4p < 2^32).  out may alias acc: a block writes only coefficients of
// its own row that it read itself, after every block of the cluster has
// read the row.
//
// ptxas (-Xptxas -v, sm_90a): 80 registers, 0 bytes of stack, no spills.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include <cooperative_groups.h>

#include "ntt_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_CLUSTER = 8;   // kp * k1 blocks a ciphertext
constexpr int MAX_K1 = 4;        // accumulator rows (GLWE dimension + 1)
constexpr int MAX_LEVEL = 16;    // L products below 2^60 sum below 2^64
constexpr int SMEM_MAX = 232448;  // 227 KB, the most a block may ask for

struct StepArgs {
  const uint32_t* acc;  // (bsz, k1, n); may alias out
  const int32_t* degrees;
  const uint32_t* key;  // (kp, k1, L, k1, n) canonical
  uint32_t* out;
  const uint32_t* roots;  // (kp, n) each
  const uint32_t* roots_p;
  const uint32_t* inv_roots;
  const uint32_t* inv_roots_p;
  PrimeSet ps;
  CrtConsts crt;
  BasisConsts bc;
  int kp, k1, log_n;
};

// Pass 1 of the forward transforms (stages 0..R-1), fused with the
// rotate-diff and the gadget digits.  Group g holds coefficients
// k * (n >> R) + g; the carry chain of each runs once across the L levels.
// A signed digit is at most B/2 = 2^(log_basis - 1) in magnitude; when that
// is below q (small), its residue is the digit or the digit plus q.
template <int R>
__device__ void digit_pass(uint32_t* rows, const uint32_t* a, int d, const BasisConsts& bc,
                           const PrimeConsts& pc, const uint32_t* roots, const uint32_t* roots_p,
                           int log_n) {
  const bool small = bc.log_basis <= 30 && (1u << (bc.log_basis - 1)) < pc.q;
  constexpr int G = 1 << R;
  const int n = 1 << log_n;
  const int log_tl = log_n - R;
  uint32_t w[G], wp[G];  // roots[1 .. G-1], the stages' blocks in order
#pragma unroll
  for (int i = 1; i < G; ++i) {
    w[i] = __ldg(roots + i);
    wp[i] = __ldg(roots_p + i);
  }
  for (int g = threadIdx.x; g < (n >> R); g += blockDim.x) {
    uint32_t diff[G], carry[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int c = (k << log_tl) + g;
      diff[k] = rotated_at(a, c, d, n) - a[c];
      carry[k] = (diff[k] & bc.init_mask) != 0u;
    }
    for (int l = 0; l < bc.level; ++l) {
      uint32_t v[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const uint32_t dg = digit_step(diff[k], bc, l, carry[k]);
        v[k] = small ? (dg >> 31 ? dg + pc.q : dg) : lift_mod_p(dg, pc);
      }
      fwd_stages<R>(
          v,
          [&](int e, int j, uint32_t& ww, uint32_t& wwp) {
            ww = w[(1 << e) + j];
            wwp = wp[(1 << e) + j];
          },
          pc.q);
      uint32_t* row = rows + (l << log_n);
#pragma unroll
      for (int k = 0; k < G; ++k) row[swz((k << log_tl) + g)] = v[k];
    }
  }
}

// The MAC of a block: for U coefficients c at a time, partial[j][c] =
// sum_l f_l[c] * keys[l][j][c] mod p, f brought into [0, p) first and the L
// products (each < 2^60) summed in 64 bits, one Barrett reduction a sum;
// partial[j] is stored to dst[j] (row r of block (pi, j)'s inbox).  Every
// load of a group is issued before its products.
template <int K1>
__device__ void mac(const uint32_t* rows, const uint32_t* keys, uint32_t* const (&dst)[MAX_K1],
                    int L, int log_n, const PrimeConsts& pc) {
  constexpr int U = 4;
  const int n = 1 << log_n, nt = blockDim.x;
  const uint32_t q = pc.q;
  for (int c0 = threadIdx.x; c0 < n; c0 += U * nt) {
    uint64_t s[U][K1] = {};
    for (int l = 0; l < L; ++l) {
      uint32_t f[U], kv[U][K1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = min(c0 + u * nt, n - 1);  // past the end: a repeat, not stored
        f[u] = rows[(l << log_n) + swz(c)];
#pragma unroll
        for (int j = 0; j < K1; ++j) kv[u][j] = keys[((l * K1 + j) << log_n) + c];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t fu = reduce_once(reduce_once(f[u], 2u * q), q);
#pragma unroll
        for (int j = 0; j < K1; ++j) s[u][j] += (uint64_t)fu * kv[u][j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * nt;
      if (c < n) {
#pragma unroll
        for (int j = 0; j < K1; ++j)
          dst[j][swz(c)] = reduce_once(barrett_lazy_wide(s[u][j], pc.ratio, q), q);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 3) cmux_step_kernel(const StepArgs a) {
  extern __shared__ __align__(16) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int log_n = a.log_n, n = 1 << log_n;
  const int kp = a.kp, k1 = a.k1, L = a.bc.level;
  const int rank = (int)cluster.block_rank();
  const int pi = rank / k1, r = rank % k1;
  const int b = (int)blockIdx.x / (kp * k1);
  const PrimeConsts pc = a.ps.p[pi];
  const uint32_t q = pc.q;
  const int tid = threadIdx.x, nt = blockDim.x;

  // shared memory: the prime's root tables (forward, then inverse); the
  // CRT inbox (kp rows: component r's residue of each prime); the L digit
  // transforms; the partials inbox (k1 rows: row rr's partial of component
  // r), then the inverse transform in row 0.  The block's key rows key[pi,
  // r] (L * k1 rows) are prefetched into L2 and read from there.
  uint32_t* tw = sm;
  uint32_t* twp = sm + n;
  uint32_t* crt_in = sm + 2 * n;
  uint32_t* rows = crt_in + (kp << log_n);
  uint32_t* inbox = rows + (L << log_n);
  const size_t toff = (size_t)pi * n;
  for (int i = 4 * tid; i < n; i += 4 * nt) {
    cp_async16(tw + i, a.roots + toff + i);
    cp_async16(twp + i, a.roots_p + toff + i);
  }
  cp_async_commit();
  const uint32_t* kg = a.key + (size_t)(pi * k1 + r) * L * k1 * n;
  if (tid == 0)
    for (int i = 0; i < (L * k1 << log_n); i += 1024)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(kg + i),
                   "r"((unsigned)min(4096, (L * k1 << log_n) * 4 - 4 * i)));
  cp_async_commit();  // an empty group: the wait counts below stay as they are

  // 1. digits of row r and the first forward pass (r0 stages)
  const uint32_t* arow = a.acc + ((size_t)b * k1 + r) * n;
  const int d = degree_mod(a.degrees[b], n);
  const int r0 = (log_n - 1) % 3 + 1;
  const uint32_t* groots = a.roots + toff;
  const uint32_t* groots_p = a.roots_p + toff;
  if (r0 == 3)
    digit_pass<3>(rows, arow, d, a.bc, pc, groots, groots_p, log_n);
  else if (r0 == 2)
    digit_pass<2>(rows, arow, d, a.bc, pc, groots, groots_p, log_n);
  else
    digit_pass<1>(rows, arow, d, a.bc, pc, groots, groots_p, log_n);
  cp_async_wait<1>();
  __syncthreads();

  // 2. the other forward passes, radix 8; then the inverse tables replace
  //    the forward ones
  const SmemRows<SwzStep> digits{rows, log_n};
  for (int s0 = r0; s0 < log_n; s0 += 3) {
    fwd_pass<3>(L, log_n, s0, FwdTable{tw, twp}, q, digits, digits);
    __syncthreads();
  }
  for (int i = 4 * tid; i < n; i += 4 * nt) {
    cp_async16(tw + i, a.inv_roots + toff + i);
    cp_async16(twp + i, a.inv_roots_p + toff + i);
  }
  cp_async_commit();

  // 3. MAC against the key rows: partial[j] goes to row r of block (pi, j)'s
  //    partials inbox (distributed shared memory)
  uint32_t* dst[MAX_K1];
#pragma unroll
  for (int j = 0; j < MAX_K1; ++j)
    dst[j] = cluster.map_shared_rank(inbox + (r << log_n), pi * k1 + (j < k1 ? j : 0));
  cp_async_wait<1>();
  __syncthreads();
  switch (k1) {
    case 1: mac<1>(rows, kg, dst, L, log_n, pc); break;
    case 2: mac<2>(rows, kg, dst, L, log_n, pc); break;
    case 3: mac<3>(rows, kg, dst, L, log_n, pc); break;
    default: mac<4>(rows, kg, dst, L, log_n, pc); break;
  }
  cp_async_wait<0>();
  cluster.sync();

  // 4. component r: the first inverse pass adds the k1 partials of the
  //    inbox, the inverse NTT runs in inbox row 0, canonical
  const auto summed = slot_load([&](int, int c) {
    const int p = swz(c);
    uint32_t v = inbox[p];
    for (int rr = 1; rr < k1; ++rr) v = reduce_once(v + inbox[(rr << log_n) + p], q);
    return v;
  });
  const InvTable itw{tw, twp};
  inv_pass<3, Last::no>(1, log_n, 0, itw, pc, summed, SmemRows<SwzStep>{inbox, log_n});
  __syncthreads();

  // 5. each of component r's kp blocks takes n / kp of its coefficients:
  //    the last inverse pass multiplies each output by (P/p_pi)^-1 and
  //    stores it into row pi of the CRT inbox of block (pd, r) that owns
  //    the coefficient
  const int chunk = (n + kp - 1) / kp;
  const auto push = slot_store([&](int, int c, uint32_t v) {
    int pd = 0;
    while (pd + 1 < kp && c >= (pd + 1) * chunk) ++pd;
    *cluster.map_shared_rank(crt_in + (pi << log_n) + c, pd * k1 + r) =
        reduce_once(shoup_mul_lazy(v, a.crt.iw[pi], a.crt.ipq[pi], q), q);
  });
  inv_rest<Last::canonical>(SmemRows<SwzStep>{inbox, log_n}, 1, log_n, 3, itw, pc, push);
  cluster.sync();  // the last access to a peer's shared memory precedes this

  // 6. integer CRT of the kp residues and the wrapping add to acc, U
  //    coefficients at a time (their acc words loaded together)
  constexpr int U = 4;
  const size_t base = ((size_t)b * k1 + r) * n;
  const int c_end = min(n, (pi + 1) * chunk);
  for (int c0 = pi * chunk + tid; c0 < c_end; c0 += U * nt) {
    uint32_t av[U];
#pragma unroll
    for (int u = 0; u < U; ++u) av[u] = a.acc[base + min(c0 + u * nt, c_end - 1)];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * nt;
      if (c >= c_end) break;
      uint64_t fix = 0;    // sum y_i * floor(2^64 / p_i), mod 2^64
      uint32_t over = 0;   // ... and its carries out of 2^64
      uint32_t total = 0;  // sum y_i * (P/p_i), mod 2^32
#pragma unroll
      for (int i = 0; i < PFT_MAX_KP; ++i)
        if (i < kp) {
          const uint32_t y = crt_in[(i << log_n) + c];
          const uint64_t nf = fix + (uint64_t)y * a.crt.afix[i];
          over += nf < fix;
          fix = nf;
          total += y * a.crt.pmod[i];
        }
      const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
      a.out[base + c] = av[u] + (total - alpha * a.crt.pmt);
    }
  }
}

int threads_for(int log_n) {
  const int t = 1 << (log_n - 3);
  return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

// The constants of a plan pack into *a and the cluster launch of bsz
// ciphertexts into *cfg (*attr: the cluster dimension, kp * k1).
int configure(const uint64_t* h, int bsz, void* stream, StepArgs* a, cudaLaunchConfig_t* cfg,
              cudaLaunchAttribute* attr) {
  a->kp = (int)h[0];
  a->k1 = (int)h[1];
  a->log_n = (int)h[2];
  if (a->kp < 1 || a->kp > PFT_MAX_KP || a->k1 < 1 || a->k1 > MAX_K1 ||
      a->kp * a->k1 > MAX_CLUSTER || a->log_n < 4 || a->log_n > 12 || bsz < 1)
    return (int)cudaErrorInvalidValue;
  a->roots = (const uint32_t*)h[3];
  a->roots_p = (const uint32_t*)h[4];
  a->inv_roots = (const uint32_t*)h[5];
  a->inv_roots_p = (const uint32_t*)h[6];
  a->ps = unpack_primes(h + 7, a->kp);
  a->crt = unpack_crt(h + 7 + 7 * a->kp, a->kp);
  a->bc = unpack_basis(h + 8 + 11 * a->kp);
  const int L = a->bc.level, k1 = a->k1;
  if (L < 1 || L > MAX_LEVEL) return (int)cudaErrorInvalidValue;
  const int key_rows = a->kp;
  const size_t smem = (size_t)(2 + key_rows + L + k1) * sizeof(uint32_t) << a->log_n;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the attribute once per device and size, not per step
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem_set[dev] < (int)smem) {
    err = cudaFuncSetAttribute(cmux_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = (int)smem;
  }
  *cfg = {};
  cfg->gridDim = dim3(bsz * a->kp * k1);
  cfg->blockDim = dim3(threads_for(a->log_n));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = a->kp * k1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

}  // namespace

extern "C" {

// One CMux step on bsz ciphertexts.  plan: the host pack of
// ops/cmux_fused.step_pack (kp, k1, log_n, the four table pointers, then the
// prime, CRT and gadget packs).  out may be acc.
int pft_cmux_step(const void* acc, const void* degrees, const void* key, void* out, int bsz,
                  const void* plan, void* stream) {
  StepArgs a{};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure((const uint64_t*)plan, bsz, stream, &a, &cfg, &attr);
  if (err != 0) return err;
  a.acc = (const uint32_t*)acc;
  a.degrees = (const int32_t*)degrees;
  a.key = (const uint32_t*)key;
  a.out = (uint32_t*)out;
  err = (int)cudaLaunchKernelEx(&cfg, cmux_step_kernel, a);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
