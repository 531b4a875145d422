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
// Layout: one thread block per (ciphertext, prime).  For A the kp blocks of
// one ciphertext form a thread-block cluster; after the inverse transforms
// each block holds its prime's CRT terms y_i in shared memory, and the
// cluster reads them across blocks (distributed shared memory) for the
// integer CRT, each block finishing an interleaved share of the
// coefficients.  B has one prime and no CRT: one block per ciphertext.
//
// Per block, with P = k1 * L forward polys, A = n / 128, B = 128:
//   1. rotate-diff (A only) and signed gadget digits of every coefficient,
//      written as byte planes [(poly, k0)][(k1, plane)];
//   2. forward pass 1: [(poly, k0)] x w1 -> X[poly][r0][k0], times the
//      twiddle tw[r0][k0] (Shoup), as u32 words [(poly, r0)][k0];
//   3. forward pass 2: their bytes x w2 -> NTT values F[poly][r0 * B + r1],
//      canonical (bit-reversed order, viewed (A, B));
//   4. MAC against the key rows with Shoup precons, canonical;
//   5. inverse pass 1 (wi1) and twiddle twi; 6. inverse pass 2 (wi2, with
//      inv_n and (P/p_i)^-1 folded in) -> canonical y in natural order;
//   7. A: CRT across the cluster + wrapping add; B: acc + rot(y, d) - y.
// Shared memory: digit planes P * B * (K1 + 16) bytes, one 528-byte row per
// (poly, r0), and P * n words: 133.5 KB at BOOLEAN_128 (k1 = 2, L = 3,
// n = 2048), 85 KB at NTRU_128 (L = 6, n = 1024), opted in above 48 KB.
//
// What bounds it: per step, each block runs ~8.8k mma.sync (forward pass 2
// of 6 polys dominates: 16 x 512 x 512 bytes each) and streams ~1 MB of
// plane matrices from L2.  Measured with clock64() per phase on an H100
// (BOOLEAN_128, 119k cycles a block, the same at batch 1 and 64): forward
// pass 2 37%, MAC 18%, inverse pass 1 18%, forward pass 1 11%, CRT 6%,
// digits 6%.  Forward pass 2 takes ~44k cycles for 6144 mma.sync, about 2x
// what they would take at an assumed 1024 int8 MACs a cycle per SM (not
// measured); going much faster needs wgmma from shared memory.  At batch 1
// only kp blocks run (2 of 132 SMs); at batch 64 128 blocks fill the card.
//
// Values are u32 words (int32 storage on the PyTorch side).

#include <cooperative_groups.h>

#include "mxu8.cuh"

namespace cg = cooperative_groups;

namespace {

struct CmuxMxuArgs {
  const uint32_t* acc;    // (bsz, k1, n)
  const int32_t* degrees; // (bsz,)
  const uint32_t* kv;     // (kp, k1, L, k1, n) or, for B, (L, n)
  const uint32_t* kpre;   // Shoup precons of kv
  uint32_t* out;          // like acc
  const int8_t* w1;       // (kp, 4 * np1, kb1) forward pass 1, digit planes
  const int8_t* w2;       // (kp, 4 * B, 4 * B) forward pass 2
  const int8_t* wi1;      // (kp, 4 * B, 4 * B) inverse pass 1
  const int8_t* wi2;      // (kp, 4 * np1, kb4) inverse pass 2
  const uint32_t* tw;     // (kp, 4, n): tw, tw precon, twi, twi precon
  PrimeSet ps;
  CrtConsts crt;
  MxuBasis bc;
  int kp, k1, log_n, dp;
};

struct Geometry {
  int n, A, P, np1, kb1, kb4, lda1, lda4;
  size_t r0_bytes, r1_bytes, r2_bytes;
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
  const size_t dig = (size_t)g.P * PFT_MXU_B * g.lda1;
  const size_t inv = (size_t)k1 * PFT_MXU_B * g.lda4;
  g.r0_bytes = dig > inv ? dig : inv;
  g.r1_bytes = (size_t)round_up(g.P * g.A, 16) * PFT_MXU_LDA2;
  g.r2_bytes = (size_t)g.P * g.n * 4;
  return g;
}

template <bool NTRU>
__global__ void __launch_bounds__(512, 1) cmux_mxu_kernel(const CmuxMxuArgs args) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int k1 = args.k1, L = args.bc.level, dp = args.dp;
  const Geometry geo = geometry(k1, L, args.log_n, dp);
  const int n = geo.n, A = geo.A, P = geo.P;
  const int log_n = args.log_n, log_a = log_n - 7;  // n = 2^log_n, A = 2^log_a
  constexpr int B = PFT_MXU_B;
  constexpr int W2 = PFT_MXU_LDA2 / 4;  // words per 528-byte row
  const int pi = NTRU ? 0 : (int)(blockIdx.x % args.kp);
  const int b = NTRU ? (int)blockIdx.x : (int)(blockIdx.x / args.kp);
  const PrimeConsts pc = args.ps.p[pi];
  const uint32_t q = pc.q;
  const uint64_t off = plane_offset(q);

  uint8_t* r0 = smem;                     // digit planes, then inverse pass-2 operand
  uint8_t* r1 = smem + geo.r0_bytes;      // forward pass-2 operand, then the MAC
  uint32_t* r2 = (uint32_t*)(r1 + geo.r1_bytes);  // F, then y
  uint32_t* r1w = (uint32_t*)r1;

  const uint32_t* acc = args.acc + (size_t)b * k1 * n;
  int d = args.degrees[b] % (2 * n);
  if (d < 0) d += 2 * n;

  // 1. digits of (acc * X^d - acc) [A] or of acc [B]
  for (int i = threadIdx.x; i < k1 * n; i += blockDim.x) {
    const int r = i >> log_n, c = i & (n - 1);
    uint32_t v = acc[i];
    if (!NTRU) {
      bool neg;
      const uint32_t src = acc[r * n + rot_source(c, d, n, &neg)];
      v = (neg ? 0u - src : src) - v;
    }
    int8_t* dst = (int8_t*)r0 + ((size_t)(r * L) * B + (c & (B - 1))) * geo.lda1 + (c / B) * dp;
    write_digits(v, args.bc, dp, dst, B * geo.lda1);
  }
  __syncthreads();

  const uint32_t* tw = args.tw + (size_t)pi * 4 * n;
  // 2. forward pass 1 + twiddle
  mm_planes<false, 2>(r0, geo.lda1, P * B, args.w1 + (size_t)pi * 4 * geo.np1 * geo.kb1, geo.np1, A,
                   geo.kb1, [&](int m, int r0i, int d0, int d1, int d2, int d3) {
                     const int poly = m / B, k0 = m % B, idx = r0i * B + k0;
                     const uint32_t x = reduce_planes(d0, d1, d2, d3, pc, off);
                     r1w[(poly * A + r0i) * W2 + k0] = shoup_mul_lazy(x, tw[idx], tw[n + idx], q);
                   });
  __syncthreads();
  // 3. forward pass 2 -> canonical NTT values, natural (bit-reversed) order
  mm_planes<true, 3>(r1, PFT_MXU_LDA2, P * A, args.w2 + (size_t)pi * 16 * B * B, B, B, 4 * B,
                  [&](int m, int r1i, int d0, int d1, int d2, int d3) {
                    r2[m * B + r1i] = reduce_planes(d0, d1, d2, d3, pc, off);
                  });
  __syncthreads();
  // 4. MAC: out_j = sum_{r, l} F[r, l] * key[r, l, j]; each thread keeps
  //    MAC_PER coefficients in registers, so their key loads overlap
  const size_t kbase = NTRU ? 0 : (size_t)pi * k1 * L * k1 * n;
  constexpr int MAC_PER = 8;
  for (int base = threadIdx.x; base < k1 * n; base += MAC_PER * blockDim.x) {
    uint32_t s[MAC_PER];
#pragma unroll
    for (int u = 0; u < MAC_PER; ++u) s[u] = 0;
    for (int r = 0; r < k1; ++r)
      for (int l = 0; l < L; ++l) {
        const uint32_t* f = r2 + (r * L + l) * n;
#pragma unroll
        for (int u = 0; u < MAC_PER; ++u) {
          const int i = base + u * blockDim.x;
          if (i < k1 * n) {
            const int j = i >> log_n, c = i & (n - 1);
            const size_t ki = kbase + ((size_t)((r * L + l) * k1 + j)) * n + c;
            const uint32_t t = shoup_mul_lazy(f[c], __ldg(args.kv + ki), __ldg(args.kpre + ki), q);
            s[u] = reduce_once(s[u] + reduce_once(t, q), q);
          }
        }
      }
#pragma unroll
    for (int u = 0; u < MAC_PER; ++u) {
      const int i = base + u * blockDim.x;
      if (i < k1 * n) r1w[(((i >> log_n) << log_a) + ((i & (n - 1)) >> 7)) * W2 + (i & (B - 1))] = s[u];
    }
  }
  __syncthreads();
  // 5. inverse pass 1 + inverse twiddle
  const int w4 = geo.lda4 / 4;
  uint32_t* r0w = (uint32_t*)r0;
  mm_planes<true, 2>(r1, PFT_MXU_LDA2, k1 * A, args.wi1 + (size_t)pi * 16 * B * B, B, B, 4 * B,
                  [&](int m, int k0, int d0, int d1, int d2, int d3) {
                    const int j = m >> log_a, r0i = m & (A - 1), idx = r0i * B + k0;
                    const uint32_t z = reduce_planes(d0, d1, d2, d3, pc, off);
                    r0w[(j * B + k0) * w4 + r0i] =
                        shoup_mul_lazy(z, tw[2 * n + idx], tw[3 * n + idx], q);
                  });
  __syncthreads();
  // 6. inverse pass 2 -> canonical y, natural order
  mm_planes<true, 2>(r0, geo.lda4, k1 * B, args.wi2 + (size_t)pi * 4 * geo.np1 * geo.kb4, geo.np1,
                  A, geo.kb4, [&](int m, int k1i, int d0, int d1, int d2, int d3) {
                    const int j = m / B, k0 = m % B;
                    r2[(j << log_n) + k1i * B + k0] = reduce_planes(d0, d1, d2, d3, pc, off);
                  });

  uint32_t* out = args.out + (size_t)b * k1 * n;
  if constexpr (NTRU) {
    __syncthreads();
    // 7B. acc + rot(delta, d) - delta mod q (mod-q negation keeps 0 at 0)
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      bool neg;
      const uint32_t src = r2[rot_source(c, d, n, &neg)];
      const uint32_t rot = (neg && src != 0u) ? q - src : src;
      const uint32_t s = reduce_once(acc[c] + rot, q);
      out[c] = reduce_once(s + (q - r2[c]), q);
    }
  } else {
    // 7A. integer CRT of the kp blocks' y_i, then the wrapping add
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int kp = args.kp;
    const uint32_t* ys[PFT_MAX_KP];
    for (int i = 0; i < kp; ++i) ys[i] = cluster.map_shared_rank(r2, i);
    for (int i = pi * blockDim.x + threadIdx.x; i < k1 * n; i += kp * blockDim.x) {
      uint64_t fix = 0;    // sum y_i * floor(2^64 / p_i), mod 2^64
      uint32_t over = 0;   // ... and its carries out of 2^64
      uint32_t total = 0;  // sum y_i * (P/p_i), mod 2^32
      for (int j = 0; j < kp; ++j) {
        const uint32_t y = ys[j][i];
        const uint64_t nf = fix + (uint64_t)y * args.crt.afix[j];
        over += nf < fix;
        fix = nf;
        total += y * args.crt.pmod[j];
      }
      const uint32_t alpha = over + (uint32_t)(fix >> 63);  // round(sum y_i / p_i)
      out[i] = acc[i] + (total - alpha * args.crt.pmt);
    }
    cluster.sync();  // keep every block's y alive until all reads are done
  }
}

template <bool NTRU>
int launch(const CmuxMxuArgs& a, int bsz, void* stream) {
  const Geometry geo = geometry(a.k1, a.bc.level, a.log_n, a.dp);
  const size_t smem = geo.r0_bytes + geo.r1_bytes + geo.r2_bytes;
  cudaError_t err = cudaFuncSetAttribute(cmux_mxu_kernel<NTRU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NTRU ? bsz : bsz * a.kp);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.kp;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = NTRU ? 0 : 1;
  err = cudaLaunchKernelEx(&cfg, cmux_mxu_kernel<NTRU>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool valid(int kp, int log_n, int dp, int level) {
  return kp >= 1 && kp <= PFT_MAX_KP && log_n >= 8 && log_n <= 12 && (dp == 1 || dp == 2) &&
         level >= 1;
}

}  // namespace

extern "C" {

int pft_cmux_mxu(const void* acc, const void* degrees, const void* kv, const void* kpre, void* out,
                 const void* w1, const void* w2, const void* wi1, const void* wi2, const void* tw,
                 const void* prime_pack, const void* crt_pack, const void* basis_pack, int kp,
                 int bsz, int k1, int log_n, int dp, void* stream) {
  const MxuBasis bc = unpack_mxu_basis((const uint64_t*)basis_pack);
  if (!valid(kp, log_n, dp, bc.level)) return (int)cudaErrorInvalidValue;
  CmuxMxuArgs a{(const uint32_t*)acc, (const int32_t*)degrees, (const uint32_t*)kv,
                (const uint32_t*)kpre, (uint32_t*)out, (const int8_t*)w1, (const int8_t*)w2,
                (const int8_t*)wi1, (const int8_t*)wi2, (const uint32_t*)tw,
                unpack_primes((const uint64_t*)prime_pack, kp),
                unpack_crt((const uint64_t*)crt_pack, kp), bc, kp, k1, log_n, dp};
  return launch<false>(a, bsz, stream);
}

int pft_ntru_cmux_mxu(const void* acc, const void* degrees, const void* kv, const void* kpre,
                      void* out, const void* w1, const void* w2, const void* wi1, const void* wi2,
                      const void* tw, const void* prime_pack, const void* basis_pack, int bsz,
                      int log_n, int dp, void* stream) {
  const MxuBasis bc = unpack_mxu_basis((const uint64_t*)basis_pack);
  if (!valid(1, log_n, dp, bc.level)) return (int)cudaErrorInvalidValue;
  CmuxMxuArgs a{(const uint32_t*)acc, (const int32_t*)degrees, (const uint32_t*)kv,
                (const uint32_t*)kpre, (uint32_t*)out, (const int8_t*)w1, (const int8_t*)w2,
                (const int8_t*)wi1, (const int8_t*)wi2, (const uint32_t*)tw,
                unpack_primes((const uint64_t*)prime_pack, 1), CrtConsts{}, bc, 1, 1, log_n, dp};
  return launch<true>(a, bsz, stream);
}

}  // extern "C"
