// The dense `onlyg` variant of the MSDA backward ablation, for Hopper
// (sm_90a).
//
// Replaces the `onlyg` branch of the TPU kernel `kernel`
// (scripts/bench_msda_ablation.py:1082-1095, `pallas_call` :1215): the
// backward stripped to its two dense products, the floor of the TPU's dense
// formulation. Per (batch b, head m), over EVERY query q and token s:
//   G[q, s]  = sum_d g[q, d] * v[s, d]               (float32)
//   dv[s, d] = sum_q round_T(G[q, s]) * g[q, d]      (float32)
//   daw[q, k] = G[q, k] for k < L * P: the first L * P tokens, which are level
//   0's when level 0 has at least L * P tokens (the wrapper checks it);
// dpy and dpx are zero (the wrapper's zeros). round_T rounds to the value's
// type, as the TPU kernel stores G in its scratch plane of that type
// (`ws_ref`, :1090) before the second product.
//
// Inputs, read in place: value (B, S, M, D) and g (B, Lq, M*D) in float32 or
// bfloat16. Outputs: dv (B, S, M, D) float32, daw (B, Lq, M, L, P) float32.
// No plane of G ever reaches device memory.
//
// Bound on the H100: 2 * 2 * B*M * Lq * S * D operations. At the ablation
// script's shapes (B*M = 128, Lq = S = 1045, D = 32) 17.9 GFLOP: 0.267 ms at
// the 67 TFLOP/s float32 rate outside the tensor cores, 0.0181 ms at the
// 989 TFLOP/s dense bf16 tensor-core rate, which in bf16 sits just above
// the bytes (value, g, dv, dpy, dpx, daw: 59.9 MB, 0.0179 ms; the kernel
// reads neither the locations nor the attention).
//
// Two kernels; the wrapper's plan (`msda_cuda.onlyg_plan`) picks one.
//
// The tiled kernels (D = 16 or 32, 16-byte aligned value and g), in the
// shape of flash attention's dV = P^T dO: one block per (b, m, tile of 128
// tokens) keeps the tile's value rows in shared memory and walks the queries
// in tiles of 64 that cp.async brings ahead; dv stays in registers for the
// whole walk and is written once.
//   bf16 (msda_onlyg_tc_kernel, 4 warps of 32 tokens, a ring of 4 g tiles,
//   3 in flight): G^T = v g^T on the tensor cores (mma.sync m16n8k16, bf16
//   in, float32 sums, K = D), rounded to bf16 in registers, where G's
//   accumulator fragments are already the A operand of the second product;
//   dv += round(G)^T g by mma.sync again, g's fragments taken transposed by
//   ldmatrix.trans. G never touches shared memory, and padded rows (D + 8
//   values) keep ldmatrix free of bank conflicts.
//   float32 (msda_onlyg_f32_kernel, 256 threads, two g tiles, 72 KB of
//   shared memory at D = 32): the CUDA cores, no TF32 of any form (the
//   67 TFLOP/s bound would not hold it). A register-tiled outer product:
//   each thread owns a 4x8 tile of G (one float4 of each operand per 4
//   channels: 12 loads for 128 products) and 4 tokens x 4 channels of dv (a
//   float4 of G and one of g per query for 16 products), with G staged in
//   shared memory between the two; products by __fmaf_rn, which -fmad=false
//   leaves fused.
// The old kernel's limits, which these answer: no tensor cores, two 4-byte
// shared-memory loads for every multiply-add, FMUL + FADD pairs under
// -fmad=false, and 32x32 tiles that re-staged every g tile 33 times a
// (b, m).
// daw is never taken from those G. Blocks of their own (past the token
// tiles on the grid's x axis, one query a thread) sum each of its L * P
// columns on the CUDA cores in channel order 0..D-1 with a separate multiply
// and add, as the plain version does, so daw agrees with it bit for bit;
// each warp writes its 32 queries' rows whole through shared memory, and
// dpy and dpx (zeros) beside them. In bf16 the tensor cores' G may round to
// another bf16 than the plain version's sequential one (a last-bit
// difference), so dv agrees to 7e-5 - 1.8e-4 of its max there (held within
// 2.5e-4; a kernel that skipped round_T would be off by more); in float32
// dv differs from it only in the order of its sums.
// Measured on the H100 at the bench shapes (device time, PERF.md §6): bf16
// ~0.077 ms (~4.3x its bound), of which the token blocks ~0.06 (their g
// stream alone ~0.026) and the daw blocks the rest; float32 ~0.60 ms
// (~2.3x its bound), about 60 % of the CUDA cores' fused multiply-add rate.
//
// ptxas (sm_90a, nvcc 12.9): tc<32> 88 registers, 30,720 bytes of static
// shared memory; tc<16> 71, 18,432; f32<32> and f32<16> 128 registers
// (72 and 56 KB dynamic); general<float> 36, <bf16> 32. No spills.
//
// The general kernel (msda_onlyg_general_kernel, D <= 116 in 48 KB of shared
// memory; any alignment; kept for the shapes the tiled ones do not take):
// one block per (b, m, tile of 32 tokens), 256 threads. The block widens its 32 value rows into shared memory once, then
// walks the queries in tiles of 32: it stages the tile's g rows, computes
// the 32x32 tile of G (each entry summed over d in order 0..D-1, which the
// plain version repeats, so G and daw agree with it bit for bit), rounds it,
// and adds round(G)^T g into the tile's dv, kept in shared memory (each
// thread owns fixed entries, so no atomics and a fixed order).
//
#include "msda_common.cuh"

namespace {

using namespace msda;

// ------------------------------------------------------------ general

constexpr int kTile = 32;     // tokens per block, and queries per step
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_onlyg_general_kernel(const T* __restrict__ value, const T* __restrict__ grad,
                          float* __restrict__ dv, float* __restrict__ daw,
                          int S, int Lq, int M, int D, int LP) {
  extern __shared__ float smem[];
  const int Dp = D + 1;  // padded rows: no bank conflicts across a warp
  float* vs = smem;                  // [kTile][Dp] value rows of this tile
  float* gs = vs + kTile * Dp;       // [kTile][Dp] g rows of the query tile
  float* Gs = gs + kTile * Dp;       // [kTile][kTile + 1] rounded G tile
  float* acc = Gs + kTile * (kTile + 1);  // [kTile][D] dv of this tile

  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kTile;
  const int bm = blockIdx.y;
  const int b = bm / M;
  const int m = bm % M;

  for (int e = t; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const int s = s0 + j;
    vs[j * Dp + d] = s < S ? to_float(value[(((long long)b * S + s) * M + m) * D + d]) : 0.0f;
    acc[e] = 0.0f;
  }
  for (int q0 = 0; q0 < Lq; q0 += kTile) {
    __syncthreads();  // the previous step is done with gs and Gs
    for (int e = t; e < kTile * D; e += kThreads) {
      const int i = e / D, d = e % D;
      const int q = q0 + i;
      gs[i * Dp + d] = q < Lq ? to_float(grad[(((long long)b * Lq + q) * M + m) * D + d]) : 0.0f;
    }
    __syncthreads();
    for (int e = t; e < kTile * kTile; e += kThreads) {
      const int i = e / kTile, j = e % kTile;
      float g_qs = 0.0f;
      for (int d = 0; d < D; ++d) g_qs = g_qs + gs[i * Dp + d] * vs[j * Dp + d];
      const int q = q0 + i, s = s0 + j;
      if (s < LP && q < Lq) daw[(((long long)b * Lq + q) * M + m) * LP + s] = g_qs;
      Gs[i * (kTile + 1) + j] = round_to<T>(g_qs);
    }
    __syncthreads();
    for (int e = t; e < kTile * D; e += kThreads) {
      const int j = e / D, d = e % D;
      float a = acc[e];
      for (int i = 0; i < kTile; ++i) a = a + Gs[i * (kTile + 1) + j] * gs[i * Dp + d];
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = t; e < kTile * D; e += kThreads) {
    const int j = e / D, d = e % D;
    const int s = s0 + j;
    if (s < S) dv[(((long long)b * S + s) * M + m) * D + d] = acc[e];
  }
}

// ------------------------------------------------------------ tiled

constexpr int kQ = 64;  // queries per staged g tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Rows [r0, r0 + kRows) of a per-(b, m) view whose rows of kD values lie
// `stride` values apart, into shared-memory rows of kPad values by 16-byte
// cp.async (not waited for); rows at or past `limit` are zeros.
template <typename T, int kD, int kPad, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int r0,
                                          int limit) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kChunks = kD / kPer;
  for (int i = threadIdx.x; i < kRows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i - r * kChunks;
    T* to = dst + r * kPad + c * kPer;
    if (r0 + r < limit) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(to)),
                   "l"(src + (r0 + r) * stride + c * kPer));
    } else {
      *(uint4*)to = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for all cp.async groups but the newest `kPending`.
template <int kPending>
__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A row of kD values at `p` (16-byte aligned) widened to float32.
template <typename T, int kD>
__device__ __forceinline__ void load_row(const T* p, float (&out)[kD]) {
  constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < kD / kPer; ++c) {
    const uint4 u = __ldg((const uint4*)p + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(e[i]);
  }
}

constexpr int kDawK = 16;  // daw columns a daw block sums at once

// The shared memory a daw block of `threads` threads uses: kDawK value rows
// widened to float32, then each warp's sums for 32 queries (padded rows).
template <int kD>
__host__ __device__ constexpr int daw_smem(int threads) {
  return (int)sizeof(float) * (kDawK * kD + threads * (kDawK + 1));
}

// A daw block (x at or past tok_tiles; one query a thread): daw[b, q, m, k]
// = sum_d g[q, d] v[k, d] for k < LP, the first product then one add per
// channel in order, as onlyg_torch sums G; and dpy = dpx = 0 for its
// queries. The block widens kDawK value rows at a time into `stage`
// (daw_smem bytes of shared memory); each thread carries kDawK sums side by
// side, and each warp writes its 32 queries' rows whole through shared
// memory (a query's row is LP floats; rows M * LP floats apart). Returns
// false for a token block.
template <typename T, int kD>
__device__ __forceinline__ bool daw_block(const T* value, const T* grad, float* dpy, float* dpx,
                                          float* daw, float* stage, int S, int Lq, int M,
                                          int LP, int tok_tiles) {
  if ((int)blockIdx.x < tok_tiles) return false;
  const int b = blockIdx.y / M, m = blockIdx.y % M;
  const long long MD = (long long)M * kD;
  const T* vbase = value + (long long)b * S * MD + m * kD;
  const int lane = threadIdx.x & 31;
  const int q = ((int)blockIdx.x - tok_tiles) * blockDim.x + threadIdx.x;
  const int q0 = q - lane;  // the warp's first query
  float* xs = stage + kDawK * kD + (threadIdx.x >> 5) * 32 * (kDawK + 1);
  auto row = [&](int r) { return (((long long)b * Lq + q0 + r) * M + m) * LP; };
  for (int e = lane; e < 32 * LP; e += 32) {
    const int r = e / LP;
    if (q0 + r < Lq) dpy[row(r) + e - r * LP] = dpx[row(r) + e - r * LP] = 0.0f;
  }
  float g[kD];
  if (q < Lq) {
    load_row<T, kD>(grad + ((long long)b * Lq + q) * MD + m * kD, g);
  } else {
#pragma unroll
    for (int d = 0; d < kD; ++d) g[d] = 0.0f;
  }
  for (int k0 = 0; k0 < LP; k0 += kDawK) {
    const int nk = min(kDawK, LP - k0);
    __syncthreads();  // the previous rows are read
    for (int e = threadIdx.x; e < nk * kD; e += blockDim.x) {
      const int k = e / kD;
      stage[e] = to_float(vbase[(k0 + k) * MD + (e - k * kD)]);
    }
    __syncthreads();
    float x[kDawK];
#pragma unroll
    for (int d = 0; d < kD; d += 4)
#pragma unroll
      for (int k = 0; k < kDawK; ++k) {
        const float4 v = *(const float4*)(stage + k * kD + d);
        x[k] = d == 0 ? g[0] * v.x : x[k] + g[d] * v.x;
        x[k] = x[k] + g[d + 1] * v.y;
        x[k] = x[k] + g[d + 2] * v.z;
        x[k] = x[k] + g[d + 3] * v.w;
      }
#pragma unroll
    for (int k = 0; k < kDawK; ++k) xs[lane * (kDawK + 1) + k] = x[k];
    __syncwarp();
    for (int e = lane; e < 32 * nk; e += 32) {
      const int r = e / nk, k = e - r * nk;
      if (q0 + r < Lq) daw[row(r) + k0 + k] = xs[r * (kDawK + 1) + k];
    }
    __syncwarp();  // xs is read before the next chunk's sums
  }
  return true;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

constexpr int kTcWarps = 4;             // 32 tokens each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcTok = 32 * kTcWarps;   // tokens per block
constexpr int kTcStages = 4;            // g tiles in flight: the ring's depth

template <int kD>
__global__ void __launch_bounds__(kTcThreads)
msda_onlyg_tc_kernel(const __nv_bfloat16* __restrict__ value,
                     const __nv_bfloat16* __restrict__ grad, float* __restrict__ dv,
                     float* __restrict__ dpy, float* __restrict__ dpx, float* __restrict__ daw,
                     int S, int Lq, int M, int LP, int tok_tiles) {
  using T = __nv_bfloat16;
  constexpr int kPad = kD + 8;  // 16-byte rows shifted 4 banks each: ldmatrix conflict-free
  constexpr int KS = kD / 16;   // k-steps of G^T = v g^T
  constexpr int ND = kD / 8;    // 8-channel tiles of dv
  __shared__ __align__(16) T vs[kTcTok * kPad];
  __shared__ __align__(16) T gs[kTcStages][kQ * kPad];
  static_assert(sizeof(gs) >= daw_smem<kD>(kTcThreads), "a daw block stages in gs");
  if (daw_block<T, kD>(value, grad, dpy, dpx, daw, reinterpret_cast<float*>(&gs[0][0]), S, Lq,
                       M, LP, tok_tiles))
    return;

  const int b = blockIdx.y / M, m = blockIdx.y % M;
  const long long MD = (long long)M * kD;
  const T* vbase = value + (long long)b * S * MD + m * kD;
  const T* gbase = grad + (long long)b * Lq * MD + m * kD;
  const int s0 = blockIdx.x * kTcTok;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = s0 + warp * 32 < S;  // warp-uniform: the warp has a token

  // one cp.async group for the value rows, then one a g tile; a tile past
  // Lq is zeros and never read
  load_tile<T, kD, kPad, kTcTok>(vs, vbase, MD, s0, S);
#pragma unroll
  for (int p = 0; p < kTcStages - 1; ++p)
    load_tile<T, kD, kPad, kQ>(gs[p], gbase, MD, p * kQ, Lq);
  unsigned a[2][KS][4];      // the warp's value rows as A fragments
  float acc[2][ND][4] = {};  // its dv
  const int nq = (Lq + kQ - 1) / kQ;
  for (int t = 0; t < nq; ++t) {
    wait_tiles<kTcStages - 2>();  // tile t (and the value rows) arrived
    __syncthreads();              // ... for every thread, and tile t - 1 is done with
    load_tile<T, kD, kPad, kQ>(gs[(t + kTcStages - 1) % kTcStages], gbase, MD,
                               (t + kTcStages - 1) * kQ, Lq);
    if (active) {
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            ldsm_x4(a[mt][ks], vs + (warp * 32 + mt * 16 + (lane & 15)) * kPad + ks * 16 +
                                   (lane >> 4) * 8);
      }
      const T* gt = gs[t % kTcStages];
#pragma unroll
      for (int sub = 0; sub < kQ / 32; ++sub) {
        // G^T for the warp's 32 tokens x 32 queries: 2 x 4 tiles of 16x8
        float c[2][4][4] = {};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const T* row = gt + (sub * 32 + n * 8 + (lane & 7)) * kPad;
          unsigned bb[KS][2];
          if constexpr (KS == 2) {
            unsigned r[4];
            ldsm_x4(r, row + (lane >> 3) * 8);
            bb[0][0] = r[0], bb[0][1] = r[1], bb[1][0] = r[2], bb[1][1] = r[3];
          } else {
            unsigned r[2];
            ldsm_x2(r, row + ((lane >> 3) & 1) * 8);
            bb[0][0] = r[0], bb[0][1] = r[1];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) mma_bf16(c[mt][n], a[mt][ks], bb[ks][0], bb[ks][1]);
        }
        // dv += round(G^T) g, 16 queries a step: two G tiles make one A fragment
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          unsigned pa[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            pa[mt][0] = pack_bf16(c[mt][2 * kk][0], c[mt][2 * kk][1]);
            pa[mt][1] = pack_bf16(c[mt][2 * kk][2], c[mt][2 * kk][3]);
            pa[mt][2] = pack_bf16(c[mt][2 * kk + 1][0], c[mt][2 * kk + 1][1]);
            pa[mt][3] = pack_bf16(c[mt][2 * kk + 1][2], c[mt][2 * kk + 1][3]);
          }
#pragma unroll
          for (int np = 0; np < ND / 2; ++np) {
            unsigned r[4];
            ldsm_x4_trans(r, gt + (sub * 32 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPad +
                                 np * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * np], pa[mt], r[0], r[1]);
              mma_bf16(acc[mt][2 * np + 1], pa[mt], r[2], r[3]);
            }
          }
        }
      }
    }
  }
  if (!active) return;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = s0 + warp * 32 + mt * 16 + gr + half * 8;
      if (s >= S) continue;
      float* out = dv + ((long long)b * S + s) * MD + m * kD + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *(float2*)(out + nd * 8) = make_float2(acc[mt][nd][2 * half], acc[mt][nd][2 * half + 1]);
    }
}

constexpr int kF32Threads = 256;
constexpr int kF32Tok = 128;  // tokens per block

// The float32 kernel's dynamic shared memory: value rows, two g tiles, G.
template <int kD>
constexpr int f32_smem() {
  return (int)sizeof(float) * (kF32Tok * (kD + 4) + 2 * kQ * (kD + 4) + kQ * (kF32Tok + 16));
}

template <int kD>
__global__ void __launch_bounds__(kF32Threads, 2)  // 2 blocks an SM: their 72 KB each
msda_onlyg_f32_kernel(const float* __restrict__ value, const float* __restrict__ grad,
                      float* __restrict__ dv, float* __restrict__ dpy, float* __restrict__ dpx,
                      float* __restrict__ daw, int S, int Lq, int M, int LP, int tok_tiles) {
  constexpr int kPad = kD + 4;         // float4 reads of 8 consecutive rows hit 8 bank quads
  constexpr int kGPad = kF32Tok + 16;  // G rows: two half-warps on other banks
  constexpr int kTpt = kD / 8;         // tokens a thread holds of dv (4 channels each)
  extern __shared__ __align__(16) float fsm[];
  float* vs = fsm;                      // [kF32Tok][kPad] value rows
  float* gs = vs + kF32Tok * kPad;      // [2][kQ][kPad] g tiles
  float* Gs = gs + 2 * kQ * kPad;       // [kQ][kGPad] G of a tile
  static_assert(sizeof(float) * kQ * kGPad >= daw_smem<kD>(kF32Threads),
                "a daw block stages in Gs");
  if (daw_block<float, kD>(value, grad, dpy, dpx, daw, Gs, S, Lq, M, LP, tok_tiles)) return;

  const int b = blockIdx.y / M, m = blockIdx.y % M;
  const long long MD = (long long)M * kD;
  const float* vbase = value + (long long)b * S * MD + m * kD;
  const float* gbase = grad + (long long)b * Lq * MD + m * kD;
  const int s0 = blockIdx.x * kF32Tok;
  const int t = threadIdx.x;
  const int tq = t >> 4, ts = t & 15;                      // G: queries tq + 16i, tokens ts + 16j
  const int ds = t % (kD / 4), st = t / (kD / 4) * kTpt;  // dv: tokens st.., channels 4 ds..

  load_tile<float, kD, kPad, kF32Tok>(vs, vbase, MD, s0, S);
  load_tile<float, kD, kPad, kQ>(gs, gbase, MD, 0, Lq);
  float acc[kTpt][4] = {};
  const int nq = (Lq + kQ - 1) / kQ;
  for (int it = 0; it < nq; ++it) {
    if (it + 1 < nq) {
      load_tile<float, kD, kPad, kQ>(gs + ((it + 1) & 1) * kQ * kPad, gbase, MD, (it + 1) * kQ,
                                     Lq);
      wait_tiles<1>();
    } else {
      wait_tiles<0>();
    }
    __syncthreads();
    const float* gt = gs + (it & 1) * kQ * kPad;
    // G = g v^T: a 4 x 8 tile a thread, one float4 of each operand per 4 channels
    float c[4][8] = {};
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      float4 gq[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gq[i] = *(const float4*)(gt + (tq + 16 * i) * kPad + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = *(const float4*)(vs + (ts + 16 * j) * kPad + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[i][j] = __fmaf_rn(gq[i].x, vv[j].x, c[i][j]);
          c[i][j] = __fmaf_rn(gq[i].y, vv[j].y, c[i][j]);
          c[i][j] = __fmaf_rn(gq[i].z, vv[j].z, c[i][j]);
          c[i][j] = __fmaf_rn(gq[i].w, vv[j].w, c[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Gs[(tq + 16 * i) * kGPad + ts + 16 * j] = c[i][j];
    __syncthreads();
    // dv += G^T g: kTpt tokens x 4 channels a thread
#pragma unroll 4
    for (int q = 0; q < kQ; ++q) {
      const float4 gv = *(const float4*)(gt + q * kPad + 4 * ds);
      float gg[kTpt];
      if constexpr (kTpt == 4) {
        const float4 x = *(const float4*)(Gs + q * kGPad + st);
        gg[0] = x.x, gg[1] = x.y, gg[2] = x.z, gg[3] = x.w;
      } else {
        const float2 x = *(const float2*)(Gs + q * kGPad + st);
        gg[0] = x.x, gg[1] = x.y;
      }
#pragma unroll
      for (int u = 0; u < kTpt; ++u) {
        acc[u][0] = __fmaf_rn(gg[u], gv.x, acc[u][0]);
        acc[u][1] = __fmaf_rn(gg[u], gv.y, acc[u][1]);
        acc[u][2] = __fmaf_rn(gg[u], gv.z, acc[u][2]);
        acc[u][3] = __fmaf_rn(gg[u], gv.w, acc[u][3]);
      }
    }
    __syncthreads();  // done with Gs and this g tile
  }
#pragma unroll
  for (int u = 0; u < kTpt; ++u) {
    const int s = s0 + st + u;
    if (s < S)
      *(float4*)(dv + ((long long)b * S + s) * MD + m * kD + 4 * ds) =
          make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
  }
}

// Launches a tiled kernel of `threads` threads and `smem` bytes of dynamic
// shared memory: ceil(S / tok) token blocks, then ceil(Lq / threads) daw
// blocks, on the grid's x axis; (b, m) on its y axis.
template <typename Kernel, typename T>
int launch_tiled(Kernel kernel, int threads, int tok, int smem, const T* value, const T* grad,
                 float* dv, float* dpy, float* dpx, float* daw, int S, int Lq, int M,
                 long long bm, int LP, cudaStream_t stream) {
  const int tok_tiles = (S + tok - 1) / tok;
  const long long x = (long long)tok_tiles + (Lq + threads - 1) / threads;
  if (x > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (smem > 0) {
    const int err = allow_smem(kernel, smem);
    if (err != 0) return err;
  }
  kernel<<<dim3((unsigned)x, (unsigned)bm), threads, smem, stream>>>(value, grad, dv, dpy, dpx,
                                                                     daw, S, Lq, M, LP,
                                                                     tok_tiles);
  return (int)cudaGetLastError();
}

int check_dims(int B, int S, int Lq, int M, int D, int LP, int device, long long* bm) {
  if (B < 1 || S < 1 || Lq < 1 || M < 1 || D < 1 || LP < 1 || LP > S)
    return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  *bm = (long long)B * M;
  return *bm > 65535 ? (int)cudaErrorInvalidConfiguration : 0;
}

}  // namespace

// The tiled kernels: D = 16 or 32, value and g 16-byte aligned (the
// wrapper's plan). Launch on `stream` of card `device`; dv, dpy, dpx and daw
// need no zeroing: every entry is written (dpy and dpx zero). Returns the
// cudaError_t of the launch (0 when accepted; cudaErrorInvalidValue for a D
// they do not take).
extern "C" int msda_onlyg_tiled(const void* value, const void* grad, void* dv, void* dpy,
                                void* dpx, void* daw, int B, int S, int Lq, int M, int D, int LP,
                                int is_bf16, int device, void* stream) {
  long long bm = 0;
  int err = check_dims(B, S, Lq, M, D, LP, device, &bm);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  const bf16* vb = (const bf16*)value;
  const bf16* gb = (const bf16*)grad;
  const float* vf = (const float*)value;
  const float* gf = (const float*)grad;
  float* out[4] = {(float*)dv, (float*)dpy, (float*)dpx, (float*)daw};
  if (D == 32)
    return is_bf16 ? launch_tiled(msda_onlyg_tc_kernel<32>, kTcThreads, kTcTok, 0, vb, gb, out[0],
                                  out[1], out[2], out[3], S, Lq, M, bm, LP, s)
                   : launch_tiled(msda_onlyg_f32_kernel<32>, kF32Threads, kF32Tok,
                                  f32_smem<32>(), vf, gf, out[0], out[1], out[2], out[3], S, Lq,
                                  M, bm, LP, s);
  if (D == 16)
    return is_bf16 ? launch_tiled(msda_onlyg_tc_kernel<16>, kTcThreads, kTcTok, 0, vb, gb, out[0],
                                  out[1], out[2], out[3], S, Lq, M, bm, LP, s)
                   : launch_tiled(msda_onlyg_f32_kernel<16>, kF32Threads, kF32Tok,
                                  f32_smem<16>(), vf, gf, out[0], out[1], out[2], out[3], S, Lq,
                                  M, bm, LP, s);
  return (int)cudaErrorInvalidValue;
}

// The general kernel, as msda_onlyg_tiled otherwise (any D up to 116; dpy
// and dpx zeroed by cudaMemsetAsync on the stream).
extern "C" int msda_onlyg_general(const void* value, const void* grad, void* dv, void* dpy,
                                  void* dpx, void* daw, int B, int S, int Lq, int M, int D,
                                  int LP, int is_bf16, int device, void* stream) {
  long long bm = 0;
  int err = check_dims(B, S, Lq, M, D, LP, device, &bm);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + kTile * (kTile + 1) + kTile * D);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((S + kTile - 1) / kTile, (unsigned)bm);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t pixel_bytes = sizeof(float) * (size_t)B * Lq * M * LP;
  void* zeros[2] = {dpy, dpx};
  for (void* zero : zeros) {
    const cudaError_t set = cudaMemsetAsync(zero, 0, pixel_bytes, s);
    if (set != cudaSuccess) return (int)set;
  }
  if (is_bf16) {
    msda_onlyg_general_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)value, (const __nv_bfloat16*)grad, (float*)dv, (float*)daw,
        S, Lq, M, D, LP);
  } else {
    msda_onlyg_general_kernel<float><<<grid, kThreads, smem, s>>>(
        (const float*)value, (const float*)grad, (float*)dv, (float*)daw, S, Lq, M, D, LP);
  }
  return (int)cudaGetLastError();
}
