// The dense `onlyg` variant of the MSDA backward ablation, for Hopper
// (sm_90a).
//
// Replaces the `onlyg` branch of the TPU kernel `kernel`
// (scripts/bench_msda_ablation.py:1086-1095, `pallas_call` :1215): the
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
//
// One block per (b, m, tile of 32 tokens), 256 threads. The block widens its
// 32 value rows into shared memory once, then walks the queries in tiles of
// 32: it stages the tile's g rows, computes the 32x32 tile of G (each entry
// summed over d in order 0..D-1, which the plain version repeats, so G and
// daw agree with it bit for bit; the file is built with -fmad=false), rounds
// it, and adds round(G)^T g into the tile's dv, kept in shared memory (each
// thread owns fixed entries, so no atomics and a fixed order). No plane of
// G ever reaches device memory.
//
// Bound on the H100: 2 * 2 * B*M * Lq * S * D operations. At the ablation
// script's shapes (B*M = 128, Lq = S = 1045, D = 32) 17.9 GFLOP: 0.267 ms at
// the 67 TFLOP/s float32 rate outside the tensor cores, 0.018 ms at the
// 989 TFLOP/s dense bf16 tensor-core rate. This kernel uses no tensor cores
// and reads both operands from shared memory for every product (two 4-byte
// loads per multiply-add), so shared-memory bandwidth paces it; register
// tiling and wgmma are later work.

#include "msda_common.cuh"

namespace {

using namespace msda;

constexpr int kTile = 32;     // tokens per block, and queries per step
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_onlyg_kernel(const T* __restrict__ value, const T* __restrict__ grad,
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

}  // namespace

// Launch on `stream` of card `device`. dv and daw need no zeroing: every
// entry is written. Returns the cudaError_t of the launch (0 when accepted).
extern "C" int msda_onlyg(const void* value, const void* grad, void* dv, void* daw,
                          int B, int S, int Lq, int M, int D, int LP,
                          int is_bf16, int device, void* stream) {
  if (B < 1 || S < 1 || Lq < 1 || M < 1 || D < 1 || LP < 1 || LP > S)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * kTile * (D + 1) + kTile * (kTile + 1) + kTile * D);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long bm = (long long)B * M;
  if (bm > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((S + kTile - 1) / kTile, (unsigned)bm);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_onlyg_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        (const __nv_bfloat16*)value, (const __nv_bfloat16*)grad, (float*)dv, (float*)daw,
        S, Lq, M, D, LP);
  } else {
    msda_onlyg_kernel<float><<<grid, kThreads, smem, s>>>(
        (const float*)value, (const float*)grad, (float*)dv, (float*)daw, S, Lq, M, D, LP);
  }
  return (int)cudaGetLastError();
}
