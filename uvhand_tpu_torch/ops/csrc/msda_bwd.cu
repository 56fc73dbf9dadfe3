// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces both TPU backward kernels: `_bwd_kernel_sep`
// (uvhand_tpu/ops/msda_pallas.py:233, separable row/column folds, bf16 with
// every level side <= 128) and `_bwd_kernel` (:320, dense per-point
// reductions, float32 or any side > 128). The two compute the same three
// gradients and differ only in how the TPU's matrix unit reduces them: they
// build dense tent planes over every token because Mosaic had no usable
// in-kernel gather. Hopper gathers natively, so one kernel in gather form
// serves every regime of the two.
//
// Per (batch b, query q, head m) one warp, lanes over the D channels of the
// head (chunks of 32 for D > 32), as in the forward kernel. For every
// (level, point) the warp recomputes the sample's pixel coordinates, floor
// corners and the four tents with the forward's expressions. For each corner
// inside the level map it
//   - reads the value row v_c and reduces dot_c = sum_d g_d * v_c[d] across
//     the warp in a fixed order (xor butterfly 16, 8, 4, 2, 1 per chunk of 32
//     channels, chunks summed in order), so every lane holds the same dot;
//   - adds a * w_c * g into a float32 dvalue buffer with atomicAdd.
// From the dots, per point:
//   dattn = sum_c w_c * dot_c                        (w_c = hy_c * hx_c)
//   dpx   = -a * sum_c sx_c * hy_c * dot_c,  sx_c = sign(px - cx_c) where the
//           corner's x tent hx_c > 0, else 0 (so sign(0) = 0 at a kink)
//   dpy   = -a * sum_c sy_c * hx_c * dot_c   (likewise)
// and the chain rule through px = x * W - 0.5 gives dloc = (dpx * W, dpy * H).
// This is the convention of the JAX backward (`_msda_bwd`,
// uvhand_tpu/ops/msda.py:288-295) and of the TPU kernels (`where(|d| < 1,
// sign(d), 0)`).
//
// Inputs, read in place: value (B, S, M, D) and attention (B, Lq, M, L, P) in
// float32 or bfloat16 (one type for both), the incoming gradient g
// (B, Lq, M*D) in the same type, locations (B, Lq, M, L, P, 2) float32.
// Outputs: dvalue (B, S, M, D) float32, zeroed by the caller and cast to the
// value's type by the caller after the sum; dloc (B, Lq, M, L, P, 2)
// float32; dattn (B, Lq, M, L, P) in the attention's type. bfloat16 inputs
// are widened and every sum is float32.
//
// The file is built with -fmad=false. dattn and dloc are deterministic and
// repeat the plain PyTorch version's order (`ms_deform_attn_torch_backward`),
// so they agree with it bit for bit in float32 in practice. dvalue is NOT
// deterministic: atomics from many warps land on one row in no fixed order,
// so its float32 sums differ from run to run in the last bits.
//
// Bound on the H100 (3.35 TB/s HBM): one encoder call of the arctic_sf model
// at batch 16 (Lq = S = 1045, M = 8, D = 32, L = P = 4, float32) must read
// value 17.1 MB, locations 17.1 MB, g 17.1 MB and attention 8.6 MB, and
// write dvalue 17.1 MB, dloc 17.1 MB and dattn 8.6 MB: about 103 MB, about
// 31 us. A decoder call (Lq = 300) moves about 54 MB, about 16 us. The work
// is ~8.6 M corner gathers of a 128-byte value row per encoder call and as
// many 128-byte rows of float32 atomics. The forward kernel was found paced
// by its gather requests through L2 rather than by HBM bytes, and this one
// makes twice the requests (a read and an atomic per corner), so it is
// expected to sit well above its byte bound. Staging value tiles in shared
// memory, TMA and wgmma are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kWarpsPerBlock = 8;

struct LevelPlan {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

// Sum over the 32 lanes; every lane ends with the same value.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ attn, const T* __restrict__ grad,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                T* __restrict__ dattn, LevelPlan plan,
                int B, int S, int Lq, int M, int D, int P) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;  // uniform across the warp
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const float* loc_row = loc + row * (long long)(L * P * 2);
  const T* attn_row = attn + row * (long long)(L * P);
  const T* g_row = grad + row * (long long)D;
  float* dloc_row = dloc + row * (long long)(L * P * 2);
  T* dattn_row = dattn + row * (long long)(L * P);
  const long long bm_off = (long long)b * S * M * D + (long long)m * D;

  for (int l = 0; l < L; ++l) {
    const int H = plan.h[l];
    const int W = plan.w[l];
    const float fH = (float)H;
    const float fW = (float)W;
    const long long level_off = bm_off + (long long)plan.start[l] * M * D;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float px = loc_row[2 * k] * fW - 0.5f;
      const float py = loc_row[2 * k + 1] * fH - 0.5f;
      const float a = to_float(attn_row[k]);
      const float x0 = floorf(px);
      const float y0 = floorf(py);
      float da = 0.0f, gx = 0.0f, gy = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float cy = y0 + (float)dy;
        const float hy = 1.0f - fabsf(py - cy);
        const float sy = hy > 0.0f ? sign_of(py - cy) : 0.0f;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float cx = x0 + (float)dx;
          const float hx = 1.0f - fabsf(px - cx);
          const float sx = hx > 0.0f ? sign_of(px - cx) : 0.0f;
          const bool valid = cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH;
          if (!valid) continue;  // uniform across the warp
          const float wc = hy * hx;
          const float aw = a * wc;
          const long long cell = (long long)cy * W + (long long)cx;
          const T* v_c = value + level_off + cell * M * D;
          float* dv_c = dvalue + level_off + cell * M * D;
          float dot = 0.0f;
          for (int d0 = 0; d0 < D; d0 += 32) {
            const int d = d0 + lane;
            float gv = 0.0f;
            if (d < D) {
              const float gd = to_float(g_row[d]);
              gv = gd * to_float(v_c[d]);
              atomicAdd(dv_c + d, aw * gd);
            }
            dot = dot + warp_sum(gv);
          }
          da = da + wc * dot;
          gx = gx + (sx * hy) * dot;
          gy = gy + (sy * hx) * dot;
        }
      }
      if (lane == 0) {
        store(dattn_row + k, da);
        dloc_row[2 * k] = -(a * gx) * fW;
        dloc_row[2 * k + 1] = -(a * gy) * fH;
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) of card `device`.
// Shapes are host arrays as for msda_fwd. `dvalue` must be zeroed by the
// caller. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* grad, void* dvalue, void* dloc, void* dattn,
                        const int* hw, const int* level_start,
                        int L, int B, int S, int Lq, int M, int D, int P,
                        int is_bf16, int device, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  LevelPlan plan;
  plan.n = L;
  for (int l = 0; l < L; ++l) {
    plan.h[l] = hw[2 * l];
    plan.w[l] = hw[2 * l + 1];
    plan.start[l] = level_start[l];
  }
  const long long rows = (long long)B * Lq * M;
  if (rows == 0) return 0;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const __nv_bfloat16*)attn,
        (const __nv_bfloat16*)grad, (float*)dvalue, (float*)dloc,
        (__nv_bfloat16*)dattn, plan, B, S, Lq, M, D, P);
  } else {
    msda_bwd_kernel<float><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (const float*)grad, (float*)dvalue, (float*)dloc, (float*)dattn,
        plan, B, S, Lq, M, D, P);
  }
  return (int)cudaGetLastError();
}
