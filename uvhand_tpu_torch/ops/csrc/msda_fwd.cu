// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (uvhand_tpu/ops/msda_pallas.py:207,
// launched by `_fwd_pallas_call`). That kernel builds a dense bilinear
// "tent" weight plane over every token of every level and contracts it with
// the whole value slab on the MXU, only because Mosaic had no usable
// in-kernel gather. Hopper gathers natively, so this kernel computes the
// same function in gather form: per (batch, query, head, level, point) it
// reads the four bilinear corners of the sample and weights each by
// attention x tent. A corner outside [0, W_l) x [0, H_l) contributes 0
// (grid_sample, align_corners=False, zero padding). Sums are float32.
//
// Layout: one warp per (b, q, m) row, lanes over the D channels of a head,
// so a corner read is one coalesced row of D values (128 bytes for D=32
// float32). Channels beyond 32 are handled in chunks of 32 by the same warp.
// The warp loops over levels and points; the per-point weight math is
// repeated by every lane (it is cheap next to the gathers).
//
// Inputs are read in place: value (B, S, M, D) and attention (B, Lq, M, L, P)
// in float32 or bfloat16 (the same type for both), locations
// (B, Lq, M, L, P, 2) in float32. Output (B, Lq, M*D) in the value's type.
//
// Bound on the H100 (3.35 TB/s HBM): one encoder call of the arctic_sf model
// at batch 16 (Lq = S = 1045, M = 8, D = 32, L = P = 4, float32) must move
// value 17.1 MB + locations 17.1 MB + attention 8.6 MB + output 17.1 MB,
// about 60 MB, i.e. about 18 us; its ~0.6 GFLOP of fp32 work is ~9 us at
// 67 TFLOP/s, so the call is bound by bytes. The gathers themselves re-read
// about 1.1 GB of value rows per encoder call; the 17 MB value fits the
// 50 MB L2, which serves that traffic. This simple kernel is expected to be
// paced by those L2 gathers rather than by HBM; staging, TMA and wgmma are
// left for later work.
//
// The file is built with -fmad=false: every product and sum is rounded on
// its own, in the same order as the plain PyTorch version
// (`ms_deform_attn_torch`), so the two agree bit for bit in float32.

#include "msda_common.cuh"

namespace {

using namespace msda;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ attn, T* __restrict__ out, LevelPlan plan,
                int B, int S, int Lq, int M, int D, int P) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const float* loc_row = loc + row * (long long)(L * P * 2);
  const T* attn_row = attn + row * (long long)(L * P);
  const T* value_bm = value + (long long)b * S * M * D + (long long)m * D;
  T* out_row = out + row * (long long)D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int H = plan.h[l];
      const int W = plan.w[l];
      const float fH = (float)H;
      const float fW = (float)W;
      const T* value_l = value_bm + (long long)plan.start[l] * M * D;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float px = loc_row[2 * k] * fW - 0.5f;
        const float py = loc_row[2 * k + 1] * fH - 0.5f;
        const float a = to_float(attn_row[k]);
        const float x0 = floorf(px);
        const float y0 = floorf(py);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float cy = y0 + (float)dy;
          const float hy = 1.0f - fabsf(py - cy);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float cx = x0 + (float)dx;
            const float hx = 1.0f - fabsf(px - cx);
            const bool valid = cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH;
            if (valid && active) {
              const float w = a * (hy * hx);
              const long long cell = (long long)cy * W + (long long)cx;
              acc = acc + w * to_float(value_l[cell * M * D + d]);
            }
          }
        }
      }
    }
    if (active) store(out_row + d, acc);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) of card `device`.
// Shapes are host arrays: hw = [H_0, W_0, H_1, W_1, ...],
// level_start = [0, H_0*W_0, ...]. Returns the cudaError_t of the launch
// (0 when it was accepted).
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, const int* hw, const int* level_start,
                        int L, int B, int S, int Lq, int M, int D, int P,
                        int is_bf16, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_fwd_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc,
        (const __nv_bfloat16*)attn, (__nv_bfloat16*)out, plan, B, S, Lq, M, D, P);
  } else {
    msda_fwd_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, plan, B, S, Lq, M, D, P);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
