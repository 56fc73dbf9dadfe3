// The `xdot` variant of the MSDA backward ablation, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel_xdot` (scripts/bench_msda_ablation.py:1022,
// `pallas_call` :1182; variants `xdot` and `xdotred`, which differ only in
// how Mosaic reduces). There the dense plane G = g v^T is an INPUT, made by
// a GEMM outside the kernel, and the dense weight plane ws goes OUT to
// device memory for a second GEMM outside the kernel, dv = ws^T g; the
// kernel body is the per-point work between the two. The two GEMMs stay
// `torch.matmul` in the port, as the JAX code leaves them to XLA.
//
// Per (batch b, query q, head m) row, with bm = b * M + m, and per point
// (level l, point p), pixel coordinates px = x * W_l - 0.5, py likewise, the
// attention a, and the sample's four corners c inside the level map with
// tents hy_c, hx_c and gates sy_c, sx_c (sign(d) where the tent is > 0,
// else 0; as msda_bwd.cu):
//   daw = sum_c (hy_c hx_c) G_c
//   dpx = -(a * sum_c (sx_c hy_c) G_c),  dpy = -(a * sum_c (sy_c hx_c) G_c)
//   ws[bm, q, s] = sum over the row's points, in (l, p) order, of
//                  a * (hy_c hx_c) for the corners c at token s, in float32,
//                  then rounded to the value's type; 0 elsewhere.
// G_c = G[bm, q, token of c] widened to float32. dpy, dpx, daw are the
// gradients in pixel space, before the chain rule.
//
// Inputs, read in place: G (B*M, Lq, S) and attention (B, Lq, M, L, P) in
// float32 or bfloat16 (one type), locations (B, Lq, M, L, P, 2) float32.
// Outputs: dpy, dpx, daw (B, Lq, M, L, P) float32; ws (B*M, Lq, S) in the
// value's type, every entry written here (the caller need not zero it).
//
// One warp per row, lanes over the row's points (one point a lane). A row
// has one owner, so ws needs no atomics: the warp zeroes the row's float32
// copy in shared memory, the lanes add their corners' weights into it one
// point after the other (a fixed order, which the plain version repeats, so
// everything agrees with it bit for bit; the file is built with
// -fmad=false), and the warp writes the whole row, coalesced, in the value's
// type.
//
// Bound on the H100: writing the ws plane, B*M*Lq*S elements. At the
// ablation script's shapes (B*M = 128, Lq = S = 1045) that is 559 MB in
// float32 (0.167 ms at 3.35 TB/s) or 280 MB in bfloat16 (0.083 ms), plus
// the per-point arrays and the G entries at the in-map corners (what this
// run's data needs of G: at most 64 of a row's 1045 entries).

#include "msda_common.cuh"

namespace {

using namespace msda;

template <typename T>
__global__ void msda_xdot_kernel(const T* __restrict__ G, const float* __restrict__ loc,
                                 const T* __restrict__ attn, float* __restrict__ dpy,
                                 float* __restrict__ dpx, float* __restrict__ daw,
                                 T* __restrict__ ws, LevelPlan plan, int B, int S, int Lq,
                                 int M, int P) {
  extern __shared__ float rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (long long)B * Lq * M) return;  // uniform across the warp
  const int m = (int)(row % M);
  const int q = (int)((row / M) % Lq);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;
  const int LP = L * P;
  const long long plane_row = (((long long)b * M + m) * Lq + q) * S;
  const T* G_row = G + plane_row;
  float* buf = rows + (long long)warp * S;

  for (int s = lane; s < S; s += 32) buf[s] = 0.0f;
  __syncwarp();
  for (int k0 = 0; k0 < LP; k0 += 32) {
    const int k = k0 + lane;
    int tok[4] = {-1, -1, -1, -1};  // -1: the corner is off the map
    float wt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < LP) {
      const int l = k / P;
      const int H = plan.h[l];
      const int W = plan.w[l];
      const float fH = (float)H;
      const float fW = (float)W;
      const float px = loc[(row * LP + k) * 2] * fW - 0.5f;
      const float py = loc[(row * LP + k) * 2 + 1] * fH - 0.5f;
      const float a = to_float(attn[row * LP + k]);
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
          const int c = 2 * dy + dx;
          if (!(cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH)) continue;
          const float wc = hy * hx;
          tok[c] = plan.start[l] + (int)cy * W + (int)cx;
          wt[c] = a * wc;
          const float g_c = to_float(G_row[tok[c]]);
          da = da + wc * g_c;
          gx = gx + (sx * hy) * g_c;
          gy = gy + (sy * hx) * g_c;
        }
      }
      dpy[row * LP + k] = -(a * gy);
      dpx[row * LP + k] = -(a * gx);
      daw[row * LP + k] = da;
    }
    // the row's weights, one point after the other in (l, p) order
    const int n = min(32, LP - k0);
    for (int j = 0; j < n; ++j) {
      if (lane == j) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tok[c] >= 0) buf[tok[c]] = buf[tok[c]] + wt[c];
      }
      __syncwarp();
    }
  }
  for (int s = lane; s < S; s += 32) store(ws + plane_row + s, buf[s]);
}

}  // namespace

// Launch on `stream` of card `device`; shapes are host arrays as for
// msda_fwd. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int msda_xdot(const void* G, const void* loc, const void* attn, void* dpy, void* dpx,
                         void* daw, void* ws, const int* hw, const int* level_start,
                         int L, int B, int S, int Lq, int M, int P,
                         int is_bf16, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const long long rows = (long long)B * Lq * M;
  int err = prepare(hw, level_start, L, 1, P, device, rows, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  // as many warps a block as 48 KB of shared memory (no opt-in needed) hold rows
  const long long fit = (48 * 1024) / (4LL * S);
  const int warps = fit < kWarpsPerBlock ? (int)fit : kWarpsPerBlock;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const long long n = (rows + warps - 1) / warps;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (size_t)warps * S;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_xdot_kernel<__nv_bfloat16><<<(unsigned)n, warps * 32, smem, s>>>(
        (const __nv_bfloat16*)G, (const float*)loc, (const __nv_bfloat16*)attn, (float*)dpy,
        (float*)dpx, (float*)daw, (__nv_bfloat16*)ws, plan, B, S, Lq, M, P);
  } else {
    msda_xdot_kernel<float><<<(unsigned)n, warps * 32, smem, s>>>(
        (const float*)G, (const float*)loc, (const float*)attn, (float*)dpy, (float*)dpx,
        (float*)daw, (float*)ws, plan, B, S, Lq, M, P);
  }
  return (int)cudaGetLastError();
}
