// Multi-scale deformable attention (MSDA) forward, factorized form, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_fac` (uvhand_tpu/ops/msda_pallas.py:388,
// launched by `_fwd_fac_pallas_call`), which the JAX package runs instead of
// `_fwd_kernel` under UVHAND_MSDA_FAC=1. That kernel lays each level's value
// out as a row table (row r, then the W*D channels of its cells, padded to
// 128 rows and 128 lanes) and computes, per (level, point), with the MXU:
//   T[c, :] = sum_r ay[r] * V[r, c, :]           (rows first)
//   out    += sum_c (aw * ax[c]) * T[c, :]        (then columns)
// through 128-row tent matrices and 0/1 expansion and fold matrices, about
// 64x the tent's 2-row support, because Mosaic had no in-kernel gather.
//
// Hopper gathers natively, so this kernel computes the same function on the
// support only. The value stays in the op's (B, S, M, D) layout: level l's
// row r starts at token start_l + r * W_l, so the row table needs no copy.
// Per (batch, query, head) one warp, lanes over the D channels; per (level,
// point) the warp touches the <= 2 rows and <= 2 columns of the sample that
// lie inside the map (zero padding elsewhere), i.e. the same four value
// rows as the gather form (msda_fwd.cu), in the TPU kernel's association.
//
// Rounding points, those of the TPU kernel (identities in float32):
//   ay[r] = round(1 - |py - r|)            to the value's type
//   awx[c] = round(a * (1 - |px - c|))     to the value's type
//   T[c, d] summed in float32
//   out[d] += round(awx[c] * T[c, d])      rounded before the column sum,
// and out accumulates in float32 over levels, points and columns, written
// once in the value's type. In bf16 this is a different function from the
// gather form, whose weights a * hy * hx stay float32.
//
// Bound on the H100: the same compulsory bytes and in-map corners as the
// gather forward (one encoder call of arctic_sf at batch 16 moves ~60 MB in
// float32, ~18 us at 3.35 TB/s; bound by bytes). Like msda_fwd.cu it is
// expected to be paced by its gather requests through L2, not by HBM bytes.
//
// The file is built with -fmad=false, and the plain PyTorch version
// (`ms_deform_attn_fac_torch`) repeats this arithmetic in this order, so the
// two agree bit for bit.

#include "msda_common.cuh"

namespace {

using namespace msda;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fac_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
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
    if (d >= D) break;  // the lanes past D have nothing to do and no warp sums
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) {
      const int W = plan.w[l];
      const float fH = (float)plan.h[l];
      const float fW = (float)W;
      const T* value_l = value_bm + (long long)plan.start[l] * M * D;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const float px = loc_row[2 * k] * fW - 0.5f;
        const float py = loc_row[2 * k + 1] * fH - 0.5f;
        const float a = to_float(attn_row[k]);
        const float x0 = floorf(px);
        const float y0 = floorf(py);
        float cy[2], ay[2];
        bool row_in[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          cy[i] = y0 + (float)i;
          ay[i] = round_to<T>(1.0f - fabsf(py - cy[i]));
          row_in[i] = cy[i] >= 0.0f && cy[i] < fH;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float cx = x0 + (float)j;
          if (!(cx >= 0.0f && cx < fW)) continue;
          const float awx = round_to<T>(a * (1.0f - fabsf(px - cx)));
          float t = 0.0f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!row_in[i]) continue;
            const long long cell = (long long)cy[i] * W + (long long)cx;
            t = t + ay[i] * to_float(value_l[cell * M * D + d]);
          }
          acc = acc + round_to<T>(awx * t);
        }
      }
    }
    store(out_row + d, acc);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) of card `device`,
// with the arguments of msda_fwd. Returns the cudaError_t of the launch (0
// when it was accepted).
extern "C" int msda_fac_fwd(const void* value, const void* loc, const void* attn,
                            void* out, const int* hw, const int* level_start,
                            int L, int B, int S, int Lq, int M, int D, int P,
                            int is_bf16, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_fac_fwd_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc,
        (const __nv_bfloat16*)attn, (__nv_bfloat16*)out, plan, B, S, Lq, M, D, P);
  } else {
    msda_fac_fwd_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (float*)out, plan, B, S, Lq, M, D, P);
  }
  return (int)cudaGetLastError();
}
