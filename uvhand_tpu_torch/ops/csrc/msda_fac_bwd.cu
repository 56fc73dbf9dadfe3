// Multi-scale deformable attention (MSDA) backward, factorized form, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_fac` (uvhand_tpu/ops/msda_pallas.py:429,
// launched by `_bwd_fac_pallas_call`), the backward of `_fwd_kernel_fac`
// (see msda_fac_fwd.cu). Per (level, point), with ay, ax the row and column
// tents, axg[c, d] = ax[c] * g[d] and T[c, :] = sum_r ay[r] * V[r, c, :]:
//   dV[r, c, d] += ay[r] * a * axg[c, d]
//   dattn        = sum_c sum_d axg[c, d] * T[c, d]
//   dpy          = -a * sum_r sgn_y[r] * Q[r],  Q[r] = sum_c sum_d axg[c, d] V[r, c, d]
//   dpx          = -a * sum_c sgn_x[c] * R[c],  R[c] = sum_d g[d] T[c, d]
// with sgn(d) = where(|d| < 1, sign(d), 0) (so sign(0) = 0 at a kink), and
// dloc = (dpx * W, dpy * H). The TPU kernel builds these with 128-row tent
// matrices and expansion/fold matrices on the MXU, then unpacks its row-table
// gradient (`_unrow`) back to tokens. Here, as in the forward, one warp per
// (batch, query, head), lanes over D, touches only the <= 2 rows and <= 2
// columns of each sample inside the map, and adds dV straight into the
// token layout (B, S, M, D): no row table, no unpacking.
//
// Rounding points, those of the TPU kernel (identities in float32):
//   ay, ax                      rounded to the value's type
//   a * axg                     rounded before the dV product
//   axg * T                     rounded before dattn's sum
//   axg                         rounded before Q's products
//   g * T                       rounded before R's column fold
//   Q[r], R[c]                  rounded before the sign-weighted sums
// All sums are float32. The channel sums use the warp's xor butterfly per
// chunk of 32 channels, chunks in order, and the plain PyTorch version
// (`ms_deform_attn_fac_torch_backward`) repeats that order, so dattn and
// dloc agree with it bit for bit (the file is built with -fmad=false).
// dV is NOT deterministic: float32 atomics from many warps land on one value
// row in no fixed order; it is summed in float32 and cast once by the caller.
//
// Bound on the H100: the same compulsory bytes as the gather backward
// (one encoder call of arctic_sf at batch 16 in float32 reads value,
// locations, g and attention and writes dvalue, dloc, dattn: ~103 MB, ~31 us
// at 3.35 TB/s; bound by bytes). Per in-map corner it makes one value read
// and one float32 atomic row, as msda_bwd.cu, plus five warp reductions per
// (level, point) where msda_bwd.cu makes one per corner, so it is expected
// to run close to msda_bwd.cu, paced by gather and atomic requests.

#include "msda_common.cuh"

namespace {

using namespace msda;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fac_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
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
    const int W = plan.w[l];
    const float fH = (float)plan.h[l];
    const float fW = (float)W;
    const long long level_off = bm_off + (long long)plan.start[l] * M * D;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float px = loc_row[2 * k] * fW - 0.5f;
      const float py = loc_row[2 * k + 1] * fH - 0.5f;
      const float a = to_float(attn_row[k]);
      const float x0 = floorf(px);
      const float y0 = floorf(py);
      // per row i and column j of the sample's support (all uniform across the warp)
      float cy[2], ay[2], sy[2], cx[2], ax[2], sx[2];
      bool row_in[2], col_in[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cy[i] = y0 + (float)i;
        const float dy = py - cy[i];
        ay[i] = round_to<T>(1.0f - fabsf(dy));
        sy[i] = fabsf(dy) < 1.0f ? sign_of(dy) : 0.0f;
        row_in[i] = cy[i] >= 0.0f && cy[i] < fH;
        cx[i] = x0 + (float)i;
        const float dx = px - cx[i];
        ax[i] = round_to<T>(1.0f - fabsf(dx));
        sx[i] = fabsf(dx) < 1.0f ? sign_of(dx) : 0.0f;
        col_in[i] = cx[i] >= 0.0f && cx[i] < fW;
      }
      float daw = 0.0f, q[2] = {0.0f, 0.0f}, r[2] = {0.0f, 0.0f};
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        // per-lane terms of this chunk's channel sums; 0 on lanes past D
        float s_daw = 0.0f, s_q[2] = {0.0f, 0.0f}, s_r[2] = {0.0f, 0.0f};
        if (d < D) {
          const float g = to_float(g_row[d]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!col_in[j]) continue;
            const float axg = ax[j] * g;
            const float h = round_to<T>(a * axg);
            const float axg_r = round_to<T>(axg);
            float t = 0.0f, v[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!row_in[i]) continue;
              const long long off = level_off + ((long long)cy[i] * W + (long long)cx[j]) * M * D + d;
              v[i] = to_float(value[off]);
              t = t + ay[i] * v[i];
              atomicAdd(dvalue + off, ay[i] * h);
            }
            s_daw = s_daw + round_to<T>(axg * t);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (row_in[i]) s_q[i] = s_q[i] + axg_r * v[i];
            }
            s_r[j] = round_to<T>(g * t);
          }
        }
        daw = daw + warp_sum(s_daw);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row_in[i]) q[i] = q[i] + warp_sum(s_q[i]);
          if (col_in[i]) r[i] = r[i] + warp_sum(s_r[i]);
        }
      }
      if (lane == 0) {
        float gy = 0.0f, gx = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row_in[i]) gy = gy + sy[i] * round_to<T>(q[i]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col_in[j]) gx = gx + sx[j] * round_to<T>(r[j]);
        }
        store(dattn_row + k, daw);
        dloc_row[2 * k] = -(a * gx) * fW;
        dloc_row[2 * k + 1] = -(a * gy) * fH;
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) of card `device`,
// with the arguments of msda_bwd. `dvalue` (float32) must be zeroed by the
// caller. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int msda_fac_bwd(const void* value, const void* loc, const void* attn,
                            const void* grad, void* dvalue, void* dloc, void* dattn,
                            const int* hw, const int* level_start,
                            int L, int B, int S, int Lq, int M, int D, int P,
                            int is_bf16, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_fac_bwd_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const __nv_bfloat16*)attn,
        (const __nv_bfloat16*)grad, (float*)dvalue, (float*)dloc,
        (__nv_bfloat16*)dattn, plan, B, S, Lq, M, D, P);
  } else {
    msda_fac_bwd_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (const float*)grad, (float*)dvalue, (float*)dloc, (float*)dattn,
        plan, B, S, Lq, M, D, P);
  }
  return (int)cudaGetLastError();
}
