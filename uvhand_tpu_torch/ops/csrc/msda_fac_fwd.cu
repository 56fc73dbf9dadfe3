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
// Hopper gathers natively, so these kernels compute the same function on
// the support only. The value stays in the op's (B, S, M, D) layout: level
// l's row r starts at token start_l + r * W_l, so the row table needs no
// copy. Per (level, point) they touch the <= 2 rows and <= 2 columns of the
// sample that lie inside the map (zero padding elsewhere), i.e. the same
// four value rows as the gather form (msda_fwd.cu), in the TPU kernel's
// association.
//
// Rounding points, those of the TPU kernel (identities in float32):
//   ay[r] = round(1 - |py - r|)            to the value's type
//   awx[c] = round(a * (1 - |px - c|))     to the value's type
//   T[c, d] summed in float32
//   out[d] += round(awx[c] * T[c, d])      rounded before the column sum,
// and out accumulates in float32 over levels, points and columns, written
// once in the value's type. In bf16 this is a different function from the
// gather form, whose weights a * hy * hx stay float32. Inputs and output as
// msda_fwd.cu's. The general kernel also takes a float16 value (rounding
// at float16 where the bf16 kernel rounds at bf16), a float64 value
// (float64 locations; every product and sum in float64, no rounding), and
// with a bf16 or fp16 value float32 attention, which it reads and widens as
// `_msda_pallas` does (msda_pallas.py:547-551); the staged kernel takes
// float32 or bf16, one type for value and attention.
//
// Two kernels, chosen by the caller from the shapes (`staged_plan` in
// ops/msda_cuda.py, the plan of the gather forward):
//
// * `msda_fac_fwd_staged_kernel` (entry `msda_fac_fwd_staged`), the kernel
//   of the model paths, laid out as `msda_fwd_staged_kernel`: one block per
//   (b, m) pair and chunk of queries copies the pair's slab of every level
//   into shared memory with 16-byte cp.async (133,760 bytes in float32 and
//   66,880 in bf16 at arctic_sf), interleaved so that lane j of an 8-lane
//   group holds channels j, j+8, ... (whole channels; a corner is one
//   16-byte load a lane for float32 D = 32). Each query row belongs to one
//   group. Eight points at a time, lane j computes point k0 + j's row tents,
//   column weights, in-map flags and first corner once (`fac_point`), and
//   the group walks the eight, passing each one's by five __shfl_sync, loads
//   the in-map corners of the point and adds per channel in the TPU's order
//   (column, then the rows inside T): per channel and point six products
//   and four sums, and in bf16 two roundings. Grid and chunks as the gather
//   forward's (`staged_fwd_grid`). It takes D = 8, 16 or 32.
// * `msda_fac_fwd_general_kernel` (entry `msda_fac_fwd`), every other
//   shape: one warp per (b, q, m) row, lanes over the D channels (chunks of
//   32), every corner a read from global memory, the point's weights
//   computed by every lane.
//
// Bound on the H100: the same compulsory bytes and in-map corners as the
// gather forward (one encoder call of arctic_sf at batch 16 moves ~60 MB in
// float32, ~18 us at 3.35 TB/s; ~30 MB, ~11.5 us in bf16; bound by bytes).
// The general kernel was measured paced by its gather requests through L2
// (~0.55 ms an encoder call, as the general gather forward); the staged
// kernel reads each slab once per chunk and serves the gathers from shared
// memory.
//
// The file is built with -fmad=false, and the plain PyTorch version
// (`ms_deform_attn_fac_torch`) repeats this arithmetic in this order, so
// both kernels agree with it bit for bit.

#include "msda_common.cuh"

namespace {

using namespace msda;

// One sample's factorized weights at pixel (px, py) of a level H x W with
// attention a: the row tents ay[i] = round(1 - |py - (y0 + i)|) and the
// column weights awx[j] = round(a * (1 - |px - (x0 + j)|)), rounded to T,
// each 0 where its row or column lies off the map, and `code` = 16 * (the
// level's cell of the (y0, x0) corner) + flags: bits 0, 1 the rows y0,
// y0 + 1 inside the map, bits 2, 3 the columns x0, x0 + 1. The cell is 0
// when no corner is inside (an in-map corner puts x0 in [-1, W) and y0 in
// [-1, H): no overflow). With an off-map corner's value taken as 0 (never
// read), sum_j round(awx[j] * (ay[0] v[0, j] + ay[1] v[1, j])) is then the
// plain version's masked sum in value, NaN and infinity included: a zero
// term differs at most in the sign of a zero, which a float32 sum that
// starts at +0 does not keep.
template <typename T, typename F>
__device__ __forceinline__ void fac_point(F px, F py, F a, int H, int W, F (&ay)[2],
                                          F (&awx)[2], int& code) {
  const F x0 = floor_of(px);
  const F y0 = floor_of(py);
  int flags = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const F cy = y0 + (F)i;
    const F cx = x0 + (F)i;
    const bool row = cy >= (F)0 && cy < (F)H;
    const bool col = cx >= (F)0 && cx < (F)W;
    ay[i] = row ? round_to<T>((F)1 - abs_of(py - cy)) : (F)0;
    awx[i] = col ? round_to<T>(a * ((F)1 - abs_of(px - cx))) : (F)0;
    flags |= (row ? 1 << i : 0) | (col ? 4 << i : 0);
  }
  const bool any = (flags & 3) && (flags & 12);
  code = (any ? ((int)y0 * W + (int)x0) * 16 : 0) + flags;
}

// Corner (row i, column j) of a point with flags `f` lies inside the map.
__device__ __forceinline__ bool corner_in(int f, int i, int j) {
  return ((f >> i) & 1) && ((f >> (2 + j)) & 1);
}

// A is the attention's type (T, or float with a bf16 or fp16 value), read
// and widened as the TPU kernel widens it; F the arithmetic type
// (arith_t<T>): float, or double for a double value.
template <typename T, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fac_fwd_general_kernel(const T* __restrict__ value, const arith_t<T>* __restrict__ loc,
                            const A* __restrict__ attn, T* __restrict__ out, LevelPlan plan,
                            int B, int S, int Lq, int M, int D, int P) {
  using F = arith_t<T>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const F* loc_row = loc + row * (long long)(L * P * 2);
  const A* attn_row = attn + row * (long long)(L * P);
  const T* value_bm = value + (long long)b * S * M * D + (long long)m * D;
  T* out_row = out + row * (long long)D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    if (d >= D) break;  // the lanes past D have nothing to do and no warp sums
    F acc = (F)0;
    for (int l = 0; l < L; ++l) {
      const int H = plan.h[l];
      const int W = plan.w[l];
      const T* value_l = value_bm + (long long)plan.start[l] * M * D;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        F ay[2], awx[2];
        int code;
        fac_point<T, F>(loc_row[2 * k] * (F)W - (F)0.5, loc_row[2 * k + 1] * (F)H - (F)0.5,
                        to_float(attn_row[k]), H, W, ay, awx, code);
        const long long cell = code >> 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!((code >> (2 + j)) & 1)) continue;
          F t = (F)0;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (corner_in(code, i, j))
              t = t + ay[i] * to_float(value_l[(cell + i * W + j) * M * D + d]);
          }
          acc = acc + round_to<T>(awx[j] * t);
        }
      }
    }
    store(out_row + d, acc);
  }
}

constexpr int kFacFwdStagedThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// D = 8 * kT channels; see the note at the top.
template <typename T, int kT>
__global__ void __launch_bounds__(kFacFwdStagedThreads, 1)
msda_fac_fwd_staged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                           const T* __restrict__ attn, T* __restrict__ out, LevelPlan plan,
                           int S, int Lq, int M, int P, int q_chunk) {
  constexpr int D = 8 * kT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slab = (T*)smem;
  const int chunks = (Lq + q_chunk - 1) / q_chunk;
  const int bm = blockIdx.x / chunks;
  const int q0 = (blockIdx.x - bm * chunks) * q_chunk;
  const int q1 = min(Lq, q0 + q_chunk);
  const int b = bm / M;
  const int m = bm - b * M;
  stage_rows(smem, value + ((long long)b * S * M + m) * D, S, D * (int)sizeof(T),
             (long long)M * D * sizeof(T));
  interleave_rows<T, kT>(slab, S);

  const int lane = threadIdx.x & 31;
  const int j = lane & 7;
  const unsigned lead = (unsigned)(lane & ~7);  // the group's first lane
  const int L = plan.n;
  const int LP = L * P;
  const int step = 4 * (blockDim.x >> 5);
  for (int q = q0 + 4 * (threadIdx.x >> 5) + (lane >> 3); q - (lane >> 3) < q1; q += step) {
    const bool act = q < q1;  // uniform in the group
    const long long row = ((long long)b * Lq + (act ? q : q0)) * M + m;
    const float* loc_row = loc + row * (2LL * LP);
    const T* attn_row = attn + row * (long long)LP;
    float acc[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
    int l = 0, p = 0, W = plan.w[0];  // level, point and width of the next point walked
    for (int k0 = 0; k0 < LP; k0 += 8) {
      // lane j: point k0 + j's weights and code, the cell made a slab row
      const int k = k0 + j;
      float ay[2] = {0.0f, 0.0f}, awx[2] = {0.0f, 0.0f};
      int code = 0;
      if (act && k < LP) {
        const int lk = k / P;
        const int Hk = plan.h[lk];
        const int Wk = plan.w[lk];
        fac_point<T>(loc_row[2 * k] * (float)Wk - 0.5f, loc_row[2 * k + 1] * (float)Hk - 0.5f,
                     to_float(attn_row[k]), Hk, Wk, ay, awx, code);
        code += plan.start[lk] * 16;
      }
      const int n = min(8, LP - k0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= n) break;  // uniform in the warp
        const unsigned src = lead | (unsigned)kk;
        const float ay0 = __shfl_sync(kFull, ay[0], src);
        const float ay1 = __shfl_sync(kFull, ay[1], src);
        const float aw0 = __shfl_sync(kFull, awx[0], src);
        const float aw1 = __shfl_sync(kFull, awx[1], src);
        const int c = __shfl_sync(kFull, code, src);
        const int r = c >> 4;  // the slab row of the (y0, x0) corner
        // every load before any sum; a corner off the map is not read
        float v[4][kT];  // corner 2i + j: row i, column j
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          if (corner_in(c, cc >> 1, cc & 1)) {
            load_lane<T, kT>(slab + (r + (cc >> 1) * W + (cc & 1)) * D + j * kT, v[cc]);
          } else {
#pragma unroll
            for (int t = 0; t < kT; ++t) v[cc][t] = 0.0f;
          }
        }
        // per channel: column 0, then column 1, the rows inside T; off-map
        // rows, columns and corners weigh 0 (see fac_point)
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          acc[t] = acc[t] + round_to<T>(aw0 * (ay0 * v[0][t] + ay1 * v[2][t]));
          acc[t] = acc[t] + round_to<T>(aw1 * (ay0 * v[1][t] + ay1 * v[3][t]));
        }
        if (++p == P && ++l < L) {
          p = 0;
          W = plan.w[l];
        }
      }
    }
    if (act) {
#pragma unroll
      for (int t = 0; t < kT; ++t) store(out + row * D + j + 8 * t, acc[t]);
    }
  }
}

template <typename T, int kT>
int launch_fac_fwd_staged(const void* value, const void* loc, const void* attn, void* out,
                          const LevelPlan& plan, int B, int S, int Lq, int M, int P, int smem,
                          int device, cudaStream_t s) {
  const auto kernel = msda_fac_fwd_staged_kernel<T, kT>;
  int q_chunk = 0;
  unsigned blocks = 0;
  const int err = staged_fwd_grid(kernel, kFacFwdStagedThreads, smem, device, (long long)B * M,
                                  Lq, &q_chunk, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kFacFwdStagedThreads, smem, s>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (T*)out, plan, S, Lq, M, P, q_chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fac_fwd_staged(const void* value, const void* loc, const void* attn, void* out,
                            const LevelPlan& plan, int B, int S, int Lq, int M, int D, int P,
                            int smem, int device, cudaStream_t s) {
  switch (D) {
    case 8: return launch_fac_fwd_staged<T, 1>(value, loc, attn, out, plan, B, S, Lq, M, P,
                                               smem, device, s);
    case 16: return launch_fac_fwd_staged<T, 2>(value, loc, attn, out, plan, B, S, Lq, M, P,
                                                smem, device, s);
    case 32: return launch_fac_fwd_staged<T, 4>(value, loc, attn, out, plan, B, S, Lq, M, P,
                                                smem, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer) of card `device`,
// with the arguments of msda_fwd. Returns the cudaError_t of the launch (0
// when it was accepted).
// `attn_dtype` is the attention's type code: the value's, or float32 with a
// bfloat16 or float16 value.
extern "C" int msda_fac_fwd(const void* value, const void* loc, const void* attn,
                            void* out, const int* hw, const int* level_start,
                            int L, int B, int S, int Lq, int M, int D, int P,
                            int dtype, int attn_dtype, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto kernel, auto t, auto at) {
    using T = decltype(t);
    using A = decltype(at);
    kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>((const T*)value, (const arith_t<T>*)loc,
                                                  (const A*)attn, (T*)out, plan, B, S, Lq, M,
                                                  D, P);
    return (int)cudaGetLastError();
  };
  const bool own = attn_dtype == dtype;  // else float32 attention
  if (!own && attn_dtype != kF32) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return own ? run(msda_fac_fwd_general_kernel<float, float>, float{}, float{})
                          : (int)cudaErrorInvalidValue;
    case kBF16:
      return own ? run(msda_fac_fwd_general_kernel<__nv_bfloat16, __nv_bfloat16>,
                       __nv_bfloat16{}, __nv_bfloat16{})
                 : run(msda_fac_fwd_general_kernel<__nv_bfloat16, float>, __nv_bfloat16{},
                       float{});
    case kF16:
      return own ? run(msda_fac_fwd_general_kernel<__half, __half>, __half{}, __half{})
                 : run(msda_fac_fwd_general_kernel<__half, float>, __half{}, float{});
    case kF64: return own ? run(msda_fac_fwd_general_kernel<double, double>, double{}, double{})
                          : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The staged kernel's launch, with the arguments of msda_fwd_staged: `smem`
// is the slab's bytes (S * D * sizeof(value's type), from `staged_plan`),
// value must be 16-byte aligned, D 8, 16 or 32.
extern "C" int msda_fac_fwd_staged(const void* value, const void* loc, const void* attn,
                                   void* out, const int* hw, const int* level_start,
                                   int L, int B, int S, int Lq, int M, int D, int P, int smem,
                                   int dtype, int attn_dtype, int device, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || attn_dtype != dtype) return (int)cudaErrorInvalidValue;
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kBF16 ? dispatch_fac_fwd_staged<__nv_bfloat16>(value, loc, attn, out, plan, B, S, Lq,
                                                          M, D, P, smem, device, s)
                 : dispatch_fac_fwd_staged<float>(value, loc, attn, out, plan, B, S, Lq, M, D,
                                                  P, smem, device, s);
}
