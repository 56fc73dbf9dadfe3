// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` (uvhand_tpu/ops/msda_pallas.py:207,
// launched by `_fwd_pallas_call`). That kernel builds a dense bilinear
// "tent" weight plane over every token of every level and contracts it with
// the whole value slab on the MXU, only because Mosaic had no usable
// in-kernel gather. Hopper gathers natively, so this file computes the
// same function in gather form: per (batch, query, head, level, point) it
// reads the four bilinear corners of the sample and weights each by
// attention x tent. A corner outside [0, W_l) x [0, H_l) contributes 0
// (grid_sample, align_corners=False, zero padding). Sums are float32.
//
// Inputs are read in place: value (B, S, M, D) and attention (B, Lq, M, L, P)
// in float32 or bfloat16 (the same type for both), locations
// (B, Lq, M, L, P, 2) in float32; the general kernel also takes a float64
// value, attention and locations, and then computes in float64 throughout,
// as the plain version does. Output (B, Lq, M*D) in the value's type.
//
// Two kernels, chosen by the caller from the shapes (`staged_plan` in
// ops/msda_cuda.py):
//
// * `msda_fwd_staged_kernel` (entry `msda_fwd_staged`), the kernel of the
//   model paths. As the TPU kernel keeps its whole (b, m) value slab in
//   VMEM, one block owns one (b, m) pair and a chunk of queries, and first
//   copies the slab value[b, :, m, :] (S rows of D, row stride M*D) into
//   shared memory with 16-byte cp.async; every corner gather of its queries
//   is then a shared-memory read instead of a 128-byte request through L2.
//   Each query row belongs to one 8-lane group (four rows a warp); lane j
//   holds channels j, j+8, ... of the row's sums (D = 8 kT channels, kT
//   each), and the staged rows are interleaved so that those kT channels
//   are adjacent: a corner's gather is one 16-byte load a lane (float32,
//   D = 32), a conflict-free 128-byte row a group. Eight points at a time,
//   lane j reads point k0 + j's location and attention (coalesced) and
//   computes its four corner weights and first corner row once; the group
//   walks the eight points, passing each one's by __shfl_sync, starts the
//   four corners' loads, then adds them channel by channel in (dy, dx)
//   order, kT independent sums a lane. Grid: B*M*chunks blocks of 1024
//   threads; chunks is the number of blocks the card holds at once (SMs x
//   blocks per SM at this slab size, from the occupancy calculator) over
//   B*M, at least 1 and at most one query per group. At arctic_sf's shapes
//   (B*M = 128 pairs, 132 SMs) that is 1 chunk in float32 (a 133,760-byte
//   slab: one block per SM) and 2 in bfloat16 (66,880 bytes: two
//   1024-thread blocks per SM), so every pair's slab is staged once or
//   twice and all SMs but 4 are busy.
//   It takes D = 8, 16 or 32 (rows of whole 16-byte chunks in both types).
// * `msda_fwd_general_kernel` (entry `msda_fwd`), every other shape (a slab
//   larger than shared memory, any other D): one warp per (b, q, m) row,
//   lanes over the D channels (chunks of 32), every corner a coalesced row
//   read from global memory, the per-point weight math repeated by every
//   lane.
//
// Bound on the H100 (3.35 TB/s HBM): one encoder call of the arctic_sf model
// at batch 16 (Lq = S = 1045, M = 8, D = 32, L = P = 4, float32) must move
// value 17.1 MB + locations 17.1 MB + attention 8.6 MB + output 17.1 MB,
// about 60 MB, i.e. about 18 us; its ~0.6 GFLOP of fp32 work is ~9 us at
// 67 TFLOP/s, so the call is bound by bytes. The general kernel re-reads
// about 1.1 GB of value rows per encoder call through L2 (8.56 M corner
// gathers) and was measured paced by those requests (~0.5 ms); the staged
// kernel reads each slab from L2 or HBM once per chunk and serves the
// gathers from shared memory.
//
// The file is built with -fmad=false: every product and sum is rounded on
// its own, in the same order as the plain PyTorch version
// (`ms_deform_attn_torch`; per channel over level, point, dy, dx), so both
// kernels agree with it bit for bit in float32.

#include "msda_common.cuh"

namespace {

using namespace msda;

// F is the arithmetic type (arith_t<T>): float, or double for a double value.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_general_kernel(const T* __restrict__ value, const arith_t<T>* __restrict__ loc,
                        const T* __restrict__ attn, T* __restrict__ out, LevelPlan plan,
                        int B, int S, int Lq, int M, int D, int P) {
  using F = arith_t<T>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const F* loc_row = loc + row * (long long)(L * P * 2);
  const T* attn_row = attn + row * (long long)(L * P);
  const T* value_bm = value + (long long)b * S * M * D + (long long)m * D;
  T* out_row = out + row * (long long)D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    F acc = (F)0;
    for (int l = 0; l < L; ++l) {
      const int H = plan.h[l];
      const int W = plan.w[l];
      const F fH = (F)H;
      const F fW = (F)W;
      const T* value_l = value_bm + (long long)plan.start[l] * M * D;
      for (int p = 0; p < P; ++p) {
        const int k = l * P + p;
        const F px = loc_row[2 * k] * fW - (F)0.5;
        const F py = loc_row[2 * k + 1] * fH - (F)0.5;
        const F a = to_float(attn_row[k]);
        const F x0 = floor_of(px);
        const F y0 = floor_of(py);
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const F cy = y0 + (F)dy;
          const F hy = (F)1 - abs_of(py - cy);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const F cx = x0 + (F)dx;
            const F hx = (F)1 - abs_of(px - cx);
            const bool valid = cx >= (F)0 && cx < fW && cy >= (F)0 && cy < fH;
            if (valid && active) {
              const F w = a * (hy * hx);
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

constexpr int kFwdStagedThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// D = 8 * kT channels; see the note at the top.
template <typename T, int kT>
__global__ void __launch_bounds__(kFwdStagedThreads, 1)
msda_fwd_staged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
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
      // lane j: point k0 + j's four corner weights (0 off the map) and the
      // slab row of its (y0, x0) corner
      const int k = k0 + j;
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int r0 = 0;
      if (act && k < LP) {
        const int lk = k / P;
        const int Hk = plan.h[lk];
        const int Wk = plan.w[lk];
        const float fH = (float)Hk;
        const float fW = (float)Wk;
        const float px = loc_row[2 * k] * fW - 0.5f;
        const float py = loc_row[2 * k + 1] * fH - 0.5f;
        const float a = to_float(attn_row[k]);
        const float x0 = floorf(px);
        const float y0 = floorf(py);
        bool any = false;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float cy = y0 + (float)(c >> 1);
          const float cx = x0 + (float)(c & 1);
          const float hy = 1.0f - fabsf(py - cy);
          const float hx = 1.0f - fabsf(px - cx);
          const bool valid = cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH;
          w[c] = valid ? a * (hy * hx) : 0.0f;
          any = any || valid;
        }
        // an in-map corner puts x0 in [-1, W) and y0 in [-1, H): no overflow
        if (any) r0 = plan.start[lk] + (int)y0 * Wk + (int)x0;
      }
      const int n = min(8, LP - k0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= n) break;  // uniform in the warp
        const unsigned src = lead | (unsigned)kk;
        float wc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) wc[c] = __shfl_sync(kFull, w[c], src);
        const int r = __shfl_sync(kFull, r0, src);
        // every load before any sum; a corner of weight 0 (off the map)
        // adds +0 and is not read
        float v[4][kT];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (wc[c] != 0.0f) {
            load_lane<T, kT>(slab + (r + (c >> 1) * W + (c & 1)) * D + j * kT, v[c]);
          } else {
#pragma unroll
            for (int t = 0; t < kT; ++t) v[c][t] = 0.0f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int t = 0; t < kT; ++t) acc[t] = acc[t] + wc[c] * v[c][t];
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
int launch_fwd_staged(const void* value, const void* loc, const void* attn, void* out,
                      const LevelPlan& plan, int B, int S, int Lq, int M, int P, int smem,
                      int device, cudaStream_t s) {
  const auto kernel = msda_fwd_staged_kernel<T, kT>;
  int q_chunk = 0;
  unsigned blocks = 0;
  const int err = staged_fwd_grid(kernel, kFwdStagedThreads, smem, device, (long long)B * M, Lq,
                                  &q_chunk, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kFwdStagedThreads, smem, s>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (T*)out, plan, S, Lq, M, P, q_chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd_staged(const void* value, const void* loc, const void* attn, void* out,
                        const LevelPlan& plan, int B, int S, int Lq, int M, int D, int P,
                        int smem, int device, cudaStream_t s) {
  switch (D) {
    case 8: return launch_fwd_staged<T, 1>(value, loc, attn, out, plan, B, S, Lq, M, P, smem,
                                           device, s);
    case 16: return launch_fwd_staged<T, 2>(value, loc, attn, out, plan, B, S, Lq, M, P, smem,
                                            device, s);
    case 32: return launch_fwd_staged<T, 4>(value, loc, attn, out, plan, B, S, Lq, M, P, smem,
                                            device, s);
    default: return (int)cudaErrorInvalidValue;
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
                        int dtype, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto kernel, auto t) {
    using T = decltype(t);
    kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const T*)value, (const arith_t<T>*)loc, (const T*)attn, (T*)out, plan, B, S, Lq, M, D,
        P);
    return (int)cudaGetLastError();
  };
  switch (dtype) {
    case kF32: return run(msda_fwd_general_kernel<float>, float{});
    case kBF16: return run(msda_fwd_general_kernel<__nv_bfloat16>, __nv_bfloat16{});
    case kF64: return run(msda_fwd_general_kernel<double>, double{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The staged kernel's launch, as msda_fwd's; `smem` is the slab's bytes
// (S * D * sizeof(value's type), from `staged_plan`), value must be 16-byte
// aligned, D 8, 16 or 32.
extern "C" int msda_fwd_staged(const void* value, const void* loc, const void* attn,
                               void* out, const int* hw, const int* level_start,
                               int L, int B, int S, int Lq, int M, int D, int P, int smem,
                               int dtype, int device, void* stream) {
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kBF16 ? dispatch_fwd_staged<__nv_bfloat16>(value, loc, attn, out, plan, B, S, Lq, M,
                                                      D, P, smem, device, s)
                 : dispatch_fwd_staged<float>(value, loc, attn, out, plan, B, S, Lq, M, D, P,
                                              smem, device, s);
}

extern "C" const char* msda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
