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
// gradient (`_unrow`) back to tokens. Here, as in the forward, the kernels
// touch only the <= 2 rows and <= 2 columns of each sample inside the map,
// and add dV straight into the token layout (B, S, M, D): no row table, no
// unpacking.
//
// Rounding points, those of the TPU kernel (identities in float32):
//   ay, ax                      rounded to the value's type
//   a * axg                     rounded before the dV product
//   axg * T                     rounded before dattn's sum
//   axg                         rounded before Q's products
//   g * T                       rounded before R's column fold
//   Q[r], R[c]                  rounded before the sign-weighted sums
// All sums are float32. The five channel sums of a point (dattn, Q[0],
// Q[1], R[0], R[1]) follow the warp's xor butterfly per chunk of 32
// channels, chunks in order, and the plain PyTorch version
// (`ms_deform_attn_fac_torch_backward`) repeats that order, so dattn and
// dloc agree with it bit for bit (the file is built with -fmad=false). dV
// is NOT deterministic: float32 additions from many threads land on one
// value row in no fixed order. Inputs and outputs as msda_bwd.cu's. The
// general kernel also takes the types of msda_fac_fwd.cu's general kernel:
// a float16 value (rounding at float16), a float64 value (float64
// throughout, no rounding, float64 atomics into dV), and float32 attention
// with a bf16 or fp16 value, read and widened; dattn is written in the
// attention's type.
//
// Two kernels, chosen by the caller from the shapes (`staged_plan(...,
// backward=True)` in ops/msda_cuda.py, the plan of the gather backward):
//
// * `msda_fac_bwd_staged_kernel` (entry `msda_fac_bwd_staged`), the kernel
//   of the model paths, laid out as `msda_bwd_staged_kernel`: one block per
//   (b, m, level), since a level's dattn and dloc need only its value rows
//   and its dV rows only its points. The block zeroes the float32 sums of
//   the dV rows it owns, copies the level's value rows into shared memory
//   with 16-byte cp.async (100,352 bytes for arctic_sf's largest level in
//   float32, 50,176 in bf16: two 512-thread blocks an SM) and interleaves
//   them, so that lane j of an 8-lane group holds channels j, j+8, j+16,
//   j+24 -- the channels the butterfly's steps 16 and 8 add, which the lane
//   adds in registers. Each group takes one (query, point) pair at a time;
//   per column it reads the in-map corners (one 16-byte load a lane for
//   float32 D = 32), adds the per-channel terms of the five sums and sends
//   its dV rows ay * round(a * axg) to L2 as float32 vector reductions
//   (red.global.add.v4.f32: no return value, no retry loop; a float32
//   atomicAdd on shared memory is a compare-and-swap loop on sm_90). The
//   butterfly's steps 4, 2, 1 then run for the five sums together, 15
//   shuffles. In bfloat16 the sums go into float32 scratch that the block
//   rounds once into its dV rows at its end, so the caller neither
//   zero-fills nor casts dvalue. B * M * L blocks of 512 threads; it takes
//   D = 8, 16 or 32.
// * `msda_fac_bwd_general_kernel` (entry `msda_fac_bwd`), every other
//   shape: one warp per (batch, query, head), lanes over D (chunks of 32),
//   every corner a read from global memory, five 32-lane butterflies per
//   point and float32 atomics into a dV buffer the caller zeroes and casts.
//
// Bound on the H100: the same compulsory bytes as the gather backward
// (one encoder call of arctic_sf at batch 16 in float32 reads value,
// locations, g and attention and writes dvalue, dloc, dattn: ~103 MB, ~31 us
// at 3.35 TB/s; ~68 MB, ~20 us in bf16; bound by bytes). Both kernels make,
// per in-map corner, one value read and one row of float32 additions into
// dV, as msda_bwd.cu; the general kernel was measured at about the general
// gather backward's time (~1.3 ms an encoder call), paced by its gathers
// and dependent warp reductions; the staged kernel serves the gathers from
// shared memory and keeps each dV row's additions one vector a lane.

#include "msda_common.cuh"

namespace {

using namespace msda;

// One sample's support at pixel (px, py) of a level H x W: per row i
// (y0 + i) and column i (x0 + i) the tent rounded to T (ay, ax), the gate
// where(|d| < 1, sign(d), 0) (sy, sx) and whether it lies inside the map
// (rin, cin), and the level's cell of the (y0, x0) corner (0 when no corner
// is inside; an in-map corner puts x0 in [-1, W) and y0 in [-1, H): no
// overflow).
template <typename F>
struct FacSample {
  F ay[2], sy[2], ax[2], sx[2];
  bool rin[2], cin[2];
  int cell0;
};

template <typename T, typename F>
__device__ __forceinline__ FacSample<F> fac_sample(F px, F py, int H, int W) {
  FacSample<F> s;
  const F x0 = floor_of(px);
  const F y0 = floor_of(py);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const F cy = y0 + (F)i;
    const F dy = py - cy;
    s.ay[i] = round_to<T>((F)1 - abs_of(dy));
    s.sy[i] = abs_of(dy) < (F)1 ? sign_of(dy) : (F)0;
    s.rin[i] = cy >= (F)0 && cy < (F)H;
    const F cx = x0 + (F)i;
    const F dx = px - cx;
    s.ax[i] = round_to<T>((F)1 - abs_of(dx));
    s.sx[i] = abs_of(dx) < (F)1 ? sign_of(dx) : (F)0;
    s.cin[i] = cx >= (F)0 && cx < (F)W;
  }
  s.cell0 = (s.rin[0] || s.rin[1]) && (s.cin[0] || s.cin[1]) ? (int)y0 * W + (int)x0 : 0;
  return s;
}

// A is the attention's type (T, or float with a bf16 or fp16 value), read
// and widened, and dattn's; F the arithmetic type (arith_t<T>): float, or
// double for a double value.
template <typename T, typename A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fac_bwd_general_kernel(const T* __restrict__ value, const arith_t<T>* __restrict__ loc,
                            const A* __restrict__ attn, const T* __restrict__ grad,
                            arith_t<T>* __restrict__ dvalue, arith_t<T>* __restrict__ dloc,
                            A* __restrict__ dattn, LevelPlan plan,
                            int B, int S, int Lq, int M, int D, int P) {
  using F = arith_t<T>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;  // uniform across the warp
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const F* loc_row = loc + row * (long long)(L * P * 2);
  const A* attn_row = attn + row * (long long)(L * P);
  const T* g_row = grad + row * (long long)D;
  F* dloc_row = dloc + row * (long long)(L * P * 2);
  A* dattn_row = dattn + row * (long long)(L * P);
  const long long bm_off = (long long)b * S * M * D + (long long)m * D;

  for (int l = 0; l < L; ++l) {
    const int H = plan.h[l];
    const int W = plan.w[l];
    const F fH = (F)H;
    const F fW = (F)W;
    const long long level_off = bm_off + (long long)plan.start[l] * M * D;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const F a = to_float(attn_row[k]);
      // the sample's support (uniform across the warp)
      const FacSample<F> s = fac_sample<T, F>(loc_row[2 * k] * fW - (F)0.5,
                                              loc_row[2 * k + 1] * fH - (F)0.5, H, W);
      F daw = (F)0, q[2] = {(F)0, (F)0}, r[2] = {(F)0, (F)0};
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        // per-lane terms of this chunk's channel sums; 0 on lanes past D
        F s_daw = (F)0, s_q[2] = {(F)0, (F)0}, s_r[2] = {(F)0, (F)0};
        if (d < D) {
          const F g = to_float(g_row[d]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!s.cin[j]) continue;
            const F axg = s.ax[j] * g;
            const F h = round_to<T>(a * axg);
            const F axg_r = round_to<T>(axg);
            F t = (F)0, v[2] = {(F)0, (F)0};
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (!s.rin[i]) continue;
              const long long off = level_off + (long long)(s.cell0 + i * W + j) * M * D + d;
              v[i] = to_float(value[off]);
              t = t + s.ay[i] * v[i];
              atomicAdd(dvalue + off, s.ay[i] * h);
            }
            s_daw = s_daw + round_to<T>(axg * t);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (s.rin[i]) s_q[i] = s_q[i] + axg_r * v[i];
            }
            s_r[j] = round_to<T>(g * t);
          }
        }
        daw = daw + warp_sum(s_daw);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (s.rin[i]) q[i] = q[i] + warp_sum(s_q[i]);
          if (s.cin[i]) r[i] = r[i] + warp_sum(s_r[i]);
        }
      }
      if (lane == 0) {
        F gy = (F)0, gx = (F)0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (s.rin[i]) gy = gy + s.sy[i] * round_to<T>(q[i]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (s.cin[j]) gx = gx + s.sx[j] * round_to<T>(r[j]);
        }
        store(dattn_row + k, daw);
        dloc_row[2 * k] = -(a * gx) * fW;
        dloc_row[2 * k + 1] = -(a * gy) * fH;
      }
    }
  }
}

constexpr int kFacBwdStagedThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// One block per (b, m, level), D = 8 * kT channels; see the note at the top.
// `dsum` holds the float32 sums: dvalue itself when T is float32, else
// scratch of dvalue's shape that the block rounds into dvalue at its end.
template <typename T, int kT>
__global__ void __launch_bounds__(kFacBwdStagedThreads, 2)
msda_fac_bwd_staged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                           const T* __restrict__ attn, const T* __restrict__ grad, T* dvalue,
                           float* dsum, float* __restrict__ dloc, T* __restrict__ dattn,
                           LevelPlan plan, int S, int Lq, int M, int P) {
  constexpr int D = 8 * kT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = (T*)smem;
  const int L = plan.n;
  const int l = blockIdx.x % L;
  const int bm = blockIdx.x / L;
  const int b = bm / M;
  const int m = bm - b * M;
  const int H = plan.h[l];
  const int W = plan.w[l];
  const long long MD = (long long)M * D;
  const long long slab = ((long long)b * S + plan.start[l]) * MD + (long long)m * D;
  stage_owned_rows<T, kT>(vs, value + slab, dsum + slab, H * W, MD);

  const float fH = (float)H;
  const float fW = (float)W;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3;
  const int j = lane & 7;
  const int LP = L * P;
  const long long pairs = (long long)Lq * P;
  const long long step = 4LL * (blockDim.x >> 5);
  for (long long f = 4LL * (threadIdx.x >> 5) + grp; f - grp < pairs; f += step) {
    const bool act = f < pairs;  // uniform in the group
    const int q = act ? (int)(f / P) : 0;
    const int k = l * P + (act ? (int)(f - (long long)q * P) : 0);
    const long long row = ((long long)b * Lq + q) * M + m;
    // lane j's channels j + 8t of g for the sums, zero beyond D (the
    // butterfly's padding), and channels j kT + t for the dV rows
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float gr[kT];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      g[t] = act ? to_float(grad[row * D + j + 8 * t]) : 0.0f;
      gr[t] = act ? to_float(grad[row * D + j * kT + t]) : 0.0f;
    }
    float px = 0.0f, py = 0.0f, a = 0.0f;
    if (act) {
      px = loc[row * (2LL * LP) + 2 * k] * fW - 0.5f;
      py = loc[row * (2LL * LP) + 2 * k + 1] * fH - 0.5f;
      a = to_float(attn[row * LP + k]);
    }
    FacSample<float> s = fac_sample<T>(px, py, H, W);
    if (!act) s.rin[0] = s.rin[1] = s.cin[0] = s.cin[1] = false;  // reads and writes nothing
    // per-channel terms of the five sums: dattn, Q[0], Q[1] (over both
    // columns), and R[c] folded in the lane at once
    float s_daw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float s_q[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float e_r[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool in[2] = {s.rin[0] && s.cin[c], s.rin[1] && s.cin[c]};  // uniform in the group
      float v[2][kT];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (in[i]) {
          load_lane<T, kT>(vs + (s.cell0 + i * W + c) * D + j * kT, v[i]);
        } else {
#pragma unroll
          for (int t = 0; t < kT; ++t) v[i][t] = 0.0f;
        }
      }
      float r_terms[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float axg = s.ax[c] * g[t];
        float tt = 0.0f;
        tt = tt + (in[0] ? s.ay[0] * v[0][t] : 0.0f);
        tt = tt + (in[1] ? s.ay[1] * v[1][t] : 0.0f);
        s_daw[t] = s_daw[t] + (s.cin[c] ? round_to<T>(axg * tt) : 0.0f);
        const float axg_r = round_to<T>(axg);
#pragma unroll
        for (int i = 0; i < 2; ++i) s_q[i][t] = s_q[i][t] + (in[i] ? axg_r * v[i][t] : 0.0f);
        r_terms[t] = s.cin[c] ? round_to<T>(g[t] * tt) : 0.0f;
      }
      e_r[c] = lane_pairs(r_terms);
      // dV rows: ay[i] * round(a * axg), lane j's kT adjacent channels as
      // float32 reductions in L2 (one 16-byte vector for D = 32)
      if (in[0] || in[1]) {
        float h[kT];
#pragma unroll
        for (int t = 0; t < kT; ++t) h[t] = round_to<T>(a * (s.ax[c] * gr[t]));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!in[i]) continue;
          float x[kT];
#pragma unroll
          for (int t = 0; t < kT; ++t) x[t] = s.ay[i] * h[t];
          red_add<kT>(dsum + slab + (s.cell0 + i * W + c) * MD + j * kT, x);
        }
      }
    }
    // the butterfly's steps 4, 2, 1 for the five sums together; every lane
    // ends with all five
    float e[5] = {lane_pairs(s_daw), lane_pairs(s_q[0]), lane_pairs(s_q[1]), e_r[0], e_r[1]};
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
      for (int n = 0; n < 5; ++n) e[n] = e[n] + __shfl_xor_sync(kFull, e[n], off);
    }
    if (act && j == 0) {
      float gy = 0.0f, gx = 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (s.rin[i]) gy = gy + s.sy[i] * round_to<T>(e[1 + i]);
        if (s.cin[i]) gx = gx + s.sx[i] * round_to<T>(e[3 + i]);
      }
      store(dattn + row * LP + k, e[0]);
      dloc[row * (2LL * LP) + 2 * k] = -(a * gx) * fW;
      dloc[row * (2LL * LP) + 2 * k + 1] = -(a * gy) * fH;
    }
  }
  round_owned_rows<T, D>(dvalue + slab, dsum + slab, H * W, MD);
}

template <typename T>
int launch_fac_bwd_staged(const void* value, const void* loc, const void* attn, const void* grad,
                          void* dvalue, void* dsum, void* dloc, void* dattn,
                          const LevelPlan& plan, int B, int S, int Lq, int M, int D, int P,
                          int smem, cudaStream_t s) {
  const long long blocks = (long long)B * M * plan.n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto run = [&](auto kernel) {
    const int err = allow_smem(kernel, smem);
    if (err != 0 || blocks == 0) return err;
    kernel<<<(unsigned)blocks, kFacBwdStagedThreads, smem, s>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (const T*)grad, (T*)dvalue,
        (float*)dsum, (float*)dloc, (T*)dattn, plan, S, Lq, M, P);
    return (int)cudaGetLastError();
  };
  switch (D) {
    case 8: return run(msda_fac_bwd_staged_kernel<T, 1>);
    case 16: return run(msda_fac_bwd_staged_kernel<T, 2>);
    case 32: return run(msda_fac_bwd_staged_kernel<T, 4>);
    default: return (int)cudaErrorInvalidValue;
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
                            int dtype, int attn_dtype, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto kernel, auto t, auto at) {
    using T = decltype(t);
    using A = decltype(at);
    using F = arith_t<T>;
    kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const T*)value, (const F*)loc, (const A*)attn, (const T*)grad, (F*)dvalue, (F*)dloc,
        (A*)dattn, plan, B, S, Lq, M, D, P);
    return (int)cudaGetLastError();
  };
  const bool own = attn_dtype == dtype;  // else float32 attention
  if (!own && attn_dtype != kF32) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return own ? run(msda_fac_bwd_general_kernel<float, float>, float{}, float{})
                          : (int)cudaErrorInvalidValue;
    case kBF16:
      return own ? run(msda_fac_bwd_general_kernel<__nv_bfloat16, __nv_bfloat16>,
                       __nv_bfloat16{}, __nv_bfloat16{})
                 : run(msda_fac_bwd_general_kernel<__nv_bfloat16, float>, __nv_bfloat16{},
                       float{});
    case kF16:
      return own ? run(msda_fac_bwd_general_kernel<__half, __half>, __half{}, __half{})
                 : run(msda_fac_bwd_general_kernel<__half, float>, __half{}, float{});
    case kF64: return own ? run(msda_fac_bwd_general_kernel<double, double>, double{}, double{})
                          : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The staged kernel's launch, with the arguments of msda_bwd_staged: it
// writes every dvalue row itself, in the value's type; `dsum` is float32
// scratch of dvalue's shape for bfloat16 (unused for float32); `smem` is the
// bytes of the largest level's value rows (from `staged_plan`); value,
// dvalue and dsum must be 16-byte aligned, D 8, 16 or 32.
extern "C" int msda_fac_bwd_staged(const void* value, const void* loc, const void* attn,
                                   const void* grad, void* dvalue, void* dsum, void* dloc,
                                   void* dattn, const int* hw, const int* level_start,
                                   int L, int B, int S, int Lq, int M, int D, int P, int smem,
                                   int dtype, int attn_dtype, int device, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || attn_dtype != dtype) return (int)cudaErrorInvalidValue;
  LevelPlan plan;
  unsigned unused = 0;
  const int err = prepare(hw, level_start, L, D, P, device, 1, &plan, &unused);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kBF16 ? launch_fac_bwd_staged<__nv_bfloat16>(value, loc, attn, grad, dvalue, dsum,
                                                        dloc, dattn, plan, B, S, Lq, M, D, P,
                                                        smem, s)
                 : launch_fac_bwd_staged<float>(value, loc, attn, grad, dvalue, dvalue, dloc,
                                                dattn, plan, B, S, Lq, M, D, P, smem, s);
}
