// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces both TPU backward kernels: `_bwd_kernel_sep`
// (uvhand_tpu/ops/msda_pallas.py:233, separable row/column folds, bf16 with
// every level side <= 128) and `_bwd_kernel` (:320, dense per-point
// reductions, float32 or any side > 128). The two compute the same three
// gradients and differ only in how the TPU's matrix unit reduces them: they
// build dense tent planes over every token because Mosaic had no usable
// in-kernel gather. Hopper gathers natively, so this file serves every
// regime of the two in gather form.
//
// Per (batch b, query q, head m, level, point) the sample's pixel
// coordinates, floor corners and four tents are the forward's expressions.
// For each corner inside the level map, with v_c its value row and g the
// incoming gradient row:
//   - dot_c = sum_d g_d * v_c[d], in the order of a 32-lane xor butterfly
//     16, 8, 4, 2, 1 per chunk of 32 channels, chunks summed in order (the
//     plain version's `_warp_sum`);
//   - dvalue[corner row] += a * w_c * g, summed in float32.
// From the dots, per point:
//   dattn = sum_c w_c * dot_c                        (w_c = hy_c * hx_c)
//   dpx   = -a * sum_c sx_c * hy_c * dot_c,  sx_c = sign(px - cx_c) where the
//           corner's x tent hx_c > 0, else 0 (so sign(0) = 0 at a kink)
//   dpy   = -a * sum_c sy_c * hx_c * dot_c   (likewise)
// summed over the corners in (dy, dx) order, and the chain rule through
// px = x * W - 0.5 gives dloc = (dpx * W, dpy * H). This is the convention
// of the JAX backward (`_msda_bwd`, uvhand_tpu/ops/msda.py:288-295) and of
// the TPU kernels (`where(|d| < 1, sign(d), 0)`).
//
// Inputs, read in place: value (B, S, M, D) and attention (B, Lq, M, L, P) in
// float32 or bfloat16 (one type for both), the incoming gradient g
// (B, Lq, M*D) in the same type, locations (B, Lq, M, L, P, 2) float32.
// Outputs: dvalue (B, S, M, D), dloc (B, Lq, M, L, P, 2) float32, dattn
// (B, Lq, M, L, P) in the attention's type. bfloat16 inputs are widened and
// every sum is float32. The general kernel also takes float64 inputs
// (locations, dvalue and dloc float64 too) and computes in float64
// throughout, as the plain version does; its dvalue sums are float64
// atomics. The file is built with -fmad=false, and dattn and
// dloc repeat the plain version's (`ms_deform_attn_torch_backward`)
// arithmetic in its order, so they agree with it bit for bit in float32 in
// practice. dvalue is NOT deterministic: its float32 sums are atomics that
// land in no fixed order.
//
// Two kernels, chosen by the caller from the shapes (`staged_plan` in
// ops/msda_cuda.py):
//
// * `msda_bwd_staged_kernel` (entry `msda_bwd_staged`), the kernel of the
//   model paths. As the TPU kernels keep the (b, m) value slab in VMEM, one
//   block owns one (b, m, level): dattn and dloc of that level's points
//   depend only on that level's value rows, and that level's dvalue rows
//   only on its points, so levels split across blocks with no sum between
//   blocks, and each dvalue row has exactly one owner. Every level has
//   Lq * P points per (b, m), so one level a block gives every block the
//   same work (a group of several levels would take several times as long
//   as a group of one). The block copies the level's value rows into
//   shared memory with 16-byte cp.async (arctic_sf's largest level,
//   28 x 28 x 32: 100,352 bytes in float32, 50,176 in bfloat16, so two
//   512-thread blocks fit an SM). Each warp takes four (query, point)
//   pairs at a time, one per 8-lane group; lane j holds channels j, j+8,
//   ... (D = 8 kT channels, kT each), the staged rows are interleaved so
//   that those are adjacent, and a group starts its four corners' gathers
//   (one 16-byte load a lane for float32 D = 32) before any sum. Each dot
//   is (c_j + c_j+16) + (c_j+8 + c_j+24) in registers and the xor steps
//   4, 2, 1 -- exactly the 32-lane butterfly's order -- taken for the four
//   corners at once in seven shuffles. The per-point sums stay in corner
//   order. dvalue: the
//   block first zeroes the float32 sums of the rows it owns, then adds
//   a * w_c * g with float32 reductions in L2 (red.global.add: REDG, no
//   return value to wait for, no retry loop), for D = 32 one 16-byte
//   vector reduction (F32x4) a lane and corner, a whole 128-byte row a
//   group. The reductions bound this kernel: an encoder call makes 275 M
//   float32 additions into dvalue. Measured (PERF.md): a float32
//   atomicAdd on shared memory compiles to a compare-and-swap loop
//   (ATOMS.CAST.SPIN) on sm_90, and a shared-memory accumulator built on
//   it took ~40 % of the kernel's time, as did scalar reductions in L2;
//   an atomicAdd whose value is unused compiled here to ATOMG, which
//   waits for the old value. The sums go straight into a float32 dvalue; for
//   bfloat16 into float32 scratch, which the block rounds once into its
//   dvalue rows at its end. So the caller neither zero-fills nor casts
//   dvalue. One launch has B * M * L blocks of 512 threads; it takes D = 8,
//   16 or 32 (rows of whole 16-byte chunks in both types).
// * `msda_bwd_general_kernel` (entry `msda_bwd`), every other shape: one
//   warp per (b, q, m) row, lanes over the D channels (chunks of 32), every
//   corner a 128-byte gather from global memory, a five-shuffle butterfly
//   per dot, and a row of float32 atomics into a dvalue buffer in global
//   memory that the caller zeroes and casts to the value's type afterwards.
//
// Bound on the H100 (3.35 TB/s HBM): one encoder call of the arctic_sf model
// at batch 16 (Lq = S = 1045, M = 8, D = 32, L = P = 4, float32) must read
// value 17.1 MB, locations 17.1 MB, g 17.1 MB and attention 8.6 MB, and
// write dvalue 17.1 MB, dloc 17.1 MB and dattn 8.6 MB: about 103 MB, about
// 31 us. A decoder call (Lq = 300) moves about 54 MB, about 16 us. The work
// is ~8.6 M corner gathers of a value row per encoder call and as many rows
// of float32 additions; the general kernel was measured paced by its
// per-corner chain of global gather, product and dependent shuffles, not by
// its atomics (the ablation below). The staged kernel moves the gathers
// into shared memory (one vector load a lane and corner), cuts the dependent
// shuffles per corner from five to three with four corners in flight, and
// keeps the float32 reductions into dvalue one sector each.
//
// Both kernel bodies also serve the research ablation of the backward
// (`uvhand_tpu_torch/scripts/bench_msda_ablation.py`; the TPU kernel `kernel`
// of scripts/bench_msda_ablation.py:1064), through two compile-time
// parameters and the entry `msda_ablate_bwd`:
//   - Out: Model writes the production outputs (dloc after the chain rule,
//     dattn in the attention's type); Pixel writes dpy, dpx and daw as
//     float32 (B, Lq, M, L, P) before the chain rule; PixelNoDpy,
//     PixelNoDaw and PixelNoDv drop one output's work: dpy = dpx = a,
//     daw = a, or no weight and no atomics at all (dvalue stays zeros), so
//     that the ablation times what each output costs.
//   - Gate: Where is sign(d) where the tent is > 0, else 0 (the production
//     gate); Eq is the TPU's equality gate [s == floor(p)] - [s == floor(p)
//     + 1], +1 on the near corner and -1 on the far one whatever the tent,
//     which differs from Where only at integer-exact coordinates.
// The production launches are <T, Out::Model, Gate::Where>: `if constexpr`
// leaves their code as it is.

#include "msda_common.cuh"

namespace {

using namespace msda;

enum class Out { Model, Pixel, PixelNoDpy, PixelNoDaw, PixelNoDv };
enum class Gate { Where, Eq };

// F is the arithmetic type (arith_t<T>): float, or double for a double value
// (the model's outputs only).
template <typename T, Out kOut = Out::Model, Gate kGate = Gate::Where>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_general_kernel(const T* __restrict__ value, const arith_t<T>* __restrict__ loc,
                        const T* __restrict__ attn, const T* __restrict__ grad,
                        arith_t<T>* __restrict__ dvalue, arith_t<T>* __restrict__ dloc,
                        T* __restrict__ dattn, LevelPlan plan,
                        int B, int S, int Lq, int M, int D, int P,
                        float* __restrict__ dpy = nullptr, float* __restrict__ dpx = nullptr,
                        float* __restrict__ daw = nullptr) {
  using F = arith_t<T>;
  constexpr bool kDv = kOut != Out::PixelNoDv;
  constexpr bool kDp = kOut != Out::PixelNoDpy;
  constexpr bool kDa = kOut != Out::PixelNoDaw;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)B * Lq * M) return;  // uniform across the warp
  const int m = (int)(row % M);
  const int b = (int)(row / ((long long)Lq * M));
  const int L = plan.n;

  const F* loc_row = loc + row * (long long)(L * P * 2);
  const T* attn_row = attn + row * (long long)(L * P);
  const T* g_row = grad + row * (long long)D;
  F* dloc_row = dloc + row * (long long)(L * P * 2);  // unused unless kOut is Model
  T* dattn_row = dattn + row * (long long)(L * P);
  const long long bm_off = (long long)b * S * M * D + (long long)m * D;

  for (int l = 0; l < L; ++l) {
    const int H = plan.h[l];
    const int W = plan.w[l];
    const F fH = (F)H;
    const F fW = (F)W;
    const long long level_off = bm_off + (long long)plan.start[l] * M * D;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const F px = loc_row[2 * k] * fW - (F)0.5;
      const F py = loc_row[2 * k + 1] * fH - (F)0.5;
      const F a = to_float(attn_row[k]);
      const F x0 = floor_of(px);
      const F y0 = floor_of(py);
      F da = (F)0, gx = (F)0, gy = (F)0;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const F cy = y0 + (F)dy;
        const F hy = (F)1 - abs_of(py - cy);
        F sy;
        if constexpr (kGate == Gate::Eq) {
          sy = dy == 0 ? (F)1 : (F)-1;
        } else {
          sy = hy > (F)0 ? sign_of(py - cy) : (F)0;
        }
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const F cx = x0 + (F)dx;
          const F hx = (F)1 - abs_of(px - cx);
          F sx;
          if constexpr (kGate == Gate::Eq) {
            sx = dx == 0 ? (F)1 : (F)-1;
          } else {
            sx = hx > (F)0 ? sign_of(px - cx) : (F)0;
          }
          const bool valid = cx >= (F)0 && cx < fW && cy >= (F)0 && cy < fH;
          if (!valid) continue;  // uniform across the warp
          const F wc = hy * hx;
          const F aw = a * wc;
          const long long cell = (long long)cy * W + (long long)cx;
          const T* v_c = value + level_off + cell * M * D;
          F* dv_c = dvalue + level_off + cell * M * D;
          F dot = (F)0;
          for (int d0 = 0; d0 < D; d0 += 32) {
            const int d = d0 + lane;
            F gv = (F)0;
            if (d < D) {
              const F gd = to_float(g_row[d]);
              gv = gd * to_float(v_c[d]);
              if constexpr (kDv) atomicAdd(dv_c + d, aw * gd);
            }
            dot = dot + warp_sum(gv);
          }
          if constexpr (kDa) da = da + wc * dot;
          if constexpr (kDp) {
            gx = gx + (sx * hy) * dot;
            gy = gy + (sy * hx) * dot;
          }
        }
      }
      if (lane == 0) {
        if constexpr (kOut == Out::Model) {
          store(dattn_row + k, da);
          dloc_row[2 * k] = -(a * gx) * fW;
          dloc_row[2 * k + 1] = -(a * gy) * fH;
        } else {
          const long long o = row * (long long)(L * P) + k;
          dpy[o] = kDp ? -(a * gy) : a;
          dpx[o] = kDp ? -(a * gx) : a;
          daw[o] = kDa ? da : a;
        }
      }
    }
  }
}

constexpr int kBwdStagedThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// One block per (b, m, level), D = 8 * kT channels; see the note at the
// top. `TDv` is dvalue's type: the value's type for the model's outputs,
// float32 for the ablation's. `dsum` holds the float32 sums: dvalue itself
// when TDv is float32, else scratch of dvalue's shape that the block
// rounds into dvalue at its end.
template <typename T, typename TDv, int kT, Out kOut = Out::Model, Gate kGate = Gate::Where>
__global__ void __launch_bounds__(kBwdStagedThreads, 2)
msda_bwd_staged_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                       const T* __restrict__ attn, const T* __restrict__ grad,
                       TDv* dvalue, float* dsum, float* __restrict__ dloc,
                       T* __restrict__ dattn, LevelPlan plan, int S, int Lq, int M, int P,
                       float* __restrict__ dpy = nullptr, float* __restrict__ dpx = nullptr,
                       float* __restrict__ daw = nullptr) {
  constexpr int D = 8 * kT;
  constexpr bool kDv = kOut != Out::PixelNoDv;
  constexpr bool kDp = kOut != Out::PixelNoDpy;
  constexpr bool kDa = kOut != Out::PixelNoDaw;
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
  // the block owns its level's dvalue rows: their float32 sums start at 0
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
    // lane j's channels j + 8t of g for the dots, zero beyond D (the
    // butterfly's padding), and channels j kT + t for the reductions
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
    const float x0 = floorf(px);
    const float y0 = floorf(py);
    // the four corners' tents, gates and rows, and every load before any sum
    float hy[4], hx[4], sy[4], sx[4], v[4][4];
    int cell[4];
    bool valid[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dy = c >> 1;
      const int dx = c & 1;
      const float cy = y0 + (float)dy;
      const float cx = x0 + (float)dx;
      hy[c] = 1.0f - fabsf(py - cy);
      hx[c] = 1.0f - fabsf(px - cx);
      if constexpr (kGate == Gate::Eq) {
        sy[c] = dy == 0 ? 1.0f : -1.0f;
        sx[c] = dx == 0 ? 1.0f : -1.0f;
      } else {
        sy[c] = hy[c] > 0.0f ? sign_of(py - cy) : 0.0f;
        sx[c] = hx[c] > 0.0f ? sign_of(px - cx) : 0.0f;
      }
      valid[c] = act && cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH;
      cell[c] = valid[c] ? (int)cy * W + (int)cx : 0;
#pragma unroll
      for (int t = kT; t < 4; ++t) v[c][t] = 0.0f;
      if (valid[c]) {
        load_lane<T, kT>(vs + cell[c] * D + j * kT, v[c]);
      } else {
#pragma unroll
        for (int t = 0; t < kT; ++t) v[c][t] = 0.0f;
      }
    }
    // each corner's dot in the 32-lane butterfly's order: in registers
    // (c_j + c_j+16) + (c_j+8 + c_j+24), then its steps 4, 2, 1 for the four
    // corners at once (each step halves the corners a lane carries, so seven
    // shuffles in all instead of twelve); lane 2c of the group ends with
    // corner c's dot, and every lane gathers the four
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      e[c] = (g[0] * v[c][0] + g[2] * v[c][2]) + (g[1] * v[c][1] + g[3] * v[c][3]);
    const bool hi = j & 4;
    const bool mid = j & 2;
    const float ra = __shfl_xor_sync(kFull, hi ? e[0] : e[2], 4);
    const float rb = __shfl_xor_sync(kFull, hi ? e[1] : e[3], 4);
    const float sa = (hi ? e[2] : e[0]) + ra;  // corner 2 hi (0 otherwise)
    const float sb = (hi ? e[3] : e[1]) + rb;  // corner 2 hi + 1
    float mine = (mid ? sb : sa) + __shfl_xor_sync(kFull, mid ? sa : sb, 2);
    mine = mine + __shfl_xor_sync(kFull, mine, 1);
    const unsigned lead = (unsigned)(lane & ~7);
    float dot[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) dot[c] = __shfl_sync(kFull, mine, lead | (unsigned)(2 * c));
    float da = 0.0f, gx = 0.0f, gy = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!valid[c]) continue;  // uniform in the group
      const float wc = hy[c] * hx[c];
      if constexpr (kDv) {
        // float32 reductions in L2 (no return, no retry loop): lane j's kT
        // adjacent channels, one 16-byte vector for D = 32
        const float aw = a * wc;
        float x[kT];
#pragma unroll
        for (int t = 0; t < kT; ++t) x[t] = aw * gr[t];
        red_add<kT>(dsum + slab + cell[c] * MD + j * kT, x);
      }
      if constexpr (kDa) da = da + wc * dot[c];
      if constexpr (kDp) {
        gx = gx + (sx[c] * hy[c]) * dot[c];
        gy = gy + (sy[c] * hx[c]) * dot[c];
      }
    }
    if (act && j == 0) {
      if constexpr (kOut == Out::Model) {
        store(dattn + row * LP + k, da);
        dloc[row * (2LL * LP) + 2 * k] = -(a * gx) * fW;
        dloc[row * (2LL * LP) + 2 * k + 1] = -(a * gy) * fH;
      } else {
        const long long o = row * LP + k;
        dpy[o] = kDp ? -(a * gy) : a;
        dpx[o] = kDp ? -(a * gx) : a;
        daw[o] = kDa ? da : a;
      }
    }
  }
  round_owned_rows<TDv, D>(dvalue + slab, dsum + slab, H * W, MD);
}

template <typename T, typename TDv, Out kOut, Gate kGate>
int launch_bwd_staged(const void* value, const void* loc, const void* attn, const void* grad,
                      void* dvalue, void* dsum, void* dloc, void* dattn, const LevelPlan& plan,
                      int B, int S, int Lq, int M, int D, int P, int smem, cudaStream_t s,
                      void* dpy = nullptr, void* dpx = nullptr, void* daw = nullptr) {
  const long long blocks = (long long)B * M * plan.n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const auto run = [&](auto kernel) {
    const int err = allow_smem(kernel, smem);
    if (err != 0 || blocks == 0) return err;
    kernel<<<(unsigned)blocks, kBwdStagedThreads, smem, s>>>(
        (const T*)value, (const float*)loc, (const T*)attn, (const T*)grad, (TDv*)dvalue,
        (float*)dsum, (float*)dloc, (T*)dattn, plan, S, Lq, M, P, (float*)dpy, (float*)dpx,
        (float*)daw);
    return (int)cudaGetLastError();
  };
  switch (D) {
    case 8: return run(msda_bwd_staged_kernel<T, TDv, 1, kOut, kGate>);
    case 16: return run(msda_bwd_staged_kernel<T, TDv, 2, kOut, kGate>);
    case 32: return run(msda_bwd_staged_kernel<T, TDv, 4, kOut, kGate>);
    default: return (int)cudaErrorInvalidValue;
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
                        int dtype, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto kernel, auto t) {
    using T = decltype(t);
    using F = arith_t<T>;
    kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        (const T*)value, (const F*)loc, (const T*)attn, (const T*)grad, (F*)dvalue, (F*)dloc,
        (T*)dattn, plan, B, S, Lq, M, D, P, nullptr, nullptr, nullptr);
    return (int)cudaGetLastError();
  };
  switch (dtype) {
    case kF32: return run(msda_bwd_general_kernel<float>, float{});
    case kBF16: return run(msda_bwd_general_kernel<__nv_bfloat16>, __nv_bfloat16{});
    case kF64: return run(msda_bwd_general_kernel<double>, double{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The staged kernel's launch (see the note at the top), as msda_bwd's but
// writing every dvalue row itself, in the value's type; `dsum` is float32
// scratch of dvalue's shape for bfloat16 (unused for float32); `smem` is
// the bytes of the largest level's value rows (from `staged_plan`); value,
// dvalue and dsum must be 16-byte aligned, D 8, 16 or 32.
extern "C" int msda_bwd_staged(const void* value, const void* loc, const void* attn,
                               const void* grad, void* dvalue, void* dsum, void* dloc,
                               void* dattn,
                               const int* hw, const int* level_start,
                               int L, int B, int S, int Lq, int M, int D, int P, int smem,
                               int dtype, int device, void* stream) {
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  LevelPlan plan;
  unsigned unused = 0;
  const int err = prepare(hw, level_start, L, D, P, device, 1, &plan, &unused);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == kBF16
             ? launch_bwd_staged<__nv_bfloat16, __nv_bfloat16, Out::Model, Gate::Where>(
                   value, loc, attn, grad, dvalue, dsum, dloc, dattn, plan, B, S, Lq, M, D, P,
                   smem, s)
             : launch_bwd_staged<float, float, Out::Model, Gate::Where>(
                   value, loc, attn, grad, dvalue, dvalue, dloc, dattn, plan, B, S, Lq, M, D,
                   P, smem, s);
}

namespace {

// One ablation launch: the staged body when smem > 0, else the general one.
template <typename T, Out kOut, Gate kGate>
int launch_ablate(int smem, unsigned blocks, cudaStream_t s, const void* value, const void* loc,
                  const void* attn, const void* grad, void* dvalue, void* dpy, void* dpx,
                  void* daw, const LevelPlan& plan, int B, int S, int Lq, int M, int D, int P) {
  if (smem > 0) {
    return launch_bwd_staged<T, float, kOut, kGate>(value, loc, attn, grad, dvalue, dvalue,
                                                    nullptr, nullptr, plan, B, S, Lq, M, D, P,
                                                    smem, s, dpy, dpx, daw);
  }
  if (blocks == 0) return 0;
  msda_bwd_general_kernel<T, kOut, kGate><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      (const T*)value, (const float*)loc, (const T*)attn, (const T*)grad, (float*)dvalue,
      nullptr, nullptr, plan, B, S, Lq, M, D, P, (float*)dpy, (float*)dpx, (float*)daw);
  return (int)cudaGetLastError();
}

template <typename T, Out kOut>
int gate_ablate(int gate, int smem, unsigned blocks, cudaStream_t s, const void* value,
                const void* loc, const void* attn, const void* grad, void* dvalue, void* dpy,
                void* dpx, void* daw, const LevelPlan& plan, int B, int S, int Lq, int M, int D,
                int P) {
  const auto run = [&](auto launch) {
    return launch(smem, blocks, s, value, loc, attn, grad, dvalue, dpy, dpx, daw, plan, B, S,
                  Lq, M, D, P);
  };
  return gate == 1 ? run(launch_ablate<T, kOut, Gate::Eq>)
                   : run(launch_ablate<T, kOut, Gate::Where>);
}

template <typename T>
int dispatch_ablate(int out, int gate, int smem, unsigned blocks, cudaStream_t s,
                    const void* value, const void* loc, const void* attn, const void* grad,
                    void* dvalue, void* dpy, void* dpx, void* daw, const LevelPlan& plan, int B,
                    int S, int Lq, int M, int D, int P) {
  const auto run = [&](auto launch) {
    return launch(gate, smem, blocks, s, value, loc, attn, grad, dvalue, dpy, dpx, daw, plan, B,
                  S, Lq, M, D, P);
  };
  switch (out) {
    case 0: return run(gate_ablate<T, Out::Pixel>);
    case 1: return run(gate_ablate<T, Out::PixelNoDpy>);
    case 2: return run(gate_ablate<T, Out::PixelNoDaw>);
    case 3: return run(gate_ablate<T, Out::PixelNoDv>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The ablation of the backward (see the note at the top): `out` 0 full,
// 1 no dpy/dpx, 2 no daw, 3 no dvalue; `gate` 0 where, 1 equality; `smem`
// 0 for the general body, else the staged body with that many bytes of
// shared memory (as msda_bwd_staged). Outputs dvalue (B, S, M, D) float32
// (the general body adds into it, so the caller zeroes it; the staged body
// writes every row; zeros under out 3), dpy, dpx, daw (B, Lq, M, L, P)
// float32 in pixel space. Returns the cudaError_t of the launch.
extern "C" int msda_ablate_bwd(const void* value, const void* loc, const void* attn,
                               const void* grad, void* dvalue, void* dpy, void* dpx, void* daw,
                               const int* hw, const int* level_start,
                               int L, int B, int S, int Lq, int M, int D, int P,
                               int out, int gate, int smem, int is_bf16, int device,
                               void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const int err = prepare(hw, level_start, L, D, P, device, (long long)B * Lq * M, &plan, &blocks);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? dispatch_ablate<__nv_bfloat16>(out, gate, smem, blocks, s, value, loc, attn,
                                                  grad, dvalue, dpy, dpx, daw, plan, B, S, Lq,
                                                  M, D, P)
                 : dispatch_ablate<float>(out, gate, smem, blocks, s, value, loc, attn, grad,
                                          dvalue, dpy, dpx, daw, plan, B, S, Lq, M, D, P);
}
