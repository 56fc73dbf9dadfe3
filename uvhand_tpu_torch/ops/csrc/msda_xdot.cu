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
// The kernel adds in the plain version's order (xdot_torch), so every
// output agrees with it bit for bit; the file is built with -fmad=false.
//
// Bound on the H100: writing the ws plane, B*M*Lq*S elements. At the
// ablation script's shapes (B*M = 128, Lq = S = 1045) that is 559 MB in
// float32 (0.167 ms at 3.35 TB/s) or 280 MB in bfloat16 (0.083 ms), plus
// the per-point arrays and the G entries at the in-map corners (what this
// run's data needs of G: at most 64 of a row's 1045 entries); 0.1912 /
// 0.1020 ms in all (bench_msda_ablation.py::xdot_kernel_bound).
//
// Design (every shape): the plane is one contiguous stream, and a block of
// 8 warps takes 8 consecutive rows of it, one a warp, lanes over the row's
// points. It writes every byte of its rows once, by aligned 16-byte stores
// wherever a 16-byte vector lies inside the row: zeros from registers, the
// nonzeros patched in. Only the at most 16 / sizeof(T) - 1 values at each
// end of a row that share a vector with the row before or after are stored
// one by one. The nonzeros go through a window of the row in shared memory
// that is never zeroed: a bit per token says which slots hold a sum (only
// the bits are cleared, S / 32 words a row), and a vector reads slots only
// where its bits are set. Sums in (l, p) order without a serial lane loop:
// the first touch of a slot stores 0, then the points add in rounds, round
// j taking each level's j-th point of the pass -- one point a level, and
// only points of one level share a corner (level ranges are disjoint), so
// no two lanes of a round meet. A row longer than the window (4096 tokens)
// is written window by window, its points' corners recomputed for each (the
// per-point outputs once). The earlier kernel's limits, which this answers:
// a float32 copy of the whole row in shared memory zeroed, filled and
// copied out (S <= 12288, at most 11 warps a block); a serial scatter, 16
// steps with one lane of 32 at work and a __syncwarp each; 2- or 4-byte
// stores on rows whose starts are only 2- or 4-byte aligned (S odd).
//
// Measured on the H100 at the bench shapes (device time, PERF.md section 6):
// ~0.179 ms bf16 and ~0.277 ms float32, 5-7 % below the earlier kernel
// (PERF_PORT_HISTORY.md). Paced by device memory, not by shared memory or
// the lanes' loop: the G entries at the corners arrive as whole 32-byte
// sectors, which put the bytes at ~0.12 / ~0.21 ms, and each row's points
// (loads, tents, sums) cost a latency that the next rows' stores overlap
// only in part.
//
// ptxas (sm_90a, nvcc 12.9): <float> and <bf16> 64 registers; the window is
// dynamic shared memory (36 KB a block at S = 1045). No spills.

#include "msda_common.cuh"

namespace {

using namespace msda;

// One point of a row: its corners inside the map (tok -1 off it), their
// weights a * tent, the tent factors of the per-point sums, and G at the
// corners (loads issued by `corners`, first used by `finish`).
struct Point {
  int tok[4];
  float wt[4];
  float wc[4], fx[4], fy[4], g[4];
  float a;
};

// Point k (level l) of a row whose per-point entries start at `at`; G at
// its corners is read where `read_g`.
template <typename T>
__device__ __forceinline__ void corners(const LevelPlan& plan, const float* loc, const T* attn,
                                        long long at, int l, const T* G_row, bool read_g,
                                        Point& pt) {
  const int H = plan.h[l];
  const int W = plan.w[l];
  const float fH = (float)H;
  const float fW = (float)W;
  const float px = loc[at * 2] * fW - 0.5f;
  const float py = loc[at * 2 + 1] * fH - 0.5f;
  pt.a = to_float(attn[at]);
  const float x0 = floorf(px);
  const float y0 = floorf(py);
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
      const bool in = cx >= 0.0f && cx < fW && cy >= 0.0f && cy < fH;
      pt.tok[c] = in ? plan.start[l] + (int)cy * W + (int)cx : -1;
      pt.wc[c] = hy * hx;
      pt.fx[c] = sx * hy;
      pt.fy[c] = sy * hx;
      pt.wt[c] = pt.a * pt.wc[c];
      pt.g[c] = in && read_g ? to_float(G_row[pt.tok[c]]) : 0.0f;
    }
  }
}

// dpy, dpx, daw of a point at `at`: sums over its in-map corners in corner
// order (an off-map corner adds nothing, not even a zero).
__device__ __forceinline__ void finish(const Point& pt, long long at, float* dpy, float* dpx,
                                       float* daw) {
  float da = 0.0f, gx = 0.0f, gy = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (pt.tok[c] < 0) continue;
    da = da + pt.wc[c] * pt.g[c];
    gx = gx + pt.fx[c] * pt.g[c];
    gy = gy + pt.fy[c] * pt.g[c];
  }
  dpy[at] = -(pt.a * gy);
  dpx[at] = -(pt.a * gx);
  daw[at] = da;
}

constexpr int kWarps = 8;
constexpr int kWindow = 4096;  // tokens a warp holds at once (a multiple of 32)

// 16 bytes of ws from float32 sums, to nearest even for bf16.
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *(float4*)p = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  *(uint4*)p = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                          pack_bf16(v[6], v[7]));
}

// `cap` floats of window slots, then `words` words of bits, a warp.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
msda_xdot_kernel(const T* __restrict__ G, const float* __restrict__ loc,
                 const T* __restrict__ attn, float* __restrict__ dpy, float* __restrict__ dpx,
                 float* __restrict__ daw, T* __restrict__ ws, LevelPlan plan, int S, int Lq,
                 int M, int P, long long rows, int win_len, int cap, int words) {
  constexpr int E = 16 / (int)sizeof(T);  // values a 16-byte vector
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * kWarps + warp;  // row (bm, q) of the plane
  if (r >= rows) return;  // uniform across the warp
  float* slot = smem + (long long)warp * (cap + words);
  unsigned* bits = (unsigned*)(slot + cap);
  const long long bm = r / Lq;
  const int q = (int)(r - bm * Lq);
  const int b = (int)(bm / M), m = (int)(bm % M);
  const int LP = plan.n * P;
  const long long prow = (((long long)b * Lq + q) * M + m) * LP;  // the row's points
  const T* G_row = G + r * S;
  T* w_row = ws + r * S;
  // t0: the first token at a 16-byte boundary; [t0, vend): whole vectors
  const int t0 = min(S, (int)(((16u - (unsigned)((unsigned long long)w_row & 15u)) & 15u) /
                              sizeof(T)));
  const int vend = t0 + (S - t0) / E * E;
  const int nwin = S - t0 > win_len ? (S - t0 + win_len - 1) / win_len : 1;
  const int rounds = min(P, 32);

  for (int win = 0; win < nwin; ++win) {
    const int lo = win == 0 ? 0 : t0 + win * win_len;
    const int hi = win == nwin - 1 ? S : t0 + (win + 1) * win_len;
    for (int i = lane; i < words; i += 32) bits[i] = 0u;
    __syncwarp();
    // the points in passes of 32, one a lane; a pass's outputs wait for its
    // G loads until the window is written (one pass and one window: the
    // common case), so the loads overlap the stores
    Point pt;
    long long at = -1;  // this lane's point of the last pass, if any
    for (int k0 = 0; k0 < LP; k0 += 32) {
      if (at >= 0) finish(pt, at, dpy, dpx, daw);
      const int k = k0 + lane;
      int rank = -1;  // the point's place among its level's points of this pass
      at = -1;
      if (k < LP) {
        const int l = k / P;
        rank = k - max(k0, l * P);
        corners(plan, loc, attn, prow + k, l, G_row, win == 0, pt);
        if (win == 0) at = prow + k;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) pt.tok[c] = -1;
      }
      int sl[4];  // window slots of the corners in it, else -1
#pragma unroll
      for (int c = 0; c < 4; ++c) sl[c] = pt.tok[c] >= lo && pt.tok[c] < hi ? pt.tok[c] - lo : -1;
      // the first touch of a slot in this window (its bit was clear) stores 0
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (sl[c] >= 0 && !(atomicOr(bits + (sl[c] >> 5), 1u << (sl[c] & 31)) >> (sl[c] & 31) & 1u))
          slot[sl[c]] = 0.0f;
      __syncwarp();
      for (int j = 0; j < rounds; ++j) {
        if (rank == j) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (sl[c] >= 0) slot[sl[c]] = slot[sl[c]] + pt.wt[c];
        }
        __syncwarp();
      }
    }
    // the window's tokens [lo, hi): one by one outside the whole vectors
    const int vlo = max(lo, t0), vhi = min(hi, vend);
    for (int t = lo + lane; t < vlo; t += 32) {
      const int i = t - lo;
      store(w_row + t, (bits[i >> 5] >> (i & 31)) & 1u ? slot[i] : 0.0f);
    }
    for (int t = max(vhi, lo) + lane; t < hi; t += 32) {
      const int i = t - lo;
      store(w_row + t, (bits[i >> 5] >> (i & 31)) & 1u ? slot[i] : 0.0f);
    }
    for (int t = vlo + lane * E; t < vhi; t += 32 * E) {
      const int i = t - lo;
      const unsigned mask =
          __funnelshift_r(bits[i >> 5], bits[(i >> 5) + 1], i & 31) & ((1u << E) - 1u);
      float v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = (mask >> e) & 1u ? slot[i + e] : 0.0f;
      store16(w_row + t, v);
    }
    if (at >= 0) finish(pt, at, dpy, dpx, daw);
    __syncwarp();  // the slots and bits are read before the next window clears them
  }
}

}  // namespace

// Launch on `stream` of card `device`; shapes are host arrays as for
// msda_fwd. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int msda_xdot(const void* G, const void* loc, const void* attn, void* dpy, void* dpx,
                         void* daw, void* ws, const int* hw, const int* level_start, int L, int B,
                         int S, int Lq, int M, int P, int is_bf16, int device, void* stream) {
  LevelPlan plan;
  unsigned blocks = 0;
  const long long rows = (long long)B * Lq * M;
  int err = prepare(hw, level_start, L, 1, P, device, rows, &plan, &blocks);
  if (err != 0 || blocks == 0) return err;
  // a window of win_len tokens (a multiple of 32) and a vector's spill past
  // the first window's head: cap slots, and a word of bits past them
  const int win_len = min((S + 31) / 32 * 32, kWindow);
  const int cap = win_len + 32;
  const int words = cap / 32 + 1;
  const int smem = (int)(sizeof(float) * kWarps * (cap + words));
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    auto kernel = msda_xdot_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024 && (err = allow_smem(kernel, smem)) != 0) return err;
    kernel<<<blocks, kWarps * 32, smem, s>>>(
        (const __nv_bfloat16*)G, (const float*)loc, (const __nv_bfloat16*)attn, (float*)dpy,
        (float*)dpx, (float*)daw, (__nv_bfloat16*)ws, plan, S, Lq, M, P, rows, win_len, cap,
        words);
  } else {
    auto kernel = msda_xdot_kernel<float>;
    if (smem > 48 * 1024 && (err = allow_smem(kernel, smem)) != 0) return err;
    kernel<<<blocks, kWarps * 32, smem, s>>>(
        (const float*)G, (const float*)loc, (const float*)attn, (float*)dpy, (float*)dpx,
        (float*)daw, (float*)ws, plan, S, Lq, M, P, rows, win_len, cap, words);
  }
  return (int)cudaGetLastError();
}
