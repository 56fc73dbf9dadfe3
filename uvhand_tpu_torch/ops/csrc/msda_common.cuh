// Helpers shared by the MSDA kernels (msda_fwd.cu, msda_bwd.cu,
// msda_fac_fwd.cu, msda_fac_bwd.cu): the level plan passed by value, the
// value types' codes and arithmetic types, type conversions, the bf16 and
// fp16 rounding of the factorized kernels, the warp
// reduction whose order the plain PyTorch versions repeat (`_warp_sum` in
// ops/msda.py), the host-side checks and grid size of a launch, and the
// shared-memory staging, lane layout and grids of the staged kernels.
//
// The general kernels run one warp per (batch, query, head) row, lanes over
// the D channels of a head (chunks of 32 for D > 32), kWarpsPerBlock warps a
// block. The staged kernels (both forms) run one block per (batch, head)
// value slab held in shared memory (the backward: one level of it); see
// msda_fwd.cu and msda_bwd.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace msda {

constexpr int kMaxLevels = 16;
constexpr int kWarpsPerBlock = 8;

struct LevelPlan {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// The codes of the value and attention types at the C entries (the
// wrappers' `TYPE_CODE` in ops/msda_cuda.py).
enum TypeCode { kF32 = 0, kBF16 = 1, kF16 = 2, kF64 = 3 };

// The arithmetic type of a value type: double for double (the plain
// versions compute float64 inputs in float64), float otherwise (bf16 and
// fp16 are widened exactly).
template <typename T>
struct Arith {
  using type = float;
};
template <>
struct Arith<double> {
  using type = double;
};
template <typename T>
using arith_t = typename Arith<T>::type;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ double to_float(double x) { return x; }  // widening is the identity
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(double* p, double x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// x rounded (to nearest even) to T and widened back; the identity for float
// and double.
template <typename T, typename F>
__device__ __forceinline__ F round_to(F x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __bfloat162float(__float2bfloat16(x));
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// floor and |x| in the arithmetic type (floorf and fabsf for float).
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return ::floor(x); }
__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return ::fabs(x); }

template <typename F>
__device__ __forceinline__ F sign_of(F d) {
  return d > (F)0 ? (F)1 : (d < (F)0 ? (F)-1 : (F)0);
}

// Sum over the 32 lanes by an xor butterfly 16, 8, 4, 2, 1; every lane ends
// with the same value.
template <typename F>
__device__ __forceinline__ F warp_sum(F x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Checks the arguments of a launch, selects `device`, fills `plan` from the
// host arrays hw = [H_0, W_0, H_1, W_1, ...] and level_start = [0, H_0*W_0,
// ...], and sets `blocks` (0: nothing to launch). Returns 0 or a cudaError_t.
inline int prepare(const int* hw, const int* level_start, int L, int D, int P, int device,
                   long long rows, LevelPlan* plan, unsigned* blocks) {
  if (L < 1 || L > kMaxLevels || D < 1 || P < 1) return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  plan->n = L;
  for (int l = 0; l < L; ++l) {
    plan->h[l] = hw[2 * l];
    plan->w[l] = hw[2 * l + 1];
    plan->start[l] = level_start[l];
  }
  const long long n = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return 0;
}

// Copies `rows` rows of `row_bytes` bytes (a multiple of 16) from global
// memory, `src_stride` bytes apart, into shared memory back to back, by
// 16-byte cp.async from every thread of the block, then waits for them and
// syncs the block. src and dst must be 16-byte aligned.
__device__ __forceinline__ void stage_rows(void* dst, const void* src, int rows, int row_bytes,
                                           long long src_stride) {
  const int chunks = row_bytes >> 4;
  const int total = rows * chunks;
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const char* from = (const char*)src + r * src_stride + c * 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + (unsigned)i * 16u),
                 "l"(from));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// The staged kernels' lanes: in a group of 8 lanes, lane j holds channels
// j, j+8, ..., j+8(kT-1) of a row of D = 8 kT channels -- the channels that
// the 32-lane butterfly of `warp_sum` adds first, so a dot keeps its order.
// After staging, each row is interleaved in place so that lane j's kT
// channels are adjacent (channel j + 8t at position j kT + t) and one
// vector load gathers them. Syncs the block.
template <typename T, int kT>
__device__ __forceinline__ void interleave_rows(T* slab, int rows) {
  constexpr int D = 8 * kT;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    const T x = slab[r * D + (lane < D ? lane : 0)];
    __syncwarp();
    if (lane < D) slab[r * D + (lane & 7) * kT + (lane >> 3)] = x;
    __syncwarp();
  }
  __syncthreads();
}

// Lane j's kT channels of an interleaved row (`at` = the row's start + j kT),
// widened to float into out[0..kT), by one vector load.
template <typename T, int kT>
__device__ __forceinline__ void load_lane(const T* at, float* out) {
  struct alignas(sizeof(T) * kT) Vec {
    T v[kT];
  };
  const Vec x = *(const Vec*)at;
#pragma unroll
  for (int t = 0; t < kT; ++t) out[t] = to_float(x.v[t]);
}

// dst[t] += x[t] for t < kT in global memory as reductions that return
// nothing (red.global.add, REDG: the warp does not wait for old values; an
// atomicAdd whose value is unused is not always compiled to one): one
// 16-byte vector reduction for kT = 4 (dst 16-byte aligned), else scalars.
template <int kT>
__device__ __forceinline__ void red_add(float* dst, const float (&x)[kT]) {
  if constexpr (kT == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(
                     __cvta_generic_to_global(dst)),
                 "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3])
                 : "memory");
  } else {
#pragma unroll
    for (int t = 0; t < kT; ++t)
      asm volatile("red.global.add.f32 [%0], %1;" ::"l"(__cvta_generic_to_global(dst + t)),
                   "f"(x[t])
                   : "memory");
  }
}

// The channel sum of one 8-lane group's row (lane j holds the terms of
// channels j + 8t in x[t], zero for t >= kT) in the 32-lane butterfly's
// order, first part: its steps 16 and 8, which stay inside the lane. Steps
// 4, 2, 1 are xor shuffles across the group.
__device__ __forceinline__ float lane_pairs(const float (&x)[4]) {
  return (x[0] + x[2]) + (x[1] + x[3]);
}

// The staged backward kernels' prologue. The block owns `rows` dvalue rows
// (`dsum`: their float32 sums, MD values apart) and their value rows (`src`,
// the same stride): it zeroes the sums, then copies the value rows into
// shared memory (`vs`) and interleaves them. The zeros reach L2 before any
// thread's reductions. Syncs the block.
template <typename T, int kT>
__device__ __forceinline__ void stage_owned_rows(T* vs, const T* src, float* dsum, int rows,
                                                 long long MD) {
  constexpr int D = 8 * kT;
  for (int i = threadIdx.x; i < rows * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4);
    *(float4*)(dsum + r * MD + 4 * (i - r * (D / 4))) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __threadfence();
  stage_rows(vs, src, rows, D * (int)sizeof(T), MD * (long long)sizeof(T));
  interleave_rows<T, kT>(vs, rows);
}

// The staged backward kernels' epilogue: where dvalue's type TDv is not
// float32, the block's float32 sums of its `rows` rows (`dsum`, MD values
// apart), rounded once into dvalue. Syncs the block first.
template <typename TDv, int D>
__device__ __forceinline__ void round_owned_rows(TDv* dvalue, const float* dsum, int rows,
                                                 long long MD) {
  if constexpr (!std::is_same_v<TDv, float>) {
    __threadfence();
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      const long long o = r * MD + (i - r * D);
      store(dvalue + o, __ldcg(dsum + o));
    }
  }
}

// Allows `kernel` `smem` bytes of dynamic shared memory (needed above
// 48 KB). Returns 0 or the cudaError_t of the refusal.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The staged forward kernels' grid, after allowing `kernel` its `smem`:
// `pairs` (batch, head) slabs, each cut into chunks of *q_chunk queries.
// The chunks a pair are the blocks the card holds at once (SMs x blocks per
// SM of `threads` threads at this slab size, from the occupancy calculator)
// over the pairs, at least 1 and at most one query per 8-lane group. Sets
// *q_chunk and *blocks (pairs and Lq must be > 0); returns 0 or a
// cudaError_t.
template <typename Kernel>
inline int staged_fwd_grid(Kernel kernel, int threads, int smem, int device, long long pairs,
                           int Lq, int* q_chunk, unsigned* blocks) {
  int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  int sms = 0, per_sm = 0;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long chunks = (long long)sms * per_sm / pairs;
  chunks = min(chunks, (long long)(Lq / (threads / 8)));  // a query per group
  chunks = max(chunks, 1LL);
  *q_chunk = (int)((Lq + chunks - 1) / chunks);
  const long long n = pairs * ((Lq + *q_chunk - 1) / *q_chunk);
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return 0;
}

}  // namespace msda
