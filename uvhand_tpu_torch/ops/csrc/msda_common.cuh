// Helpers shared by the MSDA kernels (msda_fwd.cu, msda_bwd.cu,
// msda_fac_fwd.cu, msda_fac_bwd.cu): the level plan passed by value, type
// conversions, the bf16 rounding of the factorized kernels, the warp
// reduction whose order the plain PyTorch versions repeat (`_warp_sum` in
// ops/msda.py), and the host-side checks and grid size of a launch.
//
// Every kernel runs one warp per (batch, query, head) row, lanes over the D
// channels of a head (chunks of 32 for D > 32), kWarpsPerBlock warps a block.

#pragma once

#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded (to nearest even) to T and widened back; the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same_v<T, float>) {
    return x;
  } else {
    return __bfloat162float(__float2bfloat16(x));
  }
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

// Sum over the 32 lanes by an xor butterfly 16, 8, 4, 2, 1; every lane ends
// with the same value.
__device__ __forceinline__ float warp_sum(float x) {
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

}  // namespace msda
