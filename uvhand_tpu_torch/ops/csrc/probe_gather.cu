// The in-kernel gather probe, for Hopper (sm_90a).
//
// Replaces the TPU kernels `kernel` of scripts/repro_dynamic_gather.py:23
// (`pallas_call` :31) and of scripts/probe_gather_scale.py:19 (`pallas_call`
// :28), which asked whether Mosaic could gather along sublanes or lanes
// (`jnp.take_along_axis` inside a kernel) and at what rate. The function,
// for values v (N, R, C) float32 and indices idx (N, R, C) int32:
//   axis 2: out[n, r, c] = v[n, r, idx[n, r, c]]
//   axis 1: out[n, r, c] = v[n, idx[n, r, c], c]
// (a 2-D array is N = 1, its axis 0 and 1 are 1 and 2 here). Indices must
// lie in range, as on the TPU; an index out of range gives NaN, never a read
// outside the array.
//
// One thread per output element, consecutive threads on consecutive
// elements: the index loads and the stores are coalesced; the value loads
// land wherever the indices send them, within the thread's row (axis 2) or
// column (axis 1), so L2 and L1 serve most of them.
//
// Bound on the H100: the bytes, 12 per element (index and value read,
// value written); at the largest probed shape (16, 1048, 1408) 283 MB,
// 0.085 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cmath>

namespace {

template <int kAxis>
__global__ void probe_gather_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                                    float* __restrict__ out, int N, int R, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)N * R * C;
  if (i >= n) return;
  const int j = idx[i];
  const int c = (int)(i % C);
  const long long nr = i / C;
  if constexpr (kAxis == 2) {
    out[i] = (j >= 0 && j < C) ? v[nr * C + j] : NAN;
  } else {
    const long long b = nr / R;
    out[i] = (j >= 0 && j < R) ? v[(b * R + j) * C + c] : NAN;
  }
}

}  // namespace

// v, idx and out (N, R, C) on card `device`, `axis` 1 or 2; launched on
// `stream`. Returns the cudaError_t of the launch (0 when it was accepted).
extern "C" int probe_gather(const void* v, const void* idx, void* out, int N, int R, int C,
                            int axis, int device, void* stream) {
  if (N < 1 || R < 1 || C < 1 || (axis != 1 && axis != 2)) return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n = (long long)N * R * C;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (axis == 2) {
    probe_gather_kernel<2><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)v, (const int*)idx, (float*)out, N, R, C);
  } else {
    probe_gather_kernel<1><<<(unsigned)blocks, 256, 0, s>>>(
        (const float*)v, (const int*)idx, (float*)out, N, R, C);
  }
  return (int)cudaGetLastError();
}
