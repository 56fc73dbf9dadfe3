// The dynamic lane-slice probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of scripts/probe_dynamic_lane_slice.py:32
// (`pallas_call` :39). On the TPU it asked whether Mosaic could cut head m's
// window of W lanes at a lane offset known only at run time (m * W) out of a
// (Q, M * W) operand. The function:
//   out[m * Q + q, w] = 2 * x[q, m * W + w]      (float32)
// i.e. a (Q, M, W) -> (M, Q, W) relayout times two. On Hopper a thread may
// load any address, so the question has no counterpart; the kernels measure
// the relayout as one pass.
//
// Bound on the H100: the bytes, each input read once and each output written
// once: at the probe's shape (Q = 1048, M = 8, W = 16) 1.07 MB, 0.32 us at
// 3.35 TB/s, far below a launch's own device time, which an empty kernel of
// the same grid measures (`probe_lane_slice_floor`); at the MSDA call site's
// per-head relayout (Q = 16 x 1048) 17.2 MB, 5.13 us.
//
// Two kernels; `msda_cuda.lane_slice_plan` picks one before the launch:
//
// vec4 (W % 4 == 0, x and out 16-byte aligned): each thread moves whole
//   16-byte vectors: out[m, q, 4j..4j+3] comes from x[q, m * W + 4j ..], so
//   its load and its store are aligned 16-byte accesses (a warp's loads are
//   W/4-vector runs of 4W bytes at a stride of 4MW bytes, whole sectors; its
//   stores one contiguous 512 bytes). The grid is one wave of resident
//   blocks walking the vectors with a grid-stride loop; the loads and
//   stores stream (evict first), as each byte is touched once.
//
// general (any W and alignment): one thread per output element,
//   consecutive threads on consecutive outputs (coalesced stores; the loads
//   are W-wide runs at a stride of M * W).

#include <cuda_runtime.h>

namespace {

constexpr int kVecThreads = 256;

__global__ void probe_lane_slice_kernel(const float* __restrict__ x, float* __restrict__ out,
                                        int Q, int M, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)M * Q * W;
  if (i >= n) return;
  const int w = (int)(i % W);
  const long long mq = i / W;
  const int q = (int)(mq % Q);
  const int m = (int)(mq / Q);
  out[i] = 2.0f * x[(long long)q * M * W + (long long)m * W + w];
}

// n4 = M * Q * W4 vectors (< 2^31), W4 = W / 4
__global__ void __launch_bounds__(kVecThreads)
    probe_lane_slice_vec4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                 unsigned Q, unsigned M, unsigned W4, unsigned n4) {
  const unsigned step = gridDim.x * kVecThreads;
  for (unsigned i = blockIdx.x * kVecThreads + threadIdx.x; i < n4; i += step) {
    const unsigned mq = i / W4;
    const unsigned w = i - mq * W4;
    const unsigned m = mq / Q;
    const unsigned q = mq - m * Q;
    float4 a = __ldcs(x + ((unsigned long long)q * M + m) * W4 + w);
    a.x *= 2.0f;
    a.y *= 2.0f;
    a.z *= 2.0f;
    a.w *= 2.0f;
    __stcs(out + i, a);
  }
}

// The launch floor: a kernel that does nothing, launched like the vec4 one.
__global__ void __launch_bounds__(kVecThreads) probe_empty_kernel() {}

// The vec4 kernel's grid for n4 vectors on `device`: at most one wave of
// resident blocks (SMs x blocks an SM, from the occupancy calculator, asked
// once a device). Returns 0 or a cudaError_t.
int vec4_grid(int device, long long n4, unsigned* blocks) {
  static int wave[64] = {0};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (wave[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_lane_slice_vec4_kernel,
                                                        kVecThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    wave[device] = sms * per_sm;
  }
  const long long need = (n4 + kVecThreads - 1) / kVecThreads;
  *blocks = (unsigned)(need < wave[device] ? need : wave[device]);
  return 0;
}

// The checks and the grid of the vec4 kernel and of its floor.
int vec4_launch(const void* x, const void* out, int Q, int M, int W, int device,
                unsigned* blocks) {
  if (Q < 1 || M < 1 || W < 4 || W % 4 != 0 ||
      ((unsigned long long)x | (unsigned long long)out) % 16 != 0 ||
      (long long)M * Q * (W / 4) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  return vec4_grid(device, (long long)M * Q * (W / 4), blocks);
}

}  // namespace

// The general kernel. x (Q, M * W) and out (M * Q, W) float32 on card
// `device`; launched on `stream`. Returns the cudaError_t of the launch (0
// when it was accepted).
extern "C" int probe_lane_slice(const void* x, void* out, int Q, int M, int W, int device,
                                void* stream) {
  if (Q < 1 || M < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long n = (long long)M * Q * W;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  probe_lane_slice_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, Q, M, W);
  return (int)cudaGetLastError();
}

// The vec4 kernel, as `probe_lane_slice`; W must be a multiple of 4, x and
// out 16-byte aligned and M * Q * W / 4 below 2^31 (else
// cudaErrorInvalidValue).
extern "C" int probe_lane_slice_vec4(const void* x, void* out, int Q, int M, int W, int device,
                                     void* stream) {
  unsigned blocks = 0;
  const int err = vec4_launch(x, out, Q, M, W, device, &blocks);
  if (err != 0) return err;
  probe_lane_slice_vec4_kernel<<<blocks, kVecThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, (unsigned)Q, (unsigned)M, (unsigned)(W / 4),
      (unsigned)(M * Q * (W / 4)));
  return (int)cudaGetLastError();
}

// The launch floor of `probe_lane_slice_vec4` with the same arguments: an
// empty kernel on its grid and block (x and out are only checked).
extern "C" int probe_lane_slice_floor(const void* x, void* out, int Q, int M, int W,
                                      int device, void* stream) {
  unsigned blocks = 0;
  const int err = vec4_launch(x, out, Q, M, W, device, &blocks);
  if (err != 0) return err;
  probe_empty_kernel<<<blocks, kVecThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
