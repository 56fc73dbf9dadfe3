// The dynamic lane-slice probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of scripts/probe_dynamic_lane_slice.py:32
// (`pallas_call` :39). On the TPU it asked whether Mosaic could cut head m's
// window of W lanes at a lane offset known only at run time (m * W) out of a
// (Q, M * W) operand. The function:
//   out[m * Q + q, w] = 2 * x[q, m * W + w]      (float32)
// i.e. a (Q, M, W) -> (M, Q, W) relayout times two. On Hopper a thread may
// load any address, so the question has no counterpart; the kernel measures
// the relayout as one pass: one thread per output element, consecutive
// threads on consecutive outputs (coalesced stores; the loads are W-wide
// runs at a stride of M * W).
//
// Bound on the H100: the bytes, each input read once and each output written
// once; at the probe's shape (Q = 1048, M = 8, W = 16) 1.07 MB, 0.32 us at
// 3.35 TB/s, far below a kernel launch's own latency (a few us).

#include <cuda_runtime.h>

namespace {

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

}  // namespace

// x (Q, M * W) and out (M * Q, W) float32 on card `device`; launched on
// `stream`. Returns the cudaError_t of the launch (0 when it was accepted).
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
