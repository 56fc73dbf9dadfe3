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
// outside the array (axis 2: outside the row). Both kernels keep that.
//
// Bound on the H100: the bytes, 12 per element (index and value read,
// value written); at the largest probed shape (16, 1048, 1408) 283 MB,
// 0.085 ms at 3.35 TB/s.
//
// Two kernels; `msda_cuda.gather_plan` picks one from the shapes and the
// alignment before the launch:
//
// staged (axis 2, C % 4 == 0, v, idx and out 16-byte aligned; the plan
//   picks it from 2 MiB of values, below which a call is paced by its
//   launch and this kernel's chain of set-up, copy and gather is the longer
//   one): the TPU kernel gathered from a block staged in VMEM, and so does
//   this one, from shared memory. Each row of v is gathered only by indices
//   of that row, so a block can own whole rows. Persistent blocks (as many
//   as the card holds at once) walk chunks of `chunk_rows` rows; each
//   chunk's values arrive in one ring stage by one 1-D TMA bulk copy that
//   completes on the stage's mbarrier, started `stages` chunks ahead by
//   thread 0. Every thread reads its indices as 16-byte vectors with a
//   no-allocate load, gathers four values from the staged rows (random
//   shared-memory reads: a few ways of bank conflict, not sectors of L2)
//   and writes them as one 16-byte streaming store. A stage is refilled
//   only after the whole block has passed the block barrier that ends its
//   chunk. Device memory sees the 12 compulsory bytes an element and
//   nothing more.
//
// general (every shape, either axis): one thread per output element,
//   consecutive threads on consecutive elements: the index loads and the
//   stores are coalesced; the value loads land wherever the indices send
//   them, within the thread's row (axis 2) or column (axis 1), so L2 and L1
//   serve most of them, in 32-byte sectors of which a random index uses 4
//   bytes.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kStagedThreads = 256;
constexpr int kUnroll = 4;  // index vectors a thread loads before it gathers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// The producer's arrival on `bar`: its phase completes once `bytes` have
// landed.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 1-D TMA copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int4 load_no_allocate(const int4* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ float pick(const float* row, int j, int C) {
  return (unsigned)j < (unsigned)C ? row[j] : NAN;
}

__global__ void __launch_bounds__(kStagedThreads)
    probe_gather_staged_kernel(const float* __restrict__ v, const int* __restrict__ idx,
                               float* __restrict__ out, long long rows, int C, int chunk_rows,
                               int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long stage_elems = (long long)chunk_rows * C;
  float* ring = (float*)smem;
  unsigned long long* full = (unsigned long long*)(ring + stages * stage_elems);
  const long long chunks = (rows + chunk_rows - 1) / chunk_rows;
  const int C4 = C >> 2;
  const int tid = threadIdx.x;

  // the k-th chunk this block takes, and its stage
  auto chunk_of = [&](long long k) { return blockIdx.x + k * gridDim.x; };
  auto fetch = [&](long long k) {
    const long long r0 = chunk_of(k) * chunk_rows;
    const int s = (int)(k % stages);
    const unsigned bytes = (unsigned)min((long long)chunk_rows, rows - r0) * (unsigned)C * 4u;
    mbar_expect_tx(&full[s], bytes);
    bulk_copy(ring + s * stage_elems, v + r0 * C, bytes, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < stages && chunk_of(k) < chunks; ++k) fetch(k);
  }
  for (long long k = 0; chunk_of(k) < chunks; ++k) {
    const long long r0 = chunk_of(k) * chunk_rows;
    const int s = (int)(k % stages);
    const unsigned parity = (unsigned)((k / stages) & 1);
    const int n4 = (int)min((long long)chunk_rows, rows - r0) * C4;
    const float* staged = ring + s * stage_elems;
    const int4* idx4 = (const int4*)(idx + r0 * C);
    float4* out4 = (float4*)(out + r0 * C);
    for (int j0 = tid; j0 < n4; j0 += kUnroll * kStagedThreads) {
      int4 id[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kStagedThreads;
        if (j < n4) id[u] = load_no_allocate(idx4 + j);
      }
      mbar_wait(&full[s], parity);  // at once after the chunk's first wait
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kStagedThreads;
        if (j < n4) {
          const float* row = staged + (j / C4) * C;
          __stcs(out4 + j, make_float4(pick(row, id[u].x, C), pick(row, id[u].y, C),
                                       pick(row, id[u].z, C), pick(row, id[u].w, C)));
        }
      }
    }
    __syncthreads();  // every thread is done with stage s: refill it
    if (tid == 0 && chunk_of(k + stages) < chunks) fetch(k + stages);
  }
}

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

// The general kernel. v, idx and out (N, R, C) on card `device`, `axis` 1
// or 2; launched on `stream`. Returns the cudaError_t of the launch (0 when
// it was accepted).
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

// The staged kernel, along axis 2 of v, idx and out (N, R, C) on card
// `device`: chunks of `chunk_rows` rows in a ring of `stages` stages, `smem`
// bytes of dynamic shared memory, which must be stages * (chunk_rows * C * 4
// + 8) (the ring, then one mbarrier a stage). C must be a multiple of 4 and
// the three pointers 16-byte aligned. Launched on `stream` with as many
// blocks as the card holds at once, at most one a chunk. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for what it does not
// take).
extern "C" int probe_gather_staged(const void* v, const void* idx, void* out, int N, int R,
                                   int C, int chunk_rows, int stages, int smem, int device,
                                   void* stream) {
  if (N < 1 || R < 1 || C < 1 || C % 4 != 0 || chunk_rows < 1 || stages < 2 ||
      ((unsigned long long)v | (unsigned long long)idx | (unsigned long long)out) % 16 != 0 ||
      (long long)smem != (long long)stages * ((long long)chunk_rows * C * 4 + 8)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(probe_gather_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_gather_staged_kernel,
                                                      kStagedThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long rows = (long long)N * R;
  const long long chunks = (rows + chunk_rows - 1) / chunk_rows;
  const long long blocks = chunks < (long long)sms * per_sm ? chunks : (long long)sms * per_sm;
  probe_gather_staged_kernel<<<(unsigned)blocks, kStagedThreads, smem, (cudaStream_t)stream>>>(
      (const float*)v, (const int*)idx, (float*)out, rows, C, chunk_rows, stages);
  return (int)cudaGetLastError();
}
