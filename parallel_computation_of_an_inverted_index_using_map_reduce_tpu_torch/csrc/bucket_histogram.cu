// bucket_histogram: count of each id in [0, num_buckets), 1 <= num_buckets <= 128.
//
// Replaces the Pallas TPU kernel bucket_histogram (_hist_kernel /
// _hist_call in the JAX package's ops/pallas/kernels.py), which
// utils/stats.partition_skew calls twice per --skew run: 26 letter
// buckets and the hash buckets.  Values out of range (padding) are
// ignored.
//
// Bound: memory.  It reads 4n bytes and writes 4 * num_buckets.  The TPU
// version ran one compare-and-sum per bucket over every block, summing
// across its in-order grid in SMEM.  Here each block keeps a private
// histogram in shared memory; a warp first groups equal ids with
// __match_any_sync, so a run of one hot id (Zipf text: a few letters
// dominate) costs one shared atomic per warp instead of 32.  Each block
// then adds its non-zero bins once into the global counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 128;

__global__ void bucket_histogram_kernel(const int32_t* __restrict__ values,
                                        int64_t n, int num_buckets,
                                        int32_t* __restrict__ counts) {
  __shared__ int hist[kMaxBuckets];
  for (int b = threadIdx.x; b < num_buckets; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  // uniform trip count per block: every lane reaches __match_any_sync
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < n ? values[i] : -1;
    const bool in_range = (uint32_t)v < (uint32_t)num_buckets;
    const unsigned peers = __match_any_sync(0xffffffffu, in_range ? v : -1);
    if (in_range && lane == __ffs(peers) - 1) atomicAdd(&hist[v], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < num_buckets; b += kThreads)
    if (hist[b]) atomicAdd(&counts[b], hist[b]);
}

}  // namespace

extern "C" {

// Launch on `stream`.  `counts` (num_buckets int32) must be zeroed by the
// caller; n >= 1.  Returns the cudaError_t of the launch.
int mri_bucket_histogram(const void* values, long long n, int num_buckets,
                         void* counts, int device, void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;
  const int blocks = (int)(needed < cap ? needed : cap);
  bucket_histogram_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (int64_t)n, num_buckets, (int32_t*)counts);
  return (int)cudaGetLastError();
}

const char* mri_bucket_histogram_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
