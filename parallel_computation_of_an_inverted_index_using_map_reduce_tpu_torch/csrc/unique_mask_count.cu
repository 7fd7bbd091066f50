// unique_mask_count: first-occurrence mask + unique count over ascending keys.
//
// Replaces the Pallas TPU kernel unique_mask_count (_unique_kernel /
// _unique_call in the JAX package's ops/pallas/kernels.py): the reduce
// phase's per-(term, doc) dedup, the reference reducer's linear dictionary
// scan (main.c:172-187).
//
//   mask[i] = (k[i] != k[i-1]) && (k[i] < valid_limit),  k[-1] := k[0] - 1
//   count   = sum(mask)
//
// Bound: memory.  It reads 4n bytes and writes n (one byte per mask slot)
// plus the 4-byte count, and does one compare pair per element, far below
// any compute roof.  The TPU version walked its grid in order and carried
// the previous block's last key through SMEM; here every thread reads its
// own left neighbour (a second, cached read of the same line), so blocks
// are independent and the grid is a plain grid-stride loop.  The count is
// reduced per warp with shuffles, per block through shared memory, and
// added to one int32 with a single atomicAdd per block: integer sums are
// exact in any order.  The grid is capped so the atomics stay few.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void unique_mask_count_kernel(const int32_t* __restrict__ keys,
                                         int64_t n, int32_t valid_limit,
                                         uint8_t* __restrict__ mask,
                                         int32_t* __restrict__ count) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int local = 0;
  // every thread of a block runs the same number of iterations, so the
  // full-warp shuffles below never see an exited lane
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n; base += stride) {
    const int64_t i = base + threadIdx.x;
    if (i < n) {
      const int32_t k = keys[i];
      // k[-1] := k[0] - 1 never equals k[0], so slot 0 is always a first
      const bool first = (i == 0) || (k != keys[i - 1]);
      const bool m = first && (k < valid_limit);
      mask[i] = m ? 1 : 0;
      local += m ? 1 : 0;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && s) atomicAdd(count, s);
  }
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller).  `count` must be
// zeroed by the caller; n >= 1.  Returns the cudaError_t of the launch.
int mri_unique_mask_count(const void* keys, long long n, int valid_limit,
                          void* mask, void* count, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;
  const int blocks = (int)(needed < cap ? needed : cap);
  unique_mask_count_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int64_t)n, (int32_t)valid_limit, (uint8_t*)mask,
      (int32_t*)count);
  return (int)cudaGetLastError();
}

const char* mri_unique_mask_count_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
