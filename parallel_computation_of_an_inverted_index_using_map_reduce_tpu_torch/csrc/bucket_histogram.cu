// bucket_histogram: count of each id in [0, num_buckets).
//
// Replaces the Pallas TPU kernel bucket_histogram (_hist_kernel /
// _hist_call in the JAX package's ops/pallas/kernels.py), which
// utils/stats.partition_skew calls twice per --skew run: 26 letter
// buckets and the hash buckets.  Values out of range (padding, negatives)
// are ignored.
//
// Bound: memory.  It reads 4n bytes and writes 4 * num_buckets, over
// 3.35 TB/s: 23.9 us for n = 20 M.  The work is one compare and one add
// per id, far below any compute roof.
//
// Design.  The earlier version grouped equal ids in a warp with
// __match_any_sync and had each group's leader atomicAdd into one shared
// histogram per block.  It paid a match step and a shared atomic for
// every distinct id in a warp, so its time grew with the number of
// distinct ids, not with skew: one-hot ids were its fastest input and
// uniform ids over 128 bins its slowest, all far from the byte bound.
// Here no update waits on another thread:
// - every thread owns one private 32-bit counter per bin,
//   hist[bin * blockDim.x + tid], so a warp's 32 lanes hit 32 different
//   banks whatever the ids; an update is a plain load-add-store by the
//   slot's only writer, with no warp match and no atomic;
// - out-of-range ids count into one spare trash row, so the loop has no
//   branch;
// - ids are read as 16-byte int4 vectors, kUnroll per thread per step,
//   and the next step's loads are issued before this step's ids are
//   counted; block 0 takes a scalar head up to the 16-byte boundary (a
//   view such as x[1:] starts 4 bytes off) and a scalar tail of n % 4;
// - a block is as wide as its columns fit in shared memory (1024 threads
//   up to 55 buckets, 512 up to 112, 256 up to 128), and the grid is
//   persistent: as many blocks as are resident at once, each walking the
//   array grid-strided;
// - at the end each warp sums whole bins across the block's columns with
//   shuffles, and each block adds each non-zero bin once into the global
//   counts.  Integer sums are exact in any order.  Those adds all reach
//   the few cache lines of `counts` at the end of the run, where the L2
//   serves them one after another, which is why the blocks are wide:
//   one 1024-thread block per SM issues 132 adds per bin, where
//   256-thread blocks, seven to an SM, issued seven times as many and
//   were markedly slower at 26 buckets than at 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxBuckets = 128;
constexpr int kUnroll = 4;
constexpr int kMaxSmem = 232448;  // 227 KB: the most one block may opt in to

// `col` is this thread's column of the private histogram, `ld` its row
// stride (the block width)
__device__ __forceinline__ void count_id(unsigned* col, int32_t v, unsigned nb, unsigned ld) {
  const unsigned row = (unsigned)v < nb ? (unsigned)v : nb;  // else the trash row
  col[row * ld] += 1u;
}

__device__ __forceinline__ void count_vec(unsigned* col, int4 q, unsigned nb, unsigned ld) {
  count_id(col, q.x, nb, ld);
  count_id(col, q.y, nb, ld);
  count_id(col, q.z, nb, ld);
  count_id(col, q.w, nb, ld);
}

__global__ void __launch_bounds__(kMaxThreads)
bucket_histogram_kernel(const int32_t* __restrict__ values, int64_t n,
                        int num_buckets, int32_t* __restrict__ counts) {
  extern __shared__ unsigned hist[];  // (num_buckets + 1) rows x blockDim.x
  const unsigned nb = (unsigned)num_buckets;
  const unsigned ld = blockDim.x;
  unsigned* col = hist + threadIdx.x;
  for (unsigned r = 0; r <= nb; ++r) col[r * ld] = 0u;
  // no barrier: until the merge each thread touches only its own column

  const int64_t misaligned = (int64_t)(((uintptr_t)values >> 2) & 3);
  const int64_t to_boundary = (4 - misaligned) & 3;
  const int64_t head = to_boundary < n ? to_boundary : n;
  const int4* body = reinterpret_cast<const int4*>(values + head);
  const int64_t n_vec = (n - head) >> 2;
  const int64_t tail = head + (n_vec << 2);
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) count_id(col, values[threadIdx.x], nb, ld);
    if (threadIdx.x < n - tail) count_id(col, values[tail + threadIdx.x], nb, ld);
  }

  // steps of kUnroll vectors, the next step's loads in flight while this
  // step is counted
  const int64_t stride = (int64_t)gridDim.x * ld;
  int64_t i = (int64_t)blockIdx.x * ld + threadIdx.x;
  int4 cur[kUnroll], nxt[kUnroll];
  bool full = i + (kUnroll - 1) * stride < n_vec;
  if (full) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = __ldg(body + i + u * stride);
  }
  while (full) {
    const int64_t j = i + kUnroll * stride;
    const bool next_full = j + (kUnroll - 1) * stride < n_vec;
    if (next_full) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) nxt[u] = __ldg(body + j + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) count_vec(col, cur[u], nb, ld);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
    i = j;
    full = next_full;
  }
  for (; i < n_vec; i += stride) count_vec(col, __ldg(body + i), nb, ld);
  __syncthreads();

  // warp w sums bins w, w + warps, ...: the bin loop is uniform per warp
  const unsigned lane = threadIdx.x & 31;
  for (unsigned b = threadIdx.x >> 5; b < nb; b += ld >> 5) {
    const unsigned* row = hist + b * ld;
    unsigned s = 0;
    for (unsigned k = lane; k < ld; k += 32) s += row[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && s) atomicAdd(&counts[b], (int)s);
  }
}

// The widest block whose columns fit: (num_buckets + 1) rows of 4 bytes.
int block_threads(int num_buckets) {
  int threads = kMaxThreads;
  while ((num_buckets + 1) * threads * (int)sizeof(unsigned) > kMaxSmem) threads >>= 1;
  return threads;
}

}  // namespace

extern "C" {

// Launch on `stream` (a cudaStream_t from the caller).  `counts` (int32,
// num_buckets) must be zeroed by the caller; n >= 1; 1 <= num_buckets <=
// 128.  Returns the cudaError_t of the launch.
int mri_bucket_histogram(const void* values, long long n, int num_buckets,
                         void* counts, int device, void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = block_threads(num_buckets);
  const int smem = (num_buckets + 1) * threads * (int)sizeof(unsigned);
  // always the largest opt-in, so a launch from another host thread with
  // fewer buckets never lowers it below this launch's need
  err = cudaFuncSetAttribute(bucket_histogram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_histogram_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  const long long needed = (n / 4 + threads - 1) / threads;
  const int blocks = (int)(needed < 1 ? 1 : needed < resident ? needed : resident);
  bucket_histogram_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)values, (int64_t)n, num_buckets, (int32_t*)counts);
  return (int)cudaGetLastError();
}

const char* mri_bucket_histogram_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
