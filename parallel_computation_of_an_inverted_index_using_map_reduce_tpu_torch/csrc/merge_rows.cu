// merge_rows: fold a sorted-unique window of word rows into the
// sorted-unique streaming accumulator, keeping one copy of a row the two
// share.
//
// Replaces no Pallas kernel.  The JAX package, and the port before this
// kernel, merged by concatenating the accumulator's whole capacity with
// the window, sorting the concatenation by radix passes, gathering every
// column by the permutation and scattering the first occurrences into a
// fresh capacity (ops/device_streaming.py `_merge_unique_rows`).  Both
// operands are already sorted and unique, so no sort is needed: a merge
// reads each valid row once and writes each output row once.
//
// A row is (group 0 hi, group 0 lo, ..., group g-1 lo, doc), ordered
// lexicographically; only the first `live_groups` group pairs and the doc
// column (the key columns) can differ between rows, the later group
// columns are 0 on every valid row, and every column is INT32_MAX on a
// padding row.  Inputs: the accumulator (`a`, `a_count` valid rows read
// on the card) and the window (`b`, `b_count` valid rows, read on the
// card); output: `out_cap` rows, the merged rows first, INT32_MAX after,
// and their count.
//
// Bound: memory.  The key columns of the two valid prefixes are read and
// every column of the whole output capacity is written: for the streaming
// plan's last merge (6.2 M + 0.88 M valid rows, 3 key columns, 9 columns
// of 16.78 M rows) 689 MB, 0.206 ms at 3.35 TB/s.  A compare is a few
// integer ops a row, far below any compute roof.
//
// Design.  Merge path: the merged sequence's diagonals are cut into tiles
// of `tile` rows, one block each.
// - pass 1 (count): each block binary-searches, in device memory, the
//   A/B split of its first and last diagonal (ties take A first), stages
//   the key columns of its A and B ranges in shared memory, merges them
//   there (each thread its own `per_thread` diagonals, found by a second
//   binary search in shared memory) and counts its duplicates: a B row
//   equal to the A row taken just before it.  The A row before a tile's
//   first row is staged too, so a duplicate that straddles two tiles is
//   counted once, in the later tile.  It stores its split and its count.
// - pass 2 (scan, one block): the tiles' duplicate counts become their
//   exclusive prefix, and the output count is written to the card.
// - pass 3 (write): each block stages and merges again, drops its
//   duplicates (a block scan of the threads' counts gives each kept row
//   its slot) and writes its rows at the tile's first diagonal minus the
//   duplicates of the tiles before it; the non-key columns get 0.
// - pass 4 (fill): INT32_MAX in rows [count, out_cap) of every column.
// Device-memory accesses are neighbouring lanes on neighbouring words, as
// 16-byte vectors between a scalar head and tail (a tile's rows start
// anywhere).  No count is read on the host: the grids are sized from the
// capacities and blocks past the valid diagonals exit.  The output may be
// larger than the accumulator; a capacity doubling needs no copy.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxCols = 64;
constexpr int kMaxPerThread = 8;
constexpr int kSmemTarget = 48 * 1024;   // below this the tile shrinks no further
constexpr int kMaxSmem = 96 * 1024;
constexpr int32_t kPad = 0x7fffffff;

struct Merge {
  const int32_t* a[kMaxCols];
  const int32_t* b[kMaxCols];
  int32_t* out[kMaxCols];
  int64_t a_cap, b_cap, out_cap;
  const int32_t* a_count;
  const int32_t* b_count;
  int32_t* out_count;
  int64_t* splits;     // num_tiles + 1: the A rows before each tile's first diagonal
  int64_t* tile_dups;  // num_tiles: each tile's duplicates, then their exclusive prefix
  int ncols, nkey;     // key k < nkey - 1 is column k; the last key is the doc column
  int per_thread, tile, num_tiles;
};

__device__ __forceinline__ int key_col(const Merge& m, int k) {
  return k < m.nkey - 1 ? k : m.ncols - 1;
}

__device__ __forceinline__ void valid_sizes(const Merge& m, int64_t& na, int64_t& nb) {
  const int64_t x = *m.a_count, y = *m.b_count;
  na = x < 0 ? 0 : (x > m.a_cap ? m.a_cap : x);
  nb = y < 0 ? 0 : (y > m.b_cap ? m.b_cap : y);
}

// A row i against B row j in device memory: -1, 0 or 1.
__device__ int cmp_global(const Merge& m, int64_t i, int64_t j) {
  for (int k = 0; k < m.nkey; ++k) {
    const int c = key_col(m, k);
    const int32_t x = m.a[c][i], y = m.b[c][j];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// The A rows among the first d merged rows (ties take A first).
__device__ int64_t global_split(const Merge& m, int64_t d, int64_t na, int64_t nb) {
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (cmp_global(m, mid, d - 1 - mid) <= 0) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Shared-memory rows r and s: -1, 0 or 1.
__device__ __forceinline__ int cmp_rows(const int32_t* keys, int stride, int nkey, int r,
                                        int s) {
  for (int k = 0; k < nkey; ++k) {
    const int32_t x = keys[k * stride + r], y = keys[k * stride + s];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// Words ahead of p until a 16-byte boundary, at most n.
__device__ __forceinline__ int head_words(const int32_t* p, int n) {
  const int h = (int)((4 - (((uintptr_t)p >> 2) & 3)) & 3);
  return h < n ? h : n;
}

// dst[t] = src[t] for t in [0, n), the block's threads together.
__device__ void stage(const int32_t* __restrict__ src, int n, int32_t* dst) {
  const int head = head_words(src, n);
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  const int nvec = (n - head) >> 2;
  const int4* v = reinterpret_cast<const int4*>(src + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int4 x = v[i];
    int32_t* d = dst + head + 4 * i;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
  for (int t = head + 4 * nvec + threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

// dst[t] = value(t) for t in [0, n), the block's threads together.
template <class F>
__device__ void store(int32_t* dst, int n, F value) {
  const int head = head_words(dst, n);
  if ((int)threadIdx.x < head) dst[threadIdx.x] = value(threadIdx.x);
  const int nvec = (n - head) >> 2;
  int4* v = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int r = head + 4 * i;
    v[i] = make_int4(value(r), value(r + 1), value(r + 2), value(r + 3));
  }
  for (int t = head + 4 * nvec + threadIdx.x; t < n; t += blockDim.x) dst[t] = value(t);
}

// Exclusive prefix sum of one value a thread over a block of kBlock
// threads; *total gets the block's sum.  `scratch` holds kBlock / 32 + 1.
template <int kBlock, class T>
__device__ T block_exclusive_sum(T v, T* scratch, T* total) {
  constexpr int kW = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const T w = lane < kW ? scratch[lane] : T(0);
    T s = w;
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kW) scratch[lane] = s - w;
    if (lane == 31) scratch[kW] = s;
  }
  __syncthreads();
  const T out = scratch[warp] + x - v;
  *total = scratch[kW];
  __syncthreads();
  return out;
}

template <bool kWrite>
__global__ void __launch_bounds__(kThreads) merge_tile_kernel(const Merge m) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t s_split[2];
  __shared__ int s_scan[kWarps + 1];
  int64_t na, nb;
  valid_sizes(m, na, nb);
  const int64_t total = na + nb;
  const int64_t d0 = (int64_t)blockIdx.x * m.tile;
  if (d0 >= total) {
    if (!kWrite && threadIdx.x == 0) m.tile_dups[blockIdx.x] = 0;
    return;
  }
  const int64_t d1 = d0 + m.tile < total ? d0 + m.tile : total;
  if (threadIdx.x < 2) {
    s_split[threadIdx.x] = kWrite ? m.splits[blockIdx.x + threadIdx.x]
                                  : global_split(m, threadIdx.x ? d1 : d0, na, nb);
  }
  __syncthreads();
  const int64_t a0 = s_split[0], a1 = s_split[1], b0 = d0 - a0;
  const int n = (int)(d1 - d0), nat = (int)(a1 - a0), nbt = n - nat;
  const bool ctx = a0 > 0;
  // key k's rows: [0] the A row before the tile, [1, nat] its A rows,
  // then its B rows
  const int stride = m.tile + 1;
  int32_t* keys = smem;
  int* src = smem + m.nkey * stride;
  for (int k = 0; k < m.nkey; ++k) {
    const int c = key_col(m, k);
    int32_t* row = keys + k * stride;
    if (threadIdx.x == 0) row[0] = ctx ? m.a[c][a0 - 1] : 0;
    stage(m.a[c] + a0, nat, row + 1);
    stage(m.b[c] + b0, nbt, row + 1 + nat);
  }
  __syncthreads();

  const int q0 = min((int)threadIdx.x * m.per_thread, n);
  const int cnt = min(m.per_thread, n - q0);
  int lo = q0 > nbt ? q0 - nbt : 0, hi = q0 < nat ? q0 : nat;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cmp_rows(keys, stride, m.nkey, 1 + mid, nat + q0 - mid) <= 0) lo = mid + 1;
    else hi = mid;
  }
  const int i0 = lo;
  // one merged row: its shared-memory row, and whether it repeats the A
  // row before it (row i holds A row i - 1, or the A row before the tile)
  auto merge = [&](int& i, int& j, int& from) -> bool {
    if (i < nat && (j >= nbt || cmp_rows(keys, stride, m.nkey, 1 + i, 1 + nat + j) <= 0)) {
      from = 1 + i++;
      return false;
    }
    from = 1 + nat + j++;
    return (i > 0 || ctx) && cmp_rows(keys, stride, m.nkey, i, from) == 0;
  };
  int dups = 0;
  {
    int i = i0, j = q0 - i0, from;
    for (int q = 0; q < cnt; ++q) dups += merge(i, j, from);
  }
  int block_dups;
  const int before = block_exclusive_sum<kThreads>(dups, s_scan, &block_dups);
  if (!kWrite) {
    if (threadIdx.x == 0) {
      m.tile_dups[blockIdx.x] = block_dups;
      m.splits[blockIdx.x] = a0;
      if (d1 == total) m.splits[blockIdx.x + 1] = a1;
    }
    return;
  }
  {
    int i = i0, j = q0 - i0, from, slot = q0 - before;
    for (int q = 0; q < cnt; ++q)
      if (!merge(i, j, from)) src[slot++] = from;
  }
  __syncthreads();
  const int64_t base = d0 - m.tile_dups[blockIdx.x];
  const int64_t room = m.out_cap - base;
  const int kept = n - block_dups;
  const int w = room <= 0 ? 0 : (room < kept ? (int)room : kept);
  for (int c = 0; c < m.ncols; ++c) {
    const int k = c < m.nkey - 1 ? c : (c == m.ncols - 1 ? m.nkey - 1 : -1);
    if (k < 0) {
      store(m.out[c] + base, w, [](int) { return 0; });
    } else {
      const int32_t* row = keys + k * stride;
      store(m.out[c] + base, w, [&](int r) { return row[src[r]]; });
    }
  }
}

__global__ void __launch_bounds__(kScanThreads) merge_scan_kernel(const Merge m) {
  __shared__ long long s_scan[kScanThreads / 32 + 1];
  const int per = (m.num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min((int)threadIdx.x * per, m.num_tiles);
  const int hi = min(lo + per, m.num_tiles);
  long long s = 0;
  for (int t = lo; t < hi; ++t) s += m.tile_dups[t];
  long long all;
  long long run = block_exclusive_sum<kScanThreads>(s, s_scan, &all);
  for (int t = lo; t < hi; ++t) {
    const long long v = m.tile_dups[t];
    m.tile_dups[t] = run;
    run += v;
  }
  if (threadIdx.x == 0) {
    int64_t na, nb;
    valid_sizes(m, na, nb);
    *m.out_count = (int32_t)(na + nb - all);
  }
}

// INT32_MAX into rows [count, out_cap) of column blockIdx.y.
__global__ void __launch_bounds__(kThreads) merge_fill_kernel(const Merge m) {
  const int64_t count = *m.out_count;
  const int64_t s = count < 0 ? 0 : count;
  if (s >= m.out_cap) return;
  int32_t* dst = m.out[blockIdx.y] + s;
  const int64_t n = m.out_cap - s;
  const int head = head_words(dst, n < 4 ? (int)n : 4);
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;
  if (gtid < head) dst[gtid] = kPad;
  const int64_t nvec = (n - head) >> 2;
  int4* v = reinterpret_cast<int4*>(dst + head);
  const int4 pad = make_int4(kPad, kPad, kPad, kPad);
  for (int64_t i = gtid; i < nvec; i += gstride) v[i] = pad;
  for (int64_t t = head + 4 * nvec + gtid; t < n; t += gstride) dst[t] = kPad;
}

int smem_bytes(int nkey, int per_thread) {
  const int tile = kThreads * per_thread;
  return (nkey * (tile + 1) + tile) * (int)sizeof(int32_t);
}

}  // namespace

extern "C" {

// Merge on `stream` (a cudaStream_t from the caller).  `a_cols`,
// `b_cols`, `out_cols`: host arrays of `ncols` int32 device columns of
// `a_cap`, `b_cap` and `out_cap` rows; `a_count`, `b_count`: int32 device
// scalars; `out_count`: an int32 device scalar the merge writes;
// `scratch`: `scratch_len` int64 device words, at least
// 2 * ceil((a_cap + b_cap) / 256) + 1.  The output must not overlap an
// input.  Returns the cudaError_t of the launches.
int mri_merge_sorted_rows(const void* const* a_cols, long long a_cap,
                          const void* const* b_cols, long long b_cap, int ncols,
                          int live_groups, const void* a_count, const void* b_count,
                          void* const* out_cols, long long out_cap, void* out_count,
                          void* scratch, long long scratch_len, int device, void* stream) {
  if (ncols < 3 || ncols > kMaxCols || live_groups < 1 || 2 * live_groups + 1 > ncols ||
      a_cap < 0 || b_cap < 0 || out_cap < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Merge m = {};
  for (int c = 0; c < ncols; ++c) {
    m.a[c] = (const int32_t*)a_cols[c];
    m.b[c] = (const int32_t*)b_cols[c];
    m.out[c] = (int32_t*)out_cols[c];
  }
  m.a_cap = a_cap;
  m.b_cap = b_cap;
  m.out_cap = out_cap;
  m.a_count = (const int32_t*)a_count;
  m.b_count = (const int32_t*)b_count;
  m.out_count = (int32_t*)out_count;
  m.ncols = ncols;
  m.nkey = 2 * live_groups + 1;
  m.per_thread = kMaxPerThread;
  while (m.per_thread > 1 && smem_bytes(m.nkey, m.per_thread) > kSmemTarget) m.per_thread >>= 1;
  const int smem = smem_bytes(m.nkey, m.per_thread);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  m.tile = kThreads * m.per_thread;
  const long long tiles = (a_cap + b_cap + m.tile - 1) / m.tile;
  if (tiles > 0x7fffffffLL || 2 * tiles + 1 > scratch_len) return (int)cudaErrorInvalidValue;
  m.num_tiles = (int)tiles;
  m.splits = (int64_t*)scratch;
  m.tile_dups = m.splits + tiles + 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    // always the largest opt-in, so a launch from another host thread with
    // fewer key columns never lowers it below this launch's need
    err = cudaFuncSetAttribute(merge_tile_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(merge_tile_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    merge_tile_kernel<false><<<m.num_tiles, kThreads, smem, s>>>(m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  merge_scan_kernel<<<1, kScanThreads, 0, s>>>(m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (tiles > 0) {
    merge_tile_kernel<true><<<m.num_tiles, kThreads, smem, s>>>(m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out_cap > 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long needed = (out_cap / 4 + kThreads) / kThreads;
    const long long most = (long long)sms * 4;
    dim3 grid((unsigned)(needed < most ? needed : most), (unsigned)ncols);
    merge_fill_kernel<<<grid, kThreads, 0, s>>>(m);
  }
  return (int)cudaGetLastError();
}

const char* mri_merge_sorted_rows_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
