// tokenize_window: one byte window -> its token rows (the live 5-bit
// group pairs and the doc id of every token), in one read of the bytes.
//
// Replaces no Pallas kernel.  The JAX package tokenizes a window as one
// XLA program (ops/device_tokenizer.py `tokenize_groups`), and so did the
// port before this kernel: some sixty PyTorch launches over the whole
// window (byte classification, letter cumsums, a letter compaction and a
// token-start compaction by n-element scatters, the 6-char packed stream
// and its gathers), each writing n-element int32 or int64 arrays.  The
// rows are the same: `device_tokenizer.tokenize_groups` is the plain
// version, and the output equals it byte for byte, padding included.
//
// Contract (the byte rules of native/tokenizer.cc ByteTables): a space is
// 0x20 or 0x09..0x0D; a letter is A-Z or a-z, coded (byte & 31), 1..26.
// A token starts at a non-space byte after a space, at byte 0, or at a
// document start (an inner end `doc_ends[i]`, i < num_ends - 1, below n;
// ends equal to n are padding), and runs to the next space or document
// start.  Its row, at its rank among the window's starts, packs its first
// min(letters, width) letters 6 to an int32 half (char k of a half at
// shift 25 - 5k; halves hi, lo of group 0, then of group 1, ...) over the
// first `live_groups` groups, and its doc is doc_ids[min(slot,
// num_docs - 1)], slot the count of inner ends at or before its start.
// A letterless token keeps its slot with group 0 = (INT32_MAX, INT32_MAX),
// the other groups 0 and doc INT32_MAX, as every slot from the token count
// to tok_cap does.  `num_tokens` counts every start, those past tok_cap
// too; `max_len` is the largest letter count (no width clip) of the
// tokens below tok_cap.
//
// Bound: memory.  The window's bytes are read and the rows of the whole
// capacity written: at the benchmark cell's window (19.9 MB, 16,384-row
// rounding of about 2.5 M tokens, 3 columns) about 50 MB, 0.015 ms at
// 3.35 TB/s.  A byte is a few integer ops.
//
// Design.  The window is cut into tiles of kTile bytes, one block each,
// 32 bytes a thread (two 16-byte loads where the data is aligned).
// - pass 1 (count): each block marks its document starts in a shared
//   bitmap (a binary search of doc_ends for the tile's range), builds each
//   thread's 32-bit start mask from the byte classes and counts the
//   starts.
// - pass 2 (scan, one block): the tiles' counts become their exclusive
//   prefix; the token count goes to the card and max_len is zeroed.
// - pass 3 (emit): each block rebuilds its masks and ranks its starts by
//   a block scan.  Each token walks its own bytes up to the next space or
//   document start (past the tile where it must: the window stays in the
//   50 MB L2), packs its letters and finds its doc by a binary search of
//   the tile's inner ends.  Rows go to shared memory and from there to
//   device memory column by column, so every column is written coalesced,
//   in rounds of `stage_rows` tokens; ranks at or past tok_cap are not
//   written.  A block reduction and one atomicMax give max_len.
// - pass 4 (fill): the padding rows [num_tokens, tok_cap), read on the
//   card, so the host never waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32 * kThreads;   // bytes a block
constexpr int kTileWords = kTile / 32; // doc-start bitmap words, one a thread
constexpr int kScanThreads = 1024;
constexpr int kMaxCols = 64;
constexpr int kStageBytes = 24 * 1024;
constexpr int kMaxStageRows = 2048;
constexpr int32_t kPad = 0x7fffffff;

struct Tok {
  const uint8_t* data;
  const int32_t* inner;  // doc_ends without its last entry
  const int32_t* ids;
  int32_t* out[kMaxCols];
  int64_t n, ninner, tok_cap;
  int32_t* max_len;
  int32_t* num_tokens;
  int64_t* tile_base;    // num_tiles: each tile's starts, then their exclusive prefix
  int num_docs, ncols, nchars, num_tiles, stage_rows;
  bool aligned;          // data is 16-byte aligned
};

__device__ __forceinline__ uint32_t is_space(uint32_t c) {
  return (c == 0x20u) | ((c - 0x09u) <= 4u);
}

__device__ __forceinline__ bool is_letter(uint32_t c) { return ((c | 0x20u) - 0x61u) < 26u; }

// The first index of inner[lo, hi) whose end is at or past x.
__device__ int64_t lower_bound(const int32_t* inner, int64_t lo, int64_t hi, int64_t x) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if ((int64_t)inner[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The tile's document starts as a bitmap; s_e gets the inner ends that
// lie in the tile, [s_e[0], s_e[1]).  The whole block calls it.
__device__ void tile_doc_starts(const Tok& t, int64_t lo, uint32_t* bits, int64_t* s_e) {
  for (int w = threadIdx.x; w < kTileWords; w += blockDim.x) bits[w] = 0;
  if (threadIdx.x < 2) s_e[threadIdx.x] = lower_bound(t.inner, 0, t.ninner,
                                                      lo + (int64_t)threadIdx.x * kTile);
  __syncthreads();
  for (int64_t i = s_e[0] + threadIdx.x; i < s_e[1]; i += blockDim.x) {
    const int64_t off = (int64_t)t.inner[i] - lo;
    atomicOr(&bits[off >> 5], 1u << (off & 31));
  }
  __syncthreads();
}

// Bit j: byte lo + 32 * threadIdx.x + j starts a token.
__device__ uint32_t thread_starts(const Tok& t, int64_t lo, const uint32_t* bits) {
  const int64_t base = lo + 32 * (int64_t)threadIdx.x;
  if (base >= t.n) return 0;
  uint32_t sp = 0;
  if (t.aligned && base + 32 <= t.n) {
    const uint4* v = reinterpret_cast<const uint4*>(t.data + base);
    const uint4 a = __ldg(v), b = __ldg(v + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 32; ++j) sp |= is_space((w[j >> 2] >> (8 * (j & 3))) & 0xffu) << j;
  } else {
    for (int j = 0; j < 32; ++j) {
      const uint32_t c = base + j < t.n ? __ldg(t.data + base + j) : 0x20u;
      sp |= is_space(c) << j;
    }
  }
  const uint32_t prev = base == 0 ? 1u : is_space(__ldg(t.data + base - 1));
  return ~sp & ((sp << 1) | prev | bits[threadIdx.x]);
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

// Words ahead of p until a 16-byte boundary, at most n.
__device__ __forceinline__ int head_words(const int32_t* p, int n) {
  const int h = (int)((4 - (((uintptr_t)p >> 2) & 3)) & 3);
  return h < n ? h : n;
}

// dst[r] = src[r] for r in [0, n), the block's threads together.
__device__ void store(int32_t* dst, int n, const int32_t* src) {
  const int head = head_words(dst, n);
  if ((int)threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
  const int nvec = (n - head) >> 2;
  int4* v = reinterpret_cast<int4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int r = head + 4 * i;
    v[i] = make_int4(src[r], src[r + 1], src[r + 2], src[r + 3]);
  }
  for (int r = head + 4 * nvec + threadIdx.x; r < n; r += blockDim.x) dst[r] = src[r];
}

__global__ void __launch_bounds__(kThreads) tokenize_count_kernel(const Tok t) {
  __shared__ uint32_t bits[kTileWords];
  __shared__ int64_t s_e[2];
  __shared__ int s_scan[kWarps + 1];
  const int64_t lo = (int64_t)blockIdx.x * kTile;
  tile_doc_starts(t, lo, bits, s_e);
  int total;
  block_exclusive_sum<kThreads>(__popc(thread_starts(t, lo, bits)), s_scan, &total);
  if (threadIdx.x == 0) t.tile_base[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads) tokenize_scan_kernel(const Tok t) {
  __shared__ long long s_scan[kScanThreads / 32 + 1];
  const int per = (t.num_tiles + kScanThreads - 1) / kScanThreads;
  const int lo = min((int)threadIdx.x * per, t.num_tiles);
  const int hi = min(lo + per, t.num_tiles);
  long long s = 0;
  for (int i = lo; i < hi; ++i) s += t.tile_base[i];
  long long all;
  long long run = block_exclusive_sum<kScanThreads>(s, s_scan, &all);
  for (int i = lo; i < hi; ++i) {
    const long long v = t.tile_base[i];
    t.tile_base[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) {
    *t.num_tokens = (int32_t)all;
    *t.max_len = 0;
  }
}

// One token starting at byte p into stage row `row`: its letter count.
// Inner ends [e0, e1) are the tile's; every end before e0 lies before p
// and every end from e1 on past it.
__device__ int emit_token(const Tok& t, int64_t p, int64_t e0, int64_t e1, int32_t* stage,
                          int row) {
  const int S = t.stage_rows;
  // slot: inner ends at or before p (ascending ends: an upper bound)
  int64_t a = e0, b = e1;
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if ((int64_t)t.inner[mid] <= p) a = mid + 1;
    else b = mid;
  }
  const int64_t slot = a;
  // the next document start after p ends the token
  int64_t stop = slot < t.ninner ? (int64_t)t.inner[slot] : t.n;
  if (stop > t.n) stop = t.n;
  for (int c = 0; c < t.ncols - 1; ++c) stage[c * S + row] = 0;
  int len = 0;
  uint32_t half = 0;
  for (int64_t q = p; q < stop; ++q) {
    const uint32_t c = __ldg(t.data + q);
    if (is_space(c)) break;
    if (!is_letter(c)) continue;
    if (len < t.nchars) {
      const int k = len % 6;
      half |= (c & 31u) << (25 - 5 * k);
      if (k == 5) {
        stage[(len / 6) * S + row] = (int32_t)half;
        half = 0;
      }
    }
    ++len;
  }
  const int packed = len < t.nchars ? len : t.nchars;
  if (packed % 6) stage[(packed / 6) * S + row] = (int32_t)half;
  int32_t doc = kPad;
  if (len == 0) {
    stage[row] = kPad;
    stage[S + row] = kPad;
  } else {
    doc = t.ids[slot < t.num_docs - 1 ? slot : t.num_docs - 1];
  }
  stage[(t.ncols - 1) * S + row] = doc;
  return len;
}

__global__ void __launch_bounds__(kThreads) tokenize_emit_kernel(const Tok t) {
  extern __shared__ int32_t stage[];  // ncols x stage_rows
  __shared__ uint32_t bits[kTileWords];
  __shared__ int64_t s_e[2];
  __shared__ int s_scan[kWarps + 1];
  const int64_t lo = (int64_t)blockIdx.x * kTile;
  tile_doc_starts(t, lo, bits, s_e);
  const uint32_t mask = thread_starts(t, lo, bits);
  int total;
  const int first = block_exclusive_sum<kThreads>(__popc(mask), s_scan, &total);
  const int64_t base = t.tile_base[blockIdx.x];
  const int64_t e0 = s_e[0], e1 = s_e[1];
  const int S = t.stage_rows;
  int longest = 0;
  for (int r0 = 0; r0 < total; r0 += S) {
    uint32_t m = mask;
    int k = first;
    for (; m && k < r0; ++k) m &= m - 1;
    for (; m && k < r0 + S && base + k < t.tok_cap; ++k) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int len = emit_token(t, lo + 32 * (int64_t)threadIdx.x + j, e0, e1, stage, k - r0);
      longest = len > longest ? len : longest;
    }
    __syncthreads();
    const int64_t at = base + r0;
    const int64_t room = t.tok_cap - at;
    const int rows = min(total - r0, S);
    const int w = room <= 0 ? 0 : (room < rows ? (int)room : rows);
    for (int c = 0; c < t.ncols; ++c) store(t.out[c] + at, w, stage + c * S);
    __syncthreads();
  }
  for (int off = 16; off > 0; off >>= 1)
    longest = max(longest, __shfl_down_sync(0xffffffffu, longest, off));
  if ((threadIdx.x & 31) == 0) s_scan[threadIdx.x >> 5] = longest;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int i = 0; i < kWarps; ++i) m = max(m, s_scan[i]);
    if (m > 0) atomicMax(t.max_len, m);
  }
}

// Padding into rows [num_tokens, tok_cap) of column blockIdx.y: INT32_MAX
// in group 0's halves and the doc, 0 in the other groups.
__global__ void __launch_bounds__(kThreads) tokenize_fill_kernel(const Tok t) {
  const int64_t count = *t.num_tokens;
  const int64_t s = count < 0 ? 0 : count;
  if (s >= t.tok_cap) return;
  const int c = blockIdx.y;
  const int32_t value = (c < 2 || c == t.ncols - 1) ? kPad : 0;
  int32_t* dst = t.out[c] + s;
  const int64_t n = t.tok_cap - s;
  const int head = head_words(dst, n < 4 ? (int)n : 4);
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;
  if (gtid < head) dst[gtid] = value;
  const int64_t nvec = (n - head) >> 2;
  int4* v = reinterpret_cast<int4*>(dst + head);
  const int4 fill = make_int4(value, value, value, value);
  for (int64_t i = gtid; i < nvec; i += gstride) v[i] = fill;
  for (int64_t r = head + 4 * nvec + gtid; r < n; r += gstride) dst[r] = value;
}

cudaError_t launch(const Tok& t, int device, cudaStream_t s) {
  if (t.num_tiles > 0) {
    tokenize_count_kernel<<<t.num_tiles, kThreads, 0, s>>>(t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  tokenize_scan_kernel<<<1, kScanThreads, 0, s>>>(t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || t.tok_cap == 0) return err;
  if (t.num_tiles > 0) {
    const int smem = t.ncols * t.stage_rows * (int)sizeof(int32_t);
    tokenize_emit_kernel<<<t.num_tiles, kThreads, smem, s>>>(t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long needed = (t.tok_cap / 4 + kThreads) / kThreads;
  const long long most = (long long)sms * 4;
  dim3 grid((unsigned)(needed < most ? needed : most), (unsigned)t.ncols);
  tokenize_fill_kernel<<<grid, kThreads, 0, s>>>(t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tokenize on `stream` (a cudaStream_t from the caller) on card `device`,
// which is current only for the call.  `data`: n bytes; `doc_ends`:
// `num_ends` ascending int32 ends; `doc_ids`: at least `num_docs` int32
// ids; `out_cols`: a host array of 2 * live_groups + 1 int32 device
// columns of `tok_cap` rows (the live groups' hi and lo halves, then the
// doc); `max_len`, `num_tokens`: int32 device scalars the call writes;
// `scratch`: `scratch_len` int64 device words, at least ceil(n / 8192).
// Returns the cudaError_t of the launches.
int mri_tokenize_window(const void* data, long long n, const void* doc_ends,
                        long long num_ends, const void* doc_ids, int num_docs, int width,
                        int live_groups, void* const* out_cols, long long tok_cap,
                        void* max_len, void* num_tokens, void* scratch, long long scratch_len,
                        int device, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (n < 0 || n > 0x7fffffffLL || num_ends < 0 || num_docs < 1 || width < 4 || width % 4 ||
      live_groups < 1 || 12 * (live_groups - 1) >= width || 2 * live_groups + 1 > kMaxCols ||
      tok_cap < 0 || tok_cap > 0x7fffffffLL || tiles > scratch_len)
    return (int)cudaErrorInvalidValue;
  Tok t = {};
  t.data = (const uint8_t*)data;
  t.inner = (const int32_t*)doc_ends;
  t.ids = (const int32_t*)doc_ids;
  t.ncols = 2 * live_groups + 1;
  for (int c = 0; c < t.ncols; ++c) t.out[c] = (int32_t*)out_cols[c];
  t.n = n;
  t.ninner = num_ends > 0 ? num_ends - 1 : 0;
  t.tok_cap = tok_cap;
  t.max_len = (int32_t*)max_len;
  t.num_tokens = (int32_t*)num_tokens;
  t.tile_base = (int64_t*)scratch;
  t.num_docs = num_docs;
  t.nchars = 12 * live_groups < width ? 12 * live_groups : width;
  t.num_tiles = (int)tiles;
  const int rows = kStageBytes / (t.ncols * (int)sizeof(int32_t));
  t.stage_rows = rows < kMaxStageRows ? rows : kMaxStageRows;
  t.aligned = ((uintptr_t)data & 15) == 0;
  int previous = 0;
  cudaError_t err = cudaGetDevice(&previous);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch(t, device, (cudaStream_t)stream);
  const cudaError_t restored = cudaSetDevice(previous);
  return (int)(err != cudaSuccess ? err : restored);
}

const char* mri_tokenize_window_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
