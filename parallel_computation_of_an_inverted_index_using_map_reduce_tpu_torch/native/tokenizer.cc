// Native host scan: the map phase's hot loop, one pass in C++, and the
// letter-file emit.
//
// What the reference mapper does per token — fscanf whitespace split,
// delete non-letters, lowercase, cap at 299 letters (main.c:102-117) —
// plus what its reducer re-derives later: the term dictionary and the
// per-(term, doc) dedup.  Output is the integer corpus the device engine
// consumes: sorted-vocab term ids + doc ids (one-shot), or packed
// provisional keys per document window (streaming), the packed sorted
// vocab, and first-letter ids.  The same source, scan for scan and byte
// for byte, as the JAX package's native/tokenizer.cc, cut to the entry
// points this package calls.
//
// Two frontends over one incremental core (`StreamState` + `ScanChunk`):
//
//   * one-shot `mri_tokenize` — whole corpus in, sorted-vocab ids out;
//   * streaming `mri_stream_*` — per-chunk feeds return packed
//     `prov_id * stride + doc_id` int32 keys immediately (provisional
//     ids are first-occurrence ids, stable once assigned), so the
//     caller can overlap host->device uploads with tokenizing the next
//     chunk; `mri_stream_finalize` then resolves the sorted vocab, the
//     prov->rank remap, and per-term document frequencies (the
//     combiner's counts) — everything the emit phase needs, with the
//     device program never depending on final vocab order.
//
// Beside them, `mri_token_stats` counts token starts and the longest
// cleaned token of a byte window: the all-device plan's host guard.
//
// The serve kernels `mri_serve_*` (the last section) are the host query
// engine's: block decode, the skip+gallop AND and the BM25 top-k over a
// v2/v2.1 `index.mri`'s mapped columns, the JAX package's copy.
//
// Map-phase host parallelism (the reference's N mapper threads over
// size-balanced contiguous file ranges, main.c:307-328, 348-365,
// re-expressed): every entry point takes a `num_threads`; documents are
// partitioned into contiguous byte-balanced ranges (the reference's
// greedy cut at total/N, made total and safe), each scanned by a worker
// with a *thread-local* vocab table and combiner, then merged
// sequentially at vocab scale — per-worker local ids upsert into the
// global table once per unique word, never per token.  Because the doc
// ranges are contiguous and workers are merged in range order, the
// emitted (term, doc) pair sequence is byte-for-byte the same as the
// single-threaded scan for rank-space outputs, and postings stay
// doc-ascending per term for free.  No locks anywhere: workers share
// nothing until the join, the same fork-join shape as the reference's
// map phase but without its serializing spill-file stdio locks
// (main.c:116).
//
// Hot-loop design: 256-entry byte tables (whitespace / lowercase-letter)
// instead of range compares; words hashed in 8-byte blocks AFTER the
// cleaning pass (a per-byte multiply chain serializes at ~4 cycles per
// byte — block hashing cuts the dependency chain 8x); open-addressing
// hash table whose entries carry the word's first 8 cleaned bytes
// inline, so the common case (words <= 8 letters, most English tokens)
// resolves a probe with one in-register compare and never touches the
// arena's cache lines; arena words are zero-padded to 8-byte boundaries
// so longer words compare and rehash block-wise; final std::sort over
// unique words only (vocab-scale, not token-scale).
//
// Build (native/__init__.py does this at first use):
//   g++ -O3 -ffp-contract=off -shared -fPIC -o libmri_torch_scan.so tokenizer.cc

#include <algorithm>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <exception>
#include <functional>
#include <new>
#include <system_error>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

constexpr int kMaxWordLetters = 299;  // reference MAX_WORD - 1 (main.c:7,105)
constexpr uint64_t kFnvBasis = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

struct Entry {
  uint64_t prefix;  // first 8 cleaned bytes, zero-padded (canonical)
  uint32_t offset;  // into arena (8-byte aligned)
  uint32_t len;
  int32_t id;       // provisional (first-occurrence) id; -1 = empty slot
};

inline uint64_t Load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

struct ByteTables {
  bool space[256];
  uint8_t lower[256];  // lowercase letter, or 0 = delete this byte
  ByteTables() {
    std::memset(space, 0, sizeof(space));
    std::memset(lower, 0, sizeof(lower));
    // C-locale isspace set, what fscanf %s splits on (main.c:102).
    for (uint8_t b : {' ', '\t', '\n', '\v', '\f', '\r'}) space[b] = true;
    for (int b = 'a'; b <= 'z'; ++b) lower[b] = static_cast<uint8_t>(b);
    for (int b = 'A'; b <= 'Z'; ++b) lower[b] = static_cast<uint8_t>(b + 32);
  }
};
const ByteTables kTab;

// Block FNV over a zero-padded word (callers guarantee the bytes from
// `len` up to the next 8-byte boundary are zero, making padded loads
// canonical) with a murmur-style finalizer — the low bits index the
// table, so they need the avalanche a plain FNV fold lacks.
inline uint64_t HashWord(const uint8_t* p, uint32_t len) {
  uint64_t h = kFnvBasis;
  for (uint32_t i = 0; i < len; i += 8) h = (h ^ Load64(p + i)) * kFnvPrime;
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdull;
  h ^= h >> 33;
  return h;
}

// Block equality for zero-padded words of the same length.
inline bool WordsEqual(const uint8_t* a, const uint8_t* b, uint32_t len) {
  for (uint32_t i = 0; i < len; i += 8)
    if (Load64(a + i) != Load64(b + i)) return false;
  return true;
}

// ---------------------------------------------------------------------------
// SIMD scan support (x86-64 AVX2+BMI2; scalar fallback elsewhere).
//
// The scalar clean loop pays ~10 cycles per corpus byte in branchy
// per-byte work.  Instead: one vector pass builds per-64-byte-group
// space/letter bitmasks, then tokens are walked by bit scanning and
// cleaned 8 raw bytes at a time with a pext byte-compaction (the
// letter-mask bytes select which lowered bytes survive).  Short tokens
// (<= 8 raw bytes — most of real text) first probe a direct-mapped
// raw-bytes -> prov-id cache: raw-equal implies cleaned-equal (cleaning
// deletes NUL bytes, so masked-load equality is sufficient), which
// skips clean+hash+table entirely for hot words.
// ---------------------------------------------------------------------------

#if defined(__x86_64__)

struct MaskSpan {
  std::vector<uint64_t> S;  // space bits (beyond data: 1)
  std::vector<uint64_t> L;  // letter bits
  std::vector<uint64_t> T;  // non-space bits (beyond data: 0)
  size_t base = 0;          // absolute group index of word 0
};

struct LenMasks {
  uint64_t bytes[9];  // low 8*n bits set
  LenMasks() {
    bytes[8] = ~0ull;
    for (int i = 0; i < 8; ++i) bytes[i] = (1ull << (8 * i)) - 1;
  }
};
const LenMasks kLen;

// bit j set -> byte j = 0xFF (the pext byte-selection mask)
struct ByteMaskLut {
  uint64_t m[256];
  ByteMaskLut() {
    for (int mask = 0; mask < 256; ++mask) {
      uint64_t v = 0;
      for (int j = 0; j < 8; ++j)
        if (mask & (1 << j)) v |= 0xFFull << (8 * j);
      m[mask] = v;
    }
  }
};
const ByteMaskLut kByteMask;

__attribute__((target("avx2")))
void BuildMasks(const uint8_t* data, int64_t data_len, int64_t lo, int64_t hi,
                MaskSpan& m) {
  const size_t g0 = static_cast<size_t>(lo) >> 6;
  const size_t g1 = (static_cast<size_t>(hi) + 63) >> 6;  // exclusive
  m.base = g0;
  m.S.assign(g1 - g0 + 2, ~0ull);
  m.L.assign(g1 - g0 + 2, 0);
  m.T.assign(g1 - g0 + 2, 0);
  const __m256i v9 = _mm256_set1_epi8(9), v4 = _mm256_set1_epi8(4),
      vsp = _mm256_set1_epi8(' '), v20 = _mm256_set1_epi8(0x20),
      va = _mm256_set1_epi8('a'), v25 = _mm256_set1_epi8(25);
  for (size_t g = g0; g < g1; ++g) {
    const int64_t p = static_cast<int64_t>(g) << 6;
    uint64_t sm, lm;
    if (p + 64 <= data_len) {
      sm = lm = 0;
      for (int half = 0; half < 2; ++half) {
        __m256i v = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(data + p + 32 * half));
        __m256i u = _mm256_sub_epi8(v, v9);
        __m256i ctl = _mm256_cmpeq_epi8(_mm256_min_epu8(u, v4), u);  // \t..\r
        __m256i spc = _mm256_or_si256(ctl, _mm256_cmpeq_epi8(v, vsp));
        __m256i lo8 = _mm256_or_si256(v, v20);
        __m256i d = _mm256_sub_epi8(lo8, va);
        __m256i let = _mm256_cmpeq_epi8(_mm256_min_epu8(d, v25), d);
        sm |= static_cast<uint64_t>(
                  static_cast<uint32_t>(_mm256_movemask_epi8(spc)))
              << (32 * half);
        lm |= static_cast<uint64_t>(
                  static_cast<uint32_t>(_mm256_movemask_epi8(let)))
              << (32 * half);
      }
    } else {  // buffer-tail group, scalar (bytes beyond data read as space)
      sm = ~0ull;
      lm = 0;
      for (int64_t j = p; j < data_len; ++j) {
        const uint64_t b = 1ull << (j - p);
        if (!kTab.space[data[j]]) sm &= ~b;
        if (kTab.lower[data[j]]) lm |= b;
      }
    }
    m.S[g - g0] = sm;
    m.L[g - g0] = lm;
    m.T[g - g0] = ~sm;
  }
  // +2 guard words: S stays all-ones (space), T/L all-zero — walks and
  // ExtractBits never read uninitialized memory.
  m.T[g1 - g0] = m.T[g1 - g0 + 1] = 0;
  m.L[g1 - g0] = m.L[g1 - g0 + 1] = 0;
}

// >= 8 mask bits starting at absolute byte position a (low bits).
inline uint64_t ExtractBits(const std::vector<uint64_t>& M, size_t base,
                            int64_t a) {
  const size_t w = (static_cast<size_t>(a) >> 6) - base;
  const unsigned o = static_cast<unsigned>(a) & 63;
  uint64_t x = M[w] >> o;
  if (o) x |= M[w + 1] << (64 - o);
  return x;
}

// First set bit >= pos, capped at end.
inline int64_t NextSet(const std::vector<uint64_t>& M, size_t base,
                       int64_t pos, int64_t end) {
  size_t w = (static_cast<size_t>(pos) >> 6) - base;
  uint64_t x = M[w] >> (pos & 63);
  if (x) {
    const int64_t r = pos + __builtin_ctzll(x);
    return r < end ? r : end;
  }
  const size_t wend = ((static_cast<size_t>(end) + 63) >> 6) - base;
  for (++w; w <= wend; ++w) {
    if (M[w]) {
      const int64_t r =
          (static_cast<int64_t>(w + base) << 6) + __builtin_ctzll(M[w]);
      return r < end ? r : end;
    }
  }
  return end;
}

#endif  // __x86_64__

struct CacheEntry {
  uint64_t tag;
  int32_t id;  // -1 = empty
};
// Second-level cache for 9..16-raw-byte tokens (the chunked-pext slow
// path costs ~3x the short path and covers ~a quarter of real English
// tokens — measured 33 vs 17 ns/token on the reference corpus with
// long-word mixes): 128-bit raw tag, same stream-stable-id guarantee.
struct CacheEntry16 {
  uint64_t tag0, tag1;
  int32_t id;  // -1 = empty
};
constexpr int kRawCacheBits = 13;

// Incremental tokenizer state: one per scanning thread (or the single
// global one when num_threads == 1).  Provisional ids are assigned at
// first occurrence and never change; the combiner (per-(term, doc)
// dedup, the reference reducer's dedup at main.c:176-184 pulled into
// the map phase) and the per-term document-frequency counts live here
// so nothing token-scale survives past a chunk.
struct StreamState {
  std::vector<uint8_t> arena;
  std::vector<Entry> table;
  uint64_t mask;
  int32_t next_id = 0;
  std::vector<uint32_t> word_offsets;  // prov id -> arena offset
  std::vector<uint32_t> word_lens;
  // Combiner state, interleaved so the per-token dedup touches ONE
  // cache line: last_doc = global doc ordinal last seen; df = docs
  // containing the term (meaningful only when scanned with dedup=true).
  struct TermState { int32_t last_doc; int32_t df; };
  std::vector<TermState> combiner;
  int64_t raw_tokens = 0;
  int64_t num_pairs = 0;
  int32_t doc_ordinal = 0;  // global across chunks
  // Direct-mapped raw-bytes -> prov-id caches for the SIMD scan
  // (lazily sized; ids are stream-stable so they never invalidate):
  // <= 8 raw bytes, and 9..16 raw bytes with a 128-bit tag.
  std::vector<CacheEntry> raw_cache;
  std::vector<CacheEntry16> raw_cache16;

  StreamState() : table(1 << 16), mask(table.size() - 1) {
    for (auto& e : table) e.id = -1;
    arena.reserve(1 << 20);
  }

  void Grow() {
    std::vector<Entry> bigger(table.size() * 2);
    for (auto& e : bigger) e.id = -1;
    const uint64_t bmask = bigger.size() - 1;
    for (const Entry& e : table) {
      if (e.id < 0) continue;
      uint64_t s = HashWord(arena.data() + e.offset, e.len) & bmask;
      while (bigger[s].id >= 0) s = (s + 1) & bmask;
      bigger[s] = e;
    }
    table.swap(bigger);
    mask = bmask;
  }

  // Upsert a cleaned word (hash h precomputed; `word` zero-padded to the
  // next 8-byte boundary); returns its prov id.
  int32_t Upsert(const uint8_t* word, int32_t wlen, uint64_t h) {
    const uint64_t prefix = Load64(word);
    uint64_t slot = h & mask;
    for (;;) {
      Entry& e = table[slot];
      if (e.id < 0) {
        const uint32_t off = static_cast<uint32_t>(arena.size());
        arena.insert(arena.end(), word, word + wlen);
        arena.resize((arena.size() + 7) & ~size_t{7}, 0);  // canonical pad
        e.prefix = prefix;
        e.offset = off;
        e.len = wlen;
        e.id = next_id;
        word_offsets.push_back(off);
        word_lens.push_back(wlen);
        combiner.push_back(TermState{-1, 0});
        const int32_t id = next_id++;
        if (static_cast<uint64_t>(next_id) * 10 > table.size() * 7) Grow();
        return id;
      }
      if (e.prefix == prefix && e.len == static_cast<uint32_t>(wlen) &&
          (wlen <= 8 ||
           WordsEqual(arena.data() + e.offset + 8, word + 8, wlen - 8)))
        return e.id;
      slot = (slot + 1) & mask;
    }
  }
};

// Scan a contiguous run of documents; emit (prov_id, doc_id) pairs
// through `emit` — combiner-deduped when `dedup`; repeat occurrences of
// an already-emitted (term, doc) pair go through `emit_dup` instead, so
// a caller can count within-document term frequencies without widening
// the combiner's one-cache-line TermState.  `data` is the whole
// window's concatenated bytes (`data_len` total — loads never read past
// it); this call scans docs `[doc_lo, doc_hi)` whose bytes span
// `[start_pos, doc_ends[doc_hi-1])`.
template <typename Emit, typename EmitDup>
void ScanChunkScalar(StreamState& st, const uint8_t* data, int64_t start_pos,
                     const int64_t* doc_ends, const int32_t* doc_id_values,
                     int32_t doc_lo, int32_t doc_hi, bool dedup, Emit&& emit,
                     EmitDup&& emit_dup) {
  uint8_t word[kMaxWordLetters + 8];  // +8: zero pad for block loads
  int64_t pos = start_pos;
  for (int32_t d = doc_lo; d < doc_hi; ++d, ++st.doc_ordinal) {
    const int64_t end = doc_ends[d];
    const int32_t doc_id = doc_id_values[d];
    const int32_t ordinal = st.doc_ordinal;
    while (pos < end) {
      while (pos < end && kTab.space[data[pos]]) ++pos;  // skip whitespace
      if (pos >= end) break;
      int wlen = 0;
      do {  // clean token: letters only, lowercase, cap at 299
        const uint8_t c = kTab.lower[data[pos]];
        if (c && wlen < kMaxWordLetters) word[wlen++] = c;
      } while (++pos < end && !kTab.space[data[pos]]);
      if (wlen == 0) continue;  // token cleaned to nothing (main.c:113)
      std::memset(word + wlen, 0, 8);  // canonical zero pad for Load64

      const int32_t id = st.Upsert(word, wlen, HashWord(word, wlen));
      ++st.raw_tokens;
      if (dedup) {
        StreamState::TermState& ts = st.combiner[id];
        if (ts.last_doc == ordinal) {  // (term, doc) already out
          emit_dup(id);
          continue;
        }
        ts.last_doc = ordinal;
        ++ts.df;
      }
      ++st.num_pairs;
      emit(id, doc_id);
    }
    pos = end;
  }
}

#if defined(__x86_64__)

// Chunked pext clean of one token's raw bytes [a, b) into `word`
// (zero-padded to the next 8 bytes); returns the cleaned length.  The
// general path for tokens the fixed-width caches cannot tag.
__attribute__((target("avx2,bmi2")))
static inline int CleanTokenChunked(const MaskSpan& m, const uint8_t* data,
                                    int64_t data_len, int64_t a, int64_t b,
                                    uint8_t* word) {
  constexpr uint64_t kLow8 = 0x2020202020202020ull;
  int wlen = 0;
  for (int64_t i = a; i < b; i += 8) {
    const int64_t take = (b - i < 8) ? b - i : 8;
    uint64_t raw;
    if (i + 8 <= data_len) {
      raw = Load64(data + i);
    } else {
      raw = 0;
      std::memcpy(&raw, data + i, static_cast<size_t>(data_len - i));
    }
    raw &= kLen.bytes[take];
    const uint64_t bits = ExtractBits(m.L, m.base, i) &
                          ((take == 8) ? 0xFFull
                                       : ((1ull << take) - 1)) & 0xFF;
    const uint64_t chunk = _pext_u64(raw | kLow8, kByteMask.m[bits]);
    std::memcpy(word + wlen, &chunk, 8);  // buffer is 299 + 8
    const int add = __builtin_popcountll(bits);
    wlen = (wlen + add > kMaxWordLetters) ? kMaxWordLetters : wlen + add;
  }
  if (wlen) std::memset(word + wlen, 0, 8);
  return wlen;
}

// Mask-driven scan: identical observable behavior to ScanChunkScalar
// (fuzz-tested against it via the oracle conformance suite), ~2x faster
// on real text.
template <typename Emit, typename EmitDup>
__attribute__((target("avx2,bmi2")))
void ScanChunkSimd(StreamState& st, const uint8_t* data, int64_t data_len,
                   int64_t start_pos, const int64_t* doc_ends,
                   const int32_t* doc_id_values, int32_t doc_lo,
                   int32_t doc_hi, bool dedup, Emit&& emit,
                   EmitDup&& emit_dup) {
  const int64_t span_end = doc_ends[doc_hi - 1];
  MaskSpan m;
  BuildMasks(data, data_len, start_pos, span_end, m);
  if (st.raw_cache.empty()) {
    st.raw_cache.assign(size_t{1} << kRawCacheBits, CacheEntry{0, -1});
    st.raw_cache16.assign(size_t{1} << kRawCacheBits,
                          CacheEntry16{0, 0, -1});
  }
  CacheEntry* cache = st.raw_cache.data();
  CacheEntry16* cache16 = st.raw_cache16.data();
  constexpr uint64_t kLow8 = 0x2020202020202020ull;
  uint8_t word[kMaxWordLetters + 8];
  int64_t pos = start_pos;
  for (int32_t d = doc_lo; d < doc_hi; ++d, ++st.doc_ordinal) {
    const int64_t end = doc_ends[d];
    const int32_t doc_id = doc_id_values[d];
    const int32_t ordinal = st.doc_ordinal;
    while (pos < end) {
      const int64_t a = NextSet(m.T, m.base, pos, end);
      if (a >= end) break;
      const int64_t b = NextSet(m.S, m.base, a, end);
      pos = b;
      const int64_t len_raw = b - a;
      int32_t id;
      if (len_raw <= 8 && a + 8 <= data_len) {
        const uint64_t raw = Load64(data + a) & kLen.bytes[len_raw];
        CacheEntry& ce =
            cache[(raw * 0x9E3779B97F4A7C15ull) >> (64 - kRawCacheBits)];
        if (ce.id >= 0 && ce.tag == raw) {
          id = ce.id;
        } else {
          const uint64_t bits =
              ExtractBits(m.L, m.base, a) & ((1ull << len_raw) - 1) & 0xFF;
          if (bits == 0) continue;  // cleaned to nothing (main.c:113)
          const uint64_t cleaned = _pext_u64(raw | kLow8, kByteMask.m[bits]);
          const int32_t wlen = __builtin_popcountll(bits);
          uint64_t wbuf[2] = {cleaned, 0};
          id = st.Upsert(reinterpret_cast<const uint8_t*>(wbuf), wlen,
                         HashWord(reinterpret_cast<const uint8_t*>(wbuf),
                                  static_cast<uint32_t>(wlen)));
          ce.tag = raw;
          ce.id = id;
        }
      } else if (len_raw <= 16 && a + 16 <= data_len) {
        // medium tokens: 128-bit raw tag over the same direct-mapped
        // discipline as the short cache
        const uint64_t raw0 = Load64(data + a);
        const uint64_t raw1 = Load64(data + a + 8) & kLen.bytes[len_raw - 8];
        CacheEntry16& ce =
            cache16[((raw0 ^ (raw1 * 0x9E3779B97F4A7C15ull)) *
                     0xC2B2AE3D27D4EB4Full) >> (64 - kRawCacheBits)];
        if (ce.id >= 0 && ce.tag0 == raw0 && ce.tag1 == raw1) {
          id = ce.id;
        } else {
          const int wlen =
              CleanTokenChunked(m, data, data_len, a, b, word);
          if (wlen == 0) continue;  // cleaned to nothing (main.c:113)
          id = st.Upsert(word, wlen, HashWord(word, wlen));
          ce.tag0 = raw0;
          ce.tag1 = raw1;
          ce.id = id;
        }
      } else {  // long or buffer-tail token: chunked pext, uncached
        const int wlen = CleanTokenChunked(m, data, data_len, a, b, word);
        if (wlen == 0) continue;
        id = st.Upsert(word, wlen, HashWord(word, wlen));
      }
      ++st.raw_tokens;
      if (dedup) {
        StreamState::TermState& ts = st.combiner[id];
        if (ts.last_doc == ordinal) {
          emit_dup(id);
          continue;
        }
        ts.last_doc = ordinal;
        ++ts.df;
      }
      ++st.num_pairs;
      emit(id, doc_id);
    }
    pos = end;
  }
}

const bool kHaveSimdScan =
    __builtin_cpu_supports("avx2") && __builtin_cpu_supports("bmi2");

#endif  // __x86_64__

template <typename Emit, typename EmitDup>
void ScanChunk(StreamState& st, const uint8_t* data, int64_t data_len,
               int64_t start_pos, const int64_t* doc_ends,
               const int32_t* doc_id_values, int32_t doc_lo, int32_t doc_hi,
               bool dedup, Emit&& emit, EmitDup&& emit_dup) {
  if (doc_lo >= doc_hi) return;
#if defined(__x86_64__)
  if (kHaveSimdScan) {
    ScanChunkSimd(st, data, data_len, start_pos, doc_ends, doc_id_values,
                  doc_lo, doc_hi, dedup, emit, emit_dup);
    return;
  }
#endif
  (void)data_len;
  ScanChunkScalar(st, data, start_pos, doc_ends, doc_id_values, doc_lo,
                  doc_hi, dedup, emit, emit_dup);
}

// Callers that only need first (term, doc) occurrences drop duplicate
// tokens on the floor.
template <typename Emit>
void ScanChunk(StreamState& st, const uint8_t* data, int64_t data_len,
               int64_t start_pos, const int64_t* doc_ends,
               const int32_t* doc_id_values, int32_t doc_lo, int32_t doc_hi,
               bool dedup, Emit&& emit) {
  ScanChunk(st, data, data_len, start_pos, doc_ends, doc_id_values, doc_lo,
            doc_hi, dedup, emit, [](int32_t) {});
}

// Sorted-vocab order of provisional ids (== strcmp order: letters only).
// Big-endian u64 prefix keys resolve almost every comparison with one
// integer compare (arena words are zero-padded, and 0x00 < any letter,
// so shorter-prefix words sort first automatically); only words sharing
// a full 8-byte prefix fall through to the block loop.
std::vector<int32_t> SortedOrder(const StreamState& st) {
  const uint8_t* base = st.arena.data();
  std::vector<std::pair<uint64_t, int32_t>> keyed(st.next_id);
  for (int32_t i = 0; i < st.next_id; ++i)
    keyed[i] = {__builtin_bswap64(Load64(base + st.word_offsets[i])), i};
  std::sort(keyed.begin(), keyed.end(),
            [&](const std::pair<uint64_t, int32_t>& a,
                const std::pair<uint64_t, int32_t>& b) {
              if (a.first != b.first) return a.first < b.first;
              const int32_t ia = a.second, ib = b.second;
              const uint8_t* pa = base + st.word_offsets[ia];
              const uint8_t* pb = base + st.word_offsets[ib];
              const uint32_t pla = (st.word_lens[ia] + 7) & ~7u;
              const uint32_t plb = (st.word_lens[ib] + 7) & ~7u;
              const uint32_t lim = pla > plb ? pla : plb;
              for (uint32_t i = 8; i < lim; i += 8) {
                const uint64_t ka =
                    i < pla ? __builtin_bswap64(Load64(pa + i)) : 0;
                const uint64_t kb =
                    i < plb ? __builtin_bswap64(Load64(pb + i)) : 0;
                if (ka != kb) return ka < kb;
              }
              return false;  // identical words cannot occur (unique vocab)
            });
  std::vector<int32_t> order(st.next_id);
  for (int32_t i = 0; i < st.next_id; ++i) order[i] = keyed[i].second;
  return order;
}

// ---------------------------------------------------------------------------
// Fork-join map phase: contiguous byte-balanced doc ranges, one worker
// per range, merged in range order (the reference's scheduler,
// main.c:307-323, made total: every doc lands in exactly one range and
// num_threads > num_docs yields empty tail ranges, not UB).
// ---------------------------------------------------------------------------

struct Worker {
  StreamState local;              // thread-local vocab + combiner + df
  std::vector<int32_t> l2g;       // local prov id -> global prov id
  std::vector<int32_t> pair_lids; // current window's emissions
  std::vector<int32_t> pair_docs;
  int64_t raw_in_window = 0;
};

// Cut points: ranges[t] = first doc of worker t (ranges[T] = num_docs).
std::vector<int32_t> PlanRanges(const int64_t* doc_ends, int32_t num_docs,
                                int32_t num_threads) {
  std::vector<int32_t> cuts(num_threads + 1, num_docs);
  cuts[0] = 0;
  const int64_t total = num_docs ? doc_ends[num_docs - 1] : 0;
  int32_t d = 0;
  for (int32_t t = 1; t < num_threads; ++t) {
    const int64_t target = total * t / num_threads;
    while (d < num_docs && (d ? doc_ends[d - 1] : 0) < target) ++d;
    cuts[t] = d;
  }
  return cuts;
}

// Run `fn(t)` for t in [0, T) on T-1 spawned threads + the caller.
// Exceptions inside a worker (bad_alloc on arena/vector growth) are
// captured and rethrown after the join instead of std::terminate-ing
// the process; a failed thread spawn degrades to running that worker
// inline.  Keeps the extern "C" NULL/-2-on-OOM contract intact for
// every thread count.
template <typename Fn>
void ForkJoin(int32_t T, Fn&& fn) {
  if (T == 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> threads;
  std::vector<std::exception_ptr> errs(T);
  threads.reserve(T - 1);
  auto guarded = [&](int32_t t) {
    try {
      fn(t);
    } catch (...) {
      errs[t] = std::current_exception();
    }
  };
  for (int32_t t = 1; t < T; ++t) {
    try {
      threads.emplace_back(guarded, t);
    } catch (const std::system_error&) {
      guarded(t);  // cannot spawn: run this worker's range inline
    }
  }
  guarded(0);
  for (auto& th : threads) th.join();
  for (auto& e : errs)
    if (e) std::rethrow_exception(e);
}

// Scan one window with `workers.size()` threads; each worker appends
// this window's (local_id, doc) pairs to its pair vectors and tracks
// its raw-token delta.  Single-threaded (workers.size() == 1) runs
// inline — no thread spawn.
void ParallelScan(std::vector<Worker>& workers, const uint8_t* data,
                  int64_t data_len, const int64_t* doc_ends,
                  const int32_t* doc_id_values, int32_t num_docs, bool dedup) {
  const int32_t T = static_cast<int32_t>(workers.size());
  const std::vector<int32_t> cuts = PlanRanges(doc_ends, num_docs, T);
  ForkJoin(T, [&](int32_t t) {
    Worker& w = workers[t];
    const int64_t raw0 = w.local.raw_tokens;
    const int32_t lo = cuts[t], hi = cuts[t + 1];
    const int64_t start_pos = lo ? doc_ends[lo - 1] : 0;
    w.pair_lids.clear();
    w.pair_docs.clear();
    ScanChunk(w.local, data, data_len, start_pos, doc_ends, doc_id_values,
              lo, hi, dedup, [&](int32_t id, int32_t doc) {
                w.pair_lids.push_back(id);
                w.pair_docs.push_back(doc);
              });
    w.raw_in_window = w.local.raw_tokens - raw0;
  });
}

// Extend each worker's local->global map with the words it saw for the
// first time this window.  Vocab-scale, sequential, in range order —
// this is the only cross-thread step, the analogue of the reference's
// join barrier (main.c:367-369).
void MergeVocabs(StreamState& global, std::vector<Worker>& workers) {
  for (Worker& w : workers) {
    const uint8_t* base = w.local.arena.data();
    for (int32_t lid = static_cast<int32_t>(w.l2g.size());
         lid < w.local.next_id; ++lid) {
      const uint8_t* word = base + w.local.word_offsets[lid];
      const uint32_t len = w.local.word_lens[lid];
      // worker arenas are zero-padded, so block loads stay canonical
      w.l2g.push_back(global.Upsert(word, len, HashWord(word, len)));
    }
  }
}

// Single-threaded fast path: the lone worker's local state IS the
// global vocab — extend l2g with the identity instead of re-hashing
// every word into a second table.  Returns the vocab-authoritative
// state for any thread count.
StreamState& ResolveVocab(StreamState& global, std::vector<Worker>& workers) {
  if (workers.size() == 1) {
    Worker& w = workers[0];
    for (int32_t lid = static_cast<int32_t>(w.l2g.size());
         lid < w.local.next_id; ++lid)
      w.l2g.push_back(lid);
    return w.local;
  }
  MergeVocabs(global, workers);
  return global;
}

// Fold the workers' combiner df counts (local prov space) into a
// zeroed global-prov-space buffer.  Correct because each document is
// scanned by exactly one worker, so per-(term, doc) dedup is complete
// thread-locally.  THE one fold: finalize's GlobalDf and the
// mid-stream mri_stream_df_snapshot must agree bit for bit (the
// overlap plan diffs snapshots against finalize's totals).
void FoldWorkerDf(const std::vector<Worker>& workers, int32_t* out) {
  for (const Worker& w : workers)
    for (int32_t lid = 0; lid < w.local.next_id; ++lid)
      out[w.l2g[lid]] += w.local.combiner[lid].df;
}

std::vector<int32_t> GlobalDf(const StreamState& global,
                              const std::vector<Worker>& workers) {
  std::vector<int32_t> df(std::max(global.next_id, 1), 0);
  FoldWorkerDf(workers, df.data());
  return df;
}

}  // namespace

extern "C" {

struct TokenizeResult {
  int64_t num_tokens;   // emitted pairs (== raw tokens unless dedup_pairs)
  int64_t raw_tokens;   // tokens scanned before the combiner
  int32_t vocab_size;
  int32_t vocab_width;
  int32_t* term_ids;        // [num_tokens], sorted-vocab ids
  int32_t* doc_ids;         // [num_tokens]
  uint8_t* vocab_packed;    // [vocab_size * vocab_width], NUL padded, sorted
  int32_t* letter_of_term;  // [vocab_size]
};

// data: concatenated document bytes; doc_ends[i] = exclusive end offset of
// doc i; doc_id_values[i] = its (1-based) doc id.  dedup_pairs != 0
// enables the combiner (shrinks the device feed ~4x on real text).
// num_threads >= 1 scans byte-balanced contiguous doc ranges in
// parallel; output arrays are identical for every thread count (pairs
// stay in document order, term ids are sorted-vocab ranks).
// Returns NULL on OOM.
TokenizeResult* mri_tokenize(const uint8_t* data, int64_t len,
                             const int64_t* doc_ends,
                             const int32_t* doc_id_values, int32_t num_docs,
                             int32_t dedup_pairs, int32_t num_threads) try {
  StreamState global;
  std::vector<Worker> workers(std::max(num_threads, 1));
  ParallelScan(workers, data, len, doc_ends, doc_id_values, num_docs,
               dedup_pairs != 0);
  StreamState& vst = ResolveVocab(global, workers);

  const int32_t vocab = vst.next_id;
  const std::vector<int32_t> order = SortedOrder(vst);
  int32_t width = 1;
  for (int32_t i = 0; i < vocab; ++i)
    width = std::max(width, static_cast<int32_t>(vst.word_lens[i]));

  auto* res = static_cast<TokenizeResult*>(std::malloc(sizeof(TokenizeResult)));
  if (!res) return nullptr;
  int64_t n = 0, raw = 0;
  for (const Worker& w : workers) {
    n += static_cast<int64_t>(w.pair_lids.size());
    raw += w.local.raw_tokens;
  }
  res->num_tokens = n;
  res->raw_tokens = raw;
  res->vocab_size = vocab;
  res->vocab_width = width;
  res->term_ids = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<int64_t>(n, 1)));
  res->doc_ids = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<int64_t>(n, 1)));
  res->vocab_packed = static_cast<uint8_t*>(
      std::calloc(std::max<int64_t>(static_cast<int64_t>(vocab) * width, 1), 1));
  res->letter_of_term = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(vocab, 1)));
  if (!res->term_ids || !res->doc_ids || !res->vocab_packed || !res->letter_of_term) {
    std::free(res->term_ids); std::free(res->doc_ids);
    std::free(res->vocab_packed); std::free(res->letter_of_term); std::free(res);
    return nullptr;
  }

  // provisional id -> sorted id remap; pack vocab rows
  std::vector<int32_t> remap(vocab);
  for (int32_t rank = 0; rank < vocab; ++rank) {
    const int32_t prov = order[rank];
    remap[prov] = rank;
    std::memcpy(res->vocab_packed + static_cast<int64_t>(rank) * width,
                vst.arena.data() + vst.word_offsets[prov],
                vst.word_lens[prov]);
    res->letter_of_term[rank] = res->vocab_packed[static_cast<int64_t>(rank) * width] - 'a';
  }
  int64_t i = 0;
  for (const Worker& w : workers)
    for (size_t k = 0; k < w.pair_lids.size(); ++k, ++i) {
      res->term_ids[i] = remap[w.l2g[w.pair_lids[k]]];
      res->doc_ids[i] = w.pair_docs[k];
    }
  return res;
} catch (const std::bad_alloc&) {
  return nullptr;
}

void mri_free_result(TokenizeResult* r) {
  if (!r) return;
  std::free(r->term_ids);
  std::free(r->doc_ids);
  std::free(r->vocab_packed);
  std::free(r->letter_of_term);
  std::free(r);
}

// ---------------------------------------------------------------------------
// Streaming frontend: per-chunk packed provisional keys.
//
// The device engine's pipelined path (ops/engine.sort_prov_chunks)
// sorts `prov_id * stride + doc_id` keys — no final-vocab knowledge —
// so each chunk's keys can start their host->device DMA while the next
// chunk tokenizes.  stride = max_doc_id + 2 (doc ids < stride - 1 and
// INT32_MAX padding stays strictly above every valid key).
//
// With num_threads > 1 the prov ids are assigned at the per-window
// merge (vocab-scale) instead of per token, so the numbering can
// differ from the single-threaded scan — everything downstream is
// invariant to prov numbering (the device sorts keys; emit indirects
// through the prov->rank remap).
// ---------------------------------------------------------------------------

struct StreamChunkResult {
  int64_t num_pairs;   // -1 = packed key would overflow int32 (caller
                       // falls back to the one-shot engine path)
  int64_t raw_tokens;  // this chunk's raw token count
  int32_t* keys;       // [num_pairs] packed prov*stride + doc, combiner-deduped
};

struct StreamFinalResult {
  int32_t vocab_size;
  int32_t vocab_width;
  int64_t raw_tokens;       // whole stream
  int64_t num_pairs;        // whole stream (post-combiner)
  uint8_t* vocab_packed;    // [vocab_size * width], sorted, NUL padded
  int32_t* letter_of_term;  // [vocab_size], rank space
  int32_t* remap;           // [vocab_size], prov id -> sorted rank
  int32_t* df;              // [vocab_size], prov space (combiner counts)
  int32_t* emit_order;      // [vocab_size], ranks in emit order:
                            // (letter, -df, word) per main.c:55-64
};

struct StreamHandle {
  StreamState global;
  std::vector<Worker> workers;  // empty when single-threaded
  int64_t stride = 0;
  bool key_overflow = false;
};

// num_threads > 1: byte-balanced contiguous doc ranges per feed window.
void* mri_stream_new_mt(int64_t stride, int32_t num_threads) {
  auto* h = new (std::nothrow) StreamHandle();
  if (!h) return nullptr;
  h->stride = stride;
  if (num_threads > 1) {
    try {
      h->workers.resize(num_threads);
    } catch (const std::bad_alloc&) {
      delete h;
      return nullptr;
    }
  }
  return h;
}

void mri_stream_free(void* handle) {
  delete static_cast<StreamHandle*>(handle);
}

StreamChunkResult* mri_stream_feed(void* handle, const uint8_t* data,
                                   int64_t len, const int64_t* doc_ends,
                                   const int32_t* doc_id_values,
                                   int32_t num_docs) try {
  auto& h = *static_cast<StreamHandle*>(handle);
  auto* res =
      static_cast<StreamChunkResult*>(std::malloc(sizeof(StreamChunkResult)));
  if (!res) return nullptr;
  std::vector<int32_t> keys;
  const int64_t stride = h.stride;

  if (h.workers.empty()) {  // single-threaded: scan straight into global
    keys.reserve(len / 24 + 16);
    const int64_t raw_before = h.global.raw_tokens;
    ScanChunk(h.global, data, len, 0, doc_ends, doc_id_values, 0, num_docs,
              /*dedup=*/true, [&](int32_t id, int32_t doc) {
                const int64_t key = static_cast<int64_t>(id) * stride + doc;
                if (key >= INT32_MAX) {  // INT32_MAX itself is the pad value
                  h.key_overflow = true;
                  return;
                }
                keys.push_back(static_cast<int32_t>(key));
              });
    res->raw_tokens = h.global.raw_tokens - raw_before;
  } else {  // fork-join scan + vocab-scale merge, then vectorized remap
    ParallelScan(h.workers, data, len, doc_ends, doc_id_values, num_docs,
                 /*dedup=*/true);
    MergeVocabs(h.global, h.workers);
    int64_t n = 0, raw = 0;
    for (const Worker& w : h.workers) {
      n += static_cast<int64_t>(w.pair_lids.size());
      raw += w.raw_in_window;
    }
    res->raw_tokens = raw;
    keys.reserve(n);
    for (const Worker& w : h.workers)
      for (size_t k = 0; k < w.pair_lids.size(); ++k) {
        const int64_t key =
            static_cast<int64_t>(w.l2g[w.pair_lids[k]]) * stride +
            w.pair_docs[k];
        if (key >= INT32_MAX) {
          h.key_overflow = true;
          break;
        }
        keys.push_back(static_cast<int32_t>(key));
      }
  }

  if (h.key_overflow) {
    res->num_pairs = -1;
    res->keys = nullptr;
    return res;
  }
  res->num_pairs = static_cast<int64_t>(keys.size());
  res->keys = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * std::max<size_t>(keys.size(), 1)));
  if (!res->keys) {
    std::free(res);
    return nullptr;
  }
  std::memcpy(res->keys, keys.data(), sizeof(int32_t) * keys.size());
  return res;
} catch (const std::bad_alloc&) {
  return nullptr;
}

void mri_stream_chunk_free(StreamChunkResult* r) {
  if (!r) return;
  std::free(r->keys);
  std::free(r);
}

// Device-feed variant for the pipelined plan: returns the
// half-bandwidth ``[terms | docs]`` uint16 upload buffer directly
// (0xFFFF padding, each half ``padded`` long with ``padded`` the pair
// count rounded up to ``granule``) — no host-side divmod/pack pass.
// Falls back to packed int32 keys (``keys`` non-null, ``feed_u16``
// null) when a provisional id outgrows uint16; ``num_pairs`` = -1
// signals int32 key overflow (same contract as mri_stream_feed).
struct StreamChunkU16Result {
  int64_t num_pairs;
  int64_t raw_tokens;
  int64_t padded;       // half-length of feed_u16 (0 in keys mode)
  uint16_t* feed_u16;   // [2 * padded] or NULL
  int32_t* keys;        // [num_pairs] or NULL
};

StreamChunkU16Result* mri_stream_feed_u16(void* handle, const uint8_t* data,
                                          int64_t len,
                                          const int64_t* doc_ends,
                                          const int32_t* doc_id_values,
                                          int32_t num_docs,
                                          int64_t granule) try {
  auto& h = *static_cast<StreamHandle*>(handle);
  auto* res = static_cast<StreamChunkU16Result*>(
      std::malloc(sizeof(StreamChunkU16Result)));
  if (!res) return nullptr;
  res->feed_u16 = nullptr;
  res->keys = nullptr;
  res->padded = 0;
  const int64_t stride = h.stride;
  std::vector<int32_t> ids;
  std::vector<int32_t> docs;

  if (h.workers.empty()) {  // single-threaded: scan straight into global
    ids.reserve(len / 24 + 16);
    docs.reserve(len / 24 + 16);
    const int64_t raw_before = h.global.raw_tokens;
    ScanChunk(h.global, data, len, 0, doc_ends, doc_id_values, 0, num_docs,
              /*dedup=*/true, [&](int32_t id, int32_t doc) {
                ids.push_back(id);
                docs.push_back(doc);
              });
    res->raw_tokens = h.global.raw_tokens - raw_before;
  } else {  // fork-join scan + vocab-scale merge, then remap
    ParallelScan(h.workers, data, len, doc_ends, doc_id_values, num_docs,
                 /*dedup=*/true);
    MergeVocabs(h.global, h.workers);
    int64_t n = 0, raw = 0;
    for (const Worker& w : h.workers) {
      n += static_cast<int64_t>(w.pair_lids.size());
      raw += w.raw_in_window;
    }
    res->raw_tokens = raw;
    ids.reserve(n);
    docs.reserve(n);
    for (const Worker& w : h.workers)
      for (size_t k = 0; k < w.pair_lids.size(); ++k) {
        ids.push_back(w.l2g[w.pair_lids[k]]);
        docs.push_back(w.pair_docs[k]);
      }
  }

  const int64_t n = static_cast<int64_t>(ids.size());
  res->num_pairs = n;
  // prov ids are first-occurrence ranks, so the global high-water mark
  // bounds every id in this window.  u16 mode also requires the packed
  // key the DEVICE reconstructs (id * stride + doc, int32) to fit —
  // otherwise fall through to the int32 branch, whose per-key check
  // raises the KeyOverflow contract instead of wrapping on device.
  const bool fits_u16 =
      h.global.next_id <= 0xFFFF &&
      static_cast<int64_t>(h.global.next_id - 1) * stride + (stride - 1) <
          INT32_MAX;
  if (fits_u16) {
    const int64_t g = granule > 0 ? granule : 1;
    const int64_t padded = n ? ((n + g - 1) / g) * g : 0;
    res->padded = padded;
    if (padded) {
      res->feed_u16 = static_cast<uint16_t*>(
          std::malloc(sizeof(uint16_t) * 2 * padded));
      if (!res->feed_u16) {
        std::free(res);
        return nullptr;
      }
      for (int64_t k = 0; k < n; ++k) {
        res->feed_u16[k] = static_cast<uint16_t>(ids[k]);
        res->feed_u16[padded + k] = static_cast<uint16_t>(docs[k]);
      }
      for (int64_t k = n; k < padded; ++k)
        res->feed_u16[k] = res->feed_u16[padded + k] = 0xFFFF;
    }
    return res;
  }
  // prov ids beyond uint16: fall back to packed int32 keys
  res->keys = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * std::max<int64_t>(n, 1)));
  if (!res->keys) {
    std::free(res);
    return nullptr;
  }
  for (int64_t k = 0; k < n; ++k) {
    const int64_t key = static_cast<int64_t>(ids[k]) * stride + docs[k];
    if (key >= INT32_MAX) {
      h.key_overflow = true;
      res->num_pairs = -1;
      return res;
    }
    res->keys[k] = static_cast<int32_t>(key);
  }
  return res;
} catch (const std::bad_alloc&) {
  return nullptr;
}

void mri_stream_chunk_u16_free(StreamChunkU16Result* r) {
  if (!r) return;
  std::free(r->feed_u16);
  std::free(r->keys);
  std::free(r);
}

// Current document-frequency snapshot in GLOBAL provisional-id space
// (the combiner's deduped per-(term, doc) counts so far).  Lets the
// windowed overlap plan derive per-window per-term pair counts as
// vocab-scale snapshot diffs instead of token-scale bincounts.  In MT
// mode folds the workers' thread-local counts (each document is
// scanned by exactly one worker, so the fold is exact; l2g is extended
// every feed).  Returns the term count written, or -needed when the
// caller's buffer is too small (call again with >= needed slots).
int32_t mri_stream_df_snapshot(void* handle, int32_t* out, int32_t cap) {
  auto& h = *static_cast<StreamHandle*>(handle);
  const int32_t n = h.global.next_id;
  if (n > cap) return -n;
  std::memset(out, 0, static_cast<size_t>(n) * sizeof(int32_t));
  if (h.workers.empty()) {
    for (int32_t i = 0; i < n; ++i) out[i] = h.global.combiner[i].df;
  } else {
    FoldWorkerDf(h.workers, out);
  }
  return n;
}

void mri_stream_final_free(StreamFinalResult* r);

StreamFinalResult* mri_stream_finalize(void* handle) try {
  auto& h = *static_cast<StreamHandle*>(handle);
  StreamState& st = h.global;
  const int32_t vocab = st.next_id;
  const std::vector<int32_t> order = SortedOrder(st);
  int32_t width = 1;
  for (int32_t i = 0; i < vocab; ++i)
    width = std::max(width, static_cast<int32_t>(st.word_lens[i]));

  // Stream totals + prov-space df: from the global state when
  // single-threaded, folded from the workers otherwise.
  int64_t raw_tokens, num_pairs;
  std::vector<int32_t> df_mt;
  const int32_t* df_src;
  if (h.workers.empty()) {
    raw_tokens = st.raw_tokens;
    num_pairs = st.num_pairs;
    df_mt.resize(std::max(vocab, 1));
    for (int32_t i = 0; i < vocab; ++i) df_mt[i] = st.combiner[i].df;
    df_src = df_mt.data();
  } else {
    raw_tokens = num_pairs = 0;
    for (const Worker& w : h.workers) {
      raw_tokens += w.local.raw_tokens;
      num_pairs += w.local.num_pairs;
    }
    df_mt = GlobalDf(st, h.workers);
    df_src = df_mt.data();
  }

  auto* res =
      static_cast<StreamFinalResult*>(std::malloc(sizeof(StreamFinalResult)));
  if (!res) return nullptr;
  res->vocab_size = vocab;
  res->vocab_width = width;
  res->raw_tokens = raw_tokens;
  res->num_pairs = num_pairs;
  res->vocab_packed = static_cast<uint8_t*>(
      std::calloc(std::max<int64_t>(static_cast<int64_t>(vocab) * width, 1), 1));
  res->letter_of_term =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(vocab, 1)));
  res->remap =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(vocab, 1)));
  res->df =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(vocab, 1)));
  res->emit_order =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max(vocab, 1)));
  if (!res->vocab_packed || !res->letter_of_term || !res->remap || !res->df ||
      !res->emit_order) {
    std::free(res->vocab_packed); std::free(res->letter_of_term);
    std::free(res->remap); std::free(res->df); std::free(res->emit_order);
    std::free(res);
    return nullptr;
  }
  for (int32_t rank = 0; rank < vocab; ++rank) {
    const int32_t prov = order[rank];
    res->remap[prov] = rank;
    std::memcpy(res->vocab_packed + static_cast<int64_t>(rank) * width,
                st.arena.data() + st.word_offsets[prov], st.word_lens[prov]);
    res->letter_of_term[rank] =
        res->vocab_packed[static_cast<int64_t>(rank) * width] - 'a';
  }
  if (vocab) std::memcpy(res->df, df_src, sizeof(int32_t) * vocab);
  // Emit order (the reducer's per-letter by-df ordering, main.c:55-64):
  // ranks are word-sorted, so first letters are nondecreasing — one
  // stable by-df-descending sort per letter block, ties falling back
  // to rank ascending == word ascending.  Saves the emit path a
  // vocab-scale np.lexsort per run.  The vector and stable_sort can
  // throw bad_alloc AFTER res's arrays exist, so free them on the way
  // out instead of letting the function-level catch leak them.
  try {
    std::vector<int32_t> df_rank(std::max(vocab, 1));
    for (int32_t rank = 0; rank < vocab; ++rank)
      df_rank[rank] = df_src[order[rank]];
    for (int32_t rank = 0; rank < vocab; ++rank) res->emit_order[rank] = rank;
    int32_t b = 0;
    while (b < vocab) {
      const int32_t letter = res->letter_of_term[b];
      int32_t e = b;
      while (e < vocab && res->letter_of_term[e] == letter) ++e;
      std::stable_sort(res->emit_order + b, res->emit_order + e,
                       [&](int32_t a, int32_t c) {
                         return df_rank[a] > df_rank[c];
                       });
      b = e;
    }
  } catch (const std::bad_alloc&) {
    mri_stream_final_free(res);
    return nullptr;
  }
  return res;
} catch (const std::bad_alloc&) {
  return nullptr;
}

void mri_stream_final_free(StreamFinalResult* r) {
  if (!r) return;
  std::free(r->vocab_packed);
  std::free(r->letter_of_term);
  std::free(r->remap);
  std::free(r->df);
  std::free(r->emit_order);
  std::free(r);
}


// Host-exact (token_count, max_cleaned_len) over one byte window — the
// all-device engines' stats guard (ops/device_tokenizer.
// host_token_stats): token boundaries per the device classifier
// (whitespace set main.c:102-104, tokens never span documents), length
// = letters only (main.c:105-111).  Counts EVERY token start including
// letterless tokens ("42"): the count must equal the device program's
// token_start sum.  Returns 0, or -1 on bad args.
int32_t mri_token_stats(const uint8_t* data, int64_t len,
                        const int64_t* doc_ends, int32_t num_docs,
                        int64_t* count_out, int32_t* max_len_out) try {
  if (num_docs < 0 || len < 0) return -1;
  for (int32_t d = 0; d < num_docs; ++d) {  // honor the bad-args contract:
    // a regressing or negative end would double-scan / read out of bounds
    if (doc_ends[d] < 0 || (d && doc_ends[d] < doc_ends[d - 1])) return -1;
  }
  int64_t count = 0;
  int64_t max_len = 0;
  // Token breaks happen at INNER doc ends only; the scan runs to the
  // end of the buffer, exactly like the device classifier (doc_starts
  // uses doc_ends[:-1]) and the numpy mirror — bytes past the last
  // doc's end still tokenize (callers pad with spaces).
  const int32_t spans = std::max(num_docs, 1);
  auto span_end = [&](int32_t d) -> int64_t {
    return d >= num_docs - 1 ? len : std::min<int64_t>(doc_ends[d], len);
  };
#if defined(__x86_64__)
  if (kHaveSimdScan && len > 0) {
    MaskSpan m;
    BuildMasks(data, len, 0, len, m);
    int64_t pos = 0;
    for (int32_t d = 0; d < spans; ++d) {
      const int64_t end = span_end(d);
      while (pos < end) {
        const int64_t a = NextSet(m.T, m.base, pos, end);
        if (a >= end) break;
        const int64_t b = NextSet(m.S, m.base, a, end);
        pos = b;
        ++count;
        int64_t letters = 0;
        for (int64_t p = a; p < b; p += 64) {
          uint64_t bits = ExtractBits(m.L, m.base, p);
          const int64_t take = b - p;
          if (take < 64) bits &= (1ull << take) - 1;
          letters += __builtin_popcountll(bits);
        }
        max_len = std::max(max_len, letters);
      }
      pos = end;
    }
    *count_out = count;
    *max_len_out = static_cast<int32_t>(max_len);
    return 0;
  }
#endif
  int64_t pos = 0;
  for (int32_t d = 0; d < spans; ++d) {
    const int64_t end = span_end(d);
    bool in_tok = false;
    int64_t letters = 0;
    for (; pos < end; ++pos) {
      if (kTab.space[data[pos]]) {
        if (in_tok) max_len = std::max(max_len, letters);
        in_tok = false;
        letters = 0;
        continue;
      }
      if (!in_tok) {
        in_tok = true;
        letters = 0;
        ++count;
      }
      if (kTab.lower[data[pos]]) ++letters;
    }
    if (in_tok) max_len = std::max(max_len, letters);
    pos = end;
  }
  *count_out = count;
  *max_len_out = static_cast<int32_t>(max_len);
  return 0;
} catch (const std::bad_alloc&) {
  return -1;
}

// ---------------------------------------------------------------------------
// Native emit: render the 26 <letter>.txt postings files.
//
// Byte-identical to the reference's fprintf loop (main.c:227-234):
// "word:[id1 id2 ... idN]\n", ids space separated, no trailing space.
// Terms arrive pre-ordered (order[]); letters are contiguous in that
// order because term ids follow sorted-vocab order.
// ---------------------------------------------------------------------------

namespace {

// Two digits per division: doc-id formatting is the emit loop's hot
// op (~12 ns/id with a per-digit division chain, measured; ~half with
// the pair table).
struct DigitPairs {
  char d[200];
  DigitPairs() {
    for (int i = 0; i < 100; ++i) {
      d[2 * i] = static_cast<char>('0' + i / 10);
      d[2 * i + 1] = static_cast<char>('0' + i % 10);
    }
  }
};
const DigitPairs kD2;

inline char* PutU32(char* p, uint32_t v) {
  char tmp[10];
  char* e = tmp + 10;
  while (v >= 100) {
    const uint32_t r = v % 100;
    v /= 100;
    e -= 2;
    std::memcpy(e, kD2.d + 2 * r, 2);
  }
  if (v >= 10) {
    e -= 2;
    std::memcpy(e, kD2.d + 2 * v, 2);
  } else {
    *--e = static_cast<char>('0' + v);
  }
  const size_t n = static_cast<size_t>(tmp + 10 - e);
  std::memcpy(p, e, n);
  return p + n;
}

// One postings run: a flat doc-id array (uint16 or int32 — exactly one
// base non-null) with rank-space offsets/counts.  A term's full postings
// list is the concatenation of its segments across runs in run order
// (mri_emit passes one run).
struct EmitRun {
  const uint16_t* p16;
  const int32_t* p32;
  const int64_t* offsets;  // rank space
  const int64_t* counts;   // rank space
};

// Pre-rendered doc-id strings: ids repeat constantly across postings
// lists, and the per-digit division chain in PutU32 is the emit loop's
// hot op — one fixed 8-byte copy per posting halves it.  `s` holds the
// digits left-justified; `len` the digit count (<= 7 under kIdTableMax).
struct IdStr {
  char s[7];
  uint8_t len;
};
// Table ceiling: 1 << 17 entries = 1 MB, still cache/TLB-friendly;
// larger id spaces fall back to PutU32 per posting.
constexpr uint32_t kIdTableMax = 1u << 17;

// Largest doc id across every run segment (full pass — postings are
// ascending per term on every current caller, but a bounds-critical
// table must not trust that).  Returns kIdTableMax early when the ids
// outgrow the table.
uint32_t MaxDocId(const EmitRun* runs, int32_t n_runs, int32_t vocab_size) {
  uint32_t maxid = 0;
  for (int32_t r = 0; r < n_runs; ++r) {
    const EmitRun& run = runs[r];
    for (int32_t t = 0; t < vocab_size; ++t) {
      const int64_t start = run.offsets[t], n = run.counts[t];
      for (int64_t k = 0; k < n; ++k) {
        const uint32_t v = run.p16 ? run.p16[start + k]
                                   : static_cast<uint32_t>(run.p32[start + k]);
        if (v > maxid) {
          maxid = v;
          if (maxid >= kIdTableMax) return kIdTableMax;
        }
      }
    }
  }
  return maxid;
}

// Shared emit core: one letter-file set from rank-space order and
// `n_runs` postings runs, concatenated per term in run order.
//
// Writes are ATOMIC per letter file: each file is rendered fully in
// memory, written to `<letter>.txt.tmp`, then renamed over the final
// name — a crash mid-emit leaves earlier letters complete, the
// in-flight letter only as a `.tmp`, and never a truncated-but-
// plausible `<letter>.txt` (the reference's partial_<letter>.txt spill
// files have the same never-half-a-file property, main.c:332-341).
//
// `letter_lo`/`letter_hi` + the matching `idx_start`/`idx_end` order
// slice restrict the call to a contiguous letter range (the parallel
// reduce's per-reducer partition, main.c:129-130): only files
// `letter_lo..letter_hi-1` are written, and buffer sizing covers the
// slice, not the whole vocab, so M reducers never over-allocate M-fold.
// Defaults preserve the historical whole-alphabet behavior.
int64_t EmitLettersRuns(const uint8_t* vocab_packed, int32_t vocab_size,
                        int32_t width, const int64_t* order,
                        const EmitRun* runs, int32_t n_runs,
                        const char* out_dir,
                        const uint32_t* lens = nullptr,
                        int64_t maxid_hint = -1,
                        int32_t letter_lo = 0, int32_t letter_hi = 26,
                        int64_t idx_start = 0, int64_t idx_end = -1) {
  std::string dir(out_dir);
  if (!dir.empty() && dir.back() != '/') dir += '/';
  if (idx_end < 0) idx_end = vocab_size;
  if (letter_lo >= letter_hi) return 0;  // empty partition: no files owned
  // Vectorized id formatting: render each id once, copy 8 bytes per
  // posting.  The table pays for itself whenever postings outnumber
  // distinct ids (always, past trivial corpora).  Callers that track
  // the max doc id pass it as ``maxid_hint`` and skip the full pass.
  std::vector<IdStr> id_table;
  const uint32_t maxid =
      maxid_hint >= 0 ? static_cast<uint32_t>(std::min<int64_t>(
                            maxid_hint, kIdTableMax))
                      : MaxDocId(runs, n_runs, vocab_size);
  if (idx_end > idx_start && maxid < kIdTableMax) {
    id_table.resize(static_cast<size_t>(maxid) + 1);
    for (uint32_t v = 0; v <= maxid; ++v) {
      char* p = id_table[v].s;
      id_table[v].len = static_cast<uint8_t>(PutU32(p, v) - p);
    }
  }
  const IdStr* tab = id_table.empty() ? nullptr : id_table.data();
  // One upper-bound allocation for the render buffer: per-term resize
  // calls zero-fill their growth, which costs more than the formatting
  // itself.  Bound: word row + ":[]\n" per term, <= 11 bytes per
  // posting (space + 10 digits), + 8 bytes table-copy overhang slack.
  int64_t total_df = 0;
  for (int32_t r = 0; r < n_runs; ++r)
    for (int64_t i = idx_start; i < idx_end; ++i)
      total_df += runs[r].counts[order[i]];
  std::vector<char> buf(static_cast<size_t>(idx_end - idx_start) *
                            (width + 4) +
                        11ull * total_df + 8);
  int64_t total = 0;
  int64_t idx = idx_start;
  for (int letter = letter_lo; letter < letter_hi; ++letter) {
    char* p = buf.data();
    for (; idx < idx_end; ++idx) {
      const int64_t t = order[idx];
      const uint8_t* w = vocab_packed + static_cast<int64_t>(t) * width;
      if (w[0] - 'a' != letter) break;
      // word length: caller-supplied, or walk the NUL-padded row
      int wl;
      if (lens) {
        wl = static_cast<int>(lens[t]);
      } else {
        wl = 0;
        while (wl < width && w[wl]) ++wl;
      }
      std::memcpy(p, w, wl);
      // Branch-free separators: every posting renders as " id" starting
      // one byte past the ':' slot, then ':' and '[' are patched in —
      // the '[' lands exactly on the first posting's leading space.
      char* mark = p + wl;
      p = mark + 1;
      for (int32_t r = 0; r < n_runs; ++r) {
        const EmitRun& run = runs[r];
        const int64_t start = run.offsets[t], n = run.counts[t];
        if (tab) {
          for (int64_t k = 0; k < n; ++k) {
            *p++ = ' ';
            const uint32_t v = run.p16
                ? run.p16[start + k]
                : static_cast<uint32_t>(run.p32[start + k]);
            std::memcpy(p, tab[v].s, 8);  // IdStr is 8 bytes, len <= 7
            p += tab[v].len;
          }
        } else {
          for (int64_t k = 0; k < n; ++k) {
            *p++ = ' ';
            const uint32_t v = run.p16
                ? run.p16[start + k]
                : static_cast<uint32_t>(run.p32[start + k]);
            p = PutU32(p, v);
          }
        }
      }
      mark[0] = ':';
      mark[1] = '[';
      if (p == mark + 1) p = mark + 2;  // df == 0: keep the '[' written
      *p++ = ']';
      *p++ = '\n';
    }
    const size_t nbytes = p - buf.data();
    std::string path = dir;
    path += static_cast<char>('a' + letter);
    path += ".txt";
    const std::string tmp = path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) return -1;
    if (nbytes && std::fwrite(buf.data(), 1, nbytes, f) != nbytes) {
      std::fclose(f);
      std::remove(tmp.c_str());
      return -1;
    }
    if (std::fclose(f) != 0 || std::rename(tmp.c_str(), path.c_str()) != 0) {
      std::remove(tmp.c_str());
      return -1;
    }
    total += static_cast<int64_t>(nbytes);
    // Crash hook shared with text/formatter.py: after N complete
    // letters, die without unwinding so the durability test observes
    // exactly what a hard crash leaves on disk.
    if (const char* kill_after = std::getenv("MRI_EMIT_KILL_AFTER_LETTERS")) {
      if (letter + 1 == std::atoi(kill_after)) raise(SIGKILL);
    }
  }
  return total;
}

}  // namespace

// postings16/postings32: exactly one is non-null.  order/df/offsets are
// int64 (numpy's native index types).  letter_lo/letter_hi restrict
// emission to that letter range, with idx_start/idx_end the matching
// slice of `order` (full emit: 0/26/0/vocab_size) — the per-owner emit
// of the multi-host "letter" ownership mode and the parallel reduce.
// Returns total bytes written, or -1 on IO error.
int64_t mri_emit(const uint8_t* vocab_packed, int32_t vocab_size, int32_t width,
                 const int64_t* order, const int64_t* df, const int64_t* offsets,
                 const uint16_t* postings16, const int32_t* postings32,
                 const char* out_dir, int32_t letter_lo, int32_t letter_hi,
                 int64_t idx_start, int64_t idx_end) try {
  const EmitRun run{postings16, postings32, offsets, df};
  return EmitLettersRuns(vocab_packed, vocab_size, width, order, &run, 1,
                         out_dir, /*lens=*/nullptr, /*maxid_hint=*/-1,
                         letter_lo, letter_hi, idx_start, idx_end);
} catch (const std::bad_alloc&) {
  return -1;
}

// Multi-run emit for the windowed overlap plan: each term's postings are
// the concatenation of its `n_runs` segments in run order (uint16 doc
// ids; run k's segment for rank t is run_bases[k][run_offsets[k][t] ..
// + run_counts[k][t]]).  Returns total bytes written, or -1 on IO error.
int64_t mri_emit_runs(const uint8_t* vocab_packed, int32_t vocab_size,
                      int32_t width, const int64_t* order, int32_t n_runs,
                      const uint16_t* const* run_bases,
                      const int64_t* const* run_offsets,
                      const int64_t* const* run_counts,
                      const char* out_dir) try {
  std::vector<EmitRun> runs(std::max(n_runs, 1));
  for (int32_t r = 0; r < n_runs; ++r)
    runs[r] = EmitRun{run_bases[r], nullptr, run_offsets[r], run_counts[r]};
  return EmitLettersRuns(vocab_packed, vocab_size, width, order, runs.data(),
                         n_runs, out_dir);
} catch (const std::bad_alloc&) {
  return -1;
}

// =====================================================================
// Serve-path kernels (mri_serve_*): width-specialized block decode,
// skip+gallop intersect, and the BM25 exhaustive/BMW/MaxScore top-k.
//
// The numpy Engine stays the conformance oracle: every kernel here
// reproduces its answers byte-for-byte.  The float contract is the
// tight part — per-element BM25 contributions use the numpy scorer's
// exact expression and association order,
//     denom   = tf + k1 * ((1.0 - b) + (b * dl) / avgdl)
//     contrib = ((idf * tf) * (k1 + 1.0)) / denom
// and final scores are re-accumulated in query OCCURRENCE order (the
// exhaustive path's addition order).  idf is computed caller-side (in
// Python, with np.log) and passed in as float64 so a libm-vs-numpy ulp
// can never split the backends.  native/__init__.py builds with
// -ffp-contract=off, so the compiler never contracts the mul+adds above
// into FMAs (GCC does by default on targets that have FMA, aarch64
// among them) — contraction would break the byte-identity contract.
//
// Handles are NOT thread-safe; the engine serializes calls (the GIL),
// as it does the mri_stream_* handles.

}  // extern "C" (reopened after the templated serve helpers below)

namespace {

//: mirror of serve.planner.THETA_MARGIN — relative slack on every
//: theta comparison so float associativity never prunes a true top-k
//: doc (1.0 - 1e-9 in IEEE double, bit-identical to the Python value).
const double kServeThetaMargin = 1.0 - 1e-9;
//: largest k the ranked fast path selects on the stack (bounded
//: insertion); larger cutoffs fall back to nth_element over a heap
//: vector
const int32_t kServeStackK = 128;

// ---- width-specialized bitpacked decode -----------------------------
//
// Values are LSB-first in u32 words (BitPacker's layout): value j of a
// w-bit run occupies stream bits [j*w, (j+1)*w).  A value spans at
// most two words, so a branchless 64-bit two-word window + shift +
// mask recovers it.  The window unconditionally reads words[wi + 1];
// the caller guarantees one readable word past the run (in a mmapped
// artifact the next file section provides it — see
// serve.artifact.serve_columns).

template <int W>
void ServeUnpackW(const uint32_t* words, int n, uint32_t* out) {
  constexpr uint64_t mask = (1ull << W) - 1;
  int bp = 0;
  for (int j = 0; j < n; ++j, bp += W) {
    const int wi = bp >> 5;
    const uint64_t win = words[wi]
        | (static_cast<uint64_t>(words[wi + 1]) << 32);
    out[j] = static_cast<uint32_t>((win >> (bp & 31)) & mask);
  }
}

using ServeUnpackFn = void (*)(const uint32_t*, int, uint32_t*);

//: one specialization per width 1..31 (width 0 never unpacks; the
//: exporter's BitPacker caps widths at 31)
const ServeUnpackFn kServeUnpack[32] = {
    nullptr,           ServeUnpackW<1>,  ServeUnpackW<2>,
    ServeUnpackW<3>,   ServeUnpackW<4>,  ServeUnpackW<5>,
    ServeUnpackW<6>,   ServeUnpackW<7>,  ServeUnpackW<8>,
    ServeUnpackW<9>,   ServeUnpackW<10>, ServeUnpackW<11>,
    ServeUnpackW<12>,  ServeUnpackW<13>, ServeUnpackW<14>,
    ServeUnpackW<15>,  ServeUnpackW<16>, ServeUnpackW<17>,
    ServeUnpackW<18>,  ServeUnpackW<19>, ServeUnpackW<20>,
    ServeUnpackW<21>,  ServeUnpackW<22>, ServeUnpackW<23>,
    ServeUnpackW<24>,  ServeUnpackW<25>, ServeUnpackW<26>,
    ServeUnpackW<27>,  ServeUnpackW<28>, ServeUnpackW<29>,
    ServeUnpackW<30>,  ServeUnpackW<31>,
};

// ---- in-register delta prefix sum -----------------------------------
//
// ids[0] = first; ids[j + 1] = ids[j] + (vals[j] + 1) — the stored
// values are (delta - 1).  Integer adds are exact, so the SIMD and
// scalar forms agree bit-for-bit.

void ServePrefixIdsScalar(const uint32_t* vals, int m, int32_t first,
                          int32_t* out) {
  out[0] = first;
  int32_t run = first;
  for (int j = 0; j < m; ++j) {
    run += static_cast<int32_t>(vals[j]) + 1;
    out[j + 1] = run;
  }
}

#if defined(__x86_64__) || defined(_M_X64)
__attribute__((target("avx2")))
void ServePrefixIdsAvx2(const uint32_t* vals, int m, int32_t first,
                        int32_t* out) {
  out[0] = first;
  __m256i run = _mm256_set1_epi32(first);
  const __m256i one = _mm256_set1_epi32(1);
  const __m256i bcast7 = _mm256_set1_epi32(7);
  int j = 0;
  for (; j + 8 <= m; j += 8) {
    __m256i d = _mm256_add_epi32(
        _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(vals + j)), one);
    // in-lane inclusive scan (shift-and-add), then carry the low
    // lane's total into the high lane
    d = _mm256_add_epi32(d, _mm256_slli_si256(d, 4));
    d = _mm256_add_epi32(d, _mm256_slli_si256(d, 8));
    const __m256i tot = _mm256_shuffle_epi32(d, 0xff);
    d = _mm256_add_epi32(d, _mm256_permute2x128_si256(tot, tot, 0x08));
    d = _mm256_add_epi32(d, run);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + 1 + j), d);
    run = _mm256_permutevar8x32_epi32(d, bcast7);
  }
  int32_t r = (j == 0) ? first : out[j];
  for (; j < m; ++j) {
    r += static_cast<int32_t>(vals[j]) + 1;
    out[j + 1] = r;
  }
}

const bool kHaveServeAvx2 = __builtin_cpu_supports("avx2");
#endif

inline void ServePrefixIds(const uint32_t* vals, int m, int32_t first,
                           int32_t* out) {
#if defined(__x86_64__) || defined(_M_X64)
  if (kHaveServeAvx2 && m >= 8) {
    ServePrefixIdsAvx2(vals, m, first, out);
    return;
  }
#endif
  ServePrefixIdsScalar(vals, m, first, out);
}

// ---- serve handle ----------------------------------------------------

struct ServeTermEntry {
  std::vector<int32_t> docs;        // ascending absolute doc ids
  std::vector<double> contrib;      // per-doc BM25 contribution
  std::vector<double> sorted_desc;  // contrib sorted descending
  double idf = 0.0;
};

//: one frozen ranked query (mri_serve_topk_prep): the occ/idf argument
//: arrays copied into the handle so the per-call entry point takes only
//: scalar arguments
struct ServePrep {
  std::vector<int32_t> occ;
  std::vector<double> idf;
};

struct ServeState {
  // borrowed artifact columns — the Python wrapper keeps the backing
  // buffers (mmap views + derived arrays) alive for the handle's life
  const int32_t* blk_max = nullptr;
  const int32_t* blk_first = nullptr;
  const uint8_t* blk_width = nullptr;
  const uint8_t* blk_tf_width = nullptr;
  const uint8_t* blk_max_tf = nullptr;  // u8 / u16-LE per score_bits
  const uint8_t* blk_min_dl = nullptr;  // (null on plain v2)
  const uint32_t* post_words = nullptr;
  const uint32_t* tf_words = nullptr;
  const double* doc_lens = nullptr;
  const int64_t* term_block_off = nullptr;  // vocab + 1
  const int32_t* blk_cnt = nullptr;
  const int64_t* blk_woff = nullptr;        // num_blocks + 1
  const int64_t* blk_tf_woff = nullptr;     // num_blocks + 1
  int32_t vocab = 0;
  int64_t num_blocks = 0;
  int32_t block_size = 0;
  int32_t score_bits = 0;
  int64_t num_docs = 0;
  double avgdl = 1.0, k1 = 1.2, b = 0.75;
  int32_t cache_cap = 4096;
  // per-term score memo (mirror of Engine._score_memo: cleared
  // wholesale at the cap, node-based so held pointers stay valid
  // across inserts)
  std::unordered_map<int32_t, ServeTermEntry> cache;
  // dense accumulator + epoch marks: touch-only reset between queries
  std::vector<double> acc;
  std::vector<uint32_t> mark;
  uint32_t epoch = 0;
  // scratch
  std::vector<uint32_t> vals;     // one block of raw unpacked values
  std::vector<int32_t> blk_ids;   // one decoded block (ids)
  std::vector<int32_t> blk_tf;    // one decoded block (tf)
  std::vector<int32_t> cand;      // candidate docs
  std::vector<double> partial;    // theta-maintenance scratch
  // registered ranked-path output buffers (mri_serve_set_topk_out)
  // plus the prepared-query registry (mri_serve_topk_prep) — borrowed
  // pointers, owned by the Python wrapper
  int32_t* out_docs = nullptr;
  double* out_scores = nullptr;
  int64_t* out_stats = nullptr;
  std::unordered_map<int64_t, ServePrep> preps;
  int64_t next_prep = 1;
};

inline uint32_t ServeNextEpoch(ServeState* st) {
  if (st->epoch > UINT32_MAX - 8) {
    std::fill(st->mark.begin(), st->mark.end(), 0u);
    st->epoch = 0;
  }
  return ++st->epoch;
}

// decode one block's doc ids into out (>= blk_cnt[b] slots); returns cnt
inline int ServeDecodeIds(const ServeState& st, int64_t b, int32_t* out) {
  const int cnt = st.blk_cnt[b];
  const int32_t first = st.blk_first[b];
  const int w = st.blk_width[b];
  if (cnt <= 1) {
    out[0] = first;
    return cnt;
  }
  if (w == 0) {  // all stored deltas are 0 -> consecutive ids
    for (int j = 0; j < cnt; ++j) out[j] = first + j;
    return cnt;
  }
  const uint32_t* words = st.post_words + st.blk_woff[b];
  uint32_t* scratch = const_cast<ServeState&>(st).vals.data();
  kServeUnpack[w](words, cnt - 1, scratch);
  ServePrefixIds(scratch, cnt - 1, first, out);
  return cnt;
}

// decode one block's term frequencies into out (>= cnt slots)
inline void ServeDecodeTf(const ServeState& st, int64_t b, int cnt,
                          int32_t* out) {
  const int w = st.blk_tf_width[b];
  if (w == 0) {  // stored (tf - 1) all zero -> tf 1 everywhere
    for (int j = 0; j < cnt; ++j) out[j] = 1;
    return;
  }
  const uint32_t* words = st.tf_words + st.blk_tf_woff[b];
  uint32_t* scratch = const_cast<ServeState&>(st).vals.data();
  kServeUnpack[w](words, cnt, scratch);
  for (int j = 0; j < cnt; ++j)
    out[j] = static_cast<int32_t>(scratch[j]) + 1;
}

// 3-distance prefetch for a forward walk over a term's blocks: run
// geometry far ahead, the posting payload those offsets feed closer
// in, the tf payload (touched right after the ids) last.
inline void ServePrefetchBlocks(const ServeState& st, int64_t bb,
                                int64_t b1) {
  if (bb + 8 < b1) {
    __builtin_prefetch(&st.blk_woff[bb + 8]);
    __builtin_prefetch(&st.blk_tf_woff[bb + 8]);
    __builtin_prefetch(&st.blk_first[bb + 8]);
  }
  if (bb + 2 < b1)
    __builtin_prefetch(st.post_words + st.blk_woff[bb + 2]);
  if (bb + 1 < b1)
    __builtin_prefetch(st.tf_words + st.blk_tf_woff[bb + 1]);
}

// BM25 contribution with the numpy scorer's exact expression and
// association order (see the header comment).
inline double ServeContrib(double idf, double tf, double dl, double om,
                           double k1, double b, double avgdl,
                           double k1p1) {
  const double denom = tf + k1 * (om + (b * dl) / avgdl);
  return ((idf * tf) * k1p1) / denom;
}

// decode + score one whole term into a cache entry; false on a doc id
// outside [0, num_docs) (corrupt artifact — never index doc_lens with
// it)
bool ServeFillEntry(ServeState* st, int32_t term, double idf,
                    ServeTermEntry* e) {
  const int64_t b0 = st->term_block_off[term];
  const int64_t b1 = st->term_block_off[term + 1];
  const int64_t nb = b1 - b0;
  const int64_t df = nb <= 0 ? 0
      : (nb - 1) * st->block_size + st->blk_cnt[b1 - 1];
  e->docs.resize(df);
  e->contrib.resize(df);
  e->idf = idf;
  const double om = 1.0 - st->b;
  const double k1p1 = st->k1 + 1.0;
  int64_t o = 0;
  for (int64_t bb = b0; bb < b1; ++bb) {
    ServePrefetchBlocks(*st, bb, b1);
    const int cnt = ServeDecodeIds(*st, bb, e->docs.data() + o);
    if (e->docs[o] < 0 || e->docs[o + cnt - 1] >= st->num_docs)
      return false;
    ServeDecodeTf(*st, bb, cnt, st->blk_tf.data());
    for (int j = 0; j < cnt; ++j) {
      e->contrib[o + j] = ServeContrib(
          idf, static_cast<double>(st->blk_tf[j]),
          st->doc_lens[e->docs[o + j]], om, st->k1, st->b, st->avgdl,
          k1p1);
    }
    o += cnt;
  }
  e->sorted_desc = e->contrib;
  std::sort(e->sorted_desc.begin(), e->sorted_desc.end(),
            std::greater<double>());
  return true;
}

// cached entry for a term, decoding + scoring on miss.  The cap sweep
// happens ONLY between queries (callers resolve all entries up front),
// so pointers into the node-based map never dangle mid-query.
ServeTermEntry* ServeGetEntry(ServeState* st, int32_t term, double idf) {
  auto it = st->cache.find(term);
  if (it != st->cache.end()) {
    if (it->second.idf == idf) return &it->second;
    st->cache.erase(it);  // idf changed (corpus override): rescore
  }
  // fill a local entry first: a bad_alloc mid-fill must never leave a
  // half-built entry behind for the next query to trust
  ServeTermEntry tmp;
  if (!ServeFillEntry(st, term, idf, &tmp)) return nullptr;
  ServeTermEntry* e = &st->cache[term];
  *e = std::move(tmp);
  return e;
}

// first index in a[lo, hi) with a[i] >= key (galloping from lo: the
// serve walks probe ascending keys, so lo is monotone)
template <typename T>
inline int64_t ServeGallopLower(const T* a, int64_t lo, int64_t hi,
                                T key) {
  if (lo >= hi || a[lo] >= key) return lo;
  int64_t prev = lo, step = 1;
  while (lo + step < hi && a[lo + step] < key) {
    prev = lo + step;
    step <<= 1;
  }
  int64_t l = prev + 1, h = std::min(lo + step, hi);
  while (l < h) {
    const int64_t mid = (l + h) >> 1;
    if (a[mid] < key) l = mid + 1; else h = mid;
  }
  return l;
}

// quantized per-block score column (u8 or u16-LE per score_bits)
inline uint32_t ServeScoreCol(const uint8_t* p, int score_bits,
                              int64_t i) {
  if (score_bits == 8) return p[i];
  return static_cast<uint32_t>(p[2 * i])
      | (static_cast<uint32_t>(p[2 * i + 1]) << 8);
}

// per-block BM25 upper bound — mirror of planner.block_upper_bounds:
// evaluate the contribution at (max tf, min dl); a saturated max-tf
// cell takes the tf->inf limit idf*(k1+1)
inline double ServeBlockUb(const ServeState& st, int64_t b, double idf) {
  const uint32_t cap = (1u << st.score_bits) - 1;
  const uint32_t mtf = ServeScoreCol(st.blk_max_tf, st.score_bits, b);
  if (mtf >= cap) return idf * (st.k1 + 1.0);
  const uint32_t mdl = ServeScoreCol(st.blk_min_dl, st.score_bits, b);
  return ServeContrib(idf, static_cast<double>(mtf),
                      static_cast<double>(mdl), 1.0 - st.b, st.k1,
                      st.b, st.avgdl, st.k1 + 1.0);
}

struct ServeHit {
  double score;
  int32_t doc;
};

inline bool ServeHitBetter(const ServeHit& a, const ServeHit& b) {
  if (a.score != b.score) return a.score > b.score;
  return a.doc < b.doc;
}

// top-k selection with the oracle's order: score descending, ties by
// ascending doc id (np.lexsort((cand, -scores)) semantics)
inline int64_t ServeSelectTopK(std::vector<ServeHit>* hits, int32_t k,
                               int32_t* out_docs, double* out_scores) {
  if (static_cast<int64_t>(hits->size()) > k) {
    std::nth_element(hits->begin(), hits->begin() + k, hits->end(),
                     ServeHitBetter);
    hits->resize(k);
  }
  std::sort(hits->begin(), hits->end(), ServeHitBetter);
  const int64_t n = static_cast<int64_t>(hits->size());
  for (int64_t j = 0; j < n; ++j) {
    out_docs[j] = (*hits)[j].doc;
    out_scores[j] = (*hits)[j].score;
  }
  return n;
}

//: per-query term view for the ranked evaluator
struct ServeQTerm {
  int32_t term = 0;
  int32_t w = 0;             // occurrence count in the query
  double idf = 0.0;
  ServeTermEntry* e = nullptr;  // null: not decoded (bound-only)
  double u = 0.0;            // w * (max contribution upper bound)
  int64_t b0 = 0, b1 = 0;
};

// stream the union of one or two doc-ascending contribution lists,
// calling f(score, doc) once per doc in ascending doc order.  Shared
// docs sum list-0-then-list-1 (the oracle's occurrence order); with
// ``dbl`` list 0 is a duplicated query term and every emit doubles
// (c + c — exactly w * c for w == 2).  Sequential scans only: the
// 1-2 term fast path runs through here with no dense accumulator,
// no epoch marks, and no candidate vector.
template <typename F>
inline void ServeScan2(const int32_t* d0, const double* c0, int64_t n0,
                       const int32_t* d1, const double* c1, int64_t n1,
                       bool dbl, F&& f) {
  int64_t i = 0, j = 0;
  while (i < n0 && j < n1) {
    const int32_t a = d0[i], b = d1[j];
    if (a < b) {
      f(c0[i], a);
      ++i;
    } else if (b < a) {
      f(c1[j], b);
      ++j;
    } else {
      f(c0[i] + c1[j], a);
      ++i;
      ++j;
    }
  }
  if (dbl) {
    for (; i < n0; ++i) f(c0[i] + c0[i], d0[i]);
  } else {
    for (; i < n0; ++i) f(c0[i], d0[i]);
  }
  for (; j < n1; ++j) f(c1[j], d1[j]);
}

}  // namespace

extern "C" {

void* mri_serve_new(
    const int32_t* blk_max, const int32_t* blk_first,
    const uint8_t* blk_width, const uint8_t* blk_tf_width,
    const uint8_t* blk_max_tf, const uint8_t* blk_min_dl,
    const uint32_t* post_words, const uint32_t* tf_words,
    const double* doc_lens, const int64_t* term_block_off,
    const int32_t* blk_cnt, const int64_t* blk_woff,
    const int64_t* blk_tf_woff, int32_t vocab, int64_t num_blocks,
    int32_t block_size, int32_t score_bits, int64_t num_docs,
    double avgdl, double k1, double b, int32_t cache_cap) try {
  if (vocab < 0 || num_blocks < 0 || num_docs < 0 || block_size < 2 ||
      (block_size & (block_size - 1)) != 0 || avgdl <= 0.0)
    return nullptr;
  if (!blk_max || !blk_first || !blk_width || !blk_tf_width ||
      !post_words || !tf_words || !doc_lens || !term_block_off ||
      !blk_cnt || !blk_woff || !blk_tf_woff)
    return nullptr;
  if (score_bits != 0 && score_bits != 8 && score_bits != 16)
    return nullptr;
  ServeState* st = new ServeState();
  st->blk_max = blk_max;
  st->blk_first = blk_first;
  st->blk_width = blk_width;
  st->blk_tf_width = blk_tf_width;
  st->blk_max_tf = blk_max_tf;
  st->blk_min_dl = blk_min_dl;
  st->post_words = post_words;
  st->tf_words = tf_words;
  st->doc_lens = doc_lens;
  st->term_block_off = term_block_off;
  st->blk_cnt = blk_cnt;
  st->blk_woff = blk_woff;
  st->blk_tf_woff = blk_tf_woff;
  st->vocab = vocab;
  st->num_blocks = num_blocks;
  st->block_size = block_size;
  st->score_bits = score_bits;
  st->num_docs = num_docs;
  st->avgdl = avgdl;
  st->k1 = k1;
  st->b = b;
  st->cache_cap = std::max(cache_cap, 1);
  st->acc.resize(num_docs, 0.0);
  st->mark.resize(num_docs, 0u);
  st->vals.resize(block_size);
  st->blk_ids.resize(block_size);
  st->blk_tf.resize(block_size);
  return st;
} catch (const std::bad_alloc&) {
  return nullptr;
}

void mri_serve_free(void* h) {
  delete static_cast<ServeState*>(h);
}

// decode the selected global block indices: out_ids is (n, block_size)
// int32 row-major, entries past a block's count repeating its last
// real doc id; out_tf (optional) likewise with 1s past the count —
// both exactly the numpy Artifact.decode_blocks /decode_tf_blocks
// padding so callers can swap backends per call.
int32_t mri_serve_decode_blocks(void* h, const int64_t* sel, int64_t n,
                                int32_t* out_ids, int32_t* out_tf,
                                int32_t* out_cnt) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !sel || n < 0 || !out_ids || !out_cnt) return -1;
  const int B = st->block_size;
  for (int64_t r = 0; r < n; ++r) {
    if (sel[r] < 0 || sel[r] >= st->num_blocks) return -1;
    // 3-distance prefetch on the random block walk: geometry rows far
    // ahead, posting payloads nearer, tf payloads last
    if (r + 8 < n) {
      __builtin_prefetch(&st->blk_woff[sel[r + 8]]);
      __builtin_prefetch(&st->blk_first[sel[r + 8]]);
    }
    if (r + 2 < n)
      __builtin_prefetch(st->post_words + st->blk_woff[sel[r + 2]]);
    if (out_tf && r + 1 < n)
      __builtin_prefetch(st->tf_words + st->blk_tf_woff[sel[r + 1]]);
    int32_t* row = out_ids + r * B;
    const int cnt = ServeDecodeIds(*st, sel[r], row);
    const int32_t last = row[cnt - 1];
    for (int j = cnt; j < B; ++j) row[j] = last;
    if (out_tf) {
      int32_t* trow = out_tf + r * B;
      ServeDecodeTf(*st, sel[r], cnt, trow);
      for (int j = cnt; j < B; ++j) trow[j] = 1;
    }
    out_cnt[r] = cnt;
  }
  return 0;
} catch (const std::bad_alloc&) {
  return -2;
}

// decode one whole term: ascending doc ids (+ aligned tfs when out_tf
// is non-null); returns df, or a negative error
int64_t mri_serve_decode_postings(void* h, int32_t term,
                                  int32_t* out_docs, int32_t* out_tf) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !out_docs || term < 0 || term >= st->vocab) return -1;
  const int64_t b0 = st->term_block_off[term];
  const int64_t b1 = st->term_block_off[term + 1];
  int64_t o = 0;
  for (int64_t bb = b0; bb < b1; ++bb) {
    ServePrefetchBlocks(*st, bb, b1);
    const int cnt = ServeDecodeIds(*st, bb, out_docs + o);
    if (out_tf) ServeDecodeTf(*st, bb, cnt, out_tf + o);
    o += cnt;
  }
  return o;
} catch (const std::bad_alloc&) {
  return -2;
}

// intersect the ascending candidate list against one term: blk_max
// routes each candidate to the single block that could hold it
// (galloping, monotone), only those blocks are ever bit-unpacked, and
// the in-block probe gallops too.  Returns the surviving count;
// stats2 = {blocks decoded, blocks skipped}.
int64_t mri_serve_and(void* h, const int32_t* cand, int64_t n,
                      int32_t term, int32_t* out, int64_t* stats2) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || (!cand && n > 0) || n < 0 || !out || !stats2 ||
      term < 0 || term >= st->vocab)
    return -1;
  const int64_t b0 = st->term_block_off[term];
  const int64_t b1 = st->term_block_off[term + 1];
  int64_t lo_blk = b0, cur_blk = -1, decoded = 0, m = 0, pos = 0;
  int cur_cnt = 0;
  for (int64_t t = 0; t < n; ++t) {
    const int32_t c = cand[t];
    lo_blk = ServeGallopLower(st->blk_max, lo_blk, b1, c);
    if (lo_blk >= b1) break;
    if (lo_blk != cur_blk) {
      if (lo_blk + 1 < b1)
        __builtin_prefetch(st->post_words + st->blk_woff[lo_blk + 1]);
      cur_cnt = ServeDecodeIds(*st, lo_blk, st->blk_ids.data());
      cur_blk = lo_blk;
      ++decoded;
      pos = 0;
    }
    pos = ServeGallopLower(st->blk_ids.data(), pos,
                           static_cast<int64_t>(cur_cnt), c);
    if (pos < cur_cnt && st->blk_ids[pos] == c) out[m++] = c;
  }
  stats2[0] = decoded;
  stats2[1] = (b1 - b0) - decoded;
  return m;
} catch (const std::bad_alloc&) {
  return -2;
}

// BM25 top-k over the query's occurrence list (occ[i] = lex index of
// the i-th scoring occurrence, absent terms already dropped; idf_occ
// aligned).  mode: 0 exhaustive, 1 block-max WAND, 2 MaxScore.
// Returns the result count (<= k), writing (doc, score) best-first
// with ties doc-ascending — byte-identical to the numpy Engine's
// top_k_scored.  stats3 = {blocks scored, blocks skipped, candidates}.
int64_t mri_serve_topk_bm25(void* h, const int32_t* occ, int32_t n_occ,
                            const double* idf_occ, int32_t k,
                            int32_t mode, int32_t* out_docs,
                            double* out_scores, int64_t* stats3) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !occ || !idf_occ || !out_docs || !out_scores || !stats3 ||
      n_occ < 0 || mode < 0 || mode > 2)
    return -1;
  stats3[0] = stats3[1] = stats3[2] = 0;
  if (n_occ == 0 || k <= 0) return 0;
  for (int32_t i = 0; i < n_occ; ++i)
    if (occ[i] < 0 || occ[i] >= st->vocab) return -1;
  if (mode != 0 && (!st->blk_max_tf || !st->blk_min_dl ||
                    st->score_bits == 0))
    mode = 0;  // no bound columns: prune nothing, score everything
  // cap sweep BEFORE any entry pointer is taken (mirrors the numpy
  // memo's clear-at-cap; unordered_map nodes are stable under insert,
  // so held pointers survive the fills below)
  if (static_cast<int64_t>(st->cache.size()) + n_occ >
      static_cast<int64_t>(st->cache_cap))
    st->cache.clear();

  const double margin = kServeThetaMargin;

  // ---- fast path: <= 2 scoring occurrences ---------------------------
  // sums of one or two floats are order-independent, and w*c == c+c
  // exactly for w == 2, so a single dense accumulate in occurrence
  // order already carries the exhaustive bits.  The Zipf-head query mix
  // lives here, so the path is allocation-free: entries resolve into
  // the node-stable cache and the selection runs as a bounded insertion
  // into a stack array (same strict (score desc, doc asc) order as
  // ServeSelectTopK) whenever k fits.
  if (n_occ <= 2) {
    ServeTermEntry* e0 = ServeGetEntry(st, occ[0], idf_occ[0]);
    if (!e0) return -3;
    const bool dup = n_occ == 2 && occ[1] == occ[0];
    ServeTermEntry* e1 = nullptr;
    if (n_occ == 2) {
      e1 = dup ? e0 : ServeGetEntry(st, occ[1], idf_occ[1]);
      if (!e1) return -3;
    }
    // theta seed: the best k-th single-term contribution is a floor on
    // the k-th best final score (contributions are positive)
    double theta = 0.0;
    if (static_cast<int64_t>(e0->sorted_desc.size()) >= k) {
      theta = e0->sorted_desc[k - 1];
      if (dup) theta = 2.0 * theta;
    }
    if (e1 && !dup &&
        static_cast<int64_t>(e1->sorted_desc.size()) >= k) {
      const double t = e1->sorted_desc[k - 1];
      if (t > theta) theta = t;
    }
    const double thr = theta * margin;
    // union scores stream out of a sequential two-pointer merge (the
    // lists are doc-ascending) — see ServeScan2.  Emission order is
    // doc-ascending, so the bounded insertion below lands the same
    // strict (score desc, doc asc) order as ServeSelectTopK.
    const int32_t* d0 = e0->docs.data();
    const double* c0 = e0->contrib.data();
    const int64_t n0 = static_cast<int64_t>(e0->docs.size());
    const bool two = e1 != nullptr && !dup;
    const int32_t* d1 = two ? e1->docs.data() : nullptr;
    const double* c1 = two ? e1->contrib.data() : nullptr;
    const int64_t n1 = two ? static_cast<int64_t>(e1->docs.size()) : 0;
    int64_t npass = 0;
    if (k <= kServeStackK) {
      ServeHit top[kServeStackK];
      int32_t nk = 0;
      ServeScan2(d0, c0, n0, d1, c1, n1, dup, [&](double s, int32_t d) {
        if (theta > 0.0 && s < thr) return;
        ++npass;
        if (nk == k && !(s > top[k - 1].score ||
                         (s == top[k - 1].score && d < top[k - 1].doc)))
          return;
        int32_t p = nk < k ? nk : k - 1;
        while (p > 0 && (top[p - 1].score < s ||
                         (top[p - 1].score == s && top[p - 1].doc > d))) {
          top[p] = top[p - 1];
          --p;
        }
        top[p] = ServeHit{s, d};
        if (nk < k) ++nk;
      });
      stats3[2] = npass;
      for (int32_t j = 0; j < nk; ++j) {
        out_docs[j] = top[j].doc;
        out_scores[j] = top[j].score;
      }
      return nk;
    }
    std::vector<ServeHit> big;
    big.reserve(static_cast<size_t>(n0 + n1));
    ServeScan2(d0, c0, n0, d1, c1, n1, dup, [&](double s, int32_t d) {
      if (theta <= 0.0 || s >= thr) big.push_back(ServeHit{s, d});
    });
    stats3[2] = static_cast<int64_t>(big.size());
    return ServeSelectTopK(&big, k, out_docs, out_scores);
  }

  // unique terms in first-occurrence order
  std::vector<ServeQTerm> qt;
  qt.reserve(n_occ);
  for (int32_t i = 0; i < n_occ; ++i) {
    bool seen = false;
    for (ServeQTerm& q : qt)
      if (q.term == occ[i]) {
        ++q.w;
        seen = true;
        break;
      }
    if (seen) continue;
    ServeQTerm q;
    q.term = occ[i];
    q.w = 1;
    q.idf = idf_occ[i];
    q.b0 = st->term_block_off[q.term];
    q.b1 = st->term_block_off[q.term + 1];
    qt.push_back(q);
  }
  std::vector<ServeHit> hits;

  // ---- exhaustive (3+ occurrences) -----------------------------------
  if (mode == 0) {
    for (ServeQTerm& q : qt) {
      q.e = ServeGetEntry(st, q.term, q.idf);
      if (!q.e) return -3;
    }
    const uint32_t ep = ServeNextEpoch(st);
    st->cand.clear();
    // dense accumulate per OCCURRENCE in occurrence order — the
    // oracle's exact float addition order (duplicate terms add their
    // contribution once per occurrence, not w-multiplied)
    for (int32_t i = 0; i < n_occ; ++i) {
      const ServeTermEntry* e = nullptr;
      for (const ServeQTerm& q : qt)
        if (q.term == occ[i]) {
          e = q.e;
          break;
        }
      const int64_t df = static_cast<int64_t>(e->docs.size());
      for (int64_t j = 0; j < df; ++j) {
        const int32_t d = e->docs[j];
        if (st->mark[d] != ep) {
          st->mark[d] = ep;
          st->acc[d] = e->contrib[j];
          st->cand.push_back(d);
        } else {
          st->acc[d] += e->contrib[j];
        }
      }
    }
    hits.reserve(st->cand.size());
    for (const int32_t d : st->cand)
      hits.push_back(ServeHit{st->acc[d], d});
    const int64_t n = ServeSelectTopK(&hits, k, out_docs, out_scores);
    stats3[2] = n;
    return n;
  }

  // ---- BMW / MaxScore (3+ occurrences) -------------------------------
  // Terms sort by descending weighted upper bound; while the remaining
  // bounds can still reach theta a term is essential (every posting
  // admitted), past that point no new candidate can enter the top k.
  // Survivor scores are then re-accumulated in occurrence order, so
  // the output carries the exhaustive bits.
  int64_t scored_blocks = 0, skipped_blocks = 0;
  double theta = 0.0;
  for (ServeQTerm& q : qt) {
    auto it = st->cache.find(q.term);
    if (it != st->cache.end() && it->second.idf == q.idf) {
      q.e = &it->second;
      const std::vector<double>& srt = q.e->sorted_desc;
      q.u = srt.empty() ? 0.0
          : static_cast<double>(q.w) * srt[0];
      if (static_cast<int64_t>(srt.size()) >= k) {
        const double t = static_cast<double>(q.w) * srt[k - 1];
        if (t > theta) theta = t;
      }
    } else {
      double umax = 0.0;
      for (int64_t bb = q.b0; bb < q.b1; ++bb) {
        const double ub = ServeBlockUb(*st, bb, q.idf);
        if (ub > umax) umax = ub;
      }
      q.u = static_cast<double>(q.w) * umax;
    }
  }
  std::vector<int32_t> order(qt.size());
  for (size_t p = 0; p < qt.size(); ++p)
    order[p] = static_cast<int32_t>(p);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t bq) {
    if (qt[a].u != qt[bq].u) return qt[a].u > qt[bq].u;
    return qt[a].term < qt[bq].term;
  });
  const size_t nt = qt.size();
  std::vector<double> suffix(nt + 1, 0.0);
  for (size_t p = nt; p-- > 0;)
    suffix[p] = suffix[p + 1] + qt[order[p]].u;

  const uint32_t ep = ServeNextEpoch(st);
  st->cand.clear();
  size_t boundary = nt;
  for (size_t p = 0; p < nt; ++p) {
    if (theta > 0.0 && suffix[p] < theta * margin) {
      boundary = p;
      break;
    }
    ServeQTerm& q = qt[order[p]];
    if (!q.e) {
      q.e = ServeGetEntry(st, q.term, q.idf);
      if (!q.e) return -3;
    }
    scored_blocks += q.b1 - q.b0;
    const double w = static_cast<double>(q.w);
    const int64_t df = static_cast<int64_t>(q.e->docs.size());
    for (int64_t j = 0; j < df; ++j) {
      const int32_t d = q.e->docs[j];
      const double add = q.w == 1 ? q.e->contrib[j]
                                  : w * q.e->contrib[j];
      if (st->mark[d] != ep) {
        st->mark[d] = ep;
        st->acc[d] = add;
        st->cand.push_back(d);
      } else {
        st->acc[d] += add;
      }
    }
    // dynamic theta: the k-th best partial is a floor on the k-th
    // best final score (remaining contributions only add)
    if (static_cast<int64_t>(st->cand.size()) >= k) {
      st->partial.clear();
      st->partial.reserve(st->cand.size());
      for (const int32_t d : st->cand)
        st->partial.push_back(st->acc[d]);
      std::nth_element(st->partial.begin(), st->partial.begin() + (k - 1),
                       st->partial.end(), std::greater<double>());
      const double kth = st->partial[k - 1];
      if (kth > theta) theta = kth;
    }
  }
  // drop candidates that provably cannot reach theta even with every
  // remaining (non-essential) term's full bound
  const double tail = suffix[boundary];
  const double thr = theta * margin;
  std::vector<int32_t>& cands = st->cand;
  if (theta > 0.0) {
    size_t m = 0;
    for (const int32_t d : cands)
      if (st->acc[d] + tail >= thr) cands[m++] = d;
    cands.resize(m);
  }
  std::sort(cands.begin(), cands.end());
  stats3[2] = static_cast<int64_t>(cands.size());

  // exact rescore in occurrence order = the exhaustive addition order
  std::vector<double> scores(cands.size(), 0.0);
  const double om = 1.0 - st->b;
  const double k1p1 = st->k1 + 1.0;
  std::vector<bool> counted(nt, false);
  for (int32_t i = 0; i < n_occ && !cands.empty(); ++i) {
    ServeQTerm* q = nullptr;
    size_t qpos = 0;
    for (size_t p = 0; p < nt; ++p)
      if (qt[p].term == occ[i]) {
        q = &qt[p];
        qpos = p;
        break;
      }
    if (q->e) {
      // gallop-probe the term's decoded run at each candidate
      const int32_t* docs = q->e->docs.data();
      const int64_t df = static_cast<int64_t>(q->e->docs.size());
      int64_t pos = 0;
      int64_t touched = 0, last_blk = -1;
      const int shift = __builtin_ctz(st->block_size);
      for (size_t j = 0; j < cands.size(); ++j) {
        pos = ServeGallopLower(docs, pos, df, cands[j]);
        if (pos >= df) break;
        if (docs[pos] == cands[j]) {
          scores[j] += q->e->contrib[pos];
          const int64_t blk = pos >> shift;
          if (blk != last_blk) {
            ++touched;
            last_blk = blk;
          }
        }
      }
      if (!counted[qpos]) {
        counted[qpos] = true;
        bool essential = false;
        for (size_t p = 0; p < boundary; ++p)
          if (order[p] == static_cast<int32_t>(qpos)) {
            essential = true;
            break;
          }
        if (!essential) {
          // probe economy of a memoized non-essential term
          scored_blocks += touched;
          skipped_blocks += (q->b1 - q->b0) - touched;
        }
      }
    } else {
      // never decoded: route candidates through blk_max, decode only
      // the blocks they land in, score those postings on the fly with
      // the same expression (elementwise bit-equal to a full decode)
      int64_t lo_blk = q->b0, cur_blk = -1, decoded = 0, pos = 0;
      int cur_cnt = 0;
      for (size_t j = 0; j < cands.size(); ++j) {
        const int32_t c = cands[j];
        lo_blk = ServeGallopLower(st->blk_max, lo_blk, q->b1, c);
        if (lo_blk >= q->b1) break;
        if (lo_blk != cur_blk) {
          cur_cnt = ServeDecodeIds(*st, lo_blk, st->blk_ids.data());
          if (st->blk_ids[0] < 0 ||
              st->blk_ids[cur_cnt - 1] >= st->num_docs)
            return -3;
          ServeDecodeTf(*st, lo_blk, cur_cnt, st->blk_tf.data());
          cur_blk = lo_blk;
          ++decoded;
          pos = 0;
        }
        pos = ServeGallopLower(st->blk_ids.data(), pos,
                               static_cast<int64_t>(cur_cnt), c);
        if (pos < cur_cnt && st->blk_ids[pos] == c) {
          scores[j] += ServeContrib(
              q->idf, static_cast<double>(st->blk_tf[pos]),
              st->doc_lens[c], om, st->k1, st->b, st->avgdl, k1p1);
        }
      }
      if (!counted[qpos]) {
        counted[qpos] = true;
        scored_blocks += decoded;
        skipped_blocks += (q->b1 - q->b0) - decoded;
      }
    }
  }
  hits.reserve(cands.size());
  for (size_t j = 0; j < cands.size(); ++j)
    if (scores[j] > 0.0)
      hits.push_back(ServeHit{scores[j], cands[j]});
  stats3[0] = scored_blocks;
  stats3[1] = skipped_blocks;
  return ServeSelectTopK(&hits, k, out_docs, out_scores);
} catch (const std::bad_alloc&) {
  return -2;
}

// register reusable ranked-path output buffers on the handle — the
// warm-query entry points below then take only scalar arguments, so
// ctypes marshals 4 integers instead of 9 mixed pointers per call
// (argument conversion is a measurable share of a warm ranked query)
int64_t mri_serve_set_topk_out(void* h, int32_t* out_docs,
                               double* out_scores, int64_t* stats3) {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !out_docs || !out_scores || !stats3) return -1;
  st->out_docs = out_docs;
  st->out_scores = out_scores;
  st->out_stats = stats3;
  return 0;
}

// freeze one query's (occ, idf) argument arrays into the handle;
// returns a prep id (>= 1) for mri_serve_topk_run, < 0 on error
int64_t mri_serve_topk_prep(void* h, const int32_t* occ, int32_t n_occ,
                            const double* idf_occ) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !occ || !idf_occ || n_occ <= 0) return -1;
  for (int32_t i = 0; i < n_occ; ++i)
    if (occ[i] < 0 || occ[i] >= st->vocab) return -1;
  const int64_t id = st->next_prep++;
  ServePrep& p = st->preps[id];
  p.occ.assign(occ, occ + n_occ);
  p.idf.assign(idf_occ, idf_occ + n_occ);
  return id;
} catch (const std::bad_alloc&) {
  return -2;
}

// drop every prepared query (the engine clears its prep memo at the
// same cap as its other per-query memos)
int64_t mri_serve_topk_prep_clear(void* h) {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st) return -1;
  st->preps.clear();
  return 0;
}

// drop one prepared query (un-memoizable one-shot callers)
int64_t mri_serve_topk_prep_free(void* h, int64_t prep) {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st) return -1;
  st->preps.erase(prep);
  return 0;
}

// ranked query over a prepared id, writing into the buffers registered
// by mri_serve_set_topk_out
int64_t mri_serve_topk_run(void* h, int64_t prep, int32_t k,
                           int32_t mode) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !st->out_docs) return -1;
  auto it = st->preps.find(prep);
  if (it == st->preps.end()) return -1;
  const ServePrep& p = it->second;
  return mri_serve_topk_bm25(h, p.occ.data(),
                             static_cast<int32_t>(p.occ.size()),
                             p.idf.data(), k, mode, st->out_docs,
                             st->out_scores, st->out_stats);
} catch (const std::bad_alloc&) {
  return -2;
}

// coalesced ranked batch: answer nq prepared queries in ONE library
// crossing.  Query i writes its hits at out_docs/out_scores[i * k]
// and its hit count into out_n[i]; stats3 accumulates the batch's
// block economy (blocks scored, blocks skipped, candidates) across
// all queries.  Every query must resolve to a valid prep id — any
// failure returns < 0 and the caller re-runs the batch per query.
int64_t mri_serve_topk_batch(void* h, const int64_t* preps,
                             const int32_t* modes, int32_t nq,
                             int32_t k, int32_t* out_docs,
                             double* out_scores, int32_t* out_n,
                             int64_t* stats3) try {
  ServeState* st = static_cast<ServeState*>(h);
  if (!st || !preps || !modes || !out_docs || !out_scores || !out_n ||
      !stats3 || nq <= 0 || k <= 0)
    return -1;
  stats3[0] = stats3[1] = stats3[2] = 0;
  int64_t q_stats[3];
  for (int32_t i = 0; i < nq; ++i) {
    auto it = st->preps.find(preps[i]);
    if (it == st->preps.end()) return -1;
    const ServePrep& p = it->second;
    const int64_t n = mri_serve_topk_bm25(
        h, p.occ.data(), static_cast<int32_t>(p.occ.size()),
        p.idf.data(), k, modes[i], out_docs + int64_t{i} * k,
        out_scores + int64_t{i} * k, q_stats);
    if (n < 0) return n;
    out_n[i] = static_cast<int32_t>(n);
    stats3[0] += q_stats[0];
    stats3[1] += q_stats[1];
    stats3[2] += q_stats[2];
  }
  return nq;
} catch (const std::bad_alloc&) {
  return -2;
}

}  // extern "C"
