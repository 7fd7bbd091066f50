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
//   g++ -O3 -shared -fPIC -o libmri_torch_scan.so tokenizer.cc

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <exception>
#include <new>
#include <system_error>
#include <string>
#include <thread>
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

}  // extern "C"
