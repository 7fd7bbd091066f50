"""The host query engine over a mapped ``index.mri``, the crossover
router over it and the device engine, and the helpers both engines
share (the JAX package's ``serve/engine.py``).

Batched lookups are the unit of work: a batch of query terms becomes
one ``S``-dtype numpy array, term resolution is ONE ``np.searchsorted``
over big-endian u64 prefix keys (lexicographic order of NUL-padded
bytes == numeric order of the keys) plus a vectorized exact-match
gather.  Postings decode through an LRU hot-term cache; multi-term AND
intersects sorted runs smallest-first with a galloping ``searchsorted``
probe (or the native kernel); top-k-by-df per letter is an O(k) slice
of the artifact's ``df_order`` permutation; BM25 runs exhaustive,
Block-Max WAND or MaxScore, in numpy or in the native ``mri_serve_*``
kernels (``$MRI_SERVE_NATIVE``), with float64 scores bit-equal either
way.

:func:`create_engine` opens a directory with the engine the caller or
``$MRI_SERVE_ENGINE`` names: ``device`` (the default: the torch
``DeviceEngine`` on the card), ``host`` (:class:`Engine`) or ``auto``
(:class:`AutoEngine`, which sends small batches to the host and races
the two engines once on the first large one).
"""

from __future__ import annotations

import array
import os
import time
from pathlib import Path

import numpy as np

from . import artifact as artifact_mod
from . import planner as planner_mod
from .cache import LRUCache
from ..obs import attribution as obs_attrib
from ..obs import metrics as obs_metrics
from ..obs.timing import OpTimer
from ..utils import envknobs

#: BM25 parameters (the JAX package's, so scores agree).
BM25_K1 = 1.2
BM25_B = 0.75

SCORE_ENV = "MRI_SERVE_SCORE"
SCORE_CHOICES = ("df", "bm25")

NATIVE_ENV = "MRI_SERVE_NATIVE"
NATIVE_CHOICES = ("auto", "0", "1")


class NativeUnavailable(RuntimeError):
    """``MRI_SERVE_NATIVE=1`` and the native serve kernels cannot serve
    this artifact (no library, or a v1 artifact)."""


#: ``auto`` routes by a measured batch-size crossover (:class:`AutoEngine`).
ENGINE_CHOICES = ("host", "device", "auto")
ENGINE_ENV = "MRI_SERVE_ENGINE"
CROSSOVER_ENV = "MRI_SERVE_CROSSOVER"

#: Batches below this never start the crossover probe: building the
#: device engine (the column upload) is only worth racing when the batch
#: is big enough that the card could plausibly win.
PROBE_BATCH_MIN = 8192

#: Beside a cluster shard's artifact (the JAX package's ``cluster/``).
CLUSTER_SIDECAR_NAME = "cluster_shard.json"


def _normalize(term) -> bytes:
    """Query-side mirror of the tokenizer's cleaning: lowercase, alpha
    only.  A term that cleans to something else can't be in the index."""
    if isinstance(term, bytes):
        term = term.decode("latin-1")
    term = term.lower()
    return term.encode("ascii") if term.isascii() and term.isalpha() else b""


def encode_terms(terms, width: int) -> np.ndarray:
    """Normalize str/bytes queries into the engines' S-dtype batch
    array; terms that normalize away or exceed the vocabulary width
    become b'' (never found)."""
    cleaned = [_normalize(t) for t in terms]
    return np.array([t if len(t) <= width else b"" for t in cleaned], dtype=f"S{width}")


def _union_add(cand: np.ndarray, scores: np.ndarray,
               docs: np.ndarray, add: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Merge a term's (docs, contributions) into the sorted candidate
    accumulator.  Both doc arrays are ascending and internally unique,
    so positional fancy-index adds are exact (no ``np.add.at``)."""
    merged = np.union1d(cand, docs)
    out = np.zeros(len(merged), dtype=np.float64)
    out[np.searchsorted(merged, cand)] = scores
    out[np.searchsorted(merged, docs)] += add
    return merged, out


def letter_index(letter) -> int:
    """'a'..'z' (str/bytes) or 0..25 -> letter_dir slot, or ValueError."""
    if isinstance(letter, (str, bytes)):
        letter = (letter.encode() if isinstance(letter, str) else letter)
        letter = letter[0] - ord("a")
    if not 0 <= letter < 26:
        raise ValueError(f"letter index out of range: {letter}")
    return letter


class Engine:
    """Batched query API over one loaded artifact, on the host (the JAX
    package's ``Engine``; every answer, BM25 float64 scores included,
    byte-equal to it on the same file).

    ``path`` is an output directory (its ``index.mri``) or the artifact
    file itself.  All answers are exact.
    """

    engine_name = "host"

    def __init__(self, path, cache_terms: int = 4096):
        if artifact_mod.is_segment_managed(path):
            raise artifact_mod.ArtifactError(
                f"{path} is segment-managed (segments.manifest.json "
                "present): its root index.mri may be stale, and the "
                "multi-segment engine is not ported yet (ROADMAP A15b)")
        self.artifact = artifact_mod.load_artifact(path)
        art = self.artifact
        V, width = art.vocab, max(art.width, 1)
        self.vocab_size = V
        # Materialized fixed-width term table (artifact.term_table):
        # NUL-padded rows viewed as one S-dtype column for exact-match
        # gathers, plus big-endian u64 prefix keys — the binary-search
        # column.
        rows, terms, key8 = artifact_mod.term_table(art)
        self._rows = rows
        self._terms = terms
        self._keys = key8.view(">u8").ravel()
        self._df = art.df
        # every tally below lives on this per-engine obs registry: the
        # legacy describe()/stats dicts are views over it, and the
        # daemon folds it into the Prometheus exposition
        self.metrics = obs_metrics.Registry()
        self.metrics.gauge("mri_engine_vocab_terms").set(V)
        self.metrics.gauge("mri_engine_artifact_bytes").set(art.nbytes)
        self._cache = LRUCache(cache_terms, registry=self.metrics,
                               prefix="mri_serve_cache")
        self._tf_cache = LRUCache(cache_terms, registry=self.metrics,
                                  prefix="mri_serve_tf_cache")
        self._ops = OpTimer(registry=self.metrics)
        self._sdtype = f"S{width}"
        self._width = width
        # small-batch term-resolution memo: encoded query bytes ->
        # lex index (-1: absent).  Zipf query streams resolve the same
        # few terms over and over; a dict probe replaces the whole
        # searchsorted arm for them.
        self._memo: dict[bytes, int] = {}
        self._c_blocks_decoded = \
            self.metrics.counter("mri_engine_blocks_decoded_total")
        self._c_blocks_skipped = \
            self.metrics.counter("mri_engine_blocks_skipped_total")
        self._c_bytes_decoded = \
            self.metrics.counter("mri_engine_bytes_decoded_total")
        self._bm25_cols = None  # lazy (doc_lens, ndocs, avgdl)
        # corpus-stats override seam (multi-segment serving): when set,
        # (ndocs, avgdl) and the per-term scoring df come from the
        # GLOBAL live corpus instead of this artifact, so per-segment
        # BM25 contributions stay bit-identical to a single-artifact
        # build of the same live state
        self._corpus_override = None  # (ndocs, avgdl, df_fn)
        self.planner = planner_mod.Planner(self.metrics)
        # BM25 per-term memos keyed by lex index: contributions are
        # query-independent (idf, tf and doc length are all properties
        # of the term/corpus), so the pruned evaluators reuse them
        # across a query stream instead of re-deriving per query.
        self._score_memo: dict[int, tuple] = {}
        self._bound_memo: dict[int, tuple] = {}
        self._memo_cap = max(int(cache_terms), 1)
        # ranked-path resolution memo: encoded batch bytes -> the occ
        # list (present lex indices, occurrence order) — one dict probe
        # replaces lookup + the zip/filter for repeated queries
        self._occ_memo: dict[bytes, list] = {}
        # inlined timing for the ranked hot path (the contextmanager
        # form costs a couple of microseconds per call — real money at
        # the QPS the lean small-query path runs at)
        self._h_topk = self._ops.histogram("top_k_scored")
        # native (C++) serve kernels.  The knob is resolved ONCE per
        # engine: a daemon SIGHUP reload swaps the engine, which is the
        # re-resolution point for this and every other serve knob.  The
        # handle itself builds lazily on the first eligible op (the
        # first load compiles the extension); answers are byte-
        # identical either way, so a mid-stream fallback is invisible.
        self._native_mode = resolve_native()
        self._native = None
        self._native_err: str | None = None
        self._idf_memo: dict[int, float] = {}
        #: query key -> (prep id, dfs): the frozen C-side arguments a
        #: warm native ranked query is re-issued with, plus the ranked
        #: plan memo keyed (query key, k) against the raw planner token
        self._nat_prep: dict[bytes, tuple] = {}
        self._plan_memo: dict[tuple, tuple] = {}
        # per-k {query key -> (prep id, mode, mode code, env token)}
        # plus reusable marshalling arrays for the coalesced path
        self._batch_memo: dict[int, dict] = {}
        self._ba_pids = array.array("q")
        self._ba_modes = array.array("i")
        self._c_native_ops = self.metrics.counter(
            "mri_native_ops_total")
        self._c_native_fallback = self.metrics.counter(
            "mri_native_fallback_total")
        if self._native_mode == "1":
            self._native_handle()  # required -> fail loudly up front

    # -- native serve kernels -------------------------------------------

    def _native_handle(self):
        """The lazily-built ``NativeServe`` handle, or None when native
        is off, unsupported (v1 artifact) or unavailable (no compiled
        extension).  Under ``MRI_SERVE_NATIVE=1`` unavailability raises
        instead of silently serving numpy."""
        if self._native is not None:
            return self._native
        if self._native_mode != "0" and self._native_err is None:
            art = self.artifact
            if art.version < artifact_mod.VERSION_V2:
                self._native_err = "v1 artifact (native needs v2+)"
            else:
                try:
                    from .. import native as native_mod
                    doc_lens, _, avgdl = self._bm25_corpus()
                    self._native = native_mod.NativeServe(
                        artifact_mod.serve_columns(art), doc_lens,
                        avgdl, BM25_K1, BM25_B,
                        cache_cap=self._memo_cap)
                except Exception as e:
                    self._native_err = f"{type(e).__name__}: {e}"
        if self._native is None and self._native_mode == "1":
            raise NativeUnavailable(
                "MRI_SERVE_NATIVE=1 but the native serve kernels are "
                f"unavailable: {self._native_err}")
        return self._native

    def _close_native(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        self._native_err = None
        self._nat_prep.clear()
        self._plan_memo.clear()
        self._batch_memo.clear()

    def _term_idf(self, i: int) -> float:
        """The scalar idf the native scorer receives for lex term
        ``i`` — the exact double :meth:`_term_scores` computes, so both
        backends multiply by bit-equal factors (memoized)."""
        hit = self._idf_memo.get(i)
        if hit is None:
            _, ndocs, _ = self._bm25_corpus()
            dfi = self._scoring_df(i, int(self._df[i]))
            hit = float(np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5)))
            if len(self._idf_memo) >= self._memo_cap:
                self._idf_memo.clear()
            self._idf_memo[i] = hit
        return hit

    # -- term resolution ------------------------------------------------

    def encode_batch(self, terms) -> np.ndarray:
        """Normalize a list of str/bytes queries into the S-dtype batch
        array ``lookup`` consumes.  Terms that normalize away or exceed
        the vocabulary width become b'' (never found)."""
        return encode_terms(terms, self._width)

    def lookup(self, batch: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Resolve a batch (S-dtype array from :meth:`encode_batch`, or
        anything ``np.asarray`` coerces to one) to ``(idx, found)`` —
        lex term indices (valid only where ``found``).
        """
        q = np.asarray(batch, dtype=self._sdtype)
        V = self.vocab_size
        if V == 0:
            return (np.zeros(len(q), dtype=np.int64),
                    np.zeros(len(q), dtype=bool))
        n = len(q)
        memo = self._memo
        # one ContextVar.get per lookup: the entire disabled-path cost
        # of per-term attribution
        coll = obs_attrib.active()
        if 0 < n <= 8:
            hits = [memo.get(t) for t in q.tolist()]
            if None not in hits:
                at = np.array(hits, dtype=np.int64)
                found = at >= 0
                at[~found] = 0
                if coll is not None:
                    self._feed_terms(coll, q, at, found, "memo")
                return at, found
        # S -> S8 cast pads (width < 8) or truncates (width > 8) to the
        # 8-byte prefix; big-endian u64 view preserves lex order.
        qkeys = np.ascontiguousarray(q.astype("S8")).view(">u8")
        lo = np.searchsorted(self._keys, qkeys, side="left")
        hi = np.searchsorted(self._keys, qkeys, side="right")
        at = np.minimum(lo, V - 1)
        found = (hi > lo) & (self._terms[at] == q) & (q != b"")
        # Rare arm: several vocabulary terms share a query's full
        # 8-byte prefix and the match isn't the group's first entry.
        ambiguous = np.nonzero((hi - lo > 1) & ~found & (q != b""))[0]
        for i in ambiguous:
            j = lo[i] + np.searchsorted(self._terms[lo[i]:hi[i]], q[i])
            if j < hi[i] and self._terms[j] == q[i]:
                at[i] = j
                found[i] = True
        if n <= 8:
            if len(memo) > (1 << 16):
                memo.clear()
            for t, i, ok in zip(q.tolist(), at.tolist(), found.tolist()):
                memo[t] = i if ok else -1
        if coll is not None:
            self._feed_terms(coll, q, at, found, "bisect")
        return at, found

    def _feed_terms(self, coll, q, at, found, path: str) -> None:
        """Per-term attribution entries for one resolved batch."""
        for t, i, ok in zip(q.tolist(), at.tolist(), found.tolist()):
            coll.term(t, i, ok, int(self._df[i]) if ok else 0, path)

    # -- single-term answers --------------------------------------------

    def df(self, batch) -> np.ndarray:
        """Document frequency per query (0 when absent), vectorized."""
        with self._ops.time("df"):
            idx, found = self.lookup(batch)
            if self.vocab_size == 0:
                return np.zeros(len(found), dtype=np.int64)
            return np.where(found, self._df[idx], 0).astype(np.int64)

    def postings_by_index(self, idx: int) -> np.ndarray:
        """Decoded ascending doc ids of lex term ``idx`` (LRU-cached)."""
        idx = int(idx)
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        art = self.artifact
        decoded = None
        if self._native_mode != "0" \
                and art.version >= artifact_mod.VERSION_V2:
            nat = self._native_handle()
            if nat is not None:
                res = nat.decode_postings(idx, int(self._df[idx]))
                if res is not None:
                    decoded, tf = res
                    self._c_native_ops.inc()
                    # the tf column came out of the same block walk —
                    # warm its cache so _term_scores never re-decodes
                    if self._tf_cache.peek(idx) is None:
                        tf.setflags(write=False)
                        self._tf_cache.put(idx, tf)
                else:
                    self._c_native_fallback.inc()
        if decoded is None:
            decoded = art.decode_postings(idx)
        coll = obs_attrib.active()
        if art.version >= artifact_mod.VERSION_V2:
            b0 = int(art.term_block_off[idx])
            b1 = int(art.term_block_off[idx + 1])
            nbytes = int(art.blk_woff[b1] - art.blk_woff[b0]) * 4
            self._c_blocks_decoded.inc(b1 - b0)
            self._c_bytes_decoded.inc(nbytes)
            if coll is not None:
                coll.decoded(b1 - b0, nbytes)
        else:
            self._c_blocks_decoded.inc()
            self._c_bytes_decoded.inc(decoded.nbytes)
            if coll is not None:
                coll.decoded(1, decoded.nbytes)
        decoded.setflags(write=False)
        self._cache.put(idx, decoded)
        return decoded

    def tf_by_index(self, idx: int) -> np.ndarray:
        """Per-doc term frequencies of lex term ``idx``, aligned with
        :meth:`postings_by_index` (all ones on a v1 artifact)."""
        idx = int(idx)
        hit = self._tf_cache.get(idx)
        if hit is not None:
            return hit
        decoded = self.artifact.decode_tf(idx)
        decoded.setflags(write=False)
        self._tf_cache.put(idx, decoded)
        return decoded

    def postings(self, batch) -> list[np.ndarray | None]:
        """Decoded postings per query term; None where absent."""
        with self._ops.time("postings"):
            idx, found = self.lookup(batch)
            return [self.postings_by_index(i) if ok else None
                    for i, ok in zip(idx.tolist(), found.tolist())]

    # -- compound queries -----------------------------------------------

    def top_k(self, letter, k: int) -> list[tuple[bytes, int]]:
        """The letter's k highest-df terms, (term, df), in emit order —
        exactly the first k lines of ``<letter>.txt``."""
        letter = letter_index(letter)
        with self._ops.time("top_k"):
            art = self.artifact
            lo = int(art.letter_dir[letter])
            hi = int(art.letter_dir[letter + 1])
            pick = art.df_order[lo:min(lo + max(k, 0), hi)]
            return [(art.term(i), int(self._df[i])) for i in pick]

    def _and_probe(self, acc: np.ndarray, run: np.ndarray) -> np.ndarray:
        """Keep the members of sorted ``acc`` present in sorted ``run``
        (galloping ``searchsorted`` probe)."""
        pos = np.searchsorted(run, acc)
        ok = pos < len(run)
        ok[ok] = run[pos[ok]] == acc[ok]
        return acc[ok]

    def _and_skip(self, acc: np.ndarray, idx: int) -> np.ndarray:
        """v2 AND arm: intersect ``acc`` against term ``idx`` WITHOUT
        decoding its whole postings run.  The per-block skip table
        (``blk_max``) routes every surviving candidate to the single
        block that could hold it; only those blocks are bit-unpacked.
        """
        art = self.artifact
        b0 = int(art.term_block_off[idx])
        b1 = int(art.term_block_off[idx + 1])
        blk = np.searchsorted(art.blk_max[b0:b1], acc)
        ok = blk < (b1 - b0)
        blk, cand = blk[ok], acc[ok]
        coll = obs_attrib.active()
        if not len(cand):
            self._c_blocks_skipped.inc(b1 - b0)
            if coll is not None:
                coll.skipped(b1 - b0)
            return cand
        need = np.unique(blk)
        ids, _ = art.decode_blocks(need + b0)
        nbytes = int((art.blk_woff[need + b0 + 1]
                      - art.blk_woff[need + b0]).sum()) * 4
        self._c_blocks_decoded.inc(len(need))
        self._c_blocks_skipped.inc((b1 - b0) - len(need))
        self._c_bytes_decoded.inc(nbytes)
        if coll is not None:
            coll.decoded(len(need), nbytes)
            coll.skipped((b1 - b0) - len(need))
        # rows beyond a block's count repeat its last real doc id
        # (cumsum of zero deltas), so a plain membership test is exact.
        rows = ids[np.searchsorted(need, blk)]
        return cand[(rows == cand[:, None]).any(axis=1)]

    def query_and(self, batch) -> np.ndarray:
        """Docs containing EVERY term.  Any absent term → empty.  The
        intersection gallops smallest-run-first: probe the larger sorted
        run with ``searchsorted`` at the surviving candidates only.  On
        a v2 artifact an uncached large run is never fully decoded —
        the skip table gallops past whole blocks (``--stats`` counts
        them)."""
        with self._ops.time("and"):
            idx, found = self.lookup(batch)
            if len(found) == 0 or not found.all():
                return np.zeros(0, dtype=np.int32)
            uniq = list(set(idx.tolist()))
            uniq.sort(key=lambda i: int(self._df[i]))
            acc = self.postings_by_index(uniq[0])
            v2 = self.artifact.version >= artifact_mod.VERSION_V2
            B = self.artifact.block_size
            nat = self._native_handle() \
                if self._native_mode != "0" and v2 else None
            coll = obs_attrib.active()
            for i in uniq[1:]:
                if len(acc) == 0:
                    break
                cached = self._cache.peek(i)
                # native takes the gallop arm only when the run is NOT
                # already decoded in cache: probing a cached array is a
                # single numpy searchsorted, cheaper than re-walking
                # blocks in C
                arm = self.planner.plan_and(
                    len(acc), int(self._df[i]),
                    native=nat is not None and cached is None)
                if arm == "merge":
                    # merge only fires when the partner run is at most
                    # ~2x the accumulator, so decoding it whole is
                    # cheap even when uncached
                    run = cached if cached is not None \
                        else self.postings_by_index(i)
                    acc = np.intersect1d(acc, run, assume_unique=True)
                    continue
                if arm == "native":
                    res = nat.query_and(
                        np.ascontiguousarray(acc, dtype=np.int32), i)
                    if res is not None:
                        acc, dec, skp = res
                        self._c_native_ops.inc()
                        self._c_blocks_decoded.inc(dec)
                        self._c_blocks_skipped.inc(skp)
                        if coll is not None:
                            coll.decoded(dec, 0)
                            coll.skipped(skp)
                        continue
                    self._c_native_fallback.inc()
                if cached is not None:
                    acc = self._and_probe(acc, cached)
                elif v2 and len(acc) * B < int(self._df[i]):
                    acc = self._and_skip(acc, i)
                else:
                    acc = self._and_probe(acc, self.postings_by_index(i))
            return np.ascontiguousarray(acc, dtype=np.int32)

    def query_or(self, batch) -> np.ndarray:
        """Docs containing ANY term (absent terms contribute nothing)."""
        with self._ops.time("or"):
            idx, found = self.lookup(batch)
            runs = [self.postings_by_index(i)
                    for i in sorted(set(idx[found].tolist()))]
            if not runs:
                return np.zeros(0, dtype=np.int32)
            out = runs[0] if len(runs) == 1 else \
                np.unique(np.concatenate(runs))
            return np.asarray(out, dtype=np.int32)

    # -- ranked retrieval -----------------------------------------------

    def _bm25_corpus(self) -> tuple[np.ndarray, int, float]:
        """``(doc_lens, ndocs, avgdl)`` — v2 reads the packed doc-length
        column; v1 reconstructs lengths from the postings themselves
        (every stored pair counts 1: the no-tf fallback), lazily and
        once.  Under a corpus override (multi-segment serving) the
        doc-length column stays LOCAL (it is indexed by this artifact's
        doc ids) while ndocs/avgdl are the injected global values."""
        if self._bm25_cols is None:
            cols = artifact_mod.bm25_corpus(self.artifact)
            if self._corpus_override is not None:
                ndocs, avgdl, _ = self._corpus_override
                cols = (cols[0], ndocs, avgdl)
            self._bm25_cols = cols
        return self._bm25_cols

    def set_corpus_override(self, ndocs: int, avgdl: float,
                            df_fn) -> None:
        """Score this artifact as ONE SEGMENT of a larger live corpus.

        ``ndocs``/``avgdl`` replace the artifact's own corpus stats and
        ``df_fn(lex_idx) -> int`` supplies the global live document
        frequency per local term, so every BM25 contribution this
        engine computes equals — bit for bit — what a from-scratch
        single-artifact build of the whole live corpus would compute
        for the same (term, doc).  Clears every stats-dependent memo;
        segment engines are per-generation immutable, so the multi-
        segment engine calls this exactly once, right after opening."""
        self._corpus_override = (int(ndocs), float(avgdl), df_fn)
        self._bm25_cols = None
        self._score_memo.clear()
        self._bound_memo.clear()
        self._occ_memo.clear()
        self._idf_memo.clear()
        # the native handle bakes avgdl in at construction — rebuild it
        # lazily against the overridden stats
        self._close_native()

    def _scoring_df(self, i: int, dfi: int) -> int:
        """The df that enters the idf term for lex index ``i``: the
        local ``dfi`` normally, the global live df under an override."""
        if self._corpus_override is not None:
            return int(self._corpus_override[2](i))
        return dfi

    def top_k_scored(self, batch, k: int) -> list[tuple[int, float]]:
        """BM25-ranked ``(doc_id, score)`` for the query terms, best
        first, ties broken by ascending doc id.  Absent terms contribute
        nothing; duplicated query terms accumulate twice (same as the
        scoring oracle).  Parameters: k1=BM25_K1, b=BM25_B; idf is the
        Robertson-Sparck-Jones ``ln(1 + (N - df + 0.5)/(df + 0.5))``.

        The planner picks the evaluation: exhaustive scores every
        posting; ``bmw``/``maxscore`` prune with the v2.1 per-block
        max-score columns and return the same top-k byte-identically
        (the pruned sums are re-accumulated in occurrence order, see
        :meth:`_top_k_pruned`)."""
        t0 = time.perf_counter()
        try:
            coll = obs_attrib.active()
            occ = None
            key = batch.tobytes() if isinstance(batch, np.ndarray) \
                else None
            if key is not None:
                occ = self._occ_memo.get(key)
            if occ is None:
                idx, found = self.lookup(batch)
                occ = [i for i, ok in zip(idx.tolist(),
                                          found.tolist()) if ok]
                if key is not None:
                    if len(self._occ_memo) > (1 << 16):
                        self._occ_memo.clear()
                    self._occ_memo[key] = occ
            elif coll is not None:
                art = self.artifact
                for i in occ:
                    coll.term(art.term(i), i, True,
                              int(self._df[i]), "cache")
            if occ and k > 0 and self._native_mode != "0":
                nat = self._native_handle()
                if nat is not None:
                    res = None
                    prep = self._nat_prep.get(key) \
                        if key is not None else None
                    if prep is None:
                        pid = nat.prep_query(
                            occ, [self._term_idf(i) for i in occ])
                        if pid is not None:
                            prep = (pid,
                                    [int(self._df[i]) for i in occ])
                            if key is not None:
                                if len(self._nat_prep) > (1 << 16):
                                    self._nat_prep.clear()
                                    self._plan_memo.clear()
                                    self._batch_memo.clear()
                                    nat.clear_preps()
                                self._nat_prep[key] = prep
                    if prep is not None:
                        raw = _planner_raw_token()
                        pk = (key, k)
                        pm = self._plan_memo.get(pk)
                        if pm is not None and pm[1] == raw:
                            mode = pm[0]
                        else:
                            mode = self.planner.plan_ranked(
                                self.artifact, prep[1], k)
                            if key is not None:
                                if len(self._plan_memo) > (1 << 16):
                                    self._plan_memo.clear()
                                self._plan_memo[pk] = (mode, raw)
                        res = nat.top_k_bm25_fast(prep[0], k, mode)
                        if key is None:
                            nat.free_prep(prep[0])
                    if res is not None:
                        pairs, scored, skipped, ncand = res
                        self._c_native_ops.inc()
                        self.planner.note_ranked(
                            mode, scored, skipped, ncand,
                            backend="native")
                        return pairs
                    self._c_native_fallback.inc()
            if occ and k > 0 and len(occ) <= 2:
                out = self._top_k_small(occ, k, coll)
                if out is not None:
                    return out
            mode = self.planner.plan_ranked(
                self.artifact, [int(self._df[i]) for i in occ], k)
            if mode != "exhaustive":
                return self._top_k_pruned(occ, k, mode, coll)
            out = self._top_k_exhaustive(occ, k)
            self.planner.note_ranked("exhaustive", 0, 0, len(out))
            return out
        finally:
            self._h_topk.observe(time.perf_counter() - t0)

    def top_k_scored_batch(self, batches, k: int):
        """Answer a coalesced group of ranked queries — the daemon /
        scale-out-router micro-batch regime — returning one
        ``top_k_scored`` result list per encoded batch, byte-identical
        to issuing them serially.

        With the native backend every warm query in the group resolves
        to a prepared id and the whole group crosses into C ONCE
        (``mri_serve_topk_batch``), amortizing the per-call dispatch
        (ctypes marshalling, latency observation, planner accounting)
        that dominates single-query serving on small corpora.  Cold
        queries, attribution-collected requests, and the numpy backend
        all take the per-query path, so semantics (memo fills, EXPLAIN
        spans, counters) are unchanged."""
        if k <= 0 or self._native_mode == "0" \
                or obs_attrib.active() is not None:
            return [self.top_k_scored(b, k) for b in batches]
        nat = self._native_handle()
        if nat is None:
            return [self.top_k_scored(b, k) for b in batches]
        t0 = time.perf_counter()
        out: list = [None] * len(batches)
        pids = self._ba_pids
        modes_i = self._ba_modes
        del pids[:]
        del modes_i[:]
        ncold = 0
        raw = _planner_raw_token()
        bmk = self._batch_memo.get(k)
        if bmk is None:
            bmk = self._batch_memo[k] = {}
        bm_get = bmk.get
        app_p = pids.append
        app_m = modes_i.append
        for qi, batch in enumerate(batches):
            key = batch.tobytes() if isinstance(batch, np.ndarray) \
                else None
            ent = bm_get(key) if key is not None else None
            if ent is None or ent[3] != raw:
                prep = self._nat_prep.get(key) if key is not None \
                    else None
                occ = self._occ_memo.get(key) if key is not None \
                    else None
                if prep is None or occ is None:
                    # cold query: the single path fills every memo
                    # (occ, prep, plan) so the next group runs warm
                    out[qi] = self.top_k_scored(batch, k)
                    ncold += 1
                    continue
                mode = self.planner.plan_ranked(
                    self.artifact, prep[1], k)
                ent = (prep[0], mode, nat.MODES[mode], raw)
                if len(bmk) > (1 << 16):
                    bmk.clear()
                bmk[key] = ent
            app_p(ent[0])
            app_m(ent[2])
        if pids:
            nq = len(pids)
            res = nat.top_k_bm25_batch(pids, modes_i, nq, k)
            if res is None:
                self._c_native_fallback.inc()
                for qi in range(len(batches)):
                    if out[qi] is None:
                        out[qi] = self.top_k_scored(batches[qi], k)
            else:
                pairs_list, scored, skipped, ncand = res
                self._c_native_ops.inc(nq)
                counts = {}
                for ci, nm in enumerate(nat.MODE_NAMES):
                    c = modes_i.count(ci)
                    if c:
                        counts[nm] = c
                self.planner.note_ranked_batch(
                    counts, nat.MODE_NAMES[modes_i[-1]],
                    scored, skipped, ncand, backend="native")
                if ncold == 0:
                    out = pairs_list
                else:
                    it = iter(pairs_list)
                    for qi in range(len(batches)):
                        if out[qi] is None:
                            out[qi] = next(it)
            # one ranked-op latency observation for the fused group
            # (cold queries above observed their own)
            self._h_topk.observe(time.perf_counter() - t0)
        return out

    def _top_k_small(self, occ: list[int], k: int, coll=None):
        """Lean 1-2 occurrence ranked path over memoized contributions.

        The Zipf-head query mix is dominated by short queries whose
        terms' contributions are already in ``_score_memo``; for those
        this path replaces the general TAAT machinery with a handful of
        numpy calls: dense-accumulate the memoized contributions (the
        exhaustive float addition order, so scores stay byte-identical)
        and, under bmw/maxscore, drop every doc provably below theta =
        the best single-term k-th contribution BEFORE the selection
        sort.  Returns None when a term isn't memoized yet or the
        corpus is too large for a dense throwaway accumulator — the
        general paths handle the query and fill the memo."""
        memo = self._score_memo
        h1 = memo.get(occ[0])
        if h1 is None:
            return None
        docs1, c1, srt1 = h1
        n1 = len(docs1)
        art = self.artifact
        planner = self.planner
        margin = planner_mod.THETA_MARGIN
        mode = planner.resolve_cached()
        if len(occ) == 1 or occ[1] == occ[0]:
            w = float(len(occ))
            # same plan the general dispatch would make (dfs has one
            # entry per occurrence, duplicates included)
            if mode != "exhaustive" and art.has_block_scores \
                    and k < n1 * len(occ):
                if mode == "auto":
                    mode = "bmw" if n1 > 4 * art.block_size \
                        else "maxscore"
                scores = c1 if w == 1.0 else w * c1
                theta = w * float(srt1[k - 1]) if n1 >= k else 0.0
                if coll is not None:
                    coll.theta(theta)
                if theta > 0.0:
                    keep = scores >= theta * margin
                    cand, sc = docs1[keep], scores[keep]
                else:
                    cand, sc = docs1, scores
                planner.note_ranked(mode, 0, 0, len(cand))
                order = np.lexsort((cand, -sc))[:k]
                top = cand[order]
                return list(zip(top.tolist(), sc[order].tolist()))
            out = self._top_k_exhaustive(occ, k)
            planner.note_ranked("exhaustive", 0, 0, len(out))
            return out
        h2 = memo.get(occ[1])
        if h2 is None:
            return None
        docs2, c2, srt2 = h2
        n2 = len(docs2)
        doc_lens, _, _ = self._bm25_corpus()
        ndocs = len(doc_lens)
        if ndocs > (1 << 16):
            return None
        if mode == "exhaustive" or not art.has_block_scores \
                or k >= n1 + n2:
            out = self._top_k_exhaustive(occ, k)
            planner.note_ranked("exhaustive", 0, 0, len(out))
            return out
        if mode == "auto":
            mode = "bmw" if max(n1, n2) > 4 * art.block_size \
                else "maxscore"
        scores = np.zeros(ndocs, dtype=np.float64)
        scores[docs1] = c1
        scores[docs2] += c2
        theta = float(srt1[k - 1]) if n1 >= k else 0.0
        if n2 >= k:
            t2 = float(srt2[k - 1])
            if t2 > theta:
                theta = t2
        if coll is not None:
            coll.theta(theta)
        if theta > 0.0:
            cand = (scores >= theta * margin).nonzero()[0]
        else:
            cand = (scores > 0.0).nonzero()[0]
        sc = scores[cand]
        planner.note_ranked(mode, 0, 0, len(cand))
        order = np.lexsort((cand, -sc))[:k]
        top = cand[order]
        return list(zip(top.tolist(), sc[order].tolist()))

    def _top_k_exhaustive(self, occ: list[int], k: int
                          ) -> list[tuple[int, float]]:
        """Score every posting of every query term into a dense
        accumulator — the reference evaluation the pruned paths must
        reproduce byte-for-byte.  Per-term contributions come from
        :meth:`_term_scores` (identical expression, memoized), added in
        occurrence order exactly as the inline loop always did."""
        doc_lens, ndocs, avgdl = self._bm25_corpus()
        scores = np.zeros(len(doc_lens), dtype=np.float64)
        for i in occ:
            docs, contrib, _ = self._term_scores(i)
            scores[docs] += contrib
        cand = np.nonzero(scores > 0.0)[0]
        top = cand[np.lexsort((cand, -scores[cand]))][:max(k, 0)]
        return [(int(d), float(scores[d])) for d in top]

    def _term_scores(self, i: int) -> tuple:
        """``(docs, contrib, contrib_sorted_desc)`` for lex term ``i``.

        ``contrib`` holds the term's BM25 contribution at each of its
        docs, computed with exactly the exhaustive scorer's expression
        so pruned partial sums stay elementwise bit-equal; the values
        are query-independent, so they memoize per engine."""
        hit = self._score_memo.get(i)
        if hit is not None:
            return hit
        doc_lens, ndocs, avgdl = self._bm25_corpus()
        k1, b = BM25_K1, BM25_B
        # int64 up front: fancy indexing with int32 index arrays pays a
        # per-query widening conversion that doubles its cost
        docs = self.postings_by_index(i).astype(np.int64)
        tf = self.tf_by_index(i).astype(np.float64)
        dfi = self._scoring_df(i, len(docs))
        idf = np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5))
        denom = tf + k1 * (1.0 - b + b * doc_lens[docs] / avgdl)
        contrib = idf * tf * (k1 + 1.0) / denom
        docs.setflags(write=False)
        contrib.setflags(write=False)
        srt = np.sort(contrib)[::-1]
        if len(self._score_memo) >= self._memo_cap:
            self._score_memo.clear()
        self._score_memo[i] = (docs, contrib, srt)
        return self._score_memo[i]

    def _term_bounds(self, i: int) -> tuple:
        """``(per-block upper bounds, their max)`` for lex term ``i``
        on a v2.1 artifact (float64, memoized)."""
        hit = self._bound_memo.get(i)
        if hit is not None:
            return hit
        doc_lens, ndocs, avgdl = self._bm25_corpus()
        dfi = self._scoring_df(i, int(self._df[i]))
        idf = np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5))
        ubs = planner_mod.block_upper_bounds(
            self.artifact, i, idf, avgdl, BM25_K1, BM25_B)
        if len(self._bound_memo) >= self._memo_cap:
            self._bound_memo.clear()
        self._bound_memo[i] = (ubs, float(ubs.max()) if len(ubs)
                               else 0.0)
        return self._bound_memo[i]

    def _decode_block_scores(self, i: int, need: np.ndarray, b0: int
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Decode only blocks ``need`` (term-relative) of term ``i``
        and score them: ``(docs ascending, contrib)`` — contributions
        elementwise bit-equal to :meth:`_term_scores` values."""
        art = self.artifact
        sel = need + b0
        ids, cnt = art.decode_blocks(sel)
        tfm, _ = art.decode_tf_blocks(sel)
        nbytes = int((art.blk_woff[sel + 1] - art.blk_woff[sel]).sum()) * 4
        self._c_blocks_decoded.inc(len(need))
        self._c_bytes_decoded.inc(nbytes)
        coll = obs_attrib.active()
        if coll is not None:
            coll.decoded(len(need), nbytes)
        mask = np.arange(ids.shape[1])[None, :] < cnt[:, None]
        docs = ids[mask].astype(np.int64)
        tf = tfm[mask].astype(np.float64)
        doc_lens, ndocs, avgdl = self._bm25_corpus()
        k1, b = BM25_K1, BM25_B
        dfi = self._scoring_df(i, int(self._df[i]))
        idf = np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5))
        denom = tf + k1 * (1.0 - b + b * doc_lens[docs] / avgdl)
        return docs, idf * tf * (k1 + 1.0) / denom

    def _top_k_pruned(self, occ: list[int], k: int, mode: str,
                      coll=None) -> list[tuple[int, float]]:
        """MaxScore / Block-Max WAND top-k over the v2.1 bound columns.

        Terms are processed in descending weighted-upper-bound order.
        While the remaining terms' summed bounds can still reach the
        heap threshold theta, a term is *essential*: all its postings
        are admitted as candidates.  Past that point a term can only
        reorder docs already above threshold: candidates that provably
        cannot reach theta are dropped, and (bmw) only blocks whose
        quantized bound clears theta — or that hold a surviving
        candidate — are decoded at all.  Theta is the running k-th best
        partial score, monotonically nondecreasing, and every
        comparison carries ``THETA_MARGIN`` slack so float
        associativity can never prune a true top-k doc.  Survivor
        scores are finally re-accumulated in the query's occurrence
        order — the exhaustive addition order — which makes the
        returned (doc, score) pairs byte-identical to exhaustive
        evaluation.  (Queries with <= 2 scoring occurrences skip that
        rescore: sums of one or two floats are order-independent.)"""
        if k <= 0 or not occ:
            self.planner.note_ranked(mode, 0, 0, 0)
            return []
        margin = planner_mod.THETA_MARGIN
        art = self.artifact
        weight: dict[int, int] = {}
        for i in occ:
            weight[i] = weight.get(i, 0) + 1
        terms = []
        for i, w in weight.items():
            ubs, umax = self._term_bounds(i)
            terms.append((i, float(w), float(w) * umax, ubs))
        terms.sort(key=lambda t: (-t[2], t[0]))
        n = len(terms)
        suffix = [0.0] * (n + 1)
        for p in range(n - 1, -1, -1):
            suffix[p] = suffix[p + 1] + terms[p][2]
        theta = 0.0
        cand = scores = None  # ascending int64 docs + aligned partials
        scored = skipped = 0
        shift = art.block_size.bit_length() - 1
        for pos, (i, w, wu, ubs) in enumerate(terms):
            nb = len(ubs)
            thr = theta * margin
            if theta <= 0.0 or suffix[pos] >= thr:
                # essential: admit every posting of this term
                docs, contrib, srt = self._term_scores(i)
                add = contrib if w == 1.0 else w * contrib
                scored += nb
                if cand is None:
                    cand = docs  # int64 already, never mutated
                    scores = np.array(add, dtype=np.float64)
                    if len(srt) >= k:
                        theta = w * float(srt[k - 1])
                        if coll is not None:
                            coll.theta(theta)
                    continue
                cand, scores = _union_add(cand, scores, docs, add)
            else:
                # non-essential: drop hopeless candidates first
                keep = scores + suffix[pos] >= thr
                cand, scores = cand[keep], scores[keep]
                cached = self._score_memo.get(i)
                if cached is not None:
                    docs, contrib, _ = cached
                    pos2 = np.searchsorted(docs, cand)
                    ok = pos2 < len(docs)
                    ok[ok] = docs[pos2[ok]] == cand[ok]
                    hitpos = pos2[ok]
                    add = contrib[hitpos]
                    if w != 1.0:
                        add = w * add
                    if mode == "bmw":
                        # exact per-doc bounds are available for free:
                        # admit any doc this term alone could still
                        # push past theta
                        live = w * contrib + suffix[pos + 1] >= thr \
                            if w != 1.0 \
                            else contrib + suffix[pos + 1] >= thr
                        live[hitpos] = False
                        new = np.nonzero(live)[0]
                        if len(new):
                            # admit at zero and let the probe below
                            # add the contribution exactly once
                            cand, scores = _union_add(
                                cand, scores, docs[new],
                                np.zeros(len(new)))
                            pos2 = np.searchsorted(docs, cand)
                            ok = pos2 < len(docs)
                            ok[ok] = docs[pos2[ok]] == cand[ok]
                            hitpos = pos2[ok]
                            add = contrib[hitpos]
                            if w != 1.0:
                                add = w * add
                    scores[ok] += add
                    touched = len(np.unique(hitpos >> shift)) \
                        if len(hitpos) else 0
                    scored += touched
                    skipped += nb - touched
                else:
                    b0 = int(art.term_block_off[i])
                    blk = np.searchsorted(art.blk_max[b0:b0 + nb], cand)
                    hitb = blk[blk < nb]
                    if mode == "bmw":
                        seed = np.nonzero(
                            w * ubs + suffix[pos + 1] >= thr)[0]
                        need = np.union1d(hitb, seed)
                    else:
                        need = np.unique(hitb)
                    need = need.astype(np.int64)
                    scored += len(need)
                    skipped += nb - len(need)
                    self._c_blocks_skipped.inc(nb - len(need))
                    if coll is not None:
                        coll.skipped(nb - len(need))
                    if len(need) >= nb:
                        # no block escaped — decode the whole term
                        # through the memoizing path instead (bit-equal
                        # values), so later queries over this term take
                        # the cached arm / the lean small-query path
                        docs, contrib, _ = self._term_scores(i)
                        cand, scores = _union_add(
                            cand, scores, docs,
                            contrib if w == 1.0 else w * contrib)
                    elif len(need):
                        docs, contrib = self._decode_block_scores(
                            i, need, b0)
                        # admitting every decoded doc (a superset of
                        # the candidates) is safe: a doc first seen
                        # here was provably below theta at every
                        # earlier term, so it can only be pruned or
                        # rescored exactly below the k-th best
                        cand, scores = _union_add(
                            cand, scores, docs,
                            contrib if w == 1.0 else w * contrib)
            if len(cand) >= k:
                kth = float(np.partition(
                    scores, len(scores) - k)[len(scores) - k])
                if kth > theta:
                    theta = kth
                    if coll is not None:
                        coll.theta(theta)
        if len(occ) > 2:
            if theta > 0.0:
                keep = scores >= theta * margin
                cand, scores = cand[keep], scores[keep]
            scores = self._rescore(occ, cand)
        self.planner.note_ranked(mode, scored, skipped, len(cand))
        pos3 = scores > 0.0
        cand, scores = cand[pos3], scores[pos3]
        order = np.lexsort((cand, -scores))[:k]
        return [(int(cand[j]), float(scores[j])) for j in order]

    def _rescore(self, occ: list[int], cand: np.ndarray) -> np.ndarray:
        """Re-accumulate the survivors' scores term-by-term in query
        occurrence order — the exhaustive path's float addition order —
        so a pruned 3+-term query returns byte-identical scores even
        though its partial sums were built bound-first."""
        art = self.artifact
        out = np.zeros(len(cand), dtype=np.float64)
        if not len(cand):
            return out
        for i in occ:
            cached = self._score_memo.get(i)
            if cached is not None:
                docs, contrib, _ = cached
            else:
                b0 = int(art.term_block_off[i])
                b1 = int(art.term_block_off[i + 1])
                blk = np.searchsorted(art.blk_max[b0:b1], cand)
                hitb = np.unique(blk[blk < (b1 - b0)]).astype(np.int64)
                if not len(hitb):
                    continue
                docs, contrib = self._decode_block_scores(i, hitb, b0)
            pos = np.searchsorted(docs, cand)
            ok = pos < len(docs)
            ok[ok] = docs[pos[ok]] == cand[ok]
            out[ok] += contrib[pos[ok]]
        return out

    # -- bookkeeping ----------------------------------------------------

    @property
    def cache(self) -> LRUCache:
        return self._cache

    def cache_stats(self) -> dict:
        return self._cache.stats()

    def op_stats(self) -> dict:
        return self._ops.stats()

    def decode_stats(self) -> dict:
        """Skip/decode counters — the gallop win, observable."""
        return {
            "blocks_decoded": self._c_blocks_decoded.value,
            "blocks_skipped": self._c_blocks_skipped.value,
            "bytes_decoded": self._c_bytes_decoded.value,
        }

    def describe(self) -> dict:
        """Engine identity + counters for ``mri query --stats``."""
        return {
            "engine": self.engine_name,
            "format": self.artifact.version,
            "vocab": self.vocab_size,
            "artifact_bytes": self.artifact.nbytes,
            "cache": self.cache_stats(),
            "ops": self.op_stats(),
            "decode": self.decode_stats(),
            "planner": self.planner.describe(),
            "native": {
                "mode": self._native_mode,
                "active": self._native is not None,
                "error": self._native_err,
                "ops": self._c_native_ops.value,
                "fallbacks": self._c_native_fallback.value,
            },
        }

    def close(self) -> None:
        self._close_native()
        self._cache.clear()
        self._tf_cache.clear()
        self._memo.clear()
        self._score_memo.clear()
        self._bound_memo.clear()
        self._occ_memo.clear()
        self._idf_memo.clear()
        self._bm25_cols = None
        self._df = self._keys = self._terms = self._rows = None
        self.artifact.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# The raw $MRI_SERVE_PLANNER token, for the native ranked-plan memo: the
# planner re-reads the variable on every call so a flip takes effect at
# once, and the memo must invalidate on the same signal.  CPython's
# os.environ backing dict returns the raw token without the decode layer
# (about 4x cheaper on the warm path); elsewhere the portable getter.
try:
    _PLAN_ENV_DB = os.environ._data
    _PLAN_ENV_KEY = os.environ.encodekey(planner_mod.PLANNER_ENV)
    _PLAN_ENV_DB.get(_PLAN_ENV_KEY)
except Exception:  # pragma: no cover - non-CPython environ layout
    _PLAN_ENV_DB, _PLAN_ENV_KEY = None, None


def _planner_raw_token():
    """The raw (undecoded) $MRI_SERVE_PLANNER value, or ``None``."""
    if _PLAN_ENV_DB is not None:
        return _PLAN_ENV_DB.get(_PLAN_ENV_KEY)
    return os.environ.get(planner_mod.PLANNER_ENV)


def resolve_native(mode: str | None = None) -> str:
    """``auto``/``0``/``1`` (+ $MRI_SERVE_NATIVE default), validated;
    resolved once per engine."""
    mode = mode or envknobs.get(NATIVE_ENV)
    if mode not in NATIVE_CHOICES:
        raise ValueError(f"unknown native mode {mode!r} (choices: {NATIVE_CHOICES})")
    return mode


def resolve_score(score: str | None = None) -> str:
    """``df``/``bm25`` (+ ``$MRI_SERVE_SCORE`` default) -> the mode."""
    score = score or envknobs.get(SCORE_ENV)
    if score not in SCORE_CHOICES:
        raise ValueError(f"unknown score mode {score!r} (choices: {SCORE_CHOICES})")
    return score


def resolve_engine(engine: str | None = None) -> str:
    """``host``/``device``/``auto``: the flag, else ``$MRI_SERVE_ENGINE``,
    else ``device`` — this package's entry points run on the card unless
    the caller asks otherwise (the JAX package defaults to ``auto``)."""
    engine = engine or envknobs.get(ENGINE_ENV) or "device"
    if engine not in ENGINE_CHOICES:
        raise ValueError(f"unknown engine {engine!r} (choices: {ENGINE_CHOICES})")
    return engine


class AutoEngine:
    """Crossover router over the host engine and the device engine.

    Answers every query from the host engine until a batch at least
    ``PROBE_BATCH_MIN`` wide arrives; that first batch races the two
    engines (each warmed once, then best of 3 ``df`` calls, the device
    leg's fetch included) and the winner fixes the routing for the
    engine's lifetime (``describe()["auto"]`` records the probe).
    ``$MRI_SERVE_CROSSOVER`` replaces the probe: 0 pins the host, N > 0
    routes batches of N or more to the device engine.  Only the
    batch-shaped single-term ops (df, postings, lookup) route; compound
    and ranked queries stay on the host engine, whose planner owns the
    pruning.

    The device engine is built on ``device`` (``cuda`` when None) at
    first need.  Unlike the JAX router, a device engine that cannot be
    built raises to the caller — it is never replaced by the host in
    silence; a missing card raises ``DeviceUnavailable`` here, at
    construction, unless the crossover pins the host.
    """

    engine_name = "auto"

    def __init__(self, path, cache_terms: int = 4096, device=None,
                 shards: int | None = None):
        import torch

        from ..models.inverted_index import resolve_device

        self._fixed = envknobs.get(CROSSOVER_ENV)
        self._device_name = "cuda" if device is None else str(device)
        if self._fixed != 0:
            resolve_device(torch.device(self._device_name).type)
        self._host = Engine(path, cache_terms=cache_terms)
        self._path = path
        self._cache_terms = cache_terms
        self._shards = shards
        self._device = None
        self._measured: int | None = None
        self._probe: dict | None = None

    # -- delegation -----------------------------------------------------

    @property
    def artifact(self):
        return self._host.artifact

    @property
    def vocab_size(self):
        return self._host.vocab_size

    @property
    def metrics(self):
        return self._host.metrics

    @property
    def planner(self):
        return self._host.planner

    @property
    def cache(self):
        return self._host.cache

    @property
    def device_engine(self):
        """The device engine, or None until a batch first routes there."""
        return self._device

    def __getattr__(self, name):
        # everything not routing-sensitive answers from the host engine
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._host, name)

    # -- routing --------------------------------------------------------

    def _get_device(self):
        if self._device is None:
            from .device_engine import DeviceEngine
            self._device = DeviceEngine(self._path, cache_terms=self._cache_terms,
                                        device=self._device_name, shards=self._shards)
        return self._device

    def _run_probe(self, batch) -> None:
        """Race both engines on this batch, best of 3 each, once."""
        dev = self._get_device()
        host_s = dev_s = float("inf")
        for eng in (self._host, dev):
            eng.df(batch)  # warm caches and the device's first launches
        for _ in range(3):
            t0 = time.perf_counter()
            self._host.df(batch)
            host_s = min(host_s, time.perf_counter() - t0)
            t0 = time.perf_counter()
            dev.df(batch)  # numpy out: the fetch is inside the time
            dev_s = min(dev_s, time.perf_counter() - t0)
        self._measured = len(batch) if dev_s < host_s else 1 << 62
        self._probe = {"batch": len(batch), "host_s": host_s, "device_s": dev_s,
                       "winner": "device" if dev_s < host_s else "host"}

    def _pick(self, batch):
        n = len(batch)
        if self._fixed is not None:
            if self._fixed > 0 and n >= self._fixed:
                return self._get_device()
            return self._host
        if n < PROBE_BATCH_MIN:
            return self._host
        if self._measured is None:
            self._run_probe(batch)
        if n >= self._measured:
            return self._get_device()
        return self._host

    # -- query API ------------------------------------------------------

    # Every op below is pure routing: the chosen engine times the op and
    # feeds the attribution collector itself.

    def encode_batch(self, terms):
        return self._host.encode_batch(terms)

    def lookup(self, batch):
        return self._pick(batch).lookup(batch)

    def df(self, batch):
        return self._pick(batch).df(batch)

    def postings(self, batch):
        return self._pick(batch).postings(batch)

    def query_and(self, batch):
        return self._host.query_and(batch)

    def query_or(self, batch):
        return self._host.query_or(batch)

    def top_k(self, letter, k):
        return self._host.top_k(letter, k)

    def top_k_scored(self, batch, k):
        return self._host.top_k_scored(batch, k)

    def top_k_scored_batch(self, batches, k):
        return self._host.top_k_scored_batch(batches, k)

    # -- bookkeeping ----------------------------------------------------

    def describe(self) -> dict:
        """The host engine's ``describe()`` with ``engine: auto`` and an
        ``auto`` block: the crossover, the probe and whether the device
        engine is built."""
        d = self._host.describe()
        d["engine"] = self.engine_name
        d["auto"] = {
            "crossover": self._fixed if self._fixed is not None else self._measured,
            "probe": self._probe,
            "device_ready": self._device is not None,
        }
        return d

    def close(self) -> None:
        if self._device is not None:
            self._device.close()
            self._device = None
        self._host.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _sidecar_refusal(path) -> str | None:
    """Why ``path`` is a directory this package cannot serve yet, or None."""
    p = Path(path)
    side = (p if p.is_dir() else p.parent) / CLUSTER_SIDECAR_NAME
    if side.exists():
        return (f"{path} is a cluster shard ({CLUSTER_SIDECAR_NAME} present): "
                "the shard engine is not ported yet (ROADMAP A15b)")
    if artifact_mod.is_segment_managed(path):
        return (f"{path} is segment-managed ({artifact_mod.SEGMENTS_MANIFEST_NAME} "
                "present): the multi-segment engine is not ported yet (ROADMAP A15b)")
    return None


def create_engine(path, engine: str | None = None, *, cache_terms: int = 4096,
                  shards: int | None = None, device=None):
    """Open ``path`` with the selected engine (:data:`ENGINE_CHOICES`,
    :func:`resolve_engine`); ``device`` is the device engine's, alone or
    inside ``auto`` (``cuda`` when None), and ``shards`` sizes its batch
    mesh (the JAX meaning: None is ``$MRI_SERVE_SHARDS``, else every
    visible card).  All engines answer the same API with the same
    answers.  A cluster shard or a segment-managed directory raises
    ``ArtifactError``."""
    which = resolve_engine(engine)
    why = _sidecar_refusal(path)
    if why is not None:
        raise artifact_mod.ArtifactError(why)
    if which == "device":
        from .device_engine import DeviceEngine
        return DeviceEngine(path, cache_terms=cache_terms, device=device, shards=shards)
    if which == "auto":
        return AutoEngine(path, cache_terms=cache_terms, device=device, shards=shards)
    return Engine(path, cache_terms=cache_terms)
