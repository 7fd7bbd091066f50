"""Scatter-gather query engine over a live segment set.

One :class:`MultiSegmentEngine` serves a directory managed by the
incremental-indexing layer (``segments.manifest.json``).  Every query
fans out over per-segment :class:`~.engine.Engine` instances — each
running the unchanged single-artifact code paths, BMW/MaxScore pruning
included — and the per-segment answers are merged exactly (broadcast
the batch, reduce the per-segment partials).  This is the JAX package's
``serve/multi_engine.py``: like it, it runs on the host (the reference
has no device multi-segment engine), and its answers equal it exactly,
BM25 floats and tie order included.  Segments own disjoint global doc-id ranges
``(doc_base, doc_base + docs]``, so boolean/postings merges are plain
offset-shifted concatenations and ranked merges are a heap over
per-segment candidate lists.

Byte-identity with a from-scratch single-artifact build of the same
live corpus state is a design invariant, not an approximation:

* global ``ndocs``/``avgdl`` are computed from the concatenated
  per-segment doc-length columns (tombstoned slots zeroed), which is
  elementwise the same float64 sequence the from-scratch artifact
  yields — same ``np.count_nonzero``, same ``mean()``;
* each segment engine gets those globals plus a global live-df
  callable through :meth:`~.engine.Engine.set_corpus_override`, so
  every per-(term, doc) BM25 contribution is computed by the same
  expression over the same operands;
* per-segment top-k asks for ``k + tomb_count`` candidates (a
  tombstoned doc can displace at most one live one), filters
  tombstones, and the global merge picks k by ``(-score, doc_id)`` —
  the single-engine tie order.

Deletes are visible immediately: tombstone bitmaps load with the
manifest generation and every query path filters through them.  The
engine is immutable per generation — mutations publish a new manifest
and the daemon swaps in a freshly opened engine, exactly like a hot
reload.
"""

from __future__ import annotations

import heapq

import numpy as np

from . import artifact as artifact_mod
from . import engine as engine_mod
from ..obs import attribution as obs_attrib
from ..obs import metrics as obs_metrics
from ..segments import manifest as seg_manifest
from ..segments import tombstones as tomb_mod


def merge_ranked(per_part, k: int) -> list[tuple[int, float]]:
    """Gather a ranked answer from per-part candidate lists.

    Each part is a list of ``(-score, global_doc_id)`` pairs already
    sorted ascending — i.e. best-first by ``(-score, gid)``, the
    single-engine tie order.  A D-way :func:`heapq.merge` pops exactly
    ``k`` winners without materializing the rest; parts may be empty.
    Shared by :class:`MultiSegmentEngine` (parts = segments) and the
    cluster router (parts = doc-shards answering over TCP).
    """
    out: list[tuple[int, float]] = []
    if k <= 0:
        return out
    for neg, gid in heapq.merge(*per_part):
        out.append((gid, -neg))
        if len(out) == k:
            break
    return out


def merge_doc_ids(parts) -> np.ndarray:
    """Gather one globally ascending int32 doc-id array from per-part
    ascending arrays over disjoint id sets.  Parts covering ascending
    disjoint *ranges* (segments in doc_base order) concatenate as-is;
    interleaved id sets (round-robin doc shards) take the sort arm —
    either way the output is what a monolithic engine would return.
    """
    parts = [np.asarray(p, dtype=np.int64) for p in parts if len(p)]
    if not parts:
        return np.zeros(0, dtype=np.int32)
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    if len(out) > 1 and not (np.diff(out) > 0).all():
        out = np.sort(out, kind="mergesort")
    return out.astype(np.int32)


class ShardRestrictedOracle:
    """The monolith's answers restricted to a covered subset of doc
    shards — the byte-parity contract a *partial* cluster answer is
    held to.

    When the router degrades under ``partial_policy: allow`` (a shard's
    replica set exhausted, its leg timed out), the gathered answer must
    equal what a monolithic engine over the full corpus would return
    with the missing shards' documents erased: doc shards are disjoint
    and every shard scores with the injected GLOBAL BM25 stats, so
    dropping a leg drops exactly that shard's docs from the merge and
    nothing else.  This wrapper computes that reference answer from an
    ordinary full-corpus :class:`~.engine.Engine` plus the covered gid
    set, mirroring the router's merge rules:

    * ``df`` — live df restricted to covered docs (the sum the router
      takes over answered shards' local dfs);
    * ``postings`` — covered docs only, ``None`` when no covered doc
      holds the term (the router emits ``None`` when every answered
      part is ``None``);
    * ``query_and`` / ``query_or`` — covered docs only;
    * ``top_k_scored`` — the full ranking filtered to covered docs,
      then cut to k (scores are the monolith's floats untouched);
    * ``top_k`` (letter) — terms re-ranked by restricted df,
      zero-coverage terms dropped, ``(-df, term)`` order.

    Test harness infrastructure: exactness over completeness —
    everything is recomputed per call from the base engine.
    """

    def __init__(self, engine, covered_gids):
        self._eng = engine
        self._covered = frozenset(int(g) for g in covered_gids)

    @classmethod
    def round_robin(cls, engine, shards: int, covered,
                    total_docs: int | None = None):
        """Covered set for the partition tool's default assignment
        (gid ``g`` lives on shard ``(g - 1) % shards``)."""
        if total_docs is None:
            total_docs = int(engine.artifact.max_doc_id)
        cov = frozenset(int(s) for s in covered)
        gids = [g for g in range(1, total_docs + 1)
                if (g - 1) % shards in cov]
        return cls(engine, gids)

    def _mask(self, docs: np.ndarray) -> np.ndarray:
        if not len(docs):
            return np.asarray(docs, dtype=np.int32)
        keep = np.array([int(d) in self._covered for d in docs])
        return np.asarray(docs, dtype=np.int32)[keep]

    def df(self, batch) -> np.ndarray:
        out = np.zeros(len(batch), dtype=np.int64)
        for j, col in enumerate(self._eng.postings(batch)):
            if col is not None:
                out[j] = len(self._mask(col))
        return out

    def postings(self, batch) -> list[np.ndarray | None]:
        cols = []
        for col in self._eng.postings(batch):
            col = self._mask(col) if col is not None else col
            cols.append(col if col is not None and len(col) else None)
        return cols

    def query_and(self, batch) -> np.ndarray:
        return self._mask(self._eng.query_and(batch))

    def query_or(self, batch) -> np.ndarray:
        return self._mask(self._eng.query_or(batch))

    def top_k_scored(self, batch, k: int) -> list[tuple[int, float]]:
        if k <= 0:
            return []
        # the monolith's COMPLETE ranking (every OR candidate), then
        # filter: a covered doc's rank among covered docs is its
        # monolith rank with misses deleted — same (-score, id) order
        full = self._eng.top_k_scored(
            batch, int(len(self._eng.query_or(batch))))
        return [(d, s) for d, s in full if d in self._covered][:k]

    def top_k(self, letter, k: int) -> list[tuple[bytes, int]]:
        every = self._eng.top_k(letter, self._eng.vocab_size)
        if not every:
            return []
        terms = [t for t, _ in every]
        dfs = self.df(self._eng.encode_batch(terms))
        tally = [(t, int(d)) for t, d in zip(terms, dfs) if d > 0]
        tally.sort(key=lambda kv: (-kv[1], kv[0]))
        return tally[:max(k, 0)]

    def encode_batch(self, terms) -> np.ndarray:
        return self._eng.encode_batch(terms)


class _Segment:
    """One opened segment: entry metadata, its Engine, its tombstones."""

    __slots__ = ("entry", "engine", "bits", "live_df_memo")

    def __init__(self, entry, engine, bits):
        self.entry = entry
        self.engine = engine
        self.bits = bits          # bool[docs] or None; True = deleted
        self.live_df_memo: dict[int, int] = {}

    @property
    def doc_base(self) -> int:
        return self.entry.doc_base

    def live_df(self, idx: int) -> int:
        """This segment's live (non-tombstoned) df for lex index
        ``idx``; equals the raw df when nothing here is deleted."""
        if self.bits is None:
            return int(self.engine._df[idx])
        hit = self.live_df_memo.get(idx)
        if hit is None:
            docs = self.engine.postings_by_index(idx)
            hit = int((~self.bits[docs - 1]).sum())
            self.live_df_memo[idx] = hit
        return hit

    def live_locals(self, docs: np.ndarray) -> np.ndarray:
        """Filter segment-local doc ids through the tombstone bitmap."""
        if self.bits is None or not len(docs):
            return docs
        return docs[~self.bits[np.asarray(docs, dtype=np.int64) - 1]]


class MultiSegmentEngine:
    """Batched query API over every live segment of one directory.

    Answers the same surface as :class:`~.engine.Engine` (df, postings,
    AND/OR, letter top-k, BM25 top-k, describe/close) with global doc
    ids; the daemon and CLI route here automatically when the directory
    carries a segment manifest.
    """

    engine_name = "multi"

    def __init__(self, path, cache_terms: int = 4096):
        self.root = path
        man = seg_manifest.load_manifest(path)
        if man is None:
            raise artifact_mod.ArtifactError(
                f"{path}: no segment manifest (not a live index dir)")
        self.manifest = man
        self.generation = man.generation
        self._segs: list[_Segment] = []
        try:
            for e in man.entries:
                seg_dir = seg_manifest.segment_dir(path, e.name)
                eng = engine_mod.Engine(seg_dir, cache_terms=cache_terms)
                bits = None
                if e.tombstones is not None and e.tomb_count:
                    bits = tomb_mod.load(seg_dir / e.tombstones,
                                         ndocs=e.docs)
                self._segs.append(_Segment(e, eng, bits))
        except BaseException:
            for s in self._segs:
                s.engine.close()
            raise
        self._width = max((s.engine._width for s in self._segs),
                          default=1)
        self._sdtype = f"S{self._width}"
        # global corpus stats: concatenate the per-segment doc-length
        # columns in doc_base order (zeros at tombstones and at any
        # inter-segment gap compaction left behind).  The nonzero
        # subsequence is elementwise identical to the from-scratch
        # artifact's, so ndocs and avgdl match it bit for bit.
        span = man.doc_span
        doc_lens = np.zeros(span + 1, dtype=np.float64)
        for s in self._segs:
            dl = s.engine._bm25_corpus()[0]
            e = s.entry
            n = min(len(dl), e.docs + 1)
            doc_lens[e.doc_base + 1:e.doc_base + n] = dl[1:n]
            if s.bits is not None:
                doc_lens[e.doc_base + np.nonzero(s.bits)[0] + 1] = 0.0
        self._doc_lens = doc_lens
        self._ndocs = int(np.count_nonzero(doc_lens))
        live = doc_lens[doc_lens > 0]
        # all-tombstoned corpus: avgdl 1.0 keeps the per-segment BM25
        # denominator finite (every score is filtered out anyway)
        self._avgdl = float(live.mean()) if len(live) else 1.0
        self._tomb_total = sum(e.tomb_count for e in man.entries)
        # per-term global live df, keyed by term bytes (lex indices
        # differ per segment); safe to memoize — the engine is
        # per-generation immutable
        self._global_df_memo: dict[bytes, int] = {}
        for s in self._segs:
            s.engine.set_corpus_override(
                self._ndocs, self._avgdl,
                self._df_fn_for(s))
        self.metrics = obs_metrics.Registry()
        self.metrics.gauge("mri_segments_active").set(len(self._segs))
        self.metrics.gauge("mri_generation").set(self.generation)
        self.metrics.gauge("mri_tombstoned_docs").set(self._tomb_total)
        self.metrics.gauge("mri_engine_vocab_terms").set(self.vocab_size)
        self.metrics.gauge("mri_engine_artifact_bytes").set(
            sum(e.bytes for e in man.entries))
        self._ops = engine_mod.OpTimer(registry=self.metrics)
        self._h_topk = self._ops.histogram("top_k_scored")

    # -- global stats -----------------------------------------------------

    def _df_fn_for(self, seg: _Segment):
        def df_fn(idx: int, _seg=seg) -> int:
            return self._global_live_df(_seg.engine.artifact.term(idx))
        return df_fn

    def _global_live_df(self, term: bytes) -> int:
        hit = self._global_df_memo.get(term)
        if hit is None:
            hit = 0
            for s in self._segs:
                if len(term) > s.engine._width:
                    continue
                idx, found = s.engine.lookup(
                    np.array([term], dtype=s.engine._sdtype))
                if found[0]:
                    hit += s.live_df(int(idx[0]))
            if len(self._global_df_memo) > (1 << 16):
                self._global_df_memo.clear()
            self._global_df_memo[term] = hit
        return hit

    def _seg_batch(self, seg: _Segment, batch: np.ndarray) -> np.ndarray:
        """Re-encode the global batch for one segment's width.  Terms
        longer than the segment's width are blanked BEFORE the S-dtype
        cast — a plain cast would truncate them into false matches."""
        w = seg.engine._width
        if w >= self._width:
            return batch.astype(seg.engine._sdtype)
        q = batch.astype(seg.engine._sdtype)
        long = np.array([len(t) > w for t in batch.tolist()])
        if long.any():
            q = q.copy()
            q[long] = b""
        return q

    @staticmethod
    def _seg_attrib(coll, seg: _Segment):
        """Install a per-segment child collector around one segment-
        engine call (``None`` when attribution is off); the caller
        uninstalls the returned token in a ``finally``.  The segment
        engine's own feed sites then land in the child, giving the
        explain report its per-segment breakdown."""
        if coll is None:
            return None
        return obs_attrib.install(coll.child(seg.entry.name))

    # -- term resolution --------------------------------------------------

    @property
    def vocab_size(self) -> int:
        """Distinct live terms across the segment set (terms whose
        postings are fully tombstoned still count until compaction —
        matching what a segment's vocabulary physically stores)."""
        if not self._segs:
            return 0
        if len(self._segs) == 1:
            return self._segs[0].engine.vocab_size
        cols = [s.engine._terms.astype(self._sdtype)
                for s in self._segs]
        return int(len(np.unique(np.concatenate(cols))))

    def encode_batch(self, terms) -> np.ndarray:
        return engine_mod.encode_terms(terms, self._width)

    # -- single-term answers ----------------------------------------------

    def df(self, batch) -> np.ndarray:
        """Global live document frequency per query term."""
        with self._ops.time("df"):
            q = np.asarray(batch, dtype=self._sdtype)
            out = np.zeros(len(q), dtype=np.int64)
            coll = obs_attrib.active()
            for s in self._segs:
                token = self._seg_attrib(coll, s)
                try:
                    sq = self._seg_batch(s, q)
                    idx, found = s.engine.lookup(sq)
                    if s.bits is None:
                        out += np.where(found, s.engine._df[idx], 0)
                    else:
                        for j in np.nonzero(found)[0]:
                            out[j] += s.live_df(int(idx[j]))
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
            return out

    def postings(self, batch) -> list[np.ndarray | None]:
        """Global live postings per query term; None where the term has
        no live posting anywhere (same as a from-scratch build, where
        such a term simply would not exist)."""
        with self._ops.time("postings"):
            q = np.asarray(batch, dtype=self._sdtype)
            parts: list[list[np.ndarray]] = [[] for _ in q]
            coll = obs_attrib.active()
            for s in self._segs:
                token = self._seg_attrib(coll, s)
                try:
                    sq = self._seg_batch(s, q)
                    idx, found = s.engine.lookup(sq)
                    for j in np.nonzero(found)[0]:
                        docs = s.live_locals(
                            s.engine.postings_by_index(int(idx[j])))
                        if len(docs):
                            parts[j].append(
                                docs.astype(np.int64) + s.doc_base)
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
            return [merge_doc_ids(p) if p else None for p in parts]

    # -- compound queries -------------------------------------------------

    def query_and(self, batch) -> np.ndarray:
        """Docs containing EVERY term.  Segments are independent AND
        problems (doc ranges are disjoint): each segment's own engine
        intersects with its planner/skip machinery, tombstones filter
        the result, and the shifted survivors concatenate in doc_base
        order — already globally ascending."""
        with self._ops.time("and"):
            q = np.asarray(batch, dtype=self._sdtype)
            outs = []
            coll = obs_attrib.active()
            for s in self._segs:
                token = self._seg_attrib(coll, s)
                try:
                    res = s.engine.query_and(self._seg_batch(s, q))
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
                res = s.live_locals(res)
                if len(res):
                    outs.append(res.astype(np.int64) + s.doc_base)
            return merge_doc_ids(outs)

    def query_or(self, batch) -> np.ndarray:
        """Docs containing ANY term (disjoint ranges: concat merge)."""
        with self._ops.time("or"):
            q = np.asarray(batch, dtype=self._sdtype)
            outs = []
            coll = obs_attrib.active()
            for s in self._segs:
                token = self._seg_attrib(coll, s)
                try:
                    res = s.engine.query_or(self._seg_batch(s, q))
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
                res = s.live_locals(res)
                if len(res):
                    outs.append(res.astype(np.int64) + s.doc_base)
            return merge_doc_ids(outs)

    def top_k(self, letter, k: int) -> list[tuple[bytes, int]]:
        """The letter's k highest-live-df terms across segments,
        ordered (df desc, term asc).  Note: within equal df a single
        artifact's emit order is also ascending-term, so this matches
        the single-engine answer wherever dfs are distinct or the
        artifact was produced by a packer (seed/compaction)."""
        letter = engine_mod.letter_index(letter)
        lo_b = bytes([ord("a") + letter])
        hi_b = bytes([ord("a") + letter + 1])
        with self._ops.time("top_k"):
            tally: dict[bytes, int] = {}
            coll = obs_attrib.active()
            for s in self._segs:
                token = self._seg_attrib(coll, s)
                try:
                    terms = s.engine._terms
                    lo = int(np.searchsorted(terms, np.bytes_(lo_b)))
                    hi = int(np.searchsorted(terms, np.bytes_(hi_b)))
                    for i in range(lo, hi):
                        d = s.live_df(i)
                        if d:
                            t = s.engine.artifact.term(i)
                            tally[t] = tally.get(t, 0) + d
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
            order = sorted(tally.items(), key=lambda kv: (-kv[1], kv[0]))
            return [(t, d) for t, d in order[:max(k, 0)]]

    # -- ranked retrieval -------------------------------------------------

    def top_k_scored(self, batch, k: int) -> list[tuple[int, float]]:
        """Global BM25 top-k: each segment answers ``k + tomb_count``
        from its unchanged pruned evaluators (scoring with the injected
        global stats), tombstones filter, and a heap merge picks k by
        ``(-score, doc_id)``.  Exact: a live doc in the global top k is
        outranked within its segment by at most ``k - 1`` live docs
        plus every tombstoned one."""
        import time as _time
        t0 = _time.perf_counter()
        try:
            q = np.asarray(batch, dtype=self._sdtype)
            if k <= 0:
                return []
            per_seg: list[list[tuple[float, int]]] = []
            coll = obs_attrib.active()
            for s in self._segs:
                k2 = k + s.entry.tomb_count
                token = self._seg_attrib(coll, s)
                try:
                    res = s.engine.top_k_scored(
                        self._seg_batch(s, q), k2)
                finally:
                    if token is not None:
                        obs_attrib.uninstall(token)
                if s.bits is not None:
                    res = [(d, sc) for d, sc in res
                           if not s.bits[d - 1]][:k]
                per_seg.append(
                    [(-sc, d + s.doc_base) for d, sc in res])
            # D-way heap merge on (-score, global id): per-segment
            # lists are already sorted that way (merge_ranked never
            # materializes past the k winners)
            return merge_ranked(per_seg, k)
        finally:
            self._h_topk.observe(_time.perf_counter() - t0)

    # -- bookkeeping ------------------------------------------------------

    def bm25_stats(self) -> tuple[int, float]:
        """Global ``(ndocs, avgdl)`` the segment engines score with."""
        return self._ndocs, self._avgdl

    def describe(self) -> dict:
        segs = [{
            "name": s.entry.name,
            "doc_base": s.entry.doc_base,
            "docs": s.entry.docs,
            "tombstoned": s.entry.tomb_count,
            "vocab": s.engine.vocab_size,
            "bytes": s.entry.bytes,
        } for s in self._segs]
        return {
            "engine": self.engine_name,
            "generation": self.generation,
            "segments": segs,
            "vocab": self.vocab_size,
            "ndocs": self._ndocs,
            "avgdl": self._avgdl,
            "tombstoned_docs": self._tomb_total,
            "artifact_bytes": sum(s["bytes"] for s in segs),
            "ops": self._ops.stats(),
        }

    def op_stats(self) -> dict:
        return self._ops.stats()

    def close(self) -> None:
        for s in self._segs:
            s.engine.close()
        self._segs = []
        self._global_df_memo.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
