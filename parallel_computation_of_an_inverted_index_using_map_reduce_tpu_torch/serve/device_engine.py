"""Device-resident batched query engine over ``index.mri``, in torch.

The port of the JAX package's ``serve/device_engine.py``: the artifact's
columns go up to the card ONCE, and each batch of queries is answered by
a few torch programs over them.  The batch dimension of term resolution
and of postings decode is split across ``shards`` logical shards
(``parallel/mesh.py``: shard i on ``cuda:(i % cards)``), the JAX
engine's 1-D batch mesh: the columns are replicated (one copy per card,
shared by the shards on it), a batch is padded to ``shards x pow2``
lanes, each shard resolves and decodes its contiguous slice, and the
slices are gathered in shard order — so the answers are the same at
every shard count.  Per batch:

  1. term resolution (:func:`lookup`) — ``torch.searchsorted`` over the
     8-byte big-endian term-prefix key, one int64 per term (terms are
     ``[a-z]``, so the signed order is the byte order), then a
     ``max_prefix_group``-step compare of the full fixed-width rows for
     terms that share a prefix, fused with the df gather;
  2. postings decode into a fixed-width window per term (powers of 4,
     so widths stay few): v1 gathers delta runs and takes one int32 row
     cumsum (:func:`decode_window`); v2 maps lane j statically to block
     ``j >> log2(block_size)``, reads ``blk_first`` at slot 0 and
     bit-extracts (delta - 1) elsewhere (:func:`bit_window`), and sums
     per block (:func:`decode_window_v2`).  Invalid lanes carry
     ``_SENTINEL``.  A postings batch decodes each lane at its own tier
     and scatters the valid lanes into one flat buffer, so only the
     postings come back;
  3. AND/OR over the sentinel-padded windows (:func:`bool_tail`), top-k
     by df as a ``df_order`` slice (:func:`topk_slice`), and BM25 as a
     scatter-add into a dense float32 doc-score column
     (:func:`bm25_tail`, or :func:`bm25_blocks` over the v2.1 planner's
     surviving blocks), ranked by a stable descending sort.

The host touches the card's results at two points per call, as the JAX
engine does: the resolve (whose df fixes the window width) and the
answer, each one explicit copy through pinned memory.  Query keys go up
through pinned staging, so no op waits for the card on its own.

Two orders are fixed so the card's answers do not vary from run to run:
score ties go to the lower doc id (a stable sort, as ``lax.top_k``), and
BM25 sums term-major — one ``index_add_`` per term row, whose doc ids
are unique (masked lanes add +0.0 to slot 0, exact in any order) — the
order of the JAX CPU scatter.

Every answer equals the JAX engines' (tests/test_torch_serve_*.py): df,
postings, AND, OR and top-k byte for byte; BM25 docs exactly and scores
within rel 1e-4 (float32 on the card, as in the JAX engine, whose idf
this engine takes by ``log1p`` to stay within that bound of the float64
scorer when a term is in nearly every document).
"""

from __future__ import annotations

import numpy as np
import torch

from . import artifact as artifact_mod
from . import planner as planner_mod
from .cache import LRUCache
from .engine import BM25_B, BM25_K1, encode_terms, letter_index
from ..obs import attribution as obs_attrib
from ..obs import metrics as obs_metrics
from ..obs.timing import OpTimer
from ..ops.engine import PendingFetch
from ..parallel import mesh as mesh_mod
from ..utils import envknobs

#: pad value in posting windows: larger than any doc id (guarded at
#: load), so sentinel lanes sort after every real doc.
_SENTINEL = 2 ** 31 - 1

SHARDS_ENV = "MRI_SERVE_SHARDS"
#: soft cap on decode-window elements per call (rows x width); larger
#: batches decode in chunks.
DECODE_BUDGET_ENV = "MRI_SERVE_DEVICE_DECODE_BUDGET"

#: smallest per-shard batch bucket: tiny batches all share one shape.
_MIN_LANES = 8


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n >= 1 else 1


# -- device programs: plain functions on tensors of one device -------------


def lookup(key, rows, df, q_key, q_rows, *, group: int):
    """(idx int32, found bool, df int32) per query lane: the
    ``searchsorted`` bounds of each query's 8-byte key, then a compare
    of the full rows over up to ``group`` terms sharing that key.  The
    empty (all-zero) query key is never found."""
    V = key.shape[0]
    lo = torch.searchsorted(key, q_key)
    hi = torch.searchsorted(key, q_key, right=True)
    at = lo.clamp(max=V - 1)
    found = torch.zeros(q_key.shape, dtype=torch.bool, device=q_key.device)
    for j in range(group):
        cand = (lo + j).clamp(max=V - 1)
        ok = ((lo + j) < hi) & (rows[cand] == q_rows).all(dim=1)
        at = torch.where(ok & ~found, cand, at)
        found = found | ok
    found = found & (q_key != 0)
    dfv = torch.where(found, df[at], 0)
    return at.to(torch.int32), found, dfv


def decode_window(post_offsets, postings, idx, n, *, width: int):
    """v1: (len(idx), width) sentinel-padded absolute doc ids — a gather
    of each term's delta run and one row cumsum."""
    lane = torch.arange(width, device=idx.device)
    start = post_offsets[idx.long()].long()
    pos = (start[:, None] + lane[None, :]).clamp_(max=postings.shape[0] - 1)
    valid = lane[None, :] < n[:, None]
    d = torch.where(valid, postings[pos], 0)
    docs = torch.cumsum(d, dim=1, dtype=torch.int32)
    return torch.where(valid, docs, _SENTINEL)


def bit_window(words, word_ix, off, nbits):
    """Per-lane read of an ``nbits``-bit little-endian value that starts
    ``off`` bits into word ``word_ix`` of ``words`` (int32 holding uint32
    bits, two zero pad words at the end): two word gathers and a
    shift-or in int64.  When ``off % 32 == 0`` the second word's shift
    is by 32 and the mask drops it: the read is the first word alone.
    Indices past the stream (lanes that are masked later) are clamped."""
    last = words.shape[0] - 1
    r = off & 31
    w0 = words[word_ix.clamp(max=last - 1)].long() & 0xFFFFFFFF
    w1 = words[(word_ix + 1).clamp(max=last)].long() & 0xFFFFFFFF
    val = (w0 >> r) | ((w1 << (32 - r)) & 0xFFFFFFFF)
    mask = (torch.ones_like(nbits) << nbits) - 1
    return (val & mask).to(torch.int32)


def _lanes(width: int, block_size: int, device):
    lane = torch.arange(width, device=device)
    return lane, lane & (block_size - 1), lane >> (block_size.bit_length() - 1)


def decode_window_v2(term_block_off, blk_first, blk_width, blk_woff, post_words,
                     idx, n, *, width: int, block_size: int):
    """v2 mirror of :func:`decode_window` straight from the blocked
    bitpacked layout.  Lane j maps to block ``j >> log2(block_size)``,
    slot ``j % block_size``; slot 0 reads the absolute ``blk_first``,
    every other slot its (delta - 1) plus one.  The cumsum runs PER
    BLOCK, so a partly filled block's tail never reaches the next."""
    lane, s, qb = _lanes(width, block_size, idx.device)
    bl = (term_block_off[idx.long()].long()[:, None] + qb[None, :]).clamp_(
        max=blk_first.shape[0] - 1)
    w = blk_width[bl].long()
    off = (s - 1).clamp(min=0)[None, :] * w
    delta = bit_window(post_words, blk_woff[bl].long() + (off >> 5), off, w) + 1
    vals = torch.where(s[None, :] == 0, blk_first[bl], delta)
    if width <= block_size:
        docs = torch.cumsum(vals, dim=1, dtype=torch.int32)
    else:
        T = vals.shape[0]
        docs = torch.cumsum(vals.view(T, width // block_size, block_size), dim=2,
                            dtype=torch.int32).view(T, width)
    valid = lane[None, :] < n[:, None]
    return torch.where(valid, docs, _SENTINEL)


def tf_window_v2(term_block_off, blk_tf_width, blk_tf_woff, tf_words, idx, n, *,
                 width: int, block_size: int):
    """(len(idx), width) term frequencies aligned with
    :func:`decode_window_v2` (slot s reads packed value s, no sum).
    Invalid lanes carry 0."""
    lane, s, qb = _lanes(width, block_size, idx.device)
    bl = (term_block_off[idx.long()].long()[:, None] + qb[None, :]).clamp_(
        max=blk_tf_width.shape[0] - 1)
    tw = blk_tf_width[bl].long()
    off = s[None, :] * tw
    tf = bit_window(tf_words, blk_tf_woff[bl].long() + (off >> 5), off, tw) + 1
    valid = lane[None, :] < n[:, None]
    return torch.where(valid, tf, 0)


def bool_tail(op: str, docs, n, width: int):
    """AND/OR over a (T, width) sentinel-padded window: AND probes each
    other run with ``searchsorted`` at the first run's docs, OR sorts
    the flat window and keeps first occurrences.  Returns the sorted
    result pushed to the front and its count, both on the device."""
    if op == "and":
        vals = docs[0]
        alive = torch.arange(width, device=docs.device) < n[0]
        for t in range(1, docs.shape[0]):
            j = torch.searchsorted(docs[t], vals)
            alive = alive & (j < width) & (docs[t][j.clamp(max=width - 1)] == vals)
        out = torch.sort(torch.where(alive, vals, _SENTINEL)).values
        return out, alive.sum()
    flat = torch.sort(docs.ravel()).values
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    keep = first & (flat != _SENTINEL)
    out = torch.sort(torch.where(keep, flat, _SENTINEL)).values
    return out, keep.sum()


def _top_scores(scores, k: int):
    """The ``k`` best (doc id, score) of a dense score column, ties to
    the lower doc id (a stable descending sort, as ``lax.top_k``)."""
    vals, ids = torch.sort(scores, descending=True, stable=True)
    return ids[:k], vals[:k]


def _bm25_contrib(docs, tff, weight, lane_ok, doc_lens, avgdl):
    """Per-lane BM25 contribution (0.0 on masked lanes) and the doc id
    each lane adds to (0 on masked lanes); ``weight`` is per row."""
    safe = torch.where(lane_ok, docs, 0).long()
    dl = doc_lens[safe]
    denom = tff + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / avgdl)
    contrib = torch.where(lane_ok, weight[:, None] * tff * (BM25_K1 + 1.0) / denom, 0.0)
    return safe, contrib


def bm25_tail(docs, tfs, n, doc_lens, ndocs, avgdl, *, width: int, k: int):
    """Score T found term rows into a dense float32 doc column and rank
    it.  One ``index_add_`` per row, in row order: the doc ids of a row
    are unique, so the summing order is fixed (term-major)."""
    lane_ok = (torch.arange(width, device=docs.device)[None, :] < n[:, None]) \
        & (docs != _SENTINEL)
    dfv = n.to(torch.float32)
    # log1p, where the JAX engine takes log(1 + x): for a term in nearly
    # every document x is about 0.5 / ndocs, and 1 + x in float32 keeps
    # few of its bits (2e-3 relative at 20,000 documents)
    idf = torch.log1p((ndocs - dfv + 0.5) / (dfv + 0.5))
    safe, contrib = _bm25_contrib(docs, tfs.to(torch.float32), idf, lane_ok, doc_lens, avgdl)
    scores = torch.zeros(doc_lens.shape[0], dtype=torch.float32, device=docs.device)
    for t in range(docs.shape[0]):
        scores.index_add_(0, safe[t], contrib[t])
    return _top_scores(scores, k)


def bm25_blocks(blk_first, blk_width, blk_woff, post_words, blk_tf_width, blk_tf_woff,
                tf_words, bl, cnt, widf, doc_lens, avgdl, *, k: int, block_size: int,
                segments):
    """BM25 over an (S, block_size) window of SURVIVOR blocks — the
    device form of block-max pruning.  The host picks the global block
    ids ``bl`` and folds each block's ``weight * idf`` into ``widf``;
    ``segments`` are the row ranges of one query occurrence each, whose
    blocks (one term's) hold unique doc ids: one ``index_add_`` per
    segment fixes the summing order."""
    lane = torch.arange(block_size, device=bl.device)
    bl = bl.long()
    w = blk_width[bl].long()[:, None]
    off = (lane - 1).clamp(min=0)[None, :] * w
    delta = bit_window(post_words, blk_woff[bl].long()[:, None] + (off >> 5), off, w) + 1
    vals = torch.where(lane[None, :] == 0, blk_first[bl][:, None], delta)
    docs = torch.cumsum(vals, dim=1, dtype=torch.int32)
    tw = blk_tf_width[bl].long()[:, None]
    toff = lane[None, :] * tw
    tf = bit_window(tf_words, blk_tf_woff[bl].long()[:, None] + (toff >> 5), toff, tw) + 1
    lane_ok = lane[None, :] < cnt[:, None]
    safe, contrib = _bm25_contrib(docs, tf.to(torch.float32), widf, lane_ok, doc_lens, avgdl)
    scores = torch.zeros(doc_lens.shape[0], dtype=torch.float32, device=bl.device)
    for a, b in segments:
        scores.index_add_(0, safe[a:b].ravel(), contrib[a:b].ravel())
    return _top_scores(scores, k)


def topk_slice(df_order, df, lo: int, k: int):
    """Top-k terms of one letter by df: the ``k`` entries of the emit
    order from the letter's first index, and their df."""
    pick = df_order[lo:lo + k]
    return pick, df[pick.long()]


class DeviceEngine:
    """Batched query API over one artifact resident in device memory.

    The JAX ``DeviceEngine``'s surface and answers on torch devices:
    ``device=None`` means ``cuda`` and raises ``DeviceUnavailable``
    without a card (no move to the CPU); ``device="cpu"`` runs the same
    programs on the CPU.  ``shards`` sizes the batch mesh (default:
    ``$MRI_SERVE_SHARDS``, else every visible card — one on the CPU);
    more than one shard takes a device type without an index.
    The host LRU posting cache is present but idle (decodes are device
    work), kept for the ``describe()`` keys.
    """

    engine_name = "device"

    def __init__(self, path, cache_terms: int = 4096, device=None,
                 decode_budget: int | None = None, shards: int | None = None):
        from ..models.inverted_index import resolve_device

        if artifact_mod.is_segment_managed(path):
            raise artifact_mod.ArtifactError(
                f"{path} is segment-managed (segments.manifest.json "
                "present): the device engine serves single artifacts "
                "only — use create_engine with host/auto")
        self._device = torch.device("cuda" if device is None else device)
        resolve_device(self._device.type)
        if shards is None:
            shards = envknobs.get(SHARDS_ENV)
        if shards is None:
            shards = torch.cuda.device_count() if self._device.type == "cuda" else 1
        if shards == 1:
            self._mesh = mesh_mod.Mesh((self._device,))
        elif self._device.index is not None:
            # the mesh places its shards from card 0 on: a card the
            # caller named would be silently left for another
            raise ValueError(
                f"device={str(self._device)!r} names one card, but shards={shards} "
                f"spreads over every card: pass device={self._device.type!r}")
        else:
            self._mesh = mesh_mod.make_mesh(shards, self._device.type)
        self._device = self._mesh.devices[0]  # the unsharded ops' device
        self._decode_budget = int(decode_budget if decode_budget is not None
                                  else envknobs.get(DECODE_BUDGET_ENV))
        self.artifact = artifact_mod.load_artifact(path)
        art = self.artifact
        try:
            if art.max_doc_id >= _SENTINEL:
                raise artifact_mod.ArtifactError(
                    f"{art.path}: max_doc_id {art.max_doc_id} collides with "
                    f"the device engine's padding sentinel")
            cols = artifact_mod.device_columns(art)
        except BaseException:
            art.close()
            raise
        self.vocab_size = cols["vocab"]
        self._width = cols["width"]
        self._sdtype = f"S{self._width}"
        self._group = cols["max_prefix_group"]
        self._h_df = cols["df"]
        self._h_letter_dir = cols["letter_dir"]
        self._fmt = cols["format"]

        self.column_bytes = 0
        # the resolve and decode columns go to every card of the mesh
        # (per shard, in shard order); the rest to the first card only
        key, rows, df = (self._replicate(cols[c]) for c in ("key", "rows", "df"))
        self._shard_lookup = list(zip(key, rows, df))
        self._d_key, self._d_rows, self._d_df = self._shard_lookup[0]
        self._d_df_order = self._put(cols["df_order"])
        if self._fmt >= artifact_mod.VERSION_V2:
            self._block_size = cols["block_size"]
            self._shard_decode = list(zip(*(self._replicate(cols[c]) for c in (
                "term_block_off", "blk_first", "blk_width", "blk_woff", "post_words"))))
            (self._d_term_block_off, self._d_blk_first, self._d_blk_width,
             self._d_blk_woff, self._d_post_words) = self._shard_decode[0]
            self._d_blk_tf_width = self._put(cols["blk_tf_width"])
            self._d_blk_tf_woff = self._put(cols["blk_tf_woff"])
            self._d_tf_words = self._put(cols["tf_words"])
        else:
            self._block_size = 0
            self._shard_decode = list(zip(self._replicate(cols["post_offsets"]),
                                          self._replicate(cols["postings"])))
        self._decode_cols = self._shard_decode[0]
        self._d_doc_lens = None  # lazy: uploaded at the first top_k_scored
        self._d_bm25 = None
        self._sync()

        # posting tiers: powers of 4 from 8 up to the largest df
        max_df = int(self._h_df.max()) if self.vocab_size else 1
        tiers, t = [], _MIN_LANES
        while True:
            tiers.append(t)
            if t >= max_df:
                break
            t *= 4
        self._tiers = tiers

        self.metrics = obs_metrics.Registry()
        self.metrics.gauge("mri_engine_vocab_terms").set(self.vocab_size)
        self.metrics.gauge("mri_engine_artifact_bytes").set(art.nbytes)
        self._cache = LRUCache(cache_terms, registry=self.metrics,
                               prefix="mri_serve_cache")  # idle on the device path
        self._ops = OpTimer(registry=self.metrics)
        # decode counters, host-engine names, tallied on the host from
        # the artifact's block/offset columns per resolved term
        self._c_blocks_decoded = self.metrics.counter("mri_engine_blocks_decoded_total")
        self._c_blocks_skipped = self.metrics.counter("mri_engine_blocks_skipped_total")
        self._c_bytes_decoded = self.metrics.counter("mri_engine_bytes_decoded_total")
        self.planner = planner_mod.Planner(self.metrics)
        # host-side BM25 memos of the pruning plan: per-term f64
        # contributions (theta) and per-block upper bounds
        self._bm25_host = None
        self._score_memo: dict[int, np.ndarray] = {}
        self._bound_memo: dict[int, tuple] = {}
        self._memo_cap = max(int(cache_terms), 1)

    # -- host <-> device ---------------------------------------------------

    def _put(self, a: np.ndarray, device=None) -> torch.Tensor:
        """A fresh device tensor of ``a`` (on the first card by default);
        on the card the copy goes through pinned memory and does not
        block the host."""
        device = self._device if device is None else device
        t = torch.from_numpy(np.array(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        self.column_bytes += t.numel() * t.element_size()
        return t

    def _replicate(self, a: np.ndarray) -> list[torch.Tensor]:
        """One copy of ``a`` per shard, shards on one device sharing it
        (``mesh.replicate``, with the bytes counted once per copy)."""
        by_device: dict = {}
        for d in self._mesh.devices:
            if d not in by_device:
                by_device[d] = self._put(a, d)
        return [by_device[d] for d in self._mesh.devices]

    def _sync(self) -> None:
        """Wait until every upload queued on the mesh's cards is done, so
        an engine built on one thread (a daemon's hot reload) hands a
        complete set of columns to the thread that serves from it."""
        for d in dict.fromkeys(self._mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _upload(self, a: np.ndarray, device=None) -> torch.Tensor:
        """A per-call host array to the device, without a wait."""
        device = self._device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    @staticmethod
    def _fetch(*tensors) -> list[np.ndarray]:
        """Copy results to the host: every copy starts before any is
        waited on."""
        pending = [PendingFetch(t) for t in tensors]
        return [p.wait() for p in pending]

    # -- shape bucketing -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Padded batch size: power-of-two lanes per shard, at least 8."""
        D = self._mesh.size
        return D * max(_MIN_LANES, _next_pow2(-(-n // D)))

    def _lane_bucket(self, n: int) -> int:
        """Padded size of one shard's own group of lanes."""
        return max(_MIN_LANES, _next_pow2(n))

    def _slices(self, n: int) -> list[tuple[int, int]]:
        """Each shard's contiguous ``[a, b)`` of an ``n``-lane batch:
        ``bucket(n) / shards`` lanes a shard, clipped to ``n``."""
        L = self._bucket(n) // self._mesh.size
        return [(min(i * L, n), min((i + 1) * L, n)) for i in range(self._mesh.size)]

    def _tier(self, max_len: int) -> int:
        for t in self._tiers:
            if t >= max_len:
                return t
        return self._tiers[-1]

    def _decode(self, idx, n, width: int, cols=None):
        cols = self._decode_cols if cols is None else cols
        if self._fmt >= artifact_mod.VERSION_V2:
            return decode_window_v2(*cols, idx, n, width=width,
                                    block_size=self._block_size)
        return decode_window(*cols, idx, n, width=width)

    # -- term resolution -----------------------------------------------------

    def encode_batch(self, terms) -> np.ndarray:
        return encode_terms(terms, self._width)

    def _split_keys(self, q: np.ndarray):
        """S-dtype batch -> (rows u8, int64 8-byte big-endian key)."""
        B, w = len(q), self._width
        rows = np.ascontiguousarray(q).view(np.uint8).reshape(B, w)
        k8 = rows if w >= 8 else np.pad(rows, ((0, 0), (0, 8 - w)))
        key = np.ascontiguousarray(k8[:, :8]).view(">u8").ravel().astype(np.int64)
        return rows, key

    def _resolve(self, batch):
        """(idx i32, found bool, df i32) per query, on the host: the
        first of a call's two fetches.  Each shard resolves its slice of
        the padded batch on its own card."""
        q = np.asarray(batch, dtype=self._sdtype)
        B = len(q)
        if B == 0 or self.vocab_size == 0:
            return (np.zeros(B, dtype=np.int32), np.zeros(B, dtype=bool),
                    np.zeros(B, dtype=np.int32))
        rows, key = self._split_keys(q)
        Bp = self._bucket(B)
        if Bp != B:
            rows = np.vstack([rows, np.zeros((Bp - B, self._width), np.uint8)])
            key = np.concatenate([key, np.zeros(Bp - B, np.int64)])
        L = Bp // self._mesh.size
        parts = []
        for i, (d, cols) in enumerate(zip(self._mesh.devices, self._shard_lookup)):
            idx, found, dfv = lookup(*cols, self._upload(key[i * L:(i + 1) * L], d),
                                     self._upload(rows[i * L:(i + 1) * L], d),
                                     group=self._group)
            parts.append(torch.stack([idx, found.to(torch.int32), dfv]))
        res = np.concatenate(self._fetch(*parts), axis=1)
        idx, found, dfv = res[0, :B], res[1, :B].astype(bool), res[2, :B]
        coll = obs_attrib.active()
        if coll is not None:
            for t, i, ok, d in zip(q.tolist(), idx.tolist(), found.tolist(), dfv.tolist()):
                coll.term(t, int(i), bool(ok), int(d), "device")
        return idx, found, dfv

    def lookup(self, batch):
        """(lex idx, found) per query."""
        idx, found, _ = self._resolve(batch)
        return idx.astype(np.int64), found

    # -- single-term answers ---------------------------------------------------

    def df(self, batch) -> np.ndarray:
        with self._ops.time("df"):
            _, _, dfv = self._resolve(batch)
            return dfv.astype(np.int64)

    def _note_decode(self, uidx) -> None:
        """Count one decode pass over terms ``uidx`` on the registry and
        the attribution collector (the host mirror of the device work,
        from the offset columns; the feed sits beside the counters, so a
        request's report never drifts from the registry)."""
        uidx = np.asarray(uidx, dtype=np.int64)
        if not len(uidx):
            return
        art = self.artifact
        if self._fmt >= artifact_mod.VERSION_V2:
            b0 = art.term_block_off[uidx]
            b1 = art.term_block_off[uidx + 1]
            blocks = int((b1 - b0).sum())
            nbytes = int((art.blk_woff[b1] - art.blk_woff[b0]).sum()) * 4
        else:
            blocks = len(uidx)
            nbytes = int(self._h_df[uidx].sum()) * 4
        self._c_blocks_decoded.inc(blocks)
        self._c_bytes_decoded.inc(nbytes)
        coll = obs_attrib.active()
        if coll is not None:
            coll.decoded(blocks, nbytes)

    def _decode_batch(self, idx: np.ndarray, n: np.ndarray) -> np.ndarray:
        """The postings of every lane with ``n > 0``, concatenated in lane
        order (one host array).  Each shard decodes its slice of the
        padded batch on its own card; the slices' buffers come back in
        shard order, which is lane order."""
        n = n.astype(np.int64)
        outs = [self._decode_lanes(d, cols, idx[a:b], n[a:b])
                for (a, b), d, cols in zip(self._slices(len(n)), self._mesh.devices,
                                           self._shard_decode)]
        flat = self._fetch(*[o for o in outs if o is not None])
        return np.concatenate(flat) if flat else np.zeros(0, np.int32)

    def _decode_lanes(self, device, cols, idx: np.ndarray, n: np.ndarray):
        """One shard's lanes decoded on ``device`` into one flat device
        buffer (None when they hold no postings).

        Lanes are grouped by their own width tier, so a batch pays for
        the postings it asks for, not for its longest run at every lane
        (the JAX engine decodes the whole batch at the largest tier).
        Each group decodes in chunks whose ``rows x width`` stays under
        the shard's share of the decode budget, and each chunk's valid
        lanes are scattered straight into the flat buffer (masked lanes
        to a spare last slot), so only the postings travel back."""
        offs = np.cumsum(n) - n
        total = int(n.sum())
        if total == 0:
            return None
        live = np.nonzero(n > 0)[0]
        tiers = np.asarray(self._tiers, dtype=np.int64)
        widths = tiers[np.minimum(np.searchsorted(tiers, n[live]), len(tiers) - 1)]
        groups, parts, at = [], [], 0
        for width in np.unique(widths).tolist():
            rows = live[widths == width]
            per = max(1, self._decode_budget // width // self._mesh.size)
            step = min(self._lane_bucket(len(rows)), max(_MIN_LANES, _pow2_floor(per)))
            padded = -(-len(rows) // step) * step
            groups.append((at, padded, step, width))
            parts.append(np.concatenate([rows, np.full(padded - len(rows), -1, np.int64)]))
            at += padded
        lanes = np.concatenate(parts)
        real = lanes >= 0
        d_idx = self._upload(np.where(real, idx[lanes], 0).astype(np.int32), device)
        d_n = self._upload(np.where(real, n[lanes], 0), device)
        d_offs = self._upload(np.where(real, offs[lanes], 0), device)
        out = torch.empty(total + 1, dtype=torch.int32, device=device)
        for start, padded, step, width in groups:
            lane = torch.arange(width, device=device)
            for a in range(start, start + padded, step):
                part_n = d_n[a:a + step]
                win = self._decode(d_idx[a:a + step], part_n, width, cols)
                dest = torch.where(lane[None, :] < part_n[:, None],
                                   d_offs[a:a + step, None] + lane[None, :], total)
                out.scatter_(0, dest.ravel(), win.ravel())
        return out[:total]

    def postings(self, batch) -> list[np.ndarray | None]:
        with self._ops.time("postings"):
            idx, found, dfv = self._resolve(batch)
            B = len(found)
            if B == 0:
                return []
            if not found.any():
                return [None] * B
            self._note_decode(idx[found])
            flat = self._decode_batch(idx, dfv)
            ends = np.cumsum(dfv.astype(np.int64))
            return [flat[e - d:e] if ok else None
                    for ok, d, e in zip(found.tolist(), dfv.tolist(), ends.tolist())]

    # -- compound queries --------------------------------------------------------

    def top_k(self, letter, k: int) -> list[tuple[bytes, int]]:
        letter = letter_index(letter)
        with self._ops.time("top_k"):
            lo = int(self._h_letter_dir[letter])
            hi = int(self._h_letter_dir[letter + 1])
            k_eff = min(max(k, 0), hi - lo)
            if k_eff == 0:
                return []
            pick, dfs = self._fetch(*topk_slice(self._d_df_order, self._d_df, lo, k_eff))
            art = self.artifact
            return [(art.term(int(i)), int(d)) for i, d in zip(pick, dfs)]

    def _run_bool(self, op: str, uidx: np.ndarray) -> np.ndarray:
        """AND/OR over the unique term set ``uidx``: decode every run into
        one window, combine, fetch the count and the result together."""
        self._note_decode(uidx)
        n = self._h_df[uidx].astype(np.int32)
        width = self._tier(int(n.max()))
        d_n = self._upload(n)
        docs = self._decode(self._upload(uidx.astype(np.int32)), d_n, width)
        out, cnt = bool_tail(op, docs, d_n, width)
        res = self._fetch(torch.cat([cnt.view(1).to(torch.int32), out]))[0]
        return res[1:1 + int(res[0])].astype(np.int32)

    def query_and(self, batch) -> np.ndarray:
        with self._ops.time("and"):
            idx, found, _ = self._resolve(batch)
            if len(found) == 0 or not found.all():
                return np.zeros(0, dtype=np.int32)
            return self._run_bool("and", np.unique(idx))

    def query_or(self, batch) -> np.ndarray:
        with self._ops.time("or"):
            idx, found, _ = self._resolve(batch)
            uidx = np.unique(idx[found])
            if len(uidx) == 0:
                return np.zeros(0, dtype=np.int32)
            return self._run_bool("or", uidx)

    # -- ranked retrieval --------------------------------------------------------

    def _bm25_device(self):
        """The float32 doc-length column and the (ndocs, avgdl) scalars
        as 0-d device tensors, uploaded once."""
        if self._d_doc_lens is None:
            doc_lens, ndocs, avgdl = artifact_mod.bm25_corpus(self.artifact)
            self._d_doc_lens = self._put(doc_lens.astype(np.float32))
            self._d_bm25 = self._put(np.array([ndocs, avgdl], dtype=np.float32))
        return self._d_doc_lens, self._d_bm25[0], self._d_bm25[1]

    def _bm25_host_cols(self):
        """Float64 host mirror of the corpus stats (theta bootstrap)."""
        if self._bm25_host is None:
            self._bm25_host = artifact_mod.bm25_corpus(self.artifact)
        return self._bm25_host

    def _term_contribs(self, i: int) -> np.ndarray:
        """Term ``i``'s BM25 contributions, descending (f64, host)."""
        hit = self._score_memo.get(i)
        if hit is not None:
            return hit
        doc_lens, ndocs, avgdl = self._bm25_host_cols()
        art = self.artifact
        docs = art.decode_postings(i)
        tf = art.decode_tf(i).astype(np.float64)
        dfi = len(docs)
        idf = np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5))
        denom = tf + BM25_K1 * (1.0 - BM25_B + BM25_B * doc_lens[docs] / avgdl)
        srt = np.sort(idf * tf * (BM25_K1 + 1.0) / denom)[::-1]
        if len(self._score_memo) >= self._memo_cap:
            self._score_memo.clear()
        self._score_memo[i] = srt
        return srt

    def _term_bounds(self, i: int) -> tuple:
        """(per-block f64 upper bounds, their max, idf) for term i."""
        hit = self._bound_memo.get(i)
        if hit is not None:
            return hit
        _doc_lens, ndocs, avgdl = self._bm25_host_cols()
        dfi = int(self._h_df[i])
        idf = np.log(1.0 + (ndocs - dfi + 0.5) / (dfi + 0.5))
        ubs = planner_mod.block_upper_bounds(self.artifact, i, idf, avgdl, BM25_K1, BM25_B)
        if len(self._bound_memo) >= self._memo_cap:
            self._bound_memo.clear()
        self._bound_memo[i] = (ubs, float(ubs.max()) if len(ubs) else 0.0, idf)
        return self._bound_memo[i]

    def _top_k_scored_pruned(self, occ: list[int], k: int, mode: str
                             ) -> list[tuple[int, float]]:
        """Block-survivor form of pruned ranked retrieval: the host
        derives theta (the k-th best contribution of the strongest term)
        and keeps only blocks whose bound plus every other term's summed
        bounds clears it; the device decodes and scores exactly those
        blocks.  Every true top-k doc's blocks survive, so the doc set
        matches exhaustive scoring.  ``maxscore`` masks whole terms,
        ``bmw`` masks per block."""
        art = self.artifact
        doc_lens_d, _ndocs, avgdl = self._bm25_device()
        D = int(doc_lens_d.shape[0])
        weight: dict[int, int] = {}
        for i in occ:
            weight[i] = weight.get(i, 0) + 1
        terms = [(i, w) + self._term_bounds(i) for i, w in weight.items()]
        total = sum(w * umax for _i, w, _ubs, umax, _idf in terms)
        theta = 0.0
        for i, w, _ubs, _umax, _idf in terms:
            srt = self._term_contribs(i)
            if len(srt) >= k:
                theta = max(theta, w * float(srt[k - 1]))
        coll = obs_attrib.active()
        if coll is not None:
            coll.theta(theta)
        margin = planner_mod.DEVICE_MARGIN
        bl_parts, widf_parts = [], []
        nb_total = 0
        for i, w, ubs, umax, idf in terms:
            b0 = int(art.term_block_off[i])
            nb = len(ubs)
            nb_total += nb * w
            rest = total - w * umax
            if mode == "maxscore":
                sel = (np.arange(nb, dtype=np.int64) if w * umax + rest >= theta * margin
                       else np.zeros(0, dtype=np.int64))
            else:
                sel = np.nonzero(w * ubs + rest >= theta * margin)[0]
            if not len(sel):
                continue
            # one survivor segment per query occurrence: duplicates
            # accumulate as the exhaustive path's duplicated rows do
            for _ in range(int(w)):
                bl_parts.append(sel + b0)
                widf_parts.append(np.full(len(sel), np.float32(idf), np.float32))
        if not bl_parts:
            self._c_blocks_skipped.inc(nb_total)
            if coll is not None:
                coll.skipped(nb_total)
            self.planner.note_ranked(mode, 0, nb_total, 0, backend="torch")
            return []
        bl = np.concatenate(bl_parts).astype(np.int32)
        widf = np.concatenate(widf_parts)
        cnt = art.blk_cnt[bl].astype(np.int32)
        S = len(bl)
        nbytes = int((art.blk_woff[bl.astype(np.int64) + 1] - art.blk_woff[bl]).sum()) * 4
        self._c_blocks_decoded.inc(S)
        self._c_blocks_skipped.inc(nb_total - S)
        self._c_bytes_decoded.inc(nbytes)
        if coll is not None:
            coll.decoded(S, nbytes)
            coll.skipped(nb_total - S)
        ends = np.cumsum([len(p) for p in bl_parts])
        segments = list(zip((ends - [len(p) for p in bl_parts]).tolist(), ends.tolist()))
        k_eff = min(max(k, 0), D)
        ids, vals = bm25_blocks(
            self._d_blk_first, self._d_blk_width, self._d_blk_woff, self._d_post_words,
            self._d_blk_tf_width, self._d_blk_tf_woff, self._d_tf_words,
            self._upload(bl), self._upload(cnt), self._upload(widf), doc_lens_d, avgdl,
            k=k_eff, block_size=self._block_size, segments=segments)
        self.planner.note_ranked(mode, S, nb_total - S, 0, backend="torch")
        ids, vals = self._fetch(ids, vals)
        return [(int(d), float(s)) for d, s in zip(ids, vals) if s > 0.0]

    def top_k_scored(self, batch, k: int) -> list[tuple[int, float]]:
        """BM25-ranked ``(doc_id, score)``, best first, ties by doc id —
        float32 on the device, within ~1e-6 relative of the float64 host
        scorer.  On a v2.1 artifact the planner may swap the whole-term
        windows for a survivor-block window
        (:meth:`_top_k_scored_pruned`)."""
        with self._ops.time("top_k_scored"):
            idx, found, dfv = self._resolve(batch)
            doc_lens, ndocs, avgdl = self._bm25_device()
            D = int(doc_lens.shape[0])
            if k <= 0 or D == 0 or not found.any():
                if k > 0:
                    self.planner.note_ranked("exhaustive", 0, 0, 0, backend="torch")
                return []
            occ = idx[found]
            mode = self.planner.plan_ranked(self.artifact, dfv[found].tolist(), k)
            if mode != "exhaustive":
                return self._top_k_scored_pruned(occ.tolist(), k, mode)
            self.planner.note_ranked("exhaustive", 0, 0, 0, backend="torch")
            self._note_decode(occ)
            # duplicates accumulate (host parity): every found lane is a row
            n = dfv[found].astype(np.int32)
            width = self._tier(int(n.max()))
            d_idx, d_n = self._upload(occ.astype(np.int32)), self._upload(n)
            docs = self._decode(d_idx, d_n, width)
            if self._fmt >= artifact_mod.VERSION_V2:
                tfs = tf_window_v2(self._d_term_block_off, self._d_blk_tf_width,
                                   self._d_blk_tf_woff, self._d_tf_words, d_idx, d_n,
                                   width=width, block_size=self._block_size)
            else:
                tfs = torch.ones_like(docs)  # v1: no tf column
            ids, vals = bm25_tail(docs, tfs, d_n, doc_lens, ndocs, avgdl,
                                  width=width, k=min(k, D))
            ids, vals = self._fetch(ids, vals)
            return [(int(d), float(s)) for d, s in zip(ids, vals) if s > 0.0]

    # -- bookkeeping ---------------------------------------------------------------

    @property
    def cache(self) -> LRUCache:
        return self._cache

    def cache_stats(self) -> dict:
        return self._cache.stats()

    def op_stats(self) -> dict:
        return self._ops.stats()

    def describe(self) -> dict:
        dev = self._device
        return {
            "engine": self.engine_name,
            "format": self._fmt,
            "vocab": self.vocab_size,
            "artifact_bytes": self.artifact.nbytes,
            "cache": self.cache_stats(),
            "ops": self.op_stats(),
            "planner": self.planner.describe(),
            "device": {
                "platform": dev.type,
                "name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "shards": self._mesh.size,
                "devices": [str(d) for d in self._mesh.devices],
                "tiers": self._tiers,
                "max_prefix_group": self._group,
                "column_bytes": self.column_bytes,
            },
        }

    def close(self) -> None:
        self._cache.clear()
        self._d_key = self._d_rows = self._d_df = self._d_df_order = None
        self._d_doc_lens = self._d_bm25 = None
        self._decode_cols = ()
        self._shard_lookup = self._shard_decode = []
        if self._fmt >= artifact_mod.VERSION_V2:
            self._d_term_block_off = self._d_blk_first = None
            self._d_blk_width = self._d_blk_woff = None
            self._d_post_words = self._d_blk_tf_width = None
            self._d_blk_tf_woff = self._d_tf_words = None
        self._bm25_host = None
        self._score_memo.clear()
        self._bound_memo.clear()
        self.artifact.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
