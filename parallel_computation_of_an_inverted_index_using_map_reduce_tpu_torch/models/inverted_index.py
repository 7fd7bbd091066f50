"""The flagship model: end-to-end inverted-index pipeline.

Orchestrates the chain the reference runs as fork-join pthread phases
(main.c:246-390):

    manifest -> load docs -> tokenize (host) -> index (device) -> emit (host)

with backends:
    "cuda"   — the device engine (ops/engine.py) on ``config.device``,
               by one of these plans:
               * pipelined (default when eligible): the native scan emits
                 combiner-deduped provisional keys per document window,
                 each window's upload overlaps the next window's scan,
                 and the device finalize is one sort
               * overlap (``overlap_tail_fraction``): the pipelined plan
                 with each device window sorted and fetched while later
                 windows are scanned, and the last byte share sorted on
                 the host
               * one-shot: tokenize everything (native combiner, or the
                 numpy tokenizer with ``use_native=False``), then one
                 device program
               * streaming (``stream_chunk_docs``): document windows fold
                 into a bounded sorted accumulator on the card
                 (ops/streaming.py), one finalize
               * all-device (``device_tokenize``): raw bytes up, the
                 finished index down (ops/device_tokenizer.py); a token
                 wider than the word rows restarts on the host-scan plans
               * streaming all-device (both): raw byte windows fold into
                 a bounded word-row accumulator on the card
                 (ops/device_streaming.py), with resumable stream
                 checkpoints; a too-wide token restarts on the streaming
                 plan
               On a mesh (``device_shards`` > 1, parallel/) the pipelined,
               one-shot, streaming, all-device and streaming all-device
               plans shard their pairs or bytes over logical shards and
               exchange them by owner; ``emit_ownership="letter"`` has
               each owner write its own letter files.
    "oracle" — pure-Python dict oracle (models/oracle.py)

Output is byte-identical across backends and plans, to the JAX package,
and to the pthread reference.  With ``config.artifact`` every plan but
the overlap plan also packs the serving artifact ``index.mri``
(serve/artifact.py) from the arrays it emits.
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from .. import native
from ..config import IndexConfig
from ..corpus.manifest import (DegradationReport, Manifest, iter_document_chunks,
                               iter_document_ranges, load_documents, prefetch_document_ranges)
from ..corpus.scheduler import (owner_of_letter_table, plan_contiguous_ranges,
                                plan_contiguous_windows, plan_fraction_windows,
                                window_balance_stats)
from ..obs.timing import PhaseTimer
from ..ops import device_tokenizer as DT
from ..ops import engine
from ..ops import keys as K
from ..ops.device_streaming import DeviceStreamEngine
from ..ops.streaming import StreamingIndexEngine
from ..parallel import dist_engine
from ..parallel.dist_device_streaming import DistDeviceStreamEngine
from ..parallel.dist_device_tokenizer import index_bytes_dist
from ..parallel.dist_streaming import DistStreamingIndexEngine
from ..parallel.mesh import make_mesh, shard
from ..text import formatter
from ..text.streaming import StreamingTokenizer
from ..text.tokenizer import tokenize
from ..utils import checkpoint, envknobs
from ..utils.rounding import round_up as _round_up
from .oracle import oracle_index


class DeviceUnavailable(RuntimeError):
    """The config names the card and torch sees none."""


def resolve_device(name: str) -> torch.device:
    """``torch.device`` for ``IndexConfig.device``; the card or an error,
    never a quiet move to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "device='cuda' but torch sees no CUDA device; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return torch.device(name)


def _pack_window(contents, ids, shard_len: int, docs_cap: int | None = None):
    """Pack the loaded docs into the device byte-feed layout:
    ``(buf[shard_len] space-padded, ends, ids)``, one ``ends`` and
    ``ids`` entry per doc, padded to ``docs_cap`` entries when given
    (padded ends stay at ``shard_len``: the pad region is all spaces, so
    those "docs" emit nothing; padded ids are 1).  One join + one copy —
    no per-doc Python loop.  Every call returns fresh arrays, so no
    buffer a copy to the card may still read is ever refilled."""
    joined = b"".join(contents)
    buf = np.full(shard_len, 0x20, np.uint8)
    buf[: len(joined)] = np.frombuffer(joined, np.uint8)
    cap = len(contents) if docs_cap is None else docs_cap
    ends = np.full(cap, shard_len, np.int32)
    idv = np.full(cap, 1, np.int32)
    lens = np.fromiter((len(c) for c in contents), np.int64, len(contents))
    ends[: len(contents)] = np.cumsum(lens)
    idv[: len(ids)] = np.asarray(ids, np.int32)
    return buf, ends, idv


class InvertedIndexModel:
    """Reusable pipeline object; ``self.timer`` holds the latest run's."""

    def __init__(self, config: IndexConfig | None = None):
        self.config = config or IndexConfig()
        self.timer = PhaseTimer()

    def _new_timer(self) -> PhaseTimer:
        self.timer = timer = PhaseTimer()
        timer.count("num_mappers", self.config.num_mappers)
        timer.count("num_reducers", self.config.num_reducers)
        return timer

    def run(self, manifest: Manifest, output_dir: str | None = None) -> dict:
        cfg = self.config
        report = DegradationReport()
        timer = self._new_timer()
        out_dir = output_dir if output_dir is not None else cfg.output_dir
        if cfg.backend == "oracle":
            with timer.phase("oracle"):
                stats = oracle_index(manifest, out_dir, report,
                                     artifact_path=self._artifact_path(out_dir))
            stats = {**stats, **timer.report()}
        else:
            stats = self._run_device(manifest, out_dir, timer, report)
        stats["degradation"] = report.summary()
        return stats

    def _artifact_path(self, out_dir) -> str | None:
        """Where ``--artifact`` packs the serving index (None when off)."""
        if not self.config.artifact:
            return None
        from ..serve import artifact as artifact_mod

        return str(artifact_mod.artifact_path(out_dir))

    @staticmethod
    def _count_artifact_stats(timer: PhaseTimer, emit_stats: dict) -> None:
        for key in ("artifact_bytes", "artifact_build_ms"):
            if key in emit_stats:
                timer.count(key, emit_stats[key])

    def _run_device(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                    report: DegradationReport) -> dict:
        cfg = self.config
        device = resolve_device(cfg.device)
        device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        timer.count("device", device_name)
        num_shards = self._num_shards()
        letter = cfg.emit_ownership == "letter"
        if cfg.device_tokenize:
            try:
                if cfg.stream_chunk_docs is not None:
                    if num_shards > 1:
                        if cfg.stream_checkpoint:
                            raise ValueError(
                                "stream_checkpoint is single-device only: "
                                f"device_shards=None resolved to {num_shards} shards "
                                "(the mesh streaming engine has no checkpoint); pass "
                                "device_shards=1")
                        return self._run_device_tokenize_stream_dist(manifest, out_dir,
                                                                     timer, report)
                    return self._run_device_tokenize_stream(manifest, out_dir, timer, report,
                                                            device)
                if num_shards > 1:
                    return self._run_device_tokenize_dist(manifest, out_dir, timer, report)
                if letter:
                    raise ValueError(
                        "emit_ownership='letter' requires a multi-shard mesh "
                        "(device_shards > 1)")
                return self._run_device_tokenize(manifest, out_dir, timer, report, device)
            except DT.WidthOverflow as e:
                # exactness guard tripped: restart on the host-scan plans
                # (a streaming config on the streaming plan, below) with a
                # fresh timer; the aborted attempt's wall time stays in
                # the report as its own phase.  The stream is abandoned
                # for good: a stale checkpoint would make every later
                # identical run restore, re-stream and overflow again.
                if cfg.stream_checkpoint and os.path.exists(cfg.stream_checkpoint):
                    os.remove(cfg.stream_checkpoint)
                aborted_s = sum(timer.phases.values())
                timer = self._new_timer()
                timer.count("device", device_name)
                timer.count("device_tokenize_fallback", str(e))
                timer.phases["aborted_device_tokenize"] = aborted_s
                report.skips.clear()  # the host plan reloads and records them anew
        if cfg.stream_chunk_docs is not None:
            if num_shards > 1:
                return self._run_streaming_dist(manifest, out_dir, timer, report)
            return self._run_streaming(manifest, out_dir, timer, report, device)
        # the refusals below fail loudly rather than run a plan the
        # config does not name
        if letter:
            if num_shards < 2:
                raise ValueError(
                    "emit_ownership='letter' requires a multi-shard mesh "
                    "(device_shards > 1)")
            if not self._pipelined_eligible(manifest):
                raise ValueError(
                    "emit_ownership='letter' requires the pipelined path "
                    "(native tokenizer available, no checkpoint/skew flags)")
        if cfg.overlap_tail_fraction is not None:
            if num_shards > 1:
                raise ValueError(
                    "overlap_tail_fraction is a single-device plan "
                    "(device_shards > 1 selects the multi-shard engine)")
            if not self._pipelined_eligible(manifest):
                raise ValueError(
                    "overlap_tail_fraction requires the pipelined path: "
                    "native tokenizer available, no checkpoint/skew flags, "
                    "no streaming, and <= 65534 documents")
        if self._pipelined_eligible(manifest):
            try:
                if cfg.overlap_tail_fraction is not None:
                    return self._run_overlap(manifest, out_dir, timer, report, device)
                return self._run_pipelined(manifest, out_dir, timer, report, device)
            except native.KeyOverflow:
                if letter:
                    raise ValueError(
                        "emit_ownership='letter' cannot fall back to the "
                        "one-shot engine after packed-key overflow") from None
                # prov_id * stride outgrew int32 keys mid-stream: restart
                # on the one-shot plan, whose engine picks its key width
                # from the final vocab.  The aborted attempt's wall time
                # stays in the report as its own phase.
                aborted_s = sum(timer.phases.values())
                timer = self._new_timer()
                timer.count("device", device_name)
                timer.count("pipelined_fallback", "key_overflow")
                timer.phases["aborted_pipelined"] = aborted_s
                report.skips.clear()  # the one-shot reload records them anew
        return self._run_one_shot(manifest, out_dir, timer, report, device)

    def _num_shards(self) -> int:
        """Logical shards of this run: ``device_shards``, else one per
        visible card of ``config.device`` (1 on the CPU)."""
        cfg = self.config
        if cfg.device_shards is not None:
            return cfg.device_shards
        return torch.cuda.device_count() if cfg.device == "cuda" else 1

    def _pipelined_eligible(self, manifest: Manifest) -> bool:
        """Whether the provisional-key pipelined plan applies: it needs
        the native scan, no streaming plan and no skew statistics (which
        need the token arrays on the host).  On one device it also needs
        uint16 postings (doc ids < 0xFFFF); the mesh variant fetches
        int32 and has no doc cap."""
        cfg = self.config
        return (
            cfg.pipeline_chunk_docs != 0
            and cfg.use_native
            and cfg.stream_chunk_docs is None
            and not cfg.collect_skew_stats
            and (self._num_shards() > 1 or len(manifest) <= 0xFFFE)
            and native.available()
        )

    # -- pipelined plan ------------------------------------------------

    def _run_pipelined(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                       report: DegradationReport, device: torch.device) -> dict:
        """Pipelined plan: uploads overlap the scan.

        The native scan emits packed ``prov_id * stride + doc_id`` keys
        per document window (a uint16 ``[terms | docs]`` buffer while
        prov ids fit, int32 keys after), and each window's copy to the
        card starts at once — provisional ids are stable at first
        occurrence, so the device sort never waits for the final vocab.
        After the last window, one sort and one fetch are the whole
        critical path; emit order, df and offsets are resolved on the
        host in prov space from the combiner's counts.

        On a mesh the windows are int32 keys split over the shards, and
        the finalize is a hash-bucket exchange and owner-side sort
        (parallel/dist_engine.dist_sort_prov_windows), or a letter-owner
        exchange and per-owner emit with ``emit_ownership="letter"``.
        """
        cfg = self.config
        max_doc_id = len(manifest)
        stride = max_doc_id + 2
        num_shards = self._num_shards()
        mesh = make_mesh(num_shards, cfg.device) if num_shards > 1 else None
        if cfg.pipeline_chunk_docs:
            n = len(manifest)
            windows = tuple((s, min(s + cfg.pipeline_chunk_docs, n))
                            for s in range(0, n, cfg.pipeline_chunk_docs))
        else:
            # auto: two byte-balanced windows (the reference's greedy
            # size cut, main.c:307-323) — window 1's copy runs while
            # window 2 is scanned
            windows = plan_contiguous_windows(manifest, min(2, max(len(manifest), 1)))
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        wstats = window_balance_stats(manifest, windows)
        timer.count("window_plan_bytes", wstats["bytes_per_shard"])
        timer.count("window_imbalance", wstats["max_over_mean"])
        # sharded windows must also split evenly over the mesh (lcm: a
        # power-of-two granule on a power-of-two mesh needs no padding)
        granule = math.lcm(min(1 << 14, cfg.pad_multiple), num_shards)
        chunks_dev: list = []  # one tensor per window, or its per-shard list
        staged: list[torch.Tensor] = []  # pinned windows, held until the fetch
        modes: list[str] = []
        # per window: ms the reader thread took to read it, ms the scan
        # waited for it, and ms of the scan and the copy's issue
        read_ms: list[float] = []
        wait_ms: list[float] = []
        scan_ms: list[float] = []
        num_pairs = docs_loaded = keys_capacity = 0
        with native.NativeKeyStream(stride, num_threads=threads) as stream:
            with timer.phase("tokenize_feed"), contextlib.closing(
                    prefetch_document_ranges(manifest, windows, report,
                                             read_ms=read_ms)) as reader:
                t_done = time.perf_counter()
                for contents, ids in reader:
                    t_got = time.perf_counter()
                    docs_loaded += len(contents)
                    if mesh is None:
                        # the native scan assembles the uint16 upload
                        # buffer itself (int32 keys once prov ids outgrow
                        # uint16)
                        mode, buf, nvalid, _ = stream.feed_u16(contents, ids, granule=granule)
                    else:  # the mesh path feeds int32 keys, never uint16
                        buf, _ = stream.feed(contents, ids)
                        mode, nvalid = "keys", int(buf.size)
                    if nvalid:
                        if mode == "u16":
                            padded = buf.shape[0] // 2
                            host = buf.view(np.int16)
                        else:
                            padded = _round_up(nvalid, granule)
                            host = np.full(padded, K.INT32_MAX, dtype=np.int32)
                            host[:nvalid] = buf
                        chunks_dev.append(engine.upload(host, device, staged) if mesh is None
                                          else shard(host, mesh, staged))
                        modes.append(mode)
                        keys_capacity += padded
                        num_pairs += nvalid
                    wait_ms.append(round((t_got - t_done) * 1e3, 3))
                    t_done = time.perf_counter()
                    scan_ms.append(round((t_done - t_got) * 1e3, 3))
            with timer.phase("finalize_vocab"):
                (vocab, letters, remap, df_prov, raw_tokens, _,
                 emit_order) = stream.finalize()

        vocab_size = int(vocab.shape[0])
        timer.count("documents", docs_loaded)
        timer.count("tokens", raw_tokens)
        timer.count("unique_terms", vocab_size)
        timer.count("device_shards", num_shards)
        timer.count("upload_windows", len(chunks_dev))
        timer.count("window_modes", modes)
        timer.count("window_read_ms", read_ms)
        timer.count("window_wait_ms", wait_ms)
        timer.count("window_scan_ms", scan_ms)
        if num_pairs == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        if mesh is not None:
            return self._finish_pipelined_mesh(
                chunks_dev, mesh=mesh, stride=stride, vocab=vocab, letters=letters,
                remap=remap, df_prov=df_prov, emit_order=emit_order, num_pairs=num_pairs,
                max_doc_id=max_doc_id, out_dir=out_dir, timer=timer)
        nfetch = min(keys_capacity, _round_up(num_pairs, 1 << 14))
        with timer.phase("device_index"):
            pending = engine.PendingFetch(
                engine.sort_prov_chunks(chunks_dev, stride=stride, out_size=nfetch))
            # overlapped with the in-flight sort and copy: per-rank views
            # indirect through rank -> prov (postings are grouped by prov id)
            prov_of_rank = np.empty(vocab_size, dtype=np.int64)
            prov_of_rank[remap] = np.arange(vocab_size)
            df64 = df_prov.astype(np.int64)
            offsets_prov = np.cumsum(df64) - df64
            host = {"df": df64[prov_of_rank], "order": emit_order,
                    "offsets": offsets_prov[prov_of_rank], "num_unique": num_pairs}
        with timer.phase("fetch"):
            host["postings"] = engine.host_u16(pending.wait())
        del chunks_dev, staged
        return self._emit_and_report(vocab, letters, host, out_dir, timer, max_doc_id)

    def _finish_pipelined_mesh(self, chunks_dev, *, mesh, stride: int, vocab, letters, remap,
                               df_prov, emit_order, num_pairs: int, max_doc_id: int,
                               out_dir: str, timer: PhaseTimer) -> dict:
        """The pipelined plan's mesh tail: per-rank views in prov space,
        then the exchange and the host merge (merged emit) or the
        letter-owner exchange and per-owner emit."""
        vocab_size = int(vocab.shape[0])
        prov_of_rank = np.empty(vocab_size, dtype=np.int64)
        prov_of_rank[remap] = np.arange(vocab_size)
        df64 = df_prov.astype(np.int64)
        offsets_prov = np.cumsum(df64) - df64
        df_rank = df64[prov_of_rank]
        if self.config.emit_ownership == "letter":
            return self._emit_per_owner(
                chunks_dev, stride=stride, mesh=mesh, vocab=vocab, letters=letters,
                remap=remap, df64=df64, order=emit_order, df_rank=df_rank,
                prov_of_rank=prov_of_rank, out_dir=out_dir, timer=timer,
                max_doc_id=max_doc_id, num_pairs=num_pairs)
        dist_stats: dict = {}
        with timer.phase("device_index"):
            # exchange + fetch + host merge in one blocking call
            postings = dist_engine.dist_sort_prov_windows(
                chunks_dev, stride=stride, mesh=mesh, offsets_prov=offsets_prov,
                num_pairs=num_pairs, stats=dist_stats)
        for k, v in dist_stats.items():
            timer.count(k, v)
        host = {"df": df_rank, "order": emit_order, "offsets": offsets_prov[prov_of_rank],
                "postings": postings, "num_unique": num_pairs}
        return self._emit_and_report(vocab, letters, host, out_dir, timer, max_doc_id)

    def _emit_per_owner(self, chunks_dev, *, stride: int, mesh, vocab, letters, remap, df64,
                        order, df_rank, prov_of_rank, out_dir: str, timer: PhaseTimer,
                        max_doc_id: int, num_pairs: int) -> dict:
        """Per-owner letter emission.

        One ``all_to_all`` keyed by *letter owner* — the reference's
        reducer ownership (contiguous letter ranges including the R > 26
        collapse, main.c:129-150) via corpus/scheduler.plan_letter_ranges
        — then every owner emits only its own letter files from its own
        pairs; nothing merges the global postings.  This single
        controller runs every owner's emit in turn.
        """
        n = mesh.size
        ranges, owner_of_letter = owner_of_letter_table(n)
        letters = np.asarray(letters)
        owner_of_prov = owner_of_letter[letters[np.asarray(remap)]]
        dist_stats: dict = {}
        with timer.phase("device_index"):
            rows = dist_engine.dist_letter_windows(
                chunks_dev, owner_of_prov, stride=stride, mesh=mesh, stats=dist_stats)
        for k, v in dist_stats.items():
            timer.count(k, v)
        lines = 0
        with timer.phase("emit"):
            for o, row in sorted(rows.items()):
                df_o = np.where(owner_of_prov == o, df64, 0)
                offsets_local = np.cumsum(df_o) - df_o
                postings_o = dist_engine.merge_owner_runs(
                    [row], stride, offsets_local, int(df_o.sum()))
                stats_o = formatter.emit_index(
                    out_dir, vocab=vocab, letter_of_term=letters, order=order, df=df_rank,
                    offsets=offsets_local[prov_of_rank], postings=postings_o,
                    max_doc_id=max_doc_id, letter_range=ranges[o],
                    backend=self._emit_backend())
                lines += stats_o["lines_written"]
        timer.count("emit_ownership", "letter")
        timer.count("letter_owners", n)
        timer.count("unique_pairs", num_pairs)
        timer.count("lines_written", lines)
        return timer.report()

    # -- overlap plan --------------------------------------------------

    def _run_overlap(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                     report: DegradationReport, device: torch.device) -> dict:
        """Windowed overlap plan: the device round trips hide under the
        scan.

        The pipelined plan still waits for its one fetch after the scan
        ends.  Here the corpus is cut into contiguous byte-weighted doc
        windows (``plan_fraction_windows``): each *device* window's
        provisional keys are uploaded, sorted and copied back the moment
        it is scanned, while the host scans the later windows, and the
        last ``overlap_tail_fraction`` of the bytes never goes to the
        card: its keys are sorted with numpy while the copies are in
        flight.  Windows are ascending doc ranges and a window's sorted
        keys give each term's docs ascending, so each term's postings
        list is its per-window segments in window order — the native
        multi-run emit renders them with no merge pass.  The reference's
        map->reduce barrier (main.c:367-369) forbids exactly this
        overlap; the bytes stay the same.
        """
        cfg = self.config
        max_doc_id = len(manifest)
        stride = max_doc_id + 2
        tail_f = cfg.overlap_tail_fraction
        # with two device windows the first fetch is issued earlier; with
        # one, half the launches and copies
        dev_f = 1.0 - tail_f
        if len(manifest) >= 8 and cfg.overlap_device_windows == 2:
            split = cfg.overlap_window_split
            fractions = (split * dev_f, (1.0 - split) * dev_f, tail_f)
        else:
            fractions = (dev_f, tail_f)
        windows = plan_fraction_windows(manifest, fractions)
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        timer.count("window_plan_bytes", window_balance_stats(manifest, windows)["bytes_per_shard"])
        granule = min(1 << 14, cfg.pad_multiple)

        dev_handles: list[tuple] = []  # (postings copy in flight, nvalid)
        dev_snaps: list[tuple] = []    # (df before, df after) per device window
        staged: list = []              # pinned windows, held until the fetch
        prev_snap = np.zeros(0, np.int32)
        tail_keys = None
        num_pairs = docs_loaded = 0
        with native.NativeKeyStream(stride, num_threads=threads) as stream:
            with timer.phase("tokenize_feed"), contextlib.closing(
                    prefetch_document_ranges(manifest, windows, report)) as reader:
                for wi, (contents, ids) in enumerate(reader):
                    docs_loaded += len(contents)
                    if wi == len(windows) - 1:  # the host tail
                        keys, _ = stream.feed(contents, ids)
                        num_pairs += int(keys.size)
                        if keys.size:
                            tail_keys = keys
                        continue
                    mode, buf, nvalid, _ = stream.feed_u16(contents, ids, granule=granule)
                    num_pairs += nvalid
                    if nvalid == 0:
                        continue
                    if mode == "u16":
                        host = buf.view(np.int16)
                    else:  # prov ids outgrew uint16: int32 keys
                        host = np.full(_round_up(nvalid, granule), K.INT32_MAX, np.int32)
                        host[:nvalid] = buf
                    post = engine.sort_prov_chunks(
                        [engine.upload(host, device, staged)], stride=stride,
                        out_size=_round_up(nvalid, granule))
                    dev_handles.append((engine.PendingFetch(post), nvalid))
                    # per-window per-term pair counts from combiner df
                    # snapshot diffs (vocab scale), not token-scale counts
                    snap = stream.df_snapshot(hint=max(1 << 16, prev_snap.shape[0] * 2))
                    dev_snaps.append((prev_snap, snap))
                    prev_snap = snap
            with timer.phase("finalize_vocab"):
                (vocab, letters, remap, df_prov, raw_tokens, _,
                 emit_order) = stream.finalize()

        vocab_size = int(vocab.shape[0])
        timer.count("documents", docs_loaded)
        timer.count("tokens", raw_tokens)
        timer.count("unique_terms", vocab_size)
        timer.count("device_shards", 1)
        timer.count("upload_windows", len(dev_handles))
        timer.count("overlap_tail_fraction", tail_f)
        timer.count("device_pairs", sum(n for _, n in dev_handles))
        timer.count("unique_pairs", num_pairs)
        if num_pairs == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        with timer.phase("host_tail"):
            if tail_keys is not None:
                tail_docs = (np.sort(tail_keys) % stride).astype(np.uint16)
            else:
                tail_docs = np.empty(0, np.uint16)

        with timer.phase("host_views"):
            # vocab scale, while the device copies are in flight: per-run
            # rank-space segment tables from the df snapshot diffs; the
            # emit order came from the native finalize
            prov_of_rank = np.empty(vocab_size, dtype=np.int64)
            prov_of_rank[remap] = np.arange(vocab_size)

            def run_meta(prev, cur):
                c = np.zeros(vocab_size, np.int64)
                c[: cur.shape[0]] = cur
                c[: prev.shape[0]] -= prev
                off = np.cumsum(c) - c
                return off[prov_of_rank], c[prov_of_rank]

            runs_meta = [run_meta(prev, cur) for prev, cur in dev_snaps]
            # the tail's counts: the final df minus the last device snapshot
            tail_meta = run_meta(prev_snap, df_prov.astype(np.int64))

        with timer.phase("fetch"):
            fetched = [engine.host_u16(p.wait()) for p, _ in dev_handles]
        del staged

        with timer.phase("emit"):
            runs = [(arr, off, cnt) for arr, (off, cnt) in zip(fetched, runs_meta)]
            runs.append((tail_docs, *tail_meta))
            bytes_written = native.emit_native_runs(out_dir, vocab, emit_order, runs)
        timer.count("lines_written", vocab_size)
        timer.count("bytes_written", bytes_written)
        return timer.report()

    # -- streaming plan ------------------------------------------------

    def _run_streaming(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                       report: DegradationReport, device: torch.device) -> dict:
        """Windowed plan for corpora larger than host or device memory.

        Host memory stays O(window + vocab); device memory O(window +
        unique pairs).  Each window is tokenized into provisional ids
        and folded into the card's sorted unique-pair accumulator
        (ops/streaming.py); one finalize remaps to sorted-vocab rank and
        runs the engine's shared tail.  Byte-identical to the one-shot
        plan.
        """
        cfg = self.config
        max_doc_id = len(manifest)
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        tok = StreamingTokenizer(use_native=cfg.use_native, num_threads=threads)
        eng = StreamingIndexEngine(max_doc_id=max_doc_id, device=device,
                                   window_pad=cfg.pad_multiple)
        docs_loaded = raw_tokens = pairs_fed = 0
        vocab_curve: list[int] = []  # unique terms after each window
        with timer.phase("stream"):
            for contents, ids in iter_document_chunks(manifest, cfg.stream_chunk_docs, report):
                chunk = tok.feed(contents, ids)
                docs_loaded += len(contents)
                raw_tokens += chunk.raw_tokens
                pairs_fed += int(chunk.prov_term_ids.shape[0])
                eng.feed(chunk.prov_term_ids, chunk.doc_ids, tok.vocab_size)
                vocab_curve.append(tok.vocab_size)
        vocab, remap, letters = tok.finalize()
        vocab_size = int(vocab.shape[0])
        timer.count("documents", docs_loaded)
        timer.count("tokens", raw_tokens)
        timer.count("unique_terms", vocab_size)
        timer.count("vocab_curve", vocab_curve)
        timer.count("stream_windows", eng.windows_fed)
        timer.count("accumulator_capacity", eng.capacity)
        timer.count("accumulator_mode", eng.mode)

        if pairs_fed == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        with timer.phase("device_index"):
            # every copy to the host starts before any is read
            pending = {k: engine.PendingFetch(v)
                       for k, v in eng.finalize(remap, letters, vocab_size).items()}
        with timer.phase("fetch"):
            host = {k: p.wait() for k, p in pending.items()}
            host["num_unique"] = int(host["num_unique"])
        return self._emit_and_report(vocab, letters, host, out_dir, timer, max_doc_id)

    # -- all-device plan -----------------------------------------------

    def _run_device_tokenize(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                             report: DegradationReport, device: torch.device) -> dict:
        """All-device plan: raw bytes up, finished index down.

        The whole map phase — the reference's mapper tokenize/clean/emit
        (main.c:85-124) and its reducer dedup/df/sort (main.c:126-242) —
        runs as one device program over the corpus byte tensor
        (ops/device_tokenizer.py).  The host only loads files, decodes
        the fetched unique word rows and writes the letter files.  Exact
        by construction (words are sorted byte rows, not hashes); a
        cleaned token longer than ``device_tokenize_width`` raises
        WidthOverflow and the caller restarts on a host-scan plan.
        """
        cfg = self.config
        width = cfg.device_tokenize_width
        max_doc_id = len(manifest)
        with timer.phase("load"):
            contents, doc_ids = load_documents(manifest, report)
        num_docs = len(contents)
        total = sum(len(c) for c in contents)
        timer.count("documents", num_docs)
        timer.count("device_shards", 1)
        timer.count("device_tokenize_width", width)
        if num_docs == 0 or total == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        staged: list = []  # pinned uploads, held until the counts arrive
        with timer.phase("feed"):
            padded = _round_up(total, cfg.pad_multiple)
            buf, ends, idv = _pack_window(contents, doc_ids, padded)
            # one host pass: the exact token count (a snug tok_cap; note
            # N//2+1 is NOT a bound — doc boundaries split tokens, so up
            # to one token per byte) and the exact max cleaned length —
            # abort a doomed launch before paying for it, and skip radix
            # passes over provably all-zero word columns (sort_cols)
            tok_count, host_max_len = DT.host_token_stats(buf, ends)
            tok_cap = _round_up(tok_count + 1, 1 << 15)
            if host_max_len > width:
                raise DT.WidthOverflow(
                    f"cleaned token of {host_max_len} letters "
                    f"exceeds device_tokenize_width={width}")
            sort_cols = -(-max(host_max_len, 1) // 4)  # ceil div
            timer.count("sort_cols", sort_cols)
            out = DT.index_bytes_device(
                engine.upload(buf, device, staged), engine.upload(ends, device, staged),
                engine.upload(idv, device, staged),
                width=width, tok_cap=tok_cap, num_docs=num_docs, sort_cols=sort_cols)
        with timer.phase("device_index"):
            # the one sync: all five counts in one tensor
            num_words, num_pairs, max_len, num_tokens, num_long = (
                int(v) for v in out["counts"].cpu().numpy())
            if num_tokens + 1 > tok_cap:
                raise AssertionError(
                    f"device token count {num_tokens} exceeded "
                    f"tok_cap {tok_cap}: host mask count diverged "
                    "from the device classifier (bug)")
            if max_len != host_max_len:
                raise AssertionError(
                    f"device max word len {max_len} != host "
                    f"{host_max_len}: classifier divergence (bug)")
        del staged
        timer.count("unique_terms", num_words)
        timer.count("unique_pairs", num_pairs)
        # the raw token count never reaches the host in this plan; the
        # deduped pair count the device measured stands in for it
        timer.count("tokens", num_pairs)
        return self._fetch_decode_emit_device(
            out, cap=tok_cap, num_words=num_words, num_pairs=num_pairs,
            num_long=num_long, sort_cols=sort_cols, max_doc_id=max_doc_id,
            out_dir=out_dir, timer=timer)

    def _fetch_decode_emit_device(self, out: dict, *, cap: int, num_words: int,
                                  num_pairs: int, num_long: int, sort_cols: int,
                                  max_doc_id: int, out_dir: str, timer: PhaseTimer) -> dict:
        """Tail of the all-device plan: prefix-sliced fetch with transfer
        trimming, word-row decode, and the letter-file emit.

        Transfer trimming (``DT.fetch_pack``): group pairs past the
        host-exact ``sort_cols`` bound are provably all zero; tail
        groups travel sparsely (indices + values for only the >12-char
        words, the dense arrays rebuilt by a host scatter at vocab
        scale); postings pack 3 doc ids per int32 when ids fit 10 bits,
        else 16 bits when they fit 16.  Every copy starts before any is
        read.
        """
        width = self.config.device_tokenize_width
        if num_pairs == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()
        with timer.phase("fetch"):
            nu = min(cap, _round_up(max(num_words, 1), 1 << 13))
            npairs = min(cap, _round_up(max(num_pairs, 1), 1 << 13))
            ngroups_fetch = DT.live_groups_for(sort_cols, width)
            narrow = max_doc_id < (1 << 16)
            k = DT.doc_pack_width(max_doc_id)
            nlong = (min(nu, _round_up(num_long, 1 << 10))
                     if ngroups_fetch > 1 and num_long else 0)
            packed = DT.fetch_pack(out, nu=nu, npairs=npairs, nlong=nlong, k=k,
                                   live=ngroups_fetch, narrow=narrow)
            pending = {name: [engine.PendingFetch(t) for t in engine.leaves(v)]
                       for name, v in packed.items()}
            host = {name: [engine.host_view(p.wait()) for p in ps] for name, ps in pending.items()}
            df = host["df"][0][:num_words].astype(np.int32)
            postings = DT.unpack_postings(host["post"][0], num_pairs, k)
            g0 = tuple(h[:num_words] for h in host["g0"])
            tails = host.get("tail", [])
            groups = [g0] + DT.rebuild_tail_groups(
                num_words, ngroups_fetch,
                idx=host["long_idx"][0][:num_long] if nlong else None,
                tails=[(tails[2 * g], tails[2 * g + 1]) for g in range(len(tails) // 2)],
                num_long=num_long if nlong else 0)
            timer.count("fetched_bytes", sum(a.nbytes for arrays in host.values()
                                             for a in arrays))
        with timer.phase("host_views"):
            vocab = DT.decode_word_groups(groups, width)
            letters = vocab.view(np.uint8).reshape(num_words, width)[:, 0] - ord("a")
            df64 = df.astype(np.int64)
            order, offsets = engine.host_order_offsets(letters, df64)
        host_out = {"df": df64, "order": order, "offsets": offsets, "postings": postings,
                    "num_unique": num_pairs}
        return self._emit_and_report(vocab, letters, host_out, out_dir, timer, max_doc_id)

    # -- streaming all-device plan -------------------------------------

    def _run_device_tokenize_stream(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                                    report: DegradationReport, device: torch.device) -> dict:
        """Streaming all-device plan: document-aligned byte windows fold
        into a bounded word-row accumulator on the card
        (ops/device_streaming.py) — the all-device plan for corpora
        larger than device memory, with the same exactness contract (a
        too-wide token raises WidthOverflow before its window is fed).

        With ``stream_checkpoint`` the verified accumulator prefix and
        the stream position are saved every ``stream_checkpoint_every``
        windows, and a rerun resumes after the last saved window.  Each
        save drains the merge pipeline and fetches the accumulator, so
        its cost is projected first and, when over the budget, up to
        ``MRI_TPU_CKPT_STRETCH`` consecutive saves are skipped before one
        is forced; the link rate behind the projection is re-measured by
        every save.
        """
        cfg = self.config
        width = cfg.device_tokenize_width
        max_doc_id = len(manifest)
        timer.count("device_tokenize_width", width)
        timer.count("device_shards", 1)
        timer.count("documents", len(manifest))
        eng = DeviceStreamEngine(width=width, device=device)
        fed_tokens = 0

        ckpt_path = cfg.stream_checkpoint
        resume_from = 0
        if ckpt_path:
            stream_fp = checkpoint.stream_fingerprint(
                manifest, width=width, chunk_docs=cfg.stream_chunk_docs,
                pad_multiple=cfg.pad_multiple)
            if os.path.exists(ckpt_path):
                try:
                    state = checkpoint.load_stream_state(ckpt_path, stream_fp)
                except checkpoint.CheckpointCorrupt:
                    # the save is atomic (tmp + rename), but disk
                    # corruption or a foreign file at the path must not
                    # wedge a rerun under resume='auto'
                    if cfg.resume != "auto":
                        raise
                    timer.count("quarantined_checkpoint", checkpoint.quarantine(ckpt_path))
                else:
                    eng.restore(state)
                    fed_tokens = state["fed_tokens"]
                    # the loop position, not the engine's windows_fed:
                    # empty windows are not fed, so that count can lag
                    resume_from = state["window_pos"]
                    timer.count("resumed_from_window", resume_from)
        crash_after = envknobs.get("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS")
        total_windows = -(-len(manifest) // cfg.stream_chunk_docs)
        ckpt_seconds, ckpt_saves = 0.0, 0
        ckpt_ms_per_save: list[float] = []
        ckpt_skipped_projection_s: list[float] = []
        ckpt_budget_s = envknobs.get("MRI_TPU_CKPT_BUDGET_S")
        ckpt_rate_mbps = envknobs.get("MRI_TPU_CKPT_LINK_MBPS")
        ckpt_stretch = envknobs.get("MRI_TPU_CKPT_STRETCH")
        ckpt_consec_skips = 0

        with timer.phase("stream_feed"):
            for win_i, (contents, ids) in enumerate(
                    iter_document_chunks(manifest, cfg.stream_chunk_docs, report), start=1):
                if win_i <= resume_from:
                    continue
                total = sum(len(c) for c in contents)
                # a fresh host array per window: no buffer the card may
                # still read is ever refilled
                buf, ends, idv = _pack_window(contents, ids,
                                              _round_up(total, cfg.pad_multiple))
                cnt, ml = DT.host_token_stats(buf, ends)
                if ml > width:
                    raise DT.WidthOverflow(
                        f"cleaned token of {ml} letters exceeds "
                        f"device_tokenize_width={width}")
                eng.feed(buf, ends, idv, tok_count=cnt, max_len=ml)
                fed_tokens += cnt
                # no checkpoint on the last window: the finalize deletes
                # it moments later
                if (ckpt_path and win_i < total_windows
                        and (win_i - resume_from) % cfg.stream_checkpoint_every == 0):
                    nbytes = eng.snapshot_nbytes
                    projected = nbytes / (ckpt_rate_mbps * 1e6)
                    if projected > ckpt_budget_s and ckpt_consec_skips < ckpt_stretch:
                        ckpt_consec_skips += 1
                        ckpt_skipped_projection_s.append(round(projected, 2))
                    else:
                        ckpt_consec_skips = 0
                        t0 = time.perf_counter()
                        snap = eng.snapshot()
                        if snap is not None:
                            checkpoint.save_stream_state(ckpt_path, snap, fed_tokens, win_i,
                                                         stream_fp)
                            dt = time.perf_counter() - t0
                            ckpt_seconds += dt
                            ckpt_saves += 1
                            ckpt_ms_per_save.append(round(dt * 1e3, 2))
                            moved = snap["fetched_nbytes"]
                            if dt > 1e-3 and moved:
                                # the whole save's rate (drain + fetch +
                                # write) over the bytes the fetch moved,
                                # floored so one outlier cannot lock out
                                # every later save
                                ckpt_rate_mbps = max(moved / dt / 1e6, 0.5)
                if crash_after and win_i >= crash_after:
                    raise RuntimeError(
                        f"injected stream crash after window {win_i} "
                        "(MRI_TPU_STREAM_CRASH_AFTER_WINDOWS)")
        if ckpt_saves:
            # inside stream_feed's wall time, recorded apart so a
            # checkpointed run compares with an uncheckpointed one
            timer.count("checkpoint_saves", ckpt_saves)
            timer.count("checkpoint_ms", round(ckpt_seconds * 1e3, 2))
            timer.count("checkpoint_ms_per_save", ckpt_ms_per_save)
        if ckpt_skipped_projection_s:
            timer.count("checkpoint_skips", len(ckpt_skipped_projection_s))
            timer.count("checkpoint_skipped_projection_s", ckpt_skipped_projection_s)
            timer.count("checkpoint_budget_s", ckpt_budget_s)
        timer.count("stream_windows", eng.windows_fed)
        timer.count("accumulator_capacity", eng.capacity)
        if eng.rows_curve:
            # resolved unique-row counts per merge (trails the windows by
            # the merges still in flight)
            timer.count("unique_rows_curve", eng.rows_curve)
        if eng.windows_fed == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()
        sort_cols = -(-max(eng.max_word_len, 1) // 4)  # ceil div
        timer.count("sort_cols", sort_cols)

        with timer.phase("device_index"):
            out = eng.finalize()
            num_words, num_pairs, num_long = (
                int(v) for v in engine.PendingFetch(out["counts"]).wait())
        if ckpt_path and os.path.exists(ckpt_path):
            # the stream completed; a stale checkpoint would make the next
            # identical run skip every window
            os.remove(ckpt_path)
        timer.count("unique_terms", num_words)
        timer.count("unique_pairs", num_pairs)
        timer.count("tokens", fed_tokens)
        return self._fetch_decode_emit_device(
            out, cap=int(out["df"].shape[0]), num_words=num_words, num_pairs=num_pairs,
            num_long=num_long, sort_cols=sort_cols, max_doc_id=max_doc_id,
            out_dir=out_dir, timer=timer)

    # -- mesh plans ----------------------------------------------------

    def _run_streaming_dist(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                            report: DegradationReport) -> dict:
        """Streaming on a mesh: each window is exchanged by term hash
        into per-owner bounded accumulators (parallel/dist_streaming.py),
        so memory per shard is O(unique pairs / n)."""
        cfg = self.config
        num_shards = self._num_shards()
        mesh = make_mesh(num_shards, cfg.device)
        max_doc_id = len(manifest)
        stride = max_doc_id + 2
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        timer.count("device_shards", num_shards)
        tok = StreamingTokenizer(use_native=cfg.use_native, num_threads=threads)
        eng = DistStreamingIndexEngine(max_doc_id=max_doc_id, mesh=mesh,
                                       window_pad=cfg.pad_multiple)
        docs_loaded = raw_tokens = 0
        vocab_curve: list[int] = []
        with timer.phase("stream"):
            for contents, ids in iter_document_chunks(manifest, cfg.stream_chunk_docs, report):
                chunk = tok.feed(contents, ids)
                docs_loaded += len(contents)
                raw_tokens += chunk.raw_tokens
                eng.feed(chunk.prov_term_ids, chunk.doc_ids, tok.vocab_size)
                vocab_curve.append(tok.vocab_size)
        with timer.phase("finalize_vocab"):
            vocab, remap, letters = tok.finalize()
        vocab_size = int(vocab.shape[0])
        timer.count("documents", docs_loaded)
        timer.count("tokens", raw_tokens)
        timer.count("unique_terms", vocab_size)
        timer.count("vocab_curve", vocab_curve)
        timer.count("stream_windows", eng.windows_fed)
        timer.count("accumulator_capacity_per_owner", eng.capacity)
        timer.count("accumulator_mode", eng.mode)
        timer.count("merge_retries", eng.merge_retries)

        dist_stats: dict = {}
        with timer.phase("fetch"):
            mode, rows = eng.finalize(stats=dist_stats)
        for k, v in dist_stats.items():
            timer.count(k, v)
        num_pairs = int(sum((r[0].size if mode == "pairs" else r.size) for r in rows.values()))
        if num_pairs == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()
        # vocab-scale views in prov space, then the O(N) owner-run merge
        # (the pipelined mesh tail's math)
        if mode == "pairs":
            terms = np.concatenate([r[0].astype(np.int64) for r in rows.values()])
        else:
            terms = np.concatenate([r // stride for r in rows.values()])
        df_prov = np.bincount(terms, minlength=vocab_size).astype(np.int64)
        offsets_prov = np.cumsum(df_prov) - df_prov
        if mode == "pairs":
            postings = dist_engine.merge_owner_pair_runs(rows.values(), offsets_prov, num_pairs)
        else:
            postings = dist_engine.merge_owner_runs(rows.values(), stride, offsets_prov,
                                                    num_pairs)
        prov_of_rank = np.empty(vocab_size, dtype=np.int64)
        prov_of_rank[remap] = np.arange(vocab_size)
        df_rank = df_prov[prov_of_rank]
        order, _ = engine.host_order_offsets(letters, df_rank)
        host = {"df": df_rank, "order": order, "offsets": offsets_prov[prov_of_rank],
                "postings": postings, "num_unique": num_pairs}
        return self._emit_and_report(vocab, letters, host, out_dir, timer, max_doc_id)

    def _run_device_tokenize_dist(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                                  report: DegradationReport) -> dict:
        """All-device plan on a mesh: each shard tokenizes a contiguous
        doc range's bytes; one ``all_to_all`` exchanges whole word rows
        by content hash (or by letter owner); owners dedup and count
        their terms (parallel/dist_device_tokenizer.py).  The host
        decodes per-owner vocab blocks and merges at vocab scale, or,
        with ``emit_ownership="letter"``, each owner writes its own
        letter files."""
        cfg = self.config
        width = cfg.device_tokenize_width
        n = self._num_shards()
        mesh = make_mesh(n, cfg.device)
        max_doc_id = len(manifest)
        with timer.phase("load"):
            shards = list(iter_document_ranges(
                manifest, plan_contiguous_windows(manifest, n), report))
        num_docs = sum(len(c) for c, _ in shards)
        total = sum(len(b) for c, _ in shards for b in c)
        timer.count("documents", num_docs)
        timer.count("device_shards", n)
        timer.count("device_tokenize_width", width)
        if num_docs == 0 or total == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        with timer.phase("feed"):
            shard_len = _round_up(max(max(sum(len(b) for b in c) for c, _ in shards), 1),
                                  cfg.pad_multiple)
            docs_cap = max(max(len(c) for c, _ in shards), 1)
            bufs, ends_l, ids_l = [], [], []
            tok_count = host_max_len = 0
            for contents, ids in shards:
                buf, ends, idv = _pack_window(contents, ids, shard_len, docs_cap)
                cnt, ml = DT.host_token_stats(buf, ends)
                tok_count = max(tok_count, cnt)
                host_max_len = max(host_max_len, ml)
                bufs.append(buf)
                ends_l.append(ends)
                ids_l.append(idv)
            tok_cap = _round_up(tok_count + 1, 1 << 14)
            if host_max_len > width:
                raise DT.WidthOverflow(
                    f"cleaned token of {host_max_len} letters exceeds "
                    f"device_tokenize_width={width}")
            sort_cols = -(-max(host_max_len, 1) // 4)  # ceil div
            timer.count("sort_cols", sort_cols)

        letter_mode = cfg.emit_ownership == "letter"
        owner_of_letter = ranges = None
        if letter_mode:
            ranges, owner_of_letter = owner_of_letter_table(n)
            timer.count("emit_ownership", "letter")

        dist_stats: dict = {}
        with timer.phase("device_index"):
            owners, (max_len, _) = index_bytes_dist(
                bufs, ends_l, ids_l, width=width, tok_cap=tok_cap, mesh=mesh,
                stats=dist_stats, sort_cols=sort_cols, max_doc_id=max_doc_id,
                owner_of_letter=owner_of_letter)
            if max_len != host_max_len:
                raise AssertionError(
                    f"device max word len {max_len} != host {host_max_len}: "
                    "classifier divergence (bug)")
        for k, v in dist_stats.items():
            timer.count(k, v)

        if not letter_mode:
            return self._merge_emit_owner_blocks(owners, max_doc_id=max_doc_id,
                                                 out_dir=out_dir, timer=timer)
        # per-owner letter emit: owner o holds every word of its letter
        # range (the reference's reducer ownership, main.c:129-150, at
        # raw-text level), so each owner's block writes its own files
        lines = 0
        with timer.phase("host_views_emit"):
            for o, ow in sorted(owners.items()):
                if ow["num_words"] == 0:
                    formatter.emit_index(
                        out_dir, vocab=np.empty(0, "S1"), letter_of_term=np.empty(0, np.int64),
                        order=np.empty(0, np.int64), df=np.empty(0, np.int64),
                        offsets=np.empty(0, np.int64), postings=np.empty(0, np.int32),
                        max_doc_id=max_doc_id, letter_range=ranges[o])
                    continue
                vocab_o = DT.decode_word_groups(ow["unique_groups"], width)
                df_o = ow["df"].astype(np.int64)
                letters_o = vocab_o.view(np.uint8).reshape(ow["num_words"], width)[:, 0] - ord("a")
                order_o = np.lexsort((vocab_o, -df_o, letters_o))
                stats_o = formatter.emit_index(
                    out_dir, vocab=vocab_o, letter_of_term=letters_o, order=order_o, df=df_o,
                    offsets=np.cumsum(df_o) - df_o, postings=ow["postings"].astype(np.int32),
                    max_doc_id=max_doc_id, letter_range=ranges[o],
                    backend=self._emit_backend())
                lines += stats_o["lines_written"]
        timer.count("letter_owners", n)
        timer.count("unique_terms", sum(ow["num_words"] for ow in owners.values()))
        timer.count("unique_pairs", sum(ow["num_pairs"] for ow in owners.values()))
        timer.count("lines_written", lines)
        return timer.report()

    def _merge_emit_owner_blocks(self, owners, *, max_doc_id: int, out_dir: str,
                                 timer: PhaseTimer) -> dict:
        """Merged-emit tail of the mesh device plans: decode the
        per-owner vocab blocks and merge at vocab scale — token-scale
        data never re-sorts on the host."""
        width = self.config.device_tokenize_width
        with timer.phase("host_views"):
            vocab_parts, df_parts, off_parts, post_parts = [], [], [], []
            base = 0
            for o in sorted(owners):
                ow = owners[o]
                if ow["num_words"] == 0:
                    continue
                vocab_parts.append(DT.decode_word_groups(ow["unique_groups"], width))
                df_o = ow["df"].astype(np.int64)
                off_parts.append(np.cumsum(df_o) - df_o + base)
                df_parts.append(df_o)
                post_parts.append(ow["postings"].astype(np.int32))
                base += ow["num_pairs"]
            num_words = sum(len(v) for v in vocab_parts)
            num_pairs = base
            timer.count("unique_terms", num_words)
            timer.count("unique_pairs", num_pairs)
            timer.count("tokens", num_pairs)
            if num_pairs == 0:
                with timer.phase("emit"):
                    formatter.emit_grouped(out_dir, {},
                                           artifact_path=self._artifact_path(out_dir))
                return timer.report()
            vocab = np.concatenate(vocab_parts)
            df64 = np.concatenate(df_parts)
            offsets = np.concatenate(off_parts)
            postings = np.concatenate(post_parts)
            letters = vocab.view(np.uint8).reshape(num_words, width)[:, 0] - ord("a")
            # global emit order across the owner blocks: (letter asc, df
            # desc, word asc) — the words themselves break ties (owner
            # blocks are hash-ordered, not rank-ordered)
            order = np.lexsort((vocab, -df64, letters))
        with timer.phase("emit"):
            emit_stats = formatter.emit_index(
                out_dir, vocab=vocab, letter_of_term=letters, order=order, df=df64,
                offsets=offsets, postings=postings, max_doc_id=max_doc_id,
                backend=self._emit_backend(), artifact_path=self._artifact_path(out_dir))
        timer.count("lines_written", emit_stats["lines_written"])
        self._count_artifact_stats(timer, emit_stats)
        return timer.report()

    def _run_device_tokenize_stream_dist(self, manifest: Manifest, out_dir: str,
                                         timer: PhaseTimer, report: DegradationReport) -> dict:
        """Streaming all-device plan on a mesh: each window's raw bytes
        are split over the shards, tokenized per shard, exchanged by
        content hash and folded into bounded per-owner row accumulators
        (parallel/dist_device_streaming.py).  Every shard's window is
        packed into fresh arrays."""
        cfg = self.config
        width = cfg.device_tokenize_width
        n = self._num_shards()
        mesh = make_mesh(n, cfg.device)
        max_doc_id = len(manifest)
        timer.count("device_tokenize_width", width)
        timer.count("device_shards", n)
        timer.count("documents", len(manifest))
        eng = DistDeviceStreamEngine(width=width, mesh=mesh)
        with timer.phase("stream_feed"):
            for contents, ids in iter_document_chunks(manifest, cfg.stream_chunk_docs, report):
                # byte-balanced contiguous doc split of this window — the
                # scheduler's one greedy-cut policy
                parts = [(contents[lo:hi], ids[lo:hi])
                         for lo, hi in plan_contiguous_ranges([len(c) for c in contents], n)]
                shard_len = _round_up(
                    max(max((sum(len(c) for c in cs) for cs, _ in parts), default=1), 1),
                    cfg.pad_multiple)
                docs_cap = max(max(len(c) for c, _ in parts), 1)
                bufs, ends_l, ids_l = [], [], []
                tok_count = max_len = 0
                for contents_s, ids_s in parts:
                    buf, ends, idv = _pack_window(contents_s, ids_s, shard_len, docs_cap)
                    cnt, ml = DT.host_token_stats(buf, ends)
                    tok_count = max(tok_count, cnt)
                    max_len = max(max_len, ml)
                    bufs.append(buf)
                    ends_l.append(ends)
                    ids_l.append(idv)
                if max_len > width:
                    raise DT.WidthOverflow(
                        f"cleaned token of {max_len} letters exceeds "
                        f"device_tokenize_width={width}")
                eng.feed(bufs, ends_l, ids_l, tok_count=tok_count, max_len=max_len)
        timer.count("stream_windows", eng.windows_fed)
        if eng.windows_fed == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()
        sort_cols = -(-max(eng.max_word_len, 1) // 4)  # ceil div
        timer.count("sort_cols", sort_cols)
        dist_stats: dict = {}
        with timer.phase("device_index"):
            owners = eng.finalize(sort_cols=sort_cols, max_doc_id=max_doc_id, stats=dist_stats)
        for k, v in dist_stats.items():
            timer.count(k, v)
        return self._merge_emit_owner_blocks(owners, max_doc_id=max_doc_id, out_dir=out_dir,
                                             timer=timer)

    # -- one-shot plan -------------------------------------------------

    def _run_one_shot(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                      report: DegradationReport, device: torch.device) -> dict:
        cfg = self.config
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        with timer.phase("load"):
            contents, doc_ids = load_documents(manifest, report)
        with timer.phase("tokenize"):
            corpus = tokenize(contents, doc_ids, use_native=cfg.use_native,
                              dedup_pairs=True, num_threads=threads)

        max_doc_id = len(manifest)  # doc ids are 1..len(manifest)
        num_tokens, vocab_size = corpus.num_tokens, corpus.vocab_size
        timer.count("documents", len(contents))
        timer.count("tokens", corpus.raw_tokens if corpus.raw_tokens is not None else num_tokens)
        timer.count("unique_terms", vocab_size)

        if cfg.collect_skew_stats and num_tokens:
            from ..utils.stats import partition_skew

            buckets = max(torch.cuda.device_count(), 2) if device.type == "cuda" else 2
            with timer.phase("skew_stats"):
                skew = partition_skew(corpus.term_ids, corpus.letter_of_term,
                                      num_buckets=buckets, device=device)
            timer.count("letter_imbalance", round(skew["letter_imbalance"], 3))
            timer.count("bucket_imbalance", round(skew["bucket_imbalance"], 3))

        if num_tokens == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {}, artifact_path=self._artifact_path(out_dir))
            return timer.report()

        packed = K.can_pack(vocab_size, max_doc_id)
        num_shards = self._num_shards()
        use_dist = num_shards > 1 and packed
        # half-bandwidth path: uint16 feed + fetch
        use_u16 = not use_dist and packed and vocab_size <= 0xFFFF and max_doc_id <= 0xFFFE
        prededuped = use_u16 and corpus.pairs_deduped
        padded = _round_up(num_tokens, cfg.pad_multiple)
        mesh = None
        if use_dist:
            padded = _round_up(padded, num_shards)
            mesh = make_mesh(num_shards, cfg.device)
        timer.count("device_shards", num_shards if use_dist else 1)
        timer.count("engine", "u16_prededuped" if prededuped else "u16" if use_u16
                    else "dist" if use_dist else "packed" if packed else "pairs")
        staged: list = []  # pinned shard uploads (mesh), held until the fetch
        with timer.phase("feed"):
            if use_u16:
                feed = engine.u16_feed_tensor(
                    engine.pack_u16_feed(corpus.term_ids, corpus.doc_ids, padded), device)
            else:
                letters = torch.from_numpy(corpus.letter_of_term).to(device)
                pad = np.full(padded - num_tokens, K.INT32_MAX, np.int32)
                if packed:
                    host_keys = np.full(padded, K.INT32_MAX, dtype=np.int32)
                    np.multiply(corpus.term_ids, max_doc_id + 2, out=host_keys[:num_tokens])
                    host_keys[:num_tokens] += corpus.doc_ids
                    if use_dist:
                        keys = shard(host_keys, mesh, staged)
                    else:
                        keys = torch.from_numpy(host_keys).to(device)
                else:
                    terms = torch.from_numpy(np.concatenate([corpus.term_ids, pad])).to(device)
                    docs = torch.from_numpy(np.concatenate([corpus.doc_ids, pad])).to(device)

        if prededuped:
            # the combiner already emitted each (term, doc) once: the
            # device program is one sort, and its fetch is issued at once
            # so the host derives df/order/offsets meanwhile
            nfetch = min(padded, _round_up(num_tokens, 1 << 14))
            with timer.phase("device_index"):
                pending = engine.PendingFetch(engine.index_prededuped_u16(
                    feed, max_doc_id=max_doc_id, out_size=nfetch))
                df = np.bincount(corpus.term_ids, minlength=vocab_size).astype(np.int64)
                # guard the combiner invariant this path relies on
                if len(df) != vocab_size or (vocab_size and int(df.max()) > max_doc_id):
                    raise ValueError(
                        "pairs_deduped feed violates its invariant "
                        f"(df len {len(df)} vs vocab {vocab_size}); tokenizer bug")
                order, offsets = engine.host_order_offsets(corpus.letter_of_term, df)
            with timer.phase("fetch"):
                host = {"df": df, "order": order, "offsets": offsets,
                        "postings": engine.host_u16(pending.wait()), "num_unique": num_tokens}
            return self._emit_and_report(corpus.vocab, corpus.letter_of_term, host, out_dir,
                                         timer, max_doc_id)

        with timer.phase("device_index"):
            if use_u16:
                out = engine.index_u16(feed, vocab_size=vocab_size, max_doc_id=max_doc_id)
            elif use_dist:
                # postings come back assembled on the host
                out = dist_engine.dist_index(
                    keys, letters, vocab_size=vocab_size, max_doc_id=max_doc_id,
                    mesh=mesh)
            elif packed:
                out = engine.index_packed(
                    keys, letters, vocab_size=vocab_size, max_doc_id=max_doc_id)
            else:
                out = engine.index_pairs(
                    terms, docs, letters, vocab_size=vocab_size, max_doc_id=max_doc_id)
            if device.type == "cuda":
                # so fetch below times the transfer, not the compute
                torch.cuda.synchronize(device)

        with timer.phase("fetch"):
            if use_u16:
                # df first (num_unique derives from its sum), then only the
                # valid postings prefix, rounded to a stable granule
                combined = out["combined"]
                df = engine.narrow_u16(combined[:vocab_size]).astype(np.int64)
                num_unique = int(df.sum())
                nfetch = min(padded, _round_up(max(num_unique, 1), 1 << 14))
                postings = engine.narrow_u16(combined[vocab_size : vocab_size + nfetch])
                order, offsets = engine.host_order_offsets(corpus.letter_of_term, df)
                host = {"df": df, "order": order, "offsets": offsets,
                        "postings": postings, "num_unique": num_unique}
            else:
                host = {k: v if isinstance(v, np.ndarray) else v.cpu().numpy()
                        for k, v in out.items()}

        return self._emit_and_report(corpus.vocab, corpus.letter_of_term, host, out_dir,
                                     timer, max_doc_id)

    # -- emit ----------------------------------------------------------

    def _emit_backend(self) -> str:
        """``config.emit_backend`` for the formatter: ``auto`` respects
        ``use_native`` (the scan's native switch), so one knob still
        forces an all-Python run."""
        if self.config.emit_backend == "auto" and not self.config.use_native:
            return "python"
        return self.config.emit_backend

    def _emit_and_report(self, vocab, letter_of_term, host: dict, out_dir: str,
                         timer: PhaseTimer, max_doc_id: int) -> dict:
        with timer.phase("emit"):
            emit_stats = formatter.emit_index(
                out_dir,
                vocab=vocab,
                letter_of_term=letter_of_term,
                order=host["order"],
                df=host["df"],
                offsets=host["offsets"],
                postings=host["postings"],
                max_doc_id=max_doc_id,
                backend=self._emit_backend(),
                artifact_path=self._artifact_path(out_dir),
            )
        timer.count("unique_pairs", int(host["num_unique"]))
        timer.count("lines_written", emit_stats["lines_written"])
        self._count_artifact_stats(timer, emit_stats)
        return timer.report()


def build_index(manifest: Manifest, config: IndexConfig | None = None,
                output_dir: str | None = None) -> dict:
    """One-shot convenience: index a manifest and write the letter files."""
    return InvertedIndexModel(config).run(manifest, output_dir)
