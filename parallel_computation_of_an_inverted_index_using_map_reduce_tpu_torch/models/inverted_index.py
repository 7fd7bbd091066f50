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
    "cpu"    — the host backend, no card: the JAX package's
               re-architecture of the reference's regime.  A reader
               thread per scan worker fills reusable window arenas (io/)
               while the GIL-releasing native scan (native.HostIndexStream)
               works on the last one; K workers pull byte windows from a
               lease-based steal queue (corpus/scheduler.StealQueue), a
               native merge joins their vocabularies, and M reducer
               threads emit letter ranges.  ``MRI_BUILD_SPILL_BYTES`` adds
               the out-of-core tier (build/: term-hash-sharded spill runs,
               a k-way shard merge); ``--artifact`` packs ``index.mri``
               straight off the merge state.  Worker deaths requeue their
               windows for a rescan, a dead reducer's letters are
               re-emitted.
    "oracle" — pure-Python dict oracle (models/oracle.py)

Output is byte-identical across backends and plans, to the JAX package,
and to the pthread reference.  With ``config.artifact`` every plan but
the overlap plan also packs the serving artifact ``index.mri``
(serve/artifact.py) from the arrays it emits.

Every run records its read retries and skipped documents in one
degradation report (faults.py); ``checkpoint_path`` saves or resumes the
one-shot plan's tokenized pairs, ``profile_dir`` records the device
phases with torch.profiler, ``trace_out`` writes a Chrome trace and
``audit`` the output manifest (audit.py).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time

import numpy as np
import torch

from .. import faults, native
from ..config import IndexConfig
from ..corpus.manifest import (DegradationReport, Manifest, iter_document_chunks,
                               iter_document_ranges, load_documents, prefetch_document_ranges)
from ..corpus.scheduler import (owner_of_letter_table, plan_contiguous_ranges,
                                plan_contiguous_windows, plan_fraction_windows,
                                window_balance_stats)
from ..obs import chrometrace
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

log = logging.getLogger("mri_torch.model")


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


def _profile_ctx(profile_dir: str | None, device):
    """One torch.profiler gate for every plan (the JAX package's
    ``_profile_ctx``): CPU activity, and CUDA activity on the card,
    written into ``profile_dir`` as a Chrome trace when the context
    exits; a null context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))


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
        self._meshes: list = []  # the run's meshes (_make_mesh)

    def _new_timer(self) -> PhaseTimer:
        self.timer = timer = PhaseTimer()
        timer.count("num_mappers", self.config.num_mappers)
        timer.count("num_reducers", self.config.num_reducers)
        return timer

    def run(self, manifest: Manifest, output_dir: str | None = None) -> dict:
        cfg = self.config
        # one degradation report per run: every read records its retries
        # and skipped documents here, and the summary rides the stats
        # into the CLI (exit faults.EXIT_DEGRADED when documents were
        # skipped)
        report = faults.begin_run()
        # Chrome trace export (--trace-out): written once, after the
        # run; the host backend records per-stage spans into it, the
        # device plans none (the JAX device plans' sparse trace)
        trace = None
        if cfg.trace_out:
            trace = chrometrace.TraceEvents()
            trace.name_thread(chrometrace.MAIN, "main")
        self._trace = trace
        self._meshes = []
        timer = self._new_timer()
        out_dir = output_dir if output_dir is not None else cfg.output_dir
        if cfg.backend == "oracle":
            with timer.phase("oracle"):
                stats = oracle_index(manifest, out_dir, report,
                                     artifact_path=self._artifact_path(out_dir))
            stats = {**stats, **timer.report()}
        elif cfg.backend == "cpu":
            stats = self._run_cpu(manifest, out_dir, timer, report)
        else:
            stats = self._run_device(manifest, out_dir, timer, report)
        if trace is not None:
            trace.write(cfg.trace_out)
            stats["trace_out"] = cfg.trace_out
        sent = [m.sent_bytes for m in self._meshes if m.backend is not None]
        if sent:  # in a process group: what this process sent the others
            stats["dist_sent_bytes"] = sum(sent)
        if cfg.audit:
            # the output manifest after the emit, so --verify can re-check
            # the directory later; its time is the audit's whole cost
            from .. import audit as audit_mod

            t0 = time.perf_counter()
            audit_mod.write_output_manifest(out_dir)
            stats["audit_ms"] = round(
                stats.get("audit_ms", 0.0) + (time.perf_counter() - t0) * 1e3, 3)
        stats["degradation"] = report.summary()
        if report.degraded or report.worker_recoveries or report.reducer_takeovers:
            report.log_summary()
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
                report.clear()  # the host plan rereads and records anew
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
                report.clear()  # the one-shot plan rereads and records anew
        return self._run_one_shot(manifest, out_dir, timer, report, device)

    def _make_mesh(self, num_shards: int):
        """A plan's mesh on ``config.device``, kept for the run's
        ``dist_sent_bytes``."""
        mesh = make_mesh(num_shards, self.config.device)
        self._meshes.append(mesh)
        return mesh

    def _num_shards(self) -> int:
        """Logical shards of this run: ``device_shards``, else one per
        visible card of ``config.device`` (1 on the CPU)."""
        cfg = self.config
        if cfg.device_shards is not None:
            return cfg.device_shards
        return torch.cuda.device_count() if cfg.device == "cuda" else 1

    def _pipelined_eligible(self, manifest: Manifest) -> bool:
        """Whether the provisional-key pipelined plan applies: it needs
        the native scan, no streaming plan and neither a pairs checkpoint
        nor skew statistics (which need the token arrays on the host).
        On one device it also needs uint16 postings (doc ids < 0xFFFF);
        the mesh variant fetches int32 and has no doc cap."""
        cfg = self.config
        return (
            cfg.pipeline_chunk_docs != 0
            and cfg.use_native
            and cfg.stream_chunk_docs is None
            and cfg.checkpoint_path is None
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
        mesh = self._make_mesh(num_shards) if num_shards > 1 else None
        if mesh is not None and cfg.emit_ownership != "letter":
            dist_engine.require_all_local(mesh, "merged")
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
        with timer.phase("device_index"), _profile_ctx(cfg.profile_dir, device):
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
            if cfg.profile_dir:
                pending.wait()  # keep the in-flight sort and copy inside the trace
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
        # exchange + fetch + host merge in one blocking call, all inside
        # the profiled device phase
        with timer.phase("device_index"), _profile_ctx(self.config.profile_dir,
                                                       self.config.device):
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
        pairs; nothing merges the global postings.  Each process emits
        its own owners in turn (every owner, with no process group).
        """
        n = mesh.size
        ranges, owner_of_letter = owner_of_letter_table(n)
        letters = np.asarray(letters)
        owner_of_prov = owner_of_letter[letters[np.asarray(remap)]]
        dist_stats: dict = {}
        with timer.phase("device_index"), _profile_ctx(self.config.profile_dir,
                                                       self.config.device):
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
        # the trace spans dispatch through fetch: the device sorts and
        # copies this plan overlaps end long after the feed loop
        profile = contextlib.ExitStack()
        profile.enter_context(_profile_ctx(cfg.profile_dir, device))
        try:
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
        except BaseException:
            profile.close()
            raise

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
            profile.close()
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
        profile.close()
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
        with timer.phase("stream"), _profile_ctx(cfg.profile_dir, device):
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
        with _profile_ctx(cfg.profile_dir, device):
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

        with _profile_ctx(cfg.profile_dir, device), timer.phase("stream_feed"):
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
                # fault hook (faults.py sigkill:window=K): kill this
                # process at the window boundary, after any checkpoint
                # save above; a rerun with resume='auto' must give the
                # same bytes
                inj = faults.active()
                if inj is not None:
                    inj.on_window_boundary(win_i)
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
        mesh = self._make_mesh(num_shards)
        dist_engine.require_all_local(mesh, "merged")
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
        with timer.phase("stream"), _profile_ctx(cfg.profile_dir, cfg.device):
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
        letter files: in a process group, each process its own owners'."""
        cfg = self.config
        width = cfg.device_tokenize_width
        n = self._num_shards()
        mesh = self._make_mesh(n)
        letter_mode = cfg.emit_ownership == "letter"
        if not letter_mode:
            dist_engine.require_all_local(mesh, "merged")
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
        mesh = self._make_mesh(n)
        dist_engine.require_all_local(mesh, "merged")
        max_doc_id = len(manifest)
        timer.count("device_tokenize_width", width)
        timer.count("device_shards", n)
        timer.count("documents", len(manifest))
        eng = DistDeviceStreamEngine(width=width, mesh=mesh)
        with _profile_ctx(cfg.profile_dir, cfg.device), timer.phase("stream_feed"):
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

    # -- the host backend (backend='cpu') ------------------------------------

    def _run_cpu(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                 report: DegradationReport) -> dict:
        """All-on-host engine, pipelined read → tokenize → emit.

        The reference's regime — CPU only — re-architected: no spill
        files, no locks, no token-scale sorts.  Default path: a reader
        thread fills reusable window arenas (io.executor) while the
        GIL-releasing incremental scan (native.HostIndexStream) chews
        the previous window — zero join/marshal copies end to end.
        K > 1 scan workers or M > 1 reducers take the parallel route
        (:meth:`_run_cpu_parallel`), and so do ``MRI_BUILD_SPILL_BYTES``
        and ``--artifact``; ``--io-prefetch 0`` takes the one-shot
        fork-join call (its byte-balanced worker split needs the whole
        corpus resident).  Falls back to the Python oracle when the
        native library does not build (or ``use_native`` is off),
        keeping the backend usable everywhere, and says so in
        ``cpu_fallback``.
        """
        if not self.config.use_native or not native.available():
            with timer.phase("oracle"):
                stats = oracle_index(
                    manifest, out_dir, report,
                    artifact_path=self._artifact_path(out_dir))
            timer.count("cpu_fallback", "oracle")
            return {**stats, **timer.report()}
        threads = self.config.resolved_host_threads()
        timer.count("host_threads", threads)
        if envknobs.get("MRI_BUILD_SPILL_BYTES") is not None:
            # Out-of-core route: scan workers spill term-hash-sharded
            # postings runs at the MRI_BUILD_SPILL_BYTES budget and the
            # reduce becomes a per-shard streaming k-way merge over the
            # run files.  Takes the parallel topology even at K = M = 1
            # so every (K, M, shards, budget) point shares one path —
            # and stays byte-identical to the in-memory merge.
            return self._run_cpu_parallel(manifest, out_dir, timer, report, threads)
        if self.config.artifact:
            # The serving artifact packs straight off the merge state's
            # columnar export (no letter-file round-trip), so --artifact
            # routes through the parallel reduce even at K = M = 1 —
            # byte-identical letter files at every (K, M) regardless.
            return self._run_cpu_parallel(manifest, out_dir, timer, report, threads)
        if self.config.io_prefetch > 0:
            # resolved_host_threads drives the pipelined path too (it
            # used to fall off to the one-shot call for any K > 1,
            # reporting host_threads=1 work): K scan workers + M letter
            # reducers when either knob asks for parallelism.
            if threads > 1 or self.config.num_reducers > 1:
                return self._run_cpu_parallel(manifest, out_dir, timer,
                                              report, threads)
            return self._run_cpu_pipelined(manifest, out_dir, timer, report)
        with timer.phase("load"):
            contents, doc_ids = load_documents(manifest, report)
        with timer.phase("index_emit"):
            stats = native.host_index_native(
                contents, doc_ids, out_dir, num_threads=threads)
        for key, value in stats.items():
            timer.count(key, value)
        return timer.report()

    # ~2 MB windows: several windows even for small corpora (so the
    # read-ahead has something to hide behind) while staying resident in
    # L2/L3 for the scan that immediately follows the fill.
    _CPU_WINDOW_BYTES = 2 << 20

    # Spill-budget cost model (MRI_BUILD_SPILL_BYTES): estimated native
    # scan-state footprint is pairs * 16 + vocab * 56 — a (term, doc)
    # pair holds a packed 8-byte id plus tf and flatten scratch; a
    # local term holds its arena bytes, offset/length entries, combiner
    # row, and hash slot.  An estimate, not an accounting: the budget
    # bounds worker postings memory to within a small constant factor.
    _SPILL_PAIR_BYTES = 16
    _SPILL_TERM_BYTES = 56

    def _cpu_window_bytes(self) -> int:
        # MRI_CPU_WINDOW_BYTES forces tiny windows from a subprocess —
        # the SIGKILL-at-window-boundary e2e tests need a multi-window
        # plan on a corpus small enough to kill deterministically.
        override = envknobs.get("MRI_CPU_WINDOW_BYTES")
        return override if override is not None else self._CPU_WINDOW_BYTES

    def _run_cpu_pipelined(self, manifest: Manifest, out_dir: str,
                           timer: PhaseTimer, report: DegradationReport) -> dict:
        """Arena-fed incremental host index (the io subsystem path).

        Stage attribution lands in the ``stage_*_ms`` counters: read is
        the reader thread's busy time, tokenize the native scan +
        postings finalize, emit the letter-file render + write — the
        split the JAX bench reports as ``host_stage_split``.
        """
        from ..io.executor import PipelinedWindowReader
        from ..io.reader import plan_byte_windows

        window_bytes = self._cpu_window_bytes()
        windows = plan_byte_windows(manifest, window_bytes)
        max_docs = max((hi - lo for lo, hi in windows), default=1)
        # The arena ring is reused across run() calls (steady-state: no
        # page faults from fresh buffers); construct the reader FIRST —
        # its thread starts filling window 0 while HostIndexStream
        # allocates its vocab table below.
        arenas = getattr(self, "_cpu_arenas", None)
        if arenas is not None and len(arenas) != self.config.io_prefetch + 1:
            arenas = None
        trace = getattr(self, "_trace", None)
        if trace is not None:
            trace.name_thread(chrometrace.READER_BASE, "reader-0")
            trace.name_thread(chrometrace.SCAN_BASE, "scan-worker-0")
        reader = PipelinedWindowReader(
            manifest, windows, depth=self.config.io_prefetch,
            byte_capacity=window_bytes + (window_bytes >> 2),
            doc_capacity=max_docs, arenas=arenas, report=report, trace=trace)
        self._cpu_arenas = reader.arenas
        stream = native.HostIndexStream()
        try:
            with reader, timer.phase("ingest_scan"):
                for arena in reader:
                    buf, ends, ids = arena.feed_views()
                    t0 = time.perf_counter()
                    stream.feed_arrays(buf, ends, ids)
                    if trace is not None:
                        trace.span("scan", t0, time.perf_counter(),
                                   tid=chrometrace.SCAN_BASE,
                                   args={"window": arena.window_index})
                    reader.recycle(arena)
            with timer.phase("finalize_emit"):
                t0 = time.perf_counter()
                stats = stream.finalize_emit(out_dir)
                if trace is not None:
                    trace.span("finalize_emit", t0, time.perf_counter())
        finally:
            stream.close()
            reader.close()
        for key, value in stats.items():
            timer.count(key, value)
        timer.count("io_windows", len(windows))
        timer.count("io_prefetch", self.config.io_prefetch)
        timer.count("stage_read_ms", round(reader.read_busy_s * 1e3, 3))
        timer.count("stage_tokenize_ms",
                    round(stats["scan_ms"] + stats["finalize_ms"], 3))
        timer.count("stage_emit_ms", round(stats["emit_ms"], 3))
        timer.count("read_wait_ms", round(reader.read_wait_s * 1e3, 3))
        timer.count("consume_wait_ms", round(reader.consume_wait_s * 1e3, 3))
        return timer.report()

    def _run_cpu_parallel(self, manifest: Manifest, out_dir: str,
                          timer: PhaseTimer, report: DegradationReport,
                          num_workers: int) -> dict:
        """K-worker map + M-reducer reduce on the pipelined host path.

        The reference's fork-join topology (N mapper threads scanning
        file shards, M reducer threads owning letter ranges,
        main.c:85-242) rebuilt on the zero-copy pipeline: every scan
        worker owns its own arena ring + reader thread + incremental
        native handle and pulls byte windows from one shared
        :class:`StealQueue`, so a slow stripe never idles the rest.
        ctypes releases the GIL for the native scan, partial-flatten,
        and emit calls — the Python threads are genuinely concurrent in
        C++.  Reduce is letter-partitioned: ``plan_letter_ranges``
        (``num_reducers``) splits the merged emit order and each
        reducer renders its range through the shared vectorized emit.
        Output is byte-identical to the single-worker path at every
        (K, M) — scheduling can reorder work, never bytes.

        Fault tolerance (the MapReduce re-execution move): windows are
        LEASED, not given away — a worker death (escaping exception,
        :class:`~..io.executor.ReaderDied`, or the optional
        ``MRI_WINDOW_DEADLINE_S`` lease watchdog) requeues everything
        attributed to it, completed windows included (its native handle
        dies with it), and survivors rescan; when the queue is left
        non-empty after the join, up to ``MRI_WORKER_RESPAWNS``
        (default 1) replacement workers drain it.  Only with the budget
        exhausted do the remaining windows' documents become recorded
        skips (degraded exit 3).  A dead reducer's letter range is
        re-emitted off the read-only merge state by the main thread
        (emit is atomic tmp+rename per file, so re-emit is idempotent).
        Recovered runs stay byte-identical: merge order is restored
        from global plan indices, never arrival order.
        """
        import threading

        from .. import audit as audit_mod
        from ..corpus.scheduler import StealQueue, plan_letter_ranges
        from ..io.executor import PipelinedWindowReader
        from ..io.reader import plan_byte_windows

        cfg = self.config
        spill_budget = envknobs.get("MRI_BUILD_SPILL_BYTES")
        spill_mode = spill_budget is not None
        num_shards = envknobs.get("MRI_BUILD_SHARDS")
        sdir = None
        if spill_mode:
            from ..build import spill as spill_mod
            from ..obs import metrics as obs_metrics

            # the crash hook is read inside the scan workers, where a bad
            # value would be a worker death; validate it here (exit 2)
            envknobs.get("MRI_SPILL_KILL_AFTER")
            # a SIGKILLed spill build leaves only a stale .spill-<pid>
            # dir behind; sweep those before arming our own
            spill_mod.clean_stale_dirs(out_dir)
            sdir = spill_mod.spill_dir(out_dir)
            os.makedirs(sdir, exist_ok=True)
            reg = obs_metrics.default_registry()
            ctr_spill_flushes = reg.counter(
                "mri_build_spill_flushes_total",
                help="Spill-run flushes across all scan workers")
            ctr_spill_bytes = reg.counter(
                "mri_build_spill_bytes_total",
                help="Bytes written to spill run files")
        elif cfg.num_reducers > 26:
            # letter-partitioned reduce: the reference's degenerate
            # R > 26 arithmetic leaves reducers beyond the alphabet
            # with empty ranges (documented conformance contract) —
            # say so instead of clamping silently
            log.warning(
                "num_reducers=%d exceeds the 26 letter partitions; "
                "reducers past the alphabet get empty ranges (set "
                "MRI_BUILD_SPILL_BYTES to partition by term-hash "
                "shard, where every reducer gets real work)",
                cfg.num_reducers)
        window_bytes = self._cpu_window_bytes()
        if spill_mode:
            # the budget check runs at window boundaries, so a window
            # must be a small fraction of the budget or one window's
            # intake overshoots it before the first check; floor at
            # 4 KiB so toy budgets don't degenerate to per-doc windows
            window_bytes = min(window_bytes,
                               max(spill_budget >> 4, 1 << 12))
        windows = plan_byte_windows(manifest, window_bytes)
        max_docs = max((hi - lo for lo, hi in windows), default=1)
        K = max(1, num_workers)
        # --artifact reaches here even with --io-prefetch 0 (the merge
        # state is the artifact's source); the reader needs depth >= 1
        depth = max(1, cfg.io_prefetch)
        queue = StealQueue(
            windows,
            shuffle_seed=envknobs.get("MRI_STEAL_SHUFFLE_SEED"))
        window_deadline_s = envknobs.get("MRI_WINDOW_DEADLINE_S")
        respawns_left = max(0, envknobs.get("MRI_WORKER_RESPAWNS"))

        # Per-worker arena rings, recycled across run() calls like the
        # single-worker path's ring (invalidated when K or depth moves,
        # or after any recovery — a failed run's arenas may still be
        # referenced by a leaked thread).
        rings = getattr(self, "_cpu_arena_rings", None)
        if rings is not None and (
                len(rings) != K
                or any(len(r) != depth + 1 for r in rings)):
            rings = None
        if rings is None:
            rings = [None] * K

        # Private DegradationReport per worker (reader threads record
        # without cross-worker lock contention), merged at the join so
        # a degraded run still reports every skipped doc id.
        run_report = report
        policy = faults.default_policy()
        ledger = audit_mod.WindowLedger() if cfg.audit else None
        audit_s = 0.0  # in-path invariant-check time (--audit)
        inj = faults.active()

        # Workers live in growable slots (respawns append), not fixed
        # arrays: each slot owns one reader + one native stream, and a
        # ``failed`` slot's stream is excluded from the merge.
        slots: list[dict] = []
        fail_lock = threading.Lock()
        trace = getattr(self, "_trace", None)

        def make_slot(w: int, arenas=None) -> dict:
            rep = faults.DegradationReport()
            slot = {
                "id": w, "report": rep, "partial": None,
                "fatal": None, "failed": False, "leaked": False,
                "thread": None,
                "stream": native.HostIndexStream(),
                # spill-mode state: completed run files, window ranges
                # fed since the last flush, and the footprint watermark
                "runs": [], "run_windows": [], "docs": 0,
                "scan_ms_acc": 0.0, "partial_ms_acc": 0.0, "peak_est": 0,
            }
            if trace is not None:
                trace.name_thread(chrometrace.READER_BASE + w,
                                  f"reader-{w}")
                trace.name_thread(chrometrace.SCAN_BASE + w,
                                  f"scan-worker-{w}")
            # reader last: its thread starts pulling windows immediately
            slot["reader"] = PipelinedWindowReader(
                manifest, queue, depth=depth,
                byte_capacity=window_bytes + (window_bytes >> 2),
                doc_capacity=max_docs, arenas=arenas,
                policy=policy, report=rep, worker=w, trace=trace)
            slots.append(slot)
            return slot

        def fail_slot(slot: dict, reason: str) -> None:
            """Idempotent worker-death transition: blacklist the worker,
            requeue every window attributed to it (its native handle —
            the only place those windows' postings live — is discarded
            with it), and count the recovery."""
            with fail_lock:
                if slot["failed"]:
                    return
                slot["failed"] = True
                requeued = queue.fail_worker(slot["id"])
                if ledger is not None:
                    ledger.discard_worker(slot["id"])
                run_report.record_worker_recovery(
                    windows_requeued=len(requeued))
                # spill mode: the dead worker's run files cover the
                # same windows fail_worker just requeued — delete them
                # so the rescan (by a survivor with its own runs) can't
                # double-merge those documents
                stale_runs = [run["path"] for run in slot["runs"]]
                slot["runs"] = []
                slot["run_windows"] = []
            for path in stale_runs:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            log.warning(
                "scan worker %d died (%s); requeued %d window(s) %s for "
                "rescan", slot["id"], reason, len(requeued), requeued)

        def flush_run(slot: dict, final: bool = False):
            """Spill the worker's scan state as one checksummed run
            file; unless ``final``, hand back a fresh native stream
            (the memory release that bounds the worker's footprint)."""
            stream, w = slot["stream"], slot["id"]
            t0 = time.perf_counter()
            p = stream.partial()
            slot["scan_ms_acc"] += p["scan_ms"]
            slot["partial_ms_acc"] += p["partial_ms"]
            pack = stream.runpack(num_shards)
            path, nbytes = spill_mod.write_run(
                sdir, w, len(slot["runs"]), pack, slot["run_windows"])
            t1 = time.perf_counter()
            slot["runs"].append({
                "path": path, "windows": list(slot["run_windows"]),
                "pairs": pack["pairs"], "vocab": pack["vocab"],
                "width": pack["width"], "docs": len(pack["doc_ids"]),
                "max_doc_id": pack["max_doc_id"],
                "raw_tokens": pack["raw_tokens"], "bytes": nbytes,
            })
            slot["run_windows"] = []
            ctr_spill_flushes.inc()
            ctr_spill_bytes.inc(nbytes)
            if trace is not None:
                trace.span("spill_flush", t0, t1,
                           tid=chrometrace.SCAN_BASE + w,
                           args={"run": len(slot["runs"]) - 1,
                                 "pairs": pack["pairs"],
                                 "bytes": int(nbytes)})
            if not final:
                stream.close()
                slot["stream"] = native.HostIndexStream()
            return slot["stream"]

        def scan_worker(slot: dict) -> None:
            w, reader, stream = slot["id"], slot["reader"], slot["stream"]
            try:
                for arena in reader:
                    wi = arena.window_index
                    dropped = False
                    if inj is not None:
                        inj.on_worker_window(w, wi)
                        dropped = inj.on_scan_window(wi)
                    if not dropped:
                        t0s = time.perf_counter()
                        buf, ends, ids = arena.feed_views()
                        stream.feed_arrays(buf, ends, ids)
                        if trace is not None:
                            trace.span("scan", t0s, time.perf_counter(),
                                       tid=chrometrace.SCAN_BASE + w,
                                       args={"window": wi})
                        if ledger is not None:
                            ledger.record(
                                wi, worker=w, docs=int(arena.num_docs),
                                nbytes=int(arena.used_bytes),
                                checksum=audit_mod.window_checksum(
                                    buf, ends, ids))
                        if spill_mode:
                            # wi is the 1-based global plan index
                            lo_d, hi_d = windows[wi - 1]
                            slot["run_windows"].append((wi, lo_d, hi_d))
                            slot["docs"] += int(arena.num_docs)
                    queue.ack(wi, worker=w)
                    reader.recycle(arena)
                    if spill_mode and slot["run_windows"]:
                        # documented cost model for the native scan
                        # state: ~16 B per deduped (term, doc) pair
                        # (packed id + tf) and ~56 B per local term
                        # (arena bytes + offset/len + combiner row +
                        # hash slot) — the budget trip point
                        info = stream.info()
                        est = (info["pairs"] * self._SPILL_PAIR_BYTES
                               + info["vocab"] * self._SPILL_TERM_BYTES)
                        if est > slot["peak_est"]:
                            slot["peak_est"] = est
                        # trip at half budget: the NEXT window's intake
                        # lands on top of the current estimate before
                        # the next boundary check, so the headroom is
                        # what keeps the true peak under the budget
                        if est >= spill_budget // 2:
                            stream = flush_run(slot)
                if spill_mode and slot["runs"]:
                    # this worker tripped the budget mid-scan, so its
                    # tail postings must spill too (the reduce k-way
                    # merges this worker entirely from disk)
                    if slot["run_windows"]:
                        flush_run(slot, final=True)
                    slot["partial"] = {
                        "scan_ms": slot["scan_ms_acc"],
                        "partial_ms": slot["partial_ms_acc"],
                    }
                else:
                    # flatten this worker's postings runs here, inside
                    # the map phase's parallelism, not at the serial
                    # join.  A spill-armed worker that never tripped
                    # the budget lands here too: its state stays in
                    # memory until the join decides whether ANY worker
                    # spilled (the zero-spill fast path).
                    slot["partial"] = stream.partial()
            except (KeyboardInterrupt, SystemExit) as e:
                # not a worker fault: requeue for bookkeeping but carry
                # the exception out of the scan phase
                slot["fatal"] = e
                fail_slot(slot, type(e).__name__)
            except BaseException as e:  # noqa: BLE001 — recovery path
                fail_slot(slot, f"{type(e).__name__}: {e}")
                reader.close()  # unstick + retire this slot's reader

        merge = None
        empty_stream = None
        try:
            with timer.phase("ingest_scan"):
                for w in range(K):
                    make_slot(w, arenas=rings[w])
                for slot in slots[1:]:
                    t = threading.Thread(
                        target=scan_worker, args=(slot,),
                        name=f"scan-worker-{slot['id']}", daemon=True)
                    slot["thread"] = t
                    t.start()
                scan_worker(slots[0])  # the caller's thread is worker 0
                # Join survivors; under MRI_WINDOW_DEADLINE_S a worker
                # holding any lease past the deadline is retired in
                # absentia (windows requeued) and its thread abandoned
                # — "leaked": its native stream is never closed, since
                # the wedged thread may still be inside a native call
                # (a leak beats a use-after-free).
                while True:
                    waiting = [s for s in slots[1:]
                               if s["thread"] is not None
                               and s["thread"].is_alive()
                               and not s["leaked"]]
                    if not waiting:
                        break
                    for s in waiting:
                        s["thread"].join(
                            0.2 if window_deadline_s is not None else 60.0)
                    if window_deadline_s is None:
                        continue
                    expired = queue.expired_workers(window_deadline_s)
                    for s in slots:
                        if s["id"] in expired and not s["failed"]:
                            s["leaked"] = True
                            fail_slot(s, "window lease deadline "
                                         f"({window_deadline_s}s) expired")
                # Requeued windows left after every worker exited (a
                # death can land after survivors already drained out):
                # respawn replacement workers, fresh ring + fresh native
                # handle, on this thread, until the queue is dry or the
                # budget is spent.  A replacement can die too — the loop
                # handles it like any other worker death.
                next_id = K
                while len(queue) > 0 and respawns_left > 0:
                    respawns_left -= 1
                    log.warning(
                        "respawning scan worker %d to rescan %d "
                        "requeued window(s)", next_id, len(queue))
                    scan_worker(make_slot(next_id))
                    next_id += 1
                lost_windows: list[int] = []
                if len(queue) > 0:
                    # Budget exhausted with windows unscanned: the
                    # honest degraded arm — record exactly which
                    # documents were lost, then finish with what we
                    # have (exit 3, never silence).
                    while True:
                        item = queue.pop_window()
                        if item is None:
                            break
                        wi, (lo, hi) = item
                        lost_windows.append(wi)
                        for i in range(lo, hi):
                            run_report.record_skip(
                                doc_id=manifest.doc_id(i),
                                path=manifest.paths[i],
                                reason=f"window {wi} lost to worker "
                                       "death (respawn budget "
                                       "exhausted)")
                    log.error(
                        "worker respawn budget exhausted; %d window(s) "
                        "%s lost", len(lost_windows), lost_windows)
            for slot in slots:
                run_report.merge(slot["report"])
            for slot in slots:
                if slot["fatal"] is not None:
                    raise slot["fatal"]
            if spill_mode:
                if not any(s["runs"] for s in slots if not s["failed"]):
                    # zero-spill fast path: no worker ever tripped the
                    # budget, so nothing left memory — reduce through
                    # the in-memory native merge exactly like the
                    # unset-knob build (within noise of its wall clock)
                    timer.count("spill", {
                        "budget_bytes": int(spill_budget),
                        "runs": 0, "runs_quarantined": 0, "flushes": 0,
                        "bytes_spilled": 0,
                        "peak_worker_est_bytes": max(
                            (s["peak_est"] for s in slots), default=0),
                    })
                    spill_mod.remove_dir(sdir)
                    spill_mode = False
                else:
                    # mixed case: flush the workers that never tripped
                    # the budget (their partial() already ran in the
                    # map phase, so runpack here is pure copy-out)
                    for slot in slots:
                        if not slot["failed"] and slot["run_windows"]:
                            flush_run(slot, final=True)
            live = []
            if not spill_mode:
                live = [s["stream"] for s in slots if not s["failed"]]
                if not live:
                    # every worker died: merge one empty stream so the
                    # reduce still writes the 26 (empty) letter files
                    # and the degraded report carries the whole story
                    empty_stream = native.HostIndexStream()
                    live = [empty_stream]
            if ledger is not None:
                t0 = time.perf_counter()
                ledger.check_complete(len(windows),
                                      missing_ok=lost_windows)
                audit_s += time.perf_counter() - t0
            if spill_mode:
                with timer.phase("finalize_emit"):
                    red = self._spill_reduce(
                        manifest, out_dir, timer, slots, run_report,
                        inj, trace, sdir, num_shards)
                mstats = red["mstats"]
                emit_ms = red["emit_ms"]
                emit_bytes = red["emit_bytes"]
                audit_s += red["audit_s"]
                timer.count("build_shards", red["build_shards"])
                timer.count("spill", {
                    "budget_bytes": int(spill_budget),
                    "runs": red["runs_merged"],
                    "runs_quarantined": red["runs_quarantined"],
                    "flushes": sum(len(s["runs"]) for s in slots),
                    "bytes_spilled": red["bytes_spilled"],
                    "peak_worker_est_bytes": max(
                        (s["peak_est"] for s in slots), default=0),
                })
            else:
                with timer.phase("finalize_emit"):
                    t0m = time.perf_counter()
                    merge = native.HostIndexMerge(live)
                    if trace is not None:
                        trace.span("merge", t0m, time.perf_counter())
                    if cfg.audit:
                        t0 = time.perf_counter()
                        audit_mod.check_merge(merge, live)
                        audit_s += time.perf_counter() - t0
                    ranges = plan_letter_ranges(cfg.num_reducers)
                    emit_ms = [0.0] * len(ranges)
                    emit_bytes = [0] * len(ranges)
                    emit_errors: list[BaseException | None] = [None] * len(ranges)

                    def reduce_worker(r: int, lo: int, hi: int) -> None:
                        t0 = time.perf_counter()
                        try:
                            if inj is not None:
                                inj.on_reducer(r)
                            emit_bytes[r] = merge.emit_range(lo, hi, out_dir)
                        except BaseException as e:  # noqa: BLE001
                            emit_errors[r] = e
                        t1 = time.perf_counter()
                        emit_ms[r] = (t1 - t0) * 1e3
                        if trace is not None:
                            trace.name_thread(chrometrace.REDUCE_BASE + r,
                                              f"reduce-worker-{r}")
                            trace.span("emit_range", t0, t1,
                                       tid=chrometrace.REDUCE_BASE + r,
                                       args={"letters": [lo, hi]})

                    reducers = [
                        threading.Thread(target=reduce_worker, args=(r, lo, hi),
                                         name=f"reduce-worker-{r}")
                        for r, (lo, hi) in list(enumerate(ranges))[1:]
                    ]
                    for t in reducers:
                        t.start()
                    reduce_worker(0, *ranges[0])
                    for t in reducers:
                        t.join()
                    # Reducer takeover: emit_range is read-only on the
                    # merge state and atomic per letter file, so a dead
                    # reducer's range is simply re-emitted here.  A second
                    # failure on the SAME range is a real I/O problem and
                    # raises (exit 2).
                    for r, err in enumerate(emit_errors):
                        if err is None:
                            continue
                        lo, hi = ranges[r]
                        log.warning(
                            "reduce worker %d died (%s: %s); re-emitting "
                            "letters [%d, %d) on the main thread",
                            r, type(err).__name__, err, lo, hi)
                        t0 = time.perf_counter()
                        emit_bytes[r] = merge.emit_range(lo, hi, out_dir)
                        emit_ms[r] += (time.perf_counter() - t0) * 1e3
                        run_report.record_reducer_takeover()
                        emit_errors[r] = None
                    mstats = merge.stats()
                    if cfg.artifact:
                        from ..serve import artifact as artifact_mod

                        t0 = time.perf_counter()
                        art_bytes = artifact_mod.build_from_merge(
                            artifact_mod.artifact_path(out_dir), merge)
                        t1 = time.perf_counter()
                        if trace is not None:
                            trace.span("artifact_pack", t0, t1)
                        timer.count("artifact_bytes", int(art_bytes))
                        timer.count(
                            "artifact_build_ms",
                            round((t1 - t0) * 1e3, 3))
        finally:
            recovered = any(s["failed"] for s in slots)
            for slot in slots:
                slot["reader"].close()
            if merge is not None:
                merge.close()
            for slot in slots:
                if not slot["leaked"]:
                    slot["stream"].close()
            if empty_stream is not None:
                empty_stream.close()
            # cache the rings only for a clean same-shape run
            if recovered or len(slots) != K:
                self._cpu_arena_rings = None
            else:
                self._cpu_arena_rings = [s["reader"].arenas for s in slots]

        for key, value in mstats.items():
            if key != "merge_ms":
                timer.count(key, value)
        timer.count("bytes_written", int(sum(emit_bytes)))
        timer.count("reduce_workers", len(emit_ms))
        timer.count("io_windows", len(windows))
        timer.count("io_prefetch", cfg.io_prefetch)
        if cfg.audit:
            timer.count("audit_ms", round(audit_s * 1e3, 3))
        read_ms = [round(s["reader"].read_busy_s * 1e3, 3) for s in slots]
        tok_ms = [round(s["partial"]["scan_ms"]
                        + s["partial"]["partial_ms"], 3)
                  for s in slots
                  if s["partial"] is not None and not s["failed"]]
        timer.count("stage_read_ms", round(sum(read_ms), 3))
        timer.count("stage_tokenize_ms",
                    round(sum(tok_ms) + mstats["merge_ms"], 3))
        timer.count("stage_emit_ms", round(sum(emit_ms), 3))
        timer.count("stage_read_ms_per_worker", read_ms)
        timer.count("stage_tokenize_ms_per_worker", tok_ms)
        timer.count("stage_emit_ms_per_reducer",
                    [round(ms, 3) for ms in emit_ms])
        timer.count("merge_ms", round(mstats["merge_ms"], 3))
        timer.count("read_wait_ms",
                    round(sum(s["reader"].read_wait_s
                              for s in slots) * 1e3, 3))
        timer.count("consume_wait_ms",
                    round(sum(s["reader"].consume_wait_s
                              for s in slots) * 1e3, 3))
        return timer.report()

    def _spill_reduce(self, manifest, out_dir, timer, slots, run_report,
                      inj, trace, sdir, num_shards) -> dict:
        """Disk-tier reduce for the out-of-core build.

        Input: the scan phase's checksummed run files (term-hash-sharded
        sorted postings runs, one or more per surviving worker).  Three
        phases, all bounded by O(corpus / shards) memory:

        1. **verify** — full checksum walk over every run; a torn or
           bit-flipped run is quarantined and its windows' documents
           become recorded skips (degraded exit 3 — same contract as a
           spent respawn budget, never silent corruption).
        2. **shard merge** — M reduce workers own shards round-robin
           (``shard % M``) and k-way-merge every run's slice of each
           shard into one lex-sorted shard file.  No 26-partition cap:
           every reducer gets real work at any M.
        3. **letter emit** — letters are likewise owned round-robin;
           each is assembled from the shard files' letter slices and
           rendered through the same native emit as the in-memory path,
           so the letter files are byte-identical at every (mappers,
           reducers, shards, budget) point.

        Worker deaths in 2 and 3 degrade to main-thread takeover
        (shard/letter writes are atomic and idempotent), mirroring the
        in-memory reducer-takeover contract.
        """
        import threading

        from .. import audit as audit_mod
        from ..build import ooc
        from ..build import spill as spill_mod
        from ..corpus import scheduler
        from ..obs import metrics as obs_metrics

        cfg = self.config
        M = max(1, cfg.num_reducers)
        reg = obs_metrics.default_registry()
        ctr_quarantined = reg.counter(
            "mri_build_spill_runs_quarantined_total",
            help="Spill runs that failed their checksum walk")
        ctr_merge_shards = reg.counter(
            "mri_build_merge_shards_total",
            help="Term-hash shards merged from spill runs")
        ctr_merge_runs = reg.counter(
            "mri_build_merge_runs_total",
            help="Spill runs consumed by shard merges")
        ctr_merge_pairs = reg.counter(
            "mri_build_merge_pairs_total",
            help="(term, doc) pairs produced by shard merges")
        ctr_merge_takeovers = reg.counter(
            "mri_build_merge_takeovers_total",
            help="Reduce workers whose shards/letters were re-done on "
                 "the main thread")

        # -- 1. verify every run up front; quarantine + skip on damage
        all_runs = [run for slot in slots if not slot["failed"]
                    for run in slot["runs"]]
        good_runs = []
        quarantined = 0
        for run in all_runs:
            try:
                spill_mod.verify_file(run["path"])
            except (spill_mod.SpillError, OSError) as e:
                quarantined += 1
                ctr_quarantined.inc()
                try:
                    spill_mod.quarantine(run["path"])
                except OSError:
                    pass
                log.error("spill run %s failed verification (%s); its "
                          "windows' documents are skipped",
                          os.path.basename(str(run["path"])), e)
                for wi, lo, hi in run["windows"]:
                    for i in range(lo, hi):
                        run_report.record_skip(
                            doc_id=manifest.doc_id(i),
                            path=manifest.paths[i],
                            reason=f"window {wi} lost to corrupt spill "
                                   f"run {os.path.basename(str(run['path']))}"
                                   f" ({e})")
            else:
                good_runs.append(run)
        run_paths = [run["path"] for run in good_runs]
        width_g = max([run["width"] for run in good_runs] + [1])
        max_doc_id = max((run["max_doc_id"] for run in good_runs),
                         default=0)
        audit_s = 0.0

        # -- 2. per-shard k-way merge, shards owned round-robin by M
        # workers; each worker opens its own SpillFile handles (the
        # readers seek, so a shared handle would race)
        shard_pairs = [0] * num_shards
        shard_vocab = [0] * num_shards
        shard_done = [False] * num_shards
        merge_errors: list[BaseException | None] = [None] * M
        merge_ms = [0.0] * M

        def merge_worker(r: int) -> None:
            readers = []
            t_w0 = time.perf_counter()
            try:
                if trace is not None:
                    trace.name_thread(chrometrace.REDUCE_BASE + r,
                                      f"reduce-worker-{r}")
                readers = [spill_mod.SpillFile(p) for p in run_paths]
                for s in range(r, num_shards, M):
                    t0 = time.perf_counter()
                    if inj is not None:
                        inj.on_shard_merge(s)
                    merged = ooc.merge_shard(readers, s, width_g)
                    spill_mod.write_shard(sdir, s, merged)
                    shard_pairs[s] = int(merged["postings"].shape[0])
                    shard_vocab[s] = int(merged["df"].shape[0])
                    shard_done[s] = True
                    if trace is not None:
                        trace.span("shard_merge", t0, time.perf_counter(),
                                   tid=chrometrace.REDUCE_BASE + r,
                                   args={"shard": s,
                                         "postings": shard_pairs[s]})
            except BaseException as e:  # noqa: BLE001 — recovery path
                merge_errors[r] = e
            finally:
                for f in readers:
                    f.close()
            merge_ms[r] += (time.perf_counter() - t_w0) * 1e3

        t_merge0 = time.perf_counter()
        threads = [threading.Thread(target=merge_worker, args=(r,),
                                    name=f"reduce-worker-{r}")
                   for r in range(1, M)]
        for t in threads:
            t.start()
        merge_worker(0)
        for t in threads:
            t.join()
        # Takeover: shard files are atomic and the merge inputs are
        # read-only run files, so a dead worker's shards are simply
        # re-merged here (injection hooks deliberately not re-fired —
        # same rule as the in-memory reducer takeover).
        for r, err in enumerate(merge_errors):
            if err is None:
                continue
            todo = [s for s in range(r, num_shards, M)
                    if not shard_done[s]]
            log.warning(
                "shard-merge worker %d died (%s: %s); re-merging "
                "shard(s) %s on the main thread",
                r, type(err).__name__, err, todo)
            t0 = time.perf_counter()
            readers = [spill_mod.SpillFile(p) for p in run_paths]
            try:
                for s in todo:
                    merged = ooc.merge_shard(readers, s, width_g)
                    spill_mod.write_shard(sdir, s, merged)
                    shard_pairs[s] = int(merged["postings"].shape[0])
                    shard_vocab[s] = int(merged["df"].shape[0])
                    shard_done[s] = True
            finally:
                for f in readers:
                    f.close()
            merge_ms[r] += (time.perf_counter() - t0) * 1e3
            run_report.record_reducer_takeover()
            ctr_merge_takeovers.inc()
            merge_errors[r] = None
        merge_wall_ms = (time.perf_counter() - t_merge0) * 1e3
        ctr_merge_shards.inc(num_shards)
        ctr_merge_runs.inc(len(good_runs))
        ctr_merge_pairs.inc(sum(shard_pairs))

        if cfg.audit:
            t0 = time.perf_counter()
            audit_mod.check_spill(
                sum(run["pairs"] for run in good_runs),
                sum(shard_pairs),
                sum(run["vocab"] for run in good_runs),
                sum(shard_vocab))
            audit_s += time.perf_counter() - t0

        # -- 3. letter emit off the merged shard files, letters owned
        # round-robin; native emit keeps the bytes identical to the
        # in-memory path (empty letters still write their files)
        shard_paths = [spill_mod.shard_path(sdir, s)
                       for s in range(num_shards)]
        emit_ms = [0.0] * M
        emit_bytes = [0] * M
        emit_errors: list[BaseException | None] = [None] * M
        letter_done = [False] * ooc.ALPHABET_SIZE

        def emit_letter(files, letter: int) -> int:
            parts = [p for p in (ooc.letter_slice(f, letter, width_g)
                                 for f in files) if p is not None]
            if not parts:
                return native.emit_native(
                    out_dir, np.zeros(0, dtype="S1"),
                    np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.int64),
                    np.zeros(1, dtype=np.int64),
                    np.zeros(0, dtype=np.int32),
                    letter_range=(letter, letter + 1), idx_bounds=(0, 0))
            cat = ooc.concat_letter(parts)
            order = ooc.emit_order(cat["df"])
            return native.emit_native(
                out_dir, cat["terms"], order, cat["df"], cat["offsets"],
                cat["postings"], letter_range=(letter, letter + 1),
                idx_bounds=(0, int(order.shape[0])))

        def emit_worker(r: int) -> None:
            files = []
            t_w0 = time.perf_counter()
            try:
                if inj is not None:
                    inj.on_reducer(r)
                files = [spill_mod.SpillFile(p) for p in shard_paths]
                for letter in range(r, ooc.ALPHABET_SIZE, M):
                    t0 = time.perf_counter()
                    emit_bytes[r] += emit_letter(files, letter)
                    letter_done[letter] = True
                    if trace is not None:
                        trace.span("emit_letter", t0, time.perf_counter(),
                                   tid=chrometrace.REDUCE_BASE + r,
                                   args={"letter": letter})
            except BaseException as e:  # noqa: BLE001 — recovery path
                emit_errors[r] = e
            finally:
                for f in files:
                    f.close()
            emit_ms[r] += (time.perf_counter() - t_w0) * 1e3

        threads = [threading.Thread(target=emit_worker, args=(r,),
                                    name=f"reduce-worker-{r}")
                   for r in range(1, M)]
        for t in threads:
            t.start()
        emit_worker(0)
        for t in threads:
            t.join()
        for r, err in enumerate(emit_errors):
            if err is None:
                continue
            todo = [letter for letter in range(r, ooc.ALPHABET_SIZE, M)
                    if not letter_done[letter]]
            log.warning(
                "letter-emit worker %d died (%s: %s); re-emitting "
                "letter(s) %s on the main thread",
                r, type(err).__name__, err, todo)
            t0 = time.perf_counter()
            files = [spill_mod.SpillFile(p) for p in shard_paths]
            try:
                for letter in todo:
                    emit_bytes[r] += emit_letter(files, letter)
                    letter_done[letter] = True
            finally:
                for f in files:
                    f.close()
            emit_ms[r] += (time.perf_counter() - t0) * 1e3
            run_report.record_reducer_takeover()
            ctr_merge_takeovers.inc()
            emit_errors[r] = None

        # -- artifact: whole-index lex assembly off the shard files
        if cfg.artifact:
            from ..serve import artifact as artifact_mod

            t0 = time.perf_counter()
            files = [spill_mod.SpillFile(p) for p in shard_paths]
            try:
                u8_all = np.concatenate(
                    [f.section("vocab").reshape(-1, width_g)
                     for f in files])
                word_lens_all = np.concatenate(
                    [f.section("word_lens") for f in files])
                df_all = np.concatenate([f.section("df") for f in files])
                post_all = np.concatenate(
                    [f.section("postings") for f in files])
                tf_all = np.concatenate([f.section("tf") for f in files])
            finally:
                for f in files:
                    f.close()
            src_off = np.zeros(df_all.shape[0] + 1, dtype=np.int64)
            np.cumsum(df_all, out=src_off[1:])
            lex = np.argsort(ooc.as_terms(u8_all, width_g), kind="stable")
            idx, post_off = ooc.gather_pairs(lex, src_off)
            rows_lex = u8_all[lex]
            lens_lex = word_lens_all[lex].astype(np.int64)
            term_blob = rows_lex[
                np.arange(width_g)[None, :] < lens_lex[:, None]]
            term_offsets = np.zeros(lens_lex.shape[0] + 1, dtype=np.int64)
            np.cumsum(lens_lex, out=term_offsets[1:])
            df_lex = df_all[lex]
            # df_order[emit position] = lex index; emit order is letter
            # asc, then df desc with ties word asc within the letter —
            # letter blocks are contiguous in both orders
            df_order = np.zeros(lens_lex.shape[0], dtype=np.int64)
            firsts = rows_lex[:, 0] if lens_lex.shape[0] else \
                np.zeros(0, dtype=np.uint8)
            for letter in range(ooc.ALPHABET_SIZE):
                b0 = int(np.searchsorted(firsts, ord("a") + letter))
                b1 = int(np.searchsorted(firsts, ord("a") + letter + 1))
                if b1 > b0:
                    df_order[b0:b1] = b0 + ooc.emit_order(df_lex[b0:b1])
            run_files = [spill_mod.SpillFile(p) for p in run_paths]
            try:
                doc_lens = ooc.doc_lengths(run_files, max_doc_id)
            finally:
                for f in run_files:
                    f.close()
            art_bytes = artifact_mod.pack(
                artifact_mod.artifact_path(out_dir),
                term_blob=term_blob, term_offsets=term_offsets,
                df=df_lex, post_offsets=post_off,
                postings=post_all[idx], df_order=df_order,
                max_doc_id=int(max_doc_id), width=width_g,
                tf=tf_all[idx], doc_lens=doc_lens)
            t1 = time.perf_counter()
            if trace is not None:
                trace.span("artifact_pack", t0, t1)
            timer.count("artifact_bytes", int(art_bytes))
            timer.count("artifact_build_ms", round((t1 - t0) * 1e3, 3))

        spill_mod.remove_dir(sdir)
        return {
            "mstats": {
                "documents": sum(run["docs"] for run in good_runs),
                "tokens": sum(run["raw_tokens"] for run in good_runs),
                "unique_terms": sum(shard_vocab),
                "unique_pairs": sum(shard_pairs),
                "lines_written": sum(shard_vocab),
                "merge_ms": merge_wall_ms,
            },
            "emit_ms": emit_ms,
            "emit_bytes": emit_bytes,
            "audit_s": audit_s,
            "build_shards": scheduler.term_shard_balance(shard_pairs),
            "runs_merged": len(good_runs),
            "runs_quarantined": quarantined,
            "bytes_spilled": sum(run["bytes"] for run in all_runs),
        }

    def _tokenize_or_resume(self, manifest: Manifest, timer: PhaseTimer,
                            report: DegradationReport):
        """The one-shot plan's map phase: the pairs checkpoint when
        ``checkpoint_path`` holds one for this manifest (no read, no
        scan), else load and tokenize, then save the checkpoint when
        ``checkpoint_path`` is set.  Returns ``(corpus, documents
        loaded)``; a resume loads none."""
        cfg = self.config
        ckpt = cfg.checkpoint_path
        fp = checkpoint.manifest_fingerprint(manifest) if ckpt is not None else ""
        if ckpt is not None and os.path.exists(ckpt):
            try:
                with timer.phase("resume"):
                    corpus = checkpoint.load_pairs(ckpt, expect_fingerprint=fp)
                timer.count("resumed_from", ckpt)
                return corpus, 0
            except checkpoint.CheckpointCorrupt:
                # resume='auto': a torn or garbage checkpoint must not
                # wedge the rerun — move it aside and tokenize afresh.  A
                # version or fingerprint mismatch stays a ValueError in
                # both modes (a wrong checkpoint is not a damaged one).
                if cfg.resume != "auto":
                    raise
                timer.count("quarantined_checkpoint", checkpoint.quarantine(ckpt))
        threads = cfg.resolved_host_threads()
        timer.count("host_threads", threads)
        with timer.phase("load"):
            contents, doc_ids = load_documents(manifest, report)
        with timer.phase("tokenize"):
            corpus = tokenize(contents, doc_ids, use_native=cfg.use_native,
                              dedup_pairs=True, num_threads=threads)
        if ckpt is not None:
            with timer.phase("checkpoint"):
                checkpoint.save_pairs(ckpt, corpus, fingerprint=fp)
        return corpus, len(contents)

    def _run_one_shot(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                      report: DegradationReport, device: torch.device) -> dict:
        cfg = self.config
        corpus, num_loaded = self._tokenize_or_resume(manifest, timer, report)

        max_doc_id = len(manifest)  # doc ids are 1..len(manifest)
        num_tokens, vocab_size = corpus.num_tokens, corpus.vocab_size
        timer.count("documents", num_loaded)
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
            mesh = self._make_mesh(num_shards)
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
            with timer.phase("device_index"), _profile_ctx(cfg.profile_dir, device):
                pending = engine.PendingFetch(engine.index_prededuped_u16(
                    feed, max_doc_id=max_doc_id, out_size=nfetch))
                df = np.bincount(corpus.term_ids, minlength=vocab_size).astype(np.int64)
                # guard the combiner invariant this path relies on
                if len(df) != vocab_size or (vocab_size and int(df.max()) > max_doc_id):
                    raise ValueError(
                        "pairs_deduped feed violates its invariant "
                        f"(df len {len(df)} vs vocab {vocab_size}); "
                        "corrupt checkpoint or tokenizer bug")
                order, offsets = engine.host_order_offsets(corpus.letter_of_term, df)
                if cfg.profile_dir:
                    pending.wait()  # keep the in-flight sort and copy inside the trace
            with timer.phase("fetch"):
                host = {"df": df, "order": order, "offsets": offsets,
                        "postings": engine.host_u16(pending.wait()), "num_unique": num_tokens}
            return self._emit_and_report(corpus.vocab, corpus.letter_of_term, host, out_dir,
                                         timer, max_doc_id)

        with timer.phase("device_index"), _profile_ctx(cfg.profile_dir, device):
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
