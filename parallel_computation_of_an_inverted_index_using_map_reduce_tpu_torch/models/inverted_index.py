"""The flagship model: end-to-end inverted-index pipeline.

Orchestrates the chain the reference runs as fork-join pthread phases
(main.c:246-390):

    manifest -> load docs -> tokenize (host) -> index (device) -> emit (host)

with backends:
    "cuda"   — the device engine (ops/engine.py) on ``config.device``,
               by one of two plans:
               * pipelined (default when eligible): the native scan emits
                 combiner-deduped provisional keys per document window,
                 each window's upload overlaps the next window's scan,
                 and the device finalize is one sort
               * one-shot: tokenize everything (native combiner, or the
                 numpy tokenizer with ``use_native=False``), then one
                 device program
    "oracle" — pure-Python dict oracle (models/oracle.py)

Output is byte-identical across backends and plans, to the JAX package,
and to the pthread reference.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import native
from ..config import IndexConfig
from ..corpus.manifest import (DegradationReport, Manifest, load_documents,
                               prefetch_document_ranges)
from ..corpus.scheduler import plan_contiguous_windows, window_balance_stats
from ..obs.timing import PhaseTimer
from ..ops import engine
from ..ops import keys as K
from ..text import formatter
from ..text.tokenizer import tokenize
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
                stats = oracle_index(manifest, out_dir, report)
            stats = {**stats, **timer.report()}
        else:
            stats = self._run_device(manifest, out_dir, timer, report)
        stats["degradation"] = report.summary()
        return stats

    def _run_device(self, manifest: Manifest, out_dir: str, timer: PhaseTimer,
                    report: DegradationReport) -> dict:
        device = resolve_device(self.config.device)
        device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        timer.count("device", device_name)
        if self._pipelined_eligible(manifest):
            try:
                return self._run_pipelined(manifest, out_dir, timer, report, device)
            except native.KeyOverflow:
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

    def _pipelined_eligible(self, manifest: Manifest) -> bool:
        """Whether the provisional-key pipelined plan applies: it needs
        the native scan, no skew statistics (which need the token arrays
        on the host) and uint16 postings (doc ids < 0xFFFF)."""
        cfg = self.config
        return (
            cfg.pipeline_chunk_docs != 0
            and cfg.use_native
            and not cfg.collect_skew_stats
            and len(manifest) <= 0xFFFE
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
        """
        cfg = self.config
        max_doc_id = len(manifest)
        stride = max_doc_id + 2
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
        granule = min(1 << 14, cfg.pad_multiple)
        chunks_dev: list[torch.Tensor] = []
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
                    # the native scan assembles the uint16 upload buffer
                    # itself (int32 keys once prov ids outgrow uint16)
                    mode, buf, nvalid, _ = stream.feed_u16(contents, ids, granule=granule)
                    if nvalid:
                        if mode == "u16":
                            padded = buf.shape[0] // 2
                            host = buf.view(np.int16)
                        else:
                            padded = _round_up(nvalid, granule)
                            host = np.full(padded, K.INT32_MAX, dtype=np.int32)
                            host[:nvalid] = buf
                        chunks_dev.append(engine.upload(host, device, staged))
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
        timer.count("upload_windows", len(chunks_dev))
        timer.count("window_modes", modes)
        timer.count("window_read_ms", read_ms)
        timer.count("window_wait_ms", wait_ms)
        timer.count("window_scan_ms", scan_ms)
        if num_pairs == 0:
            with timer.phase("emit"):
                formatter.emit_grouped(out_dir, {})
            return timer.report()

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
                formatter.emit_grouped(out_dir, {})
            return timer.report()

        packed = K.can_pack(vocab_size, max_doc_id)
        # half-bandwidth path: uint16 feed + fetch
        use_u16 = packed and vocab_size <= 0xFFFF and max_doc_id <= 0xFFFE
        prededuped = use_u16 and corpus.pairs_deduped
        padded = _round_up(num_tokens, cfg.pad_multiple)
        timer.count("engine", "u16_prededuped" if prededuped else "u16" if use_u16
                    else "packed" if packed else "pairs")
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
                host = {k: v.cpu().numpy() for k, v in out.items()}

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
            )
        timer.count("unique_pairs", int(host["num_unique"]))
        timer.count("lines_written", emit_stats["lines_written"])
        return timer.report()


def build_index(manifest: Manifest, config: IndexConfig | None = None,
                output_dir: str | None = None) -> dict:
    """One-shot convenience: index a manifest and write the letter files."""
    return InvertedIndexModel(config).run(manifest, output_dir)
