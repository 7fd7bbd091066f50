"""The flagship model: end-to-end inverted-index pipeline.

Orchestrates the chain the reference runs as fork-join pthread phases
(main.c:246-390):

    manifest -> load docs -> tokenize (host) -> index (device) -> emit (host)

with backends:
    "cuda"   — sorted-vocab ids + the one-shot device engine (ops/engine.py)
               on ``config.device``
    "oracle" — pure-Python dict oracle (models/oracle.py)

Output is byte-identical across backends, to the JAX package, and to
the pthread reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import IndexConfig
from ..corpus.manifest import DegradationReport, Manifest, load_documents
from ..obs.timing import PhaseTimer
from ..ops import engine
from ..ops import keys as K
from ..text import formatter
from ..text.tokenizer import tokenize_documents
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

    def run(self, manifest: Manifest, output_dir: str | None = None) -> dict:
        cfg = self.config
        report = DegradationReport()
        self.timer = timer = PhaseTimer()
        timer.count("num_mappers", cfg.num_mappers)
        timer.count("num_reducers", cfg.num_reducers)
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
        timer.count("device", torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")
        with timer.phase("load"):
            contents, doc_ids = load_documents(manifest, report)
        with timer.phase("tokenize"):
            corpus = tokenize_documents(contents, doc_ids)

        max_doc_id = len(manifest)  # doc ids are 1..len(manifest)
        num_tokens, vocab_size = corpus.num_tokens, corpus.vocab_size
        timer.count("documents", len(contents))
        timer.count("tokens", num_tokens)
        timer.count("unique_terms", vocab_size)

        if self.config.collect_skew_stats and num_tokens:
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
        padded = _round_up(num_tokens, self.config.pad_multiple)
        timer.count("engine", "u16" if use_u16 else "packed" if packed else "pairs")
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

        with timer.phase("emit"):
            emit_stats = formatter.emit_index(
                out_dir,
                vocab=corpus.vocab,
                letter_of_term=corpus.letter_of_term,
                order=host["order"],
                df=host["df"],
                offsets=host["offsets"],
                postings=host["postings"],
                max_doc_id=max_doc_id,
            )
        timer.count("unique_pairs", int(host["num_unique"]))
        timer.count("lines_written", emit_stats["lines_written"])
        return timer.report()


def build_index(manifest: Manifest, config: IndexConfig | None = None,
                output_dir: str | None = None) -> dict:
    """One-shot convenience: index a manifest and write the letter files."""
    return InvertedIndexModel(config).run(manifest, output_dir)
