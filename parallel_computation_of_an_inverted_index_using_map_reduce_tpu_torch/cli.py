"""Command-line entry point, compatible with the reference's invocation.

Reference: ``./tema1 <num_mappers> <num_reducers> <input_file>``
(main.c:248-255).  The same three positionals work — outputs
a.txt..z.txt land in the CWD by default, exactly like the reference —
plus flags for the device engine:

    python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch \\
        4 26 list.txt --output-dir=out --stats [--artifact]
        [--device-shards N [--emit-ownership letter]]

and the query side over an ``--artifact`` build's ``index.mri``:

    python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch \\
        query out word1 word2 [--op and|or] [--top-k K --letter L]
        [--score df|bm25] [--stats] [--engine host|device|auto]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .config import IndexConfig
from .corpus.manifest import read_manifest
from .models.inverted_index import DeviceUnavailable, build_index
from .utils.checkpoint import CheckpointCorrupt

EXIT_DEGRADED = 3

_EPILOG = """\
exit codes:
  0  clean run
  2  error (bad arguments, I/O failure, a corrupt --stream-checkpoint
     under --resume strict, no CUDA device for --device cuda)
  3  degraded (completed, but skipped unreadable documents; see the
     'degradation' block of --stats)
"""


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mri-torch",
        description="inverted-index MapReduce on a CUDA device (PyTorch)",
        epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("num_mappers", type=int,
                   help="host shard count (reference mapper threads; output-invariant)")
    p.add_argument("num_reducers", type=int,
                   help="reduce partition count (reference reducer threads; output-invariant)")
    p.add_argument("file_list", help="manifest: count header then one path per line")
    p.add_argument("--backend", choices=("cuda", "oracle"), default="cuda",
                   help="cuda: device engine; oracle: pure-Python conformance backend")
    p.add_argument("--output-dir", default=".", help="where a.txt..z.txt are written (default: CWD)")
    p.add_argument("--pad-multiple", type=int, default=1 << 16)
    p.add_argument("--stats", action="store_true", help="print a JSON stats line to stdout")
    p.add_argument("--skew", action="store_true",
                   help="also measure letter vs hash-bucket partition skew on the device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the engine (cpu runs the kernels' plain versions)")
    p.add_argument("--stream-chunk-docs", type=int, default=None,
                   help="streaming plan: window size in whole documents "
                        "(bounded host/device memory; default: off)")
    p.add_argument("--pipeline-chunk-docs", type=int, default=None,
                   help="pipelined plan: documents per upload window "
                        "(default: auto, two windows; 0 = one-shot engine)")
    p.add_argument("--device-tokenize", action="store_true",
                   help="all-device plan: raw corpus bytes up, finished index "
                        "down (the whole map phase on the device; single "
                        "device; exact, with a restart on the host-scan plans "
                        "for tokens longer than --device-tokenize-width)")
    p.add_argument("--device-tokenize-width", type=int, default=48,
                   help="device word-row bytes (multiple of 4)")
    p.add_argument("--device-shards", type=int, default=None,
                   help="mesh size: shard the device engine over this many "
                        "logical shards, round-robin on the visible cards "
                        "(default: one per visible card of --device; 1 = "
                        "single device)")
    p.add_argument("--overlap-tail-fraction", type=float, default=None,
                   help="windowed overlap plan: this fraction of corpus "
                        "bytes (the last doc range) is indexed on the host "
                        "while the earlier windows' device sorts and fetches "
                        "run (single device)")
    p.add_argument("--overlap-device-windows", type=int, default=2, choices=(1, 2),
                   help="overlap plan device windows: 2 = earliest first "
                        "fetch, 1 = half the launches and copies")
    p.add_argument("--overlap-window-split", type=float, default=0.55,
                   help="the first device window's share of the overlap "
                        "plan's device bytes")
    p.add_argument("--stream-checkpoint", default=None,
                   help="crash-resumable streaming all-device plan "
                        "(--device-tokenize --stream-chunk-docs): save the "
                        "verified accumulator here; a rerun of the same "
                        "command resumes at the last saved window")
    p.add_argument("--stream-checkpoint-every", type=int, default=2,
                   help="windows between stream checkpoints")
    p.add_argument("--host-threads", type=int, default=None,
                   help="native scan threads (default: num_mappers if > 1, "
                        "else min(cores, 8)); output-invariant")
    p.add_argument("--emit-ownership", choices=("merged", "letter"), default="merged",
                   help="merged: one host writes all 26 files; letter: "
                        "the mesh's owners emit their own letter ranges "
                        "(the reference's reducer ownership)")
    p.add_argument("--emit-backend", choices=("auto", "native", "python"), default="auto",
                   help="letter-file writer: auto = native emit when available, "
                        "python = the pure-Python writer; byte-identical either way")
    p.add_argument("--resume", choices=("strict", "auto"), default="strict",
                   help="stream-checkpoint trust policy: strict = a corrupt "
                        "checkpoint is an error; auto = move it aside to "
                        "<path>.corrupt and restart fresh")
    p.add_argument("--artifact", action="store_true",
                   help="also pack the compact mmap serving artifact "
                        "(index.mri) next to the letter files at emit "
                        "time — what 'query' loads (serve/artifact.py "
                        "format; MRI_SERVE_FORMAT picks v1, v2 or v2.1)")
    return p


def _query_main(argv: list[str]) -> int:
    """``query DIR ...`` — answer from an --artifact build's index.mri
    with the engine ``--engine`` (or ``$MRI_SERVE_ENGINE``) names."""
    p = argparse.ArgumentParser(
        prog="mri-torch query",
        description="batched lookups against a built index.mri artifact")
    p.add_argument("index_dir", help="output dir of an --artifact run "
                                     "(or the index.mri file itself)")
    p.add_argument("terms", nargs="*", help="query words")
    p.add_argument("--batch-file", default=None,
                   help="read query words from this file, one per line")
    p.add_argument("--op", choices=("and", "or"), default=None,
                   help="combine ALL query words into one multi-term "
                        "query instead of answering each separately")
    p.add_argument("--top-k", type=int, default=None, metavar="K",
                   help="df mode: the K highest-df terms of --letter's "
                        "range; bm25 mode (--score bm25): the K best-"
                        "scoring documents for the query words")
    p.add_argument("--letter", default=None, help="letter for --top-k (a..z)")
    p.add_argument("--score", choices=("df", "bm25"), default=None,
                   help="--top-k scoring mode: df = per-letter highest-df "
                        "terms, bm25 = ranked document retrieval over the "
                        "query words (v1 scores with tf=1). Default: "
                        "MRI_SERVE_SCORE env, else df")
    p.add_argument("--engine", choices=("host", "device", "auto"), default=None,
                   help="query backend: host = numpy (or the native serve "
                        "kernels, MRI_SERVE_NATIVE) over the mapped "
                        "artifact; device = torch programs over "
                        "device-resident columns; auto = host for small "
                        "batches, the device when a probe of the first "
                        "batch of 8192 or more says it wins "
                        "(MRI_SERVE_CROSSOVER overrides the probe). "
                        "Default: MRI_SERVE_ENGINE env, else device. "
                        "Answers are the same either way")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the device engine, alone or inside "
                        "auto (default cuda; no CUDA device is exit 2, never "
                        "a quiet move to the CPU or the host engine)")
    p.add_argument("--stats", action="store_true",
                   help="print an engine stats JSON line last (cache "
                        "counters, per-op timing, planner; native kernels "
                        "(host, auto), crossover probe (auto), device info "
                        "(device))")
    # intermixed: ``query DIR --op and the dog`` must not feed "the dog"
    # back into --op's greedy positional scan
    args = p.parse_intermixed_args(argv)

    from .serve import ArtifactError, create_engine
    from .serve.engine import NativeUnavailable, resolve_score

    try:
        score = resolve_score(args.score)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    terms = list(args.terms)
    if args.batch_file is not None:
        try:
            with open(args.batch_file, "r", encoding="utf-8") as f:
                terms.extend(line.strip() for line in f if line.strip())
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.top_k is None and not terms:
        # an empty --batch-file is a valid (empty) batch: no output,
        # exit 0 — only a missing query is an error
        if args.batch_file is not None:
            return 0
        print("error: no query terms (positional words, --batch-file, "
              "or --top-k with --letter)", file=sys.stderr)
        return 2
    ranked = args.top_k is not None and score == "bm25"
    if args.top_k is not None and not ranked and args.letter is None:
        print("error: --top-k needs --letter (or --score bm25 with "
              "query terms)", file=sys.stderr)
        return 2
    if ranked and not terms:
        print("error: --score bm25 --top-k needs query terms", file=sys.stderr)
        return 2
    try:
        # ValueError: a bad knob read at construction (MRI_SERVE_ENGINE,
        # _NATIVE, _CROSSOVER); no card; MRI_SERVE_NATIVE=1 without the
        # native kernels.  Any other error keeps its traceback.
        engine = create_engine(args.index_dir, args.engine, device=args.device)
    except (ArtifactError, ValueError, DeviceUnavailable, NativeUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        if ranked:
            top = engine.top_k_scored(engine.encode_batch(terms), args.top_k)
            print(json.dumps({
                "score": "bm25", "k": args.top_k, "terms": terms,
                "docs": [{"doc": d, "score": round(s, 6)} for d, s in top]}))
        elif args.top_k is not None:
            top = engine.top_k(args.letter, args.top_k)
            print(json.dumps({
                "letter": args.letter,
                "top": [{"term": t.decode("ascii"), "df": d} for t, d in top]}))
        if terms and not ranked and args.op is not None:
            batch = engine.encode_batch(terms)
            docs = (engine.query_and(batch) if args.op == "and"
                    else engine.query_or(batch))
            print(json.dumps({"op": args.op, "terms": terms, "docs": docs.tolist()}))
        elif terms and not ranked:
            batch = engine.encode_batch(terms)
            dfs = engine.df(batch)
            posts = engine.postings(batch)
            for term, d, ids in zip(terms, dfs.tolist(), posts):
                print(json.dumps({
                    "term": term, "found": ids is not None, "df": d,
                    "postings": ids.tolist() if ids is not None else []}))
        if args.stats:
            print(json.dumps(engine.describe()))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        engine.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "query":
        return _query_main(argv[1:])
    args = make_parser().parse_args(argv)
    # validate the reference positionals up front with ONE clear line on
    # stderr, not an IndexConfig traceback
    if args.num_mappers < 1:
        print(f"error: num_mappers must be >= 1, got {args.num_mappers}", file=sys.stderr)
        return 2
    if args.num_reducers < 1:
        print(f"error: num_reducers must be >= 1, got {args.num_reducers}", file=sys.stderr)
        return 2
    if not os.path.exists(args.file_list):
        print(f"error: input list {args.file_list!r} does not exist", file=sys.stderr)
        return 2
    try:
        manifest = read_manifest(args.file_list)
        config = IndexConfig(
            num_mappers=args.num_mappers,
            num_reducers=args.num_reducers,
            backend=args.backend,
            output_dir=args.output_dir,
            pad_multiple=args.pad_multiple,
            collect_skew_stats=args.skew,
            device=args.device,
            pipeline_chunk_docs=args.pipeline_chunk_docs,
            stream_chunk_docs=args.stream_chunk_docs,
            device_tokenize=args.device_tokenize,
            device_tokenize_width=args.device_tokenize_width,
            device_shards=args.device_shards,
            emit_ownership=args.emit_ownership,
            host_threads=args.host_threads,
            emit_backend=args.emit_backend,
            overlap_tail_fraction=args.overlap_tail_fraction,
            overlap_device_windows=args.overlap_device_windows,
            overlap_window_split=args.overlap_window_split,
            stream_checkpoint=args.stream_checkpoint,
            stream_checkpoint_every=args.stream_checkpoint_every,
            resume=args.resume,
            artifact=args.artifact,
        )
        stats = build_index(manifest, config)
    except (OSError, ValueError, DeviceUnavailable, CheckpointCorrupt) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.stats:
        print(json.dumps(stats, sort_keys=True))
    skipped = stats["degradation"]["skipped_docs"]
    if skipped:
        print(f"warning: completed DEGRADED — skipped {len(skipped)} "
              f"unreadable document(s) (doc ids {sorted(skipped)}); "
              f"exit {EXIT_DEGRADED}", file=sys.stderr)
        return EXIT_DEGRADED
    return 0


if __name__ == "__main__":
    sys.exit(main())
