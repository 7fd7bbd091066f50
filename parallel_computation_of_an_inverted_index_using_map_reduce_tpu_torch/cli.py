"""Command-line entry point, compatible with the reference's invocation.

Reference: ``./tema1 <num_mappers> <num_reducers> <input_file>``
(main.c:248-255).  The same three positionals work — outputs
a.txt..z.txt land in the CWD by default, exactly like the reference —
plus flags for the device engine:

    python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch \\
        4 26 list.txt --output-dir=out --stats
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
    p.add_argument("--emit-backend", choices=("auto", "native", "python"), default="auto",
                   help="letter-file writer: auto = native emit when available, "
                        "python = the pure-Python writer; byte-identical either way")
    p.add_argument("--resume", choices=("strict", "auto"), default="strict",
                   help="stream-checkpoint trust policy: strict = a corrupt "
                        "checkpoint is an error; auto = move it aside to "
                        "<path>.corrupt and restart fresh")
    return p


def main(argv: list[str] | None = None) -> int:
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
            host_threads=args.host_threads,
            emit_backend=args.emit_backend,
            overlap_tail_fraction=args.overlap_tail_fraction,
            overlap_device_windows=args.overlap_device_windows,
            overlap_window_split=args.overlap_window_split,
            stream_checkpoint=args.stream_checkpoint,
            stream_checkpoint_every=args.stream_checkpoint_every,
            resume=args.resume,
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
