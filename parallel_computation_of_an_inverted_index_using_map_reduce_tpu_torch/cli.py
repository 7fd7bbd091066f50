"""Command-line entry point, compatible with the reference's invocation.

Reference: ``./tema1 <num_mappers> <num_reducers> <input_file>``
(main.c:248-255).  The same three positionals work — outputs
a.txt..z.txt land in the CWD by default, exactly like the reference —
plus flags for the device engine:

    python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch \\
        4 26 list.txt --output-dir=out --stats [--artifact]
        [--device-shards N [--emit-ownership letter]]
        [--checkpoint PATH] [--fault-spec SPEC] [--audit]
        [--trace-out FILE] [--profile-dir DIR]

and for the host backend, which never touches the card (K scan workers
and M letter reducers, ``MRI_BUILD_SPILL_BYTES`` for the out-of-core
spill):

    ... 8 4 list.txt --backend cpu [--io-prefetch N] [--host-threads T]

``--verify DIR`` re-checks an ``--audit`` run's output directory
against its ``index.manifest.json`` (exit 0 when it matches, 2 naming
each mismatched file),

and the query side over an ``--artifact`` build's ``index.mri``:

    python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch \\
        query out word1 word2 [--op and|or] [--top-k K --letter L]
        [--score df|bm25] [--stats] [--explain] [--engine host|device|auto]
        [--device cuda|cpu]

the resident daemon over it and its operator clients:

    ... serve out [--listen HOST:PORT] [--engine host|device|auto]
        [--shards N] [--listen-metrics PORT] [--fault-spec SPEC]
        [--device cuda|cpu] [--replica-of HOST:PORT]
    ... metrics HOST:PORT|DIR      (Prometheus text)
    ... flightdump HOST:PORT [--out FILE]
    ... top HOST:PORT|DIR [--once] [--json]

``serve`` prints one ``{"event": "listening", ...}`` line, drains on
SIGTERM/SIGINT (exit 0; a second signal exits 1) with a ``drained``
line, reloads on SIGHUP and dumps the flight recorder on SIGQUIT.

The live index (``segments/``) keeps an ``--artifact`` directory
current without a rebuild, with the JAX CLI's arguments, JSON stdout and
exit codes:

    ... append out --add FILE [FILE ...]   (one new immutable segment)
    ... delete out --docs ID [ID ...]      (tombstones)
    ... compact out [--force] [--prune]
    ... recover out                        (replay the mutation WAL)
    ... replicate out --from HOST:PORT     (one catch-up round)

each with ``--fault-spec SPEC``.  ``query``/``serve`` on such a
directory open the host multi-segment engine unless ``--engine device``
is named (exit 2, as the JAX CLI).

The doc-sharded cluster (``cluster/``), on the host as in the JAX
package, with its CLI's arguments, JSON lines and exit codes:

    ... shard LIST --shards D --out CL [--mode round-robin|size-balanced]
        [--verify | --verify-only]          (CL/shard-0 .. CL/shard-D-1)
    ... serve CL/shard-S --listen HOST:PORT   (a shard daemon)
    ... router --shards h:1|h:2,h:3 --listen HOST:PORT [--hedge-ms MS]
        [--fault-spec SPEC]
    ... top ROUTER:PORT                     (fleet rows per replica)

``query``/``serve`` on a shard directory open the host shard engine
unless ``--engine device`` is named (exit 2, as the JAX CLI).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import faults
from .audit import AuditError, verify_output_dir
from .config import IndexConfig
from .corpus.manifest import read_manifest
from .faults import EXIT_DEGRADED
from .models.inverted_index import DeviceUnavailable, build_index
from .obs import chrometrace
from .obs.timing import Step
from .utils import envknobs
from .utils.checkpoint import CheckpointCorrupt

_EPILOG = """\
exit codes:
  0  clean run
  2  error (bad arguments or fault spec, I/O failure, a corrupt
     --checkpoint or --stream-checkpoint under --resume strict, an audit
     failure, a --verify mismatch, no CUDA device for --device cuda)
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
                   help="host shard count (reference mapper threads; "
                        "backend=cpu scan workers; output-invariant)")
    p.add_argument("num_reducers", type=int,
                   help="reduce partition count (reference reducer threads; "
                        "backend=cpu letter-range reduce workers; "
                        "output-invariant)")
    p.add_argument("file_list", help="manifest: count header then one path per line")
    p.add_argument("--backend", choices=("cuda", "cpu", "oracle"), default="cuda",
                   help="cuda: device engine; cpu: the native host pipeline "
                        "(no card); oracle: pure-Python conformance backend")
    p.add_argument("--output-dir", default=".", help="where a.txt..z.txt are written (default: CWD)")
    p.add_argument("--pad-multiple", type=int, default=1 << 16)
    p.add_argument("--checkpoint", default=None,
                   help="save/resume the tokenized map-phase pairs at this path")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the device phases here")
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
    p.add_argument("--io-prefetch", type=int, default=2,
                   help="backend=cpu read-ahead depth: window arenas the "
                        "reader thread keeps filled while the native scan "
                        "runs (0 = one-shot load, no pipeline)")
    p.add_argument("--resume", choices=("strict", "auto"), default="strict",
                   help="checkpoint-trust policy: strict = a corrupt "
                        "checkpoint is a hard error; auto = quarantine it "
                        "to <path>.corrupt and restart fresh (crash-safe "
                        "rerun after SIGKILL mid-save)")
    p.add_argument("--fault-spec", default=None,
                   help="arm the deterministic fault injector (faults.py "
                        "grammar, e.g. 'read-error:doc=2:times=2' or "
                        "'sigkill:window=2;seed=7'; also readable from "
                        f"${faults.ENV_VAR}) — test/bench only, never "
                        "needed for production runs")
    p.add_argument("--artifact", action="store_true",
                   help="also pack the compact mmap serving artifact "
                        "(index.mri) next to the letter files at emit "
                        "time — what 'query' loads (serve/artifact.py "
                        "format; MRI_SERVE_FORMAT picks v1, v2 or v2.1)")
    p.add_argument("--audit", action="store_true",
                   help="integrity audit: an index.manifest.json output "
                        "manifest (per-file adler32) after the emit, which "
                        "--verify DIR re-checks; audit failures exit 2, never "
                        "silently wrong bytes")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace_event JSON timeline of the "
                        "build here (load in chrome://tracing or "
                        "ui.perfetto.dev): the manifest, the build, its "
                        "phases and steps, on the Unix clock")
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
    p.add_argument("--explain", action="store_true",
                   help="print a per-request cost report JSON line "
                        "after the answers: per-term df and resolution "
                        "path, planner decision with its theta "
                        "progression, blocks scored/skipped, bytes "
                        "decoded, cache hits/misses")
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
    if args.explain:
        from .obs import attribution as obs_attrib
        if ranked:
            explain_op = "top_k_scored"
        elif args.top_k is not None:
            explain_op = "top_k"
        elif args.op is not None:
            explain_op = f"query_{args.op}"
        else:
            explain_op = "df+postings"
        explain_cm = obs_attrib.collect(explain_op)
    else:
        explain_cm = None
    try:
        coll = explain_cm.__enter__() if explain_cm is not None else None
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
        if coll is not None:
            explain_cm.__exit__(None, None, None)
            explain_cm = None
            print(json.dumps({"explain": coll.report()}))
        if args.stats:
            print(json.dumps(engine.describe()))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if explain_cm is not None:
            explain_cm.__exit__(None, None, None)
        engine.close()
    return 0


def _device_arg(p: argparse.ArgumentParser, what: str) -> None:
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=f"torch device of the device engine {what} (default "
                        "cuda; no CUDA device is exit 2, never a quiet move "
                        "to the CPU or the host engine)")


def _serve_main(argv: list[str]) -> int:
    """``serve DIR --listen HOST:PORT`` — the resident daemon
    (serve/daemon.py).  Blocks until drained by SIGTERM/SIGINT."""
    import signal
    import threading

    p = argparse.ArgumentParser(
        prog="mri-torch serve",
        description="resident JSON-lines query daemon over a built "
                    "index.mri artifact")
    p.add_argument("index_dir", help="output dir of an --artifact run "
                                     "(or the index.mri file itself)")
    p.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                   help="bind address (port 0 = ephemeral; the chosen "
                        "port is printed in the 'listening' JSON line)")
    p.add_argument("--engine", choices=("host", "device", "auto"), default=None,
                   help="query backend (same choices as 'query'; default "
                        "MRI_SERVE_ENGINE env, else device)")
    p.add_argument("--cache-terms", type=int, default=4096,
                   help="hot-term LRU capacity (host engine)")
    p.add_argument("--shards", type=int, default=None,
                   help="device engine's logical shard count (default "
                        "MRI_SERVE_SHARDS env, else every visible card)")
    p.add_argument("--fault-spec", default=None,
                   help="arm the deterministic fault injector "
                        "(serve kinds: handler-crash/client-disconnect/"
                        "slow-client/reload-corrupt/dispatcher-hang) "
                        "— test/bench only")
    p.add_argument("--listen-metrics", type=int, default=None, metavar="PORT",
                   help="also serve Prometheus text metrics over plain "
                        "HTTP on 127.0.0.1:PORT (0 = ephemeral; the "
                        "chosen port is printed in the 'listening' line)")
    p.add_argument("--replica-of", default=None, metavar="HOST:PORT",
                   help="run as a read-only replica of the primary "
                        "daemon at HOST:PORT: catch up by segment "
                        "shipping every MRI_REPLICA_POLL_MS, reject "
                        "mutations, report replica_lagging in healthz "
                        "until the first round succeeds")
    _device_arg(p, "(alone or inside auto)")
    args = p.parse_args(argv)
    # the daemon is the one long-lived process: route every mri_torch.*
    # logger through the structured obs funnel (MRI_OBS_LOG_FORMAT);
    # in-process embedding (ServeDaemon.start()) leaves logging alone
    from .obs import logging as obs_logging
    try:
        obs_logging.configure()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    host, _, port_s = args.listen.rpartition(":")
    try:
        port = int(port_s)
        if not host or not (0 <= port <= 65535):
            raise ValueError
    except ValueError:
        print(f"error: --listen must be HOST:PORT, got {args.listen!r}", file=sys.stderr)
        return 2
    if args.listen_metrics is not None and not (0 <= args.listen_metrics <= 65535):
        print(f"error: --listen-metrics must be 0..65535, got {args.listen_metrics}",
              file=sys.stderr)
        return 2

    from . import segments
    from .serve import ArtifactError
    from .serve.daemon import ServeDaemon
    from .serve.engine import NativeUnavailable

    if args.replica_of is not None:
        try:
            segments.replica.parse_addr(args.replica_of)
        except segments.SegmentError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        # resolved before the daemon exists so a bad value is the
        # one-line exit-2 knob contract, not a traceback mid-serve
        gc_freeze = envknobs.get("MRI_SERVE_GC_FREEZE")
        # construction runs startup WAL recovery (primaries) before the
        # first engine open — a torn directory rejects here, exit 2
        daemon = ServeDaemon(args.index_dir, host, port, engine=args.engine,
                             cache_terms=args.cache_terms, shards=args.shards,
                             metrics_port=args.listen_metrics,
                             replica_of=args.replica_of, device=args.device)
    except (ArtifactError, segments.SegmentError, ValueError, OSError,
            DeviceUnavailable, NativeUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        daemon.start()
    except OSError as e:
        print(f"error: cannot listen on {args.listen}: {e}", file=sys.stderr)
        daemon.drain()
        return 2

    if gc_freeze:
        # the startup heap (interpreter, imports, engine) is permanent:
        # freeze it so a cyclic-GC pass scans only request churn
        import gc
        gc.collect()
        gc.freeze()

    stop = threading.Event()

    def _on_stop_signal(signum, frame):
        if stop.is_set():
            # second signal: the drain is not fast enough for the
            # operator — the documented forced exit, code 1
            os._exit(1)
        stop.set()

    def _on_hup(signum, frame):
        # reload off the signal frame AND off the dispatcher: the new
        # engine is built on this throwaway thread; only the swap takes
        # the dispatch lock
        threading.Thread(target=daemon.reload, name="mri-serve-reload", daemon=True).start()

    def _on_quit(signum, frame):
        # SIGQUIT = dump the flight recorder and keep serving
        threading.Thread(target=daemon.dump_flight, args=("sigquit",),
                         name="mri-serve-flight", daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_stop_signal)
        signal.signal(signal.SIGINT, _on_stop_signal)
        signal.signal(signal.SIGHUP, _on_hup)
        signal.signal(signal.SIGQUIT, _on_quit)

    bound_host, bound_port = daemon.address
    listening = {"event": "listening", "host": bound_host, "port": bound_port,
                 "pid": os.getpid(), "engine": daemon._engine.engine_name}
    if daemon.metrics_address is not None:
        listening["metrics_port"] = daemon.metrics_address[1]
    print(json.dumps(listening), flush=True)
    try:
        while not stop.is_set():
            stop.wait(0.2)
        rc = daemon.drain()
    except Exception:
        # unexpected serve crash: keep the black box before the
        # traceback takes the process down
        daemon.dump_flight("crash")
        raise
    print(json.dumps({"event": "drained", "counters": daemon.final_stats["counters"]},
                     sort_keys=True), flush=True)
    return rc


def _daemon_addr(target: str):
    """``(host, port)`` when ``target`` names a daemon, else None."""
    host, _, port_s = target.rpartition(":")
    if host and port_s.isdigit() and int(port_s) <= 65535 and not os.path.exists(target):
        return host, int(port_s)
    return None


def _admin_rpc(addr, op: str, timeout: float) -> dict:
    """One admin op on a fresh connection; raises OSError / ValueError."""
    import socket

    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.sendall(json.dumps({"op": op, "id": 1}).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def _static_engine(target: str, device: str):
    """A throwaway engine over a built artifact (``create_engine``'s
    default: the device engine), or an exit code after one error line."""
    from .serve import ArtifactError, create_engine
    from .serve.engine import NativeUnavailable

    try:
        return create_engine(target, None, device=device)
    except (ArtifactError, ValueError, DeviceUnavailable, NativeUnavailable) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _metrics_main(argv: list[str]) -> int:
    """``metrics TARGET`` — Prometheus text exposition of a running
    daemon (HOST:PORT, its 'metrics' admin op) or of a built artifact
    (DIR, a throwaway engine's registry)."""
    p = argparse.ArgumentParser(
        prog="mri-torch metrics",
        description="print Prometheus text-format metrics from a running "
                    "serve daemon (HOST:PORT) or a built artifact (DIR)")
    p.add_argument("target", help="serve daemon HOST:PORT, or the "
                                  "output dir of an --artifact run")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="daemon connect/read timeout in seconds")
    _device_arg(p, "(DIR targets)")
    args = p.parse_args(argv)

    addr = _daemon_addr(args.target)
    if addr is not None:
        try:
            resp = _admin_rpc(addr, "metrics", args.timeout)
        except OSError as e:
            print(f"error: cannot reach daemon at {args.target}: {e}", file=sys.stderr)
            return 2
        except ValueError:
            print(f"error: bad response from {args.target}", file=sys.stderr)
            return 2
        if not resp.get("ok"):
            print(f"error: daemon refused metrics: {resp.get('error', 'unknown')}",
                  file=sys.stderr)
            return 2
        sys.stdout.write(resp.get("text", ""))
        return 0
    engine = _static_engine(args.target, args.device)
    if isinstance(engine, int):
        return engine
    try:
        sys.stdout.write(engine.metrics.render_text())
    finally:
        engine.close()
    return 0


def _flightdump_main(argv: list[str]) -> int:
    """``flightdump HOST:PORT`` — a running daemon's flight recorder
    (last N completed request cost-reports + slow offenders) as one JSON
    document, without waiting for a crash."""
    p = argparse.ArgumentParser(
        prog="mri-torch flightdump",
        description="dump a running serve daemon's flight recorder "
                    "(bounded ring of recent request cost-reports, "
                    "MRI_OBS_FLIGHT_RING) as one JSON document")
    p.add_argument("target", metavar="HOST:PORT",
                   help="a running serve daemon's protocol address")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the dump to this file (stdout always "
                        "gets the JSON)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="daemon connect/read timeout in seconds")
    args = p.parse_args(argv)

    host, _, port_s = args.target.rpartition(":")
    if not (host and port_s.isdigit() and int(port_s) <= 65535):
        print(f"error: target must be HOST:PORT, got {args.target!r}", file=sys.stderr)
        return 2
    try:
        resp = _admin_rpc((host, int(port_s)), "flightdump", args.timeout)
    except OSError as e:
        print(f"error: cannot reach daemon at {args.target}: {e}", file=sys.stderr)
        return 2
    except ValueError:
        print(f"error: bad response from {args.target}", file=sys.stderr)
        return 2
    if not resp.get("ok"):
        print(f"error: daemon refused flightdump: {resp.get('error', 'unknown')}",
              file=sys.stderr)
        return 2
    text = json.dumps(resp.get("flight", {}), sort_keys=True)
    print(text)
    if args.out is not None:
        try:
            with open(args.out, "w", encoding="utf-8") as f:
                f.write(text + "\n")
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    return 0


def _top_sample(addr: tuple, timeout: float) -> dict:
    """One dashboard poll: ``healthz`` + ``stats`` + ``slo`` pipelined
    over a single daemon connection, matched back up by request id."""
    import socket

    reqs = (b'{"op":"healthz","id":1}\n'
            b'{"op":"stats","id":2}\n'
            b'{"op":"slo","id":3}\n')
    by_id: dict = {}
    with socket.create_connection(addr, timeout=timeout) as sock:
        sock.sendall(reqs)
        f = sock.makefile("rb")
        try:
            for _ in range(3):
                line = f.readline()
                if not line:
                    break
                resp = json.loads(line)
                by_id[resp.get("id")] = resp
        finally:
            f.close()
    health = dict(by_id.get(1, {}))
    health.pop("id", None)
    return {"healthz": health,
            "stats": by_id.get(2, {}).get("stats", {}),
            "slo": by_id.get(3, {}).get("slo", {})}


def _top_num(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _top_render(target: str, sample: dict) -> str:
    """One plain-text dashboard frame over a poll's sample (the JAX
    ``top`` frame; a router's sample adds one fleet row per replica)."""
    h = sample.get("healthz") or {}
    st = sample.get("stats") or {}
    slo = sample.get("slo") or {}
    ready = "ready" if h.get("ready") else "NOT READY"
    reasons = ",".join(h.get("reasons") or []) or "-"
    counters = st.get("counters") or {}
    lines = [
        f"mri top — {target} — {ready} ({h.get('status', '?')})",
        f"queue_depth={st.get('queue_depth', h.get('queue_depth', 0))}"
        f"  inflight={st.get('inflight', 0)}"
        f"  connections={st.get('connections', 0)}"
        f"  reasons={reasons}",
        "",
        f"{'window':<8}{'qps':>12}{'shed/s':>10}{'err/s':>10}{'p50 ms':>10}{'p99 ms':>10}",
    ]
    rolling = st.get("rolling") or {}
    for label in ("10s", "1m", "5m"):
        w = rolling.get(label) or {}
        lines.append(f"{label:<8}{_top_num(w.get('qps')):>12}"
                     f"{_top_num(w.get('shed_per_s')):>10}"
                     f"{_top_num(w.get('error_per_s')):>10}"
                     f"{_top_num(w.get('p50_ms')):>10}"
                     f"{_top_num(w.get('p99_ms')):>10}")
    tenants = st.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append(f"{'tenant':<12}{'wt':>4}{'rate':>8}{'admitted':>10}{'shed':>8}"
                     f"{'hits':>8}{'depth':>7}{'p95 ms':>10}{'burn 1m':>9}")
        for name in sorted(tenants):
            t = tenants[name] or {}
            admitted = (t.get("requests", 0) or 0) - (t.get("shed", 0) or 0)
            burns = [b for b in (t.get("burn_1m") or {}).values()
                     if isinstance(b, (int, float))]
            rate = t.get("rate_rps")
            lines.append(
                f"{name:<12}{_top_num(t.get('weight')):>4}"
                f"{('-' if rate is None else f'{rate:g}'):>8}"
                f"{admitted:>10}{_top_num(t.get('shed')):>8}"
                f"{_top_num(t.get('cache_hits')):>8}"
                f"{_top_num(t.get('queue_depth')):>7}"
                f"{_top_num(t.get('p95_ms')):>10}"
                f"{_top_num(max(burns) if burns else None):>9}")
    for name in sorted(slo):
        entry = slo[name] or {}
        head = f"slo {name} (target {entry.get('target')}"
        if entry.get("threshold_ms") is not None:
            head += f", <= {entry['threshold_ms']} ms"
        lines.append("")
        lines.append(head + ")")
        lines.append(f"  {'window':<8}{'ratio':>12}{'burn':>10}{'events':>10}")
        for label in ("10s", "1m", "5m"):
            pt = (entry.get("windows") or {}).get(label) or {}
            lines.append(f"  {label:<8}{_top_num(pt.get('ratio')):>12}"
                         f"{_top_num(pt.get('burn')):>10}{_top_num(pt.get('total')):>10}")
    cluster = st.get("cluster") or {}
    if cluster.get("shards"):
        lines.extend(_top_fleet_rows(cluster))
    lines.append("")
    nonzero = "  ".join(f"{k}={v}" for k, v in counters.items() if v)
    lines.append("counters: " + (nonzero or "-"))
    return "\n".join(lines) + "\n"


def _top_fleet_rows(cluster: dict) -> list[str]:
    """A router's fleet: one row per replica, all from the same single
    stats poll, then the coverage line (a shard counts as answerable
    while any replica is ready with a breaker that is not open)."""
    lines = ["", f"{'shard':<8}{'replica':<22}{'state':<10}"
                 f"{'breaker':<11}{'p95 ms':>10}  reasons"]
    answerable = 0
    for sh in cluster["shards"]:
        p95 = sh.get("p95_ms")
        reps = sh.get("replicas") or []
        if any(r.get("ready") and r.get("breaker", "closed") != "open"
               for r in reps):
            answerable += 1
        for rep in reps:
            state = "ready" if rep.get("ready") else "DOWN"
            if rep.get("primary"):
                state += "*"
            why = ",".join(rep.get("reasons") or []) or "-"
            lines.append(f"{sh.get('shard', '?'):<8}{rep.get('addr', '?'):<22}"
                         f"{state:<10}{rep.get('breaker', 'closed'):<11}"
                         f"{_top_num(p95):>10}  {why}")
    nshards = len(cluster["shards"])
    cov_line = f"coverage: {answerable}/{nshards} shards answerable"
    if answerable < nshards:
        cov_line += "  [DEGRADED]"
    cov_line += (f"  partial_default={cluster.get('partial_default') or 'fail'}"
                 f"  breakers_open={cluster.get('breakers_open', 0)}")
    lines.append(cov_line)
    return lines


def _top_main(argv: list[str]) -> int:
    """``top TARGET`` — the live operational-health dashboard.

    HOST:PORT polls a running daemon's ``stats``/``slo``/``healthz``
    admin ops and redraws every ``--interval`` seconds (Ctrl-C exits 0);
    ``--once --json`` prints one machine-readable sample.  DIR prints one
    static engine snapshot of a built artifact."""
    import time as time_mod

    p = argparse.ArgumentParser(
        prog="mri-torch top",
        description="live operational-health dashboard for a running serve "
                    "daemon (HOST:PORT) or one static metrics snapshot of a "
                    "built artifact (DIR)")
    p.add_argument("target", help="serve daemon HOST:PORT, or the "
                                  "output dir of an --artifact run")
    p.add_argument("--interval", type=float, default=1.0,
                   help="refresh period in seconds (live mode)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (no screen clear)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output (implies --once)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="daemon connect/read timeout in seconds")
    _device_arg(p, "(DIR targets)")
    args = p.parse_args(argv)
    once = args.once or args.as_json

    addr = _daemon_addr(args.target)
    if addr is None:
        engine = _static_engine(args.target, args.device)
        if isinstance(engine, int):
            return engine
        try:
            desc = engine.describe()
            text = engine.metrics.render_text()
        finally:
            engine.close()
        if args.as_json:
            print(json.dumps({"engine": desc, "metrics_text": text}, sort_keys=True))
        else:
            print(f"mri top — {args.target} (static artifact snapshot)")
            print(json.dumps(desc, sort_keys=True))
            sys.stdout.write(text)
        return 0
    try:
        while True:
            try:
                sample = _top_sample(addr, args.timeout)
            except (OSError, ValueError) as e:
                print(f"error: cannot poll daemon at {args.target}: {e}", file=sys.stderr)
                return 2
            if args.as_json:
                print(json.dumps(sample, sort_keys=True))
            else:
                if not once:
                    sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
                sys.stdout.write(_top_render(args.target, sample))
                sys.stdout.flush()
            if once:
                return 0
            time_mod.sleep(max(0.05, args.interval))
    except KeyboardInterrupt:
        return 0


def _segments_main(cmd: str, argv: list[str]) -> int:
    """``mri-torch append|delete|compact DIR ...`` — incremental indexing.

    Mutations are serialized under the segments lock and published by
    atomic manifest swap: readers on the old generation are never
    disturbed, and a failed mutation leaves the old manifest live."""
    p = argparse.ArgumentParser(
        prog=f"mri-torch {cmd}",
        description={
            "append": "index new files as one immutable segment and "
                      "publish the next manifest generation",
            "delete": "tombstone global doc ids (query-invisible "
                      "immediately; space reclaimed at compaction)",
            "compact": "merge the cheapest adjacent segment run into "
                       "one replacement segment, dropping tombstones",
        }[cmd])
    p.add_argument("index_dir", help="an --artifact output dir (first "
                                     "append seeds segments/ from its "
                                     "index.mri)")
    if cmd == "append":
        p.add_argument("--add", nargs="+", required=True, metavar="FILE",
                       help="text files to index as the new segment")
    elif cmd == "delete":
        p.add_argument("--docs", nargs="+", required=True, type=int,
                       metavar="ID", help="global doc ids to tombstone")
    else:
        p.add_argument("--force", action="store_true",
                       help="compact even below the "
                            "MRI_SEGMENT_COMPACT_TRIGGER segment count")
        p.add_argument("--prune", action="store_true",
                       help="after compacting, delete retired segment "
                            "dirs no longer referenced by the manifest "
                            "(unsafe while readers hold old generations)")
    p.add_argument("--fault-spec", default=None,
                   help="inject faults (see mri-torch --help for grammar)")
    args = p.parse_args(argv)

    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from . import segments
    try:
        if cmd == "append":
            missing = [f for f in args.add if not os.path.exists(f)]
            if missing:
                print(f"error: input files do not exist: {missing}",
                      file=sys.stderr)
                return 2
            res = segments.append_files(args.index_dir, args.add)
        elif cmd == "delete":
            res = segments.delete_docs(args.index_dir, args.docs)
        else:
            res = segments.compact(args.index_dir, force=args.force)
        print(json.dumps(res, sort_keys=True))
        if cmd == "compact" and args.prune:
            pruned = segments.prune_retired(args.index_dir)
            print(json.dumps({"pruned": pruned}, sort_keys=True))
    except segments.SegmentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except faults.InjectedCompactCrash as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _recover_main(argv: list[str]) -> int:
    """``mri-torch recover DIR`` — roll a live index directory forward to
    the last acknowledged mutation (segments/wal.py): replay WAL
    records above the manifest's generation, quarantine torn tail
    records, sweep mutation scratch.  Idempotent; also runs implicitly
    when a primary daemon starts."""
    p = argparse.ArgumentParser(
        prog="mri-torch recover",
        description="replay the mutation WAL after a crash: apply "
                    "acknowledged-but-unpublished records, quarantine "
                    "torn tail records, remove mutation scratch")
    p.add_argument("index_dir", help="a live (segment-managed) index "
                                     "directory")
    p.add_argument("--fault-spec", default=None,
                   help="inject faults (see mri-torch --help for grammar)")
    args = p.parse_args(argv)
    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from . import segments
    try:
        report = segments.recover(args.index_dir)
    except segments.SegmentError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report, sort_keys=True))
    return 0


def _replicate_main(argv: list[str]) -> int:
    """``mri-torch replicate DIR --from HOST:PORT`` — one catch-up round
    against a primary daemon (segments/replica.py): fetch the segment
    files this directory is missing (adler32-verified, staged, then
    atomically adopted) plus the primary's WAL tail.  Never re-indexes.
    Run it in a loop — or use ``mri-torch serve --replica-of`` — for a
    live replica."""
    p = argparse.ArgumentParser(
        prog="mri-torch replicate",
        description="catch a local index directory up to a primary "
                    "daemon by segment shipping (snapshot diff + "
                    "verified fetch + WAL tail adoption)")
    p.add_argument("index_dir", help="the replica's index directory "
                                     "(created if empty)")
    p.add_argument("--from", dest="source", required=True,
                   metavar="HOST:PORT",
                   help="the primary daemon's --listen address")
    p.add_argument("--timeout", type=float, default=30.0,
                   help="per-RPC socket timeout in seconds")
    p.add_argument("--fault-spec", default=None,
                   help="inject faults (see mri-torch --help for grammar)")
    args = p.parse_args(argv)
    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from . import segments
    try:
        addr = segments.replica.parse_addr(args.source)
        res = segments.replicate(args.index_dir, addr,
                                 timeout=args.timeout)
    except (segments.SegmentError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(res, sort_keys=True))
    return 0


def _shard_main(argv: list[str]) -> int:
    """``shard LIST --shards D --out DIR`` — partition a corpus into D
    buildable doc-shards with global-BM25 sidecars
    (cluster/partition.py)."""
    p = argparse.ArgumentParser(
        prog="mri-torch shard",
        description="partition a corpus manifest into D doc-shards, "
                    "build each with the host backend's --artifact path, "
                    "and stamp global BM25 stats into per-shard "
                    "sidecars so a router over the shards answers "
                    "byte-identically to a monolithic build")
    p.add_argument("file_list", help="source corpus manifest (count "
                                     "header then one path per line)")
    p.add_argument("--shards", type=int, required=True, metavar="D",
                   help="number of doc-shards (1 <= D <= corpus size)")
    p.add_argument("--out", required=True, metavar="DIR",
                   help="cluster directory; shard s builds into "
                        "DIR/shard-s")
    p.add_argument("--mode", choices=("round-robin", "size-balanced"),
                   default="round-robin",
                   help="doc assignment: round-robin by manifest "
                        "position (default) or greedy size-balanced "
                        "over file bytes")
    p.add_argument("--mappers", type=int, default=1,
                   help="per-shard build mapper count")
    p.add_argument("--reducers", type=int, default=2,
                   help="per-shard build reducer count")
    p.add_argument("--verify", action="store_true",
                   help="after building (or against an existing DIR), "
                        "byte-verify every per-shard manifest and gid "
                        "map against the recomputed assignment")
    p.add_argument("--verify-only", action="store_true",
                   help="skip the build; just verify DIR")
    args = p.parse_args(argv)

    from .cluster import partition as part_mod
    try:
        if not args.verify_only:
            cluster = part_mod.partition(
                args.file_list, args.shards, args.out,
                mode=args.mode, mappers=args.mappers,
                reducers=args.reducers,
                progress=lambda msg: print(
                    json.dumps({"event": "progress", "detail": msg}),
                    flush=True))
            print(json.dumps({"event": "partitioned", **cluster},
                             sort_keys=True), flush=True)
        if args.verify or args.verify_only:
            summary = part_mod.verify(args.file_list, args.out)
            print(json.dumps({"event": "verified", **summary},
                             sort_keys=True), flush=True)
    except part_mod.PartitionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _router_main(argv: list[str]) -> int:
    """``router --shards SPEC --listen HOST:PORT`` — the scatter-gather
    front end over shard daemons (cluster/router.py).  Blocks until
    drained by SIGTERM/SIGINT, as ``serve`` does."""
    import signal
    import threading

    p = argparse.ArgumentParser(
        prog="mri-torch router",
        description="scatter-gather router over doc-shard serve "
                    "daemons: same JSON-lines protocol as 'serve', "
                    "data ops fan out to every shard and gather "
                    "through a D-way merge; hedged requests and "
                    "replica failover ride shard health")
    p.add_argument("--shards", required=True, metavar="SPEC",
                   help="shard endpoints: shards joined by ',', "
                        "replicas of one shard joined by '|' — "
                        "'h:1|h:2,h:3' is two shards, the first with "
                        "two replicas")
    p.add_argument("--listen", default="127.0.0.1:0", metavar="HOST:PORT",
                   help="bind address (port 0 = ephemeral; the chosen "
                        "port is printed in the 'listening' JSON line)")
    p.add_argument("--hedge-ms", type=float, default=None,
                   help="hedge delay: -1 adaptive shard p95 (default, "
                        "from MRI_CLUSTER_HEDGE_MS), 0 off, >0 fixed ms")
    p.add_argument("--fault-spec", default=None,
                   help="arm the deterministic fault injector "
                        "(cluster kinds: shard-dead/shard-slow/"
                        "router-conn-reset/shard-blackout/"
                        "overload-storm) — test/bench only")
    args = p.parse_args(argv)

    from .obs import logging as obs_logging
    try:
        obs_logging.configure()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    from .cluster import router as router_mod
    try:
        shard_addrs = router_mod.parse_shard_arg(args.shards)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    host, _, port_s = args.listen.rpartition(":")
    try:
        port = int(port_s)
        if not host or not (0 <= port <= 65535):
            raise ValueError
    except ValueError:
        print(f"error: --listen must be HOST:PORT, got {args.listen!r}", file=sys.stderr)
        return 2

    try:
        router = router_mod.RouterDaemon(shard_addrs, host, port,
                                         hedge_ms=args.hedge_ms)
    except ValueError as e:
        # construction-time knob reads (a bad $MRI_CLUSTER_HEDGE_MS):
        # the one-line exit-2 contract
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        router.start()
    except OSError as e:
        print(f"error: cannot listen on {args.listen}: {e}", file=sys.stderr)
        router.drain()
        return 2

    stop = threading.Event()

    def _on_stop_signal(signum, frame):
        if stop.is_set():
            # second signal: the documented forced exit, code 1
            os._exit(1)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _on_stop_signal)
        signal.signal(signal.SIGINT, _on_stop_signal)

    bound_host, bound_port = router.address
    print(json.dumps({"event": "listening", "host": bound_host,
                      "port": bound_port, "pid": os.getpid(),
                      "shards": len(shard_addrs),
                      "replicas": [len(r) for r in shard_addrs]}),
          flush=True)
    while not stop.is_set():
        stop.wait(0.2)
    rc = router.drain()
    print(json.dumps({"event": "drained",
                      "counters": router.final_stats["counters"]},
                     sort_keys=True), flush=True)
    return rc


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sub = {"query": _query_main, "serve": _serve_main, "metrics": _metrics_main,
           "flightdump": _flightdump_main, "top": _top_main,
           "recover": _recover_main, "replicate": _replicate_main,
           "shard": _shard_main, "router": _router_main}
    if argv and argv[0] in sub:
        return sub[argv[0]](argv[1:])
    if argv and argv[0] in ("append", "delete", "compact"):
        return _segments_main(argv[0], argv[1:])
    # --verify DIR is a standalone mode (no reference positionals)
    if "--verify" in argv:
        i = argv.index("--verify")
        if i + 1 >= len(argv):
            print("error: --verify needs an output directory", file=sys.stderr)
            return 2
        ok, problems = verify_output_dir(argv[i + 1])
        for line in problems:
            print(f"verify: {line}", file=sys.stderr)
        if ok:
            print(f"verify: {argv[i + 1]} matches its index manifest")
        return 0 if ok else 2
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
    if args.fault_spec is not None:
        try:
            faults.install(args.fault_spec)
        except faults.FaultSpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    # one span collector per build (--trace-out): the manifest, the whole
    # build, its phases and the plan's own spans, written after the build
    trace = chrometrace.TraceEvents() if args.trace_out else None
    try:
        with Step("manifest", trace) as read:
            manifest = read_manifest(args.file_list)
        config = IndexConfig(
            num_mappers=args.num_mappers,
            num_reducers=args.num_reducers,
            backend=args.backend,
            output_dir=args.output_dir,
            pad_multiple=args.pad_multiple,
            checkpoint_path=args.checkpoint,
            profile_dir=args.profile_dir,
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
            io_prefetch=args.io_prefetch,
            overlap_tail_fraction=args.overlap_tail_fraction,
            overlap_device_windows=args.overlap_device_windows,
            overlap_window_split=args.overlap_window_split,
            stream_checkpoint=args.stream_checkpoint,
            stream_checkpoint_every=args.stream_checkpoint_every,
            resume=args.resume,
            audit=args.audit,
            artifact=args.artifact,
            trace_out=args.trace_out,
        )
        with Step("build", trace) as built:
            stats = build_index(manifest, config, trace=trace)
        if trace is not None:
            trace.write(args.trace_out)
    except (AuditError, OSError, ValueError, DeviceUnavailable, CheckpointCorrupt) as e:
        # ValueError covers the knobs too: a bad MRI_READ_* value is a
        # one-line configuration error, not a reader-thread traceback
        print(f"error: {e}", file=sys.stderr)
        return 2
    # the CLI's own times: build_ms - total_ms is the build's set-up and
    # teardown outside every phase
    stats["manifest_ms"] = round(read.ms, 3)
    stats["build_ms"] = round(built.ms, 3)
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
