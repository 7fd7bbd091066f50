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
        [--device cuda|cpu]
    ... metrics HOST:PORT|DIR      (Prometheus text)
    ... flightdump HOST:PORT [--out FILE]
    ... top HOST:PORT|DIR [--once] [--json]

``serve`` prints one ``{"event": "listening", ...}`` line, drains on
SIGTERM/SIGINT (exit 0; a second signal exits 1) with a ``drained``
line, reloads on SIGHUP and dumps the flight recorder on SIGQUIT.  The
segment subcommands (``shard``, ``router``, ``append``, ``delete``,
``compact``, ``recover``, ``replicate``) and ``serve --replica-of`` exit
2: they need the segment layer, not ported yet (ROADMAP A15b).
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
                   help="host shard count (reference mapper threads; output-invariant)")
    p.add_argument("num_reducers", type=int,
                   help="reduce partition count (reference reducer threads; output-invariant)")
    p.add_argument("file_list", help="manifest: count header then one path per line")
    p.add_argument("--backend", choices=("cuda", "oracle"), default="cuda",
                   help="cuda: device engine; oracle: pure-Python conformance backend")
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
                        "ui.perfetto.dev)")
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


#: JAX CLI subcommands that need the segment layer (ROADMAP A15b)
SEGMENT_SUBCOMMANDS = ("shard", "router", "append", "delete", "compact",
                       "recover", "replicate")


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
                   help="not ported yet: replicas need the segment layer "
                        "(ROADMAP A15b); exits 2")
    _device_arg(p, "(alone or inside auto)")
    args = p.parse_args(argv)

    if args.replica_of is not None:
        print(f"error: --replica-of needs segment shipping: the segment layer "
              "is not ported yet (ROADMAP A15b)", file=sys.stderr)
        return 2
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

    from .serve import ArtifactError
    from .serve.daemon import ServeDaemon
    from .serve.engine import NativeUnavailable

    try:
        # resolved before the daemon exists so a bad value is the
        # one-line exit-2 knob contract, not a traceback mid-serve
        gc_freeze = envknobs.get("MRI_SERVE_GC_FREEZE")
        daemon = ServeDaemon(args.index_dir, host, port, engine=args.engine,
                             cache_terms=args.cache_terms, shards=args.shards,
                             metrics_port=args.listen_metrics, device=args.device)
    except (ArtifactError, ValueError, OSError, DeviceUnavailable, NativeUnavailable) as e:
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
    ``top`` frame without its router fleet rows, ROADMAP A15b)."""
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
    lines.append("")
    nonzero = "  ".join(f"{k}={v}" for k, v in counters.items() if v)
    lines.append("counters: " + (nonzero or "-"))
    return "\n".join(lines) + "\n"


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


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sub = {"query": _query_main, "serve": _serve_main, "metrics": _metrics_main,
           "flightdump": _flightdump_main, "top": _top_main}
    if argv and argv[0] in sub:
        return sub[argv[0]](argv[1:])
    if argv and argv[0] in SEGMENT_SUBCOMMANDS:
        print(f"error: {argv[0]!r} needs the segment layer, which is not ported "
              "yet (ROADMAP A15b)", file=sys.stderr)
        return 2
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
    try:
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
        stats = build_index(manifest, config)
    except (AuditError, OSError, ValueError, DeviceUnavailable, CheckpointCorrupt) as e:
        # ValueError covers the knobs too: a bad MRI_READ_* value is a
        # one-line configuration error, not a reader-thread traceback
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
