#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (exit 1, no result line):

1. The card (``nvidia-smi`` name and power limit) and the build: the
   CUDA kernels from ``csrc/`` with nvcc (one process per source) and,
   at the same time, the native host scan ``native/tokenizer.cc`` with
   g++ (times and ptxas report).  A native build failure fails here.
2. Path A — the reference envelope: a 355-doc, 33,000-word-vocab Zipf
   corpus (~1.03 M tokens).  Two legs, each with its letter-file md5
   equal to the oracle's:
   - the one-shot plan over the numpy tokenizer
     (``build_index`` with ``IndexConfig(use_native=False)``; the CLI has
     no such flag): the ``u16`` engine, ``unique_mask_count`` launched;
   - the default CLI run (``4 26 list.txt --stats``): the pipelined plan
     with two uint16 windows (``upload_windows == 2``, ``tokenize_feed``
     present).
3. Path B — the one-shot plan fed by the native combiner at
   BASELINE.json config 4's vocabulary (100,000 words) with 20,000 docs
   (20 M tokens), ``--skew``: the ``packed`` engine, both kernels
   launched; md5 equal to the same build with ``--device cpu``.
4. Path C — the default CLI run on Path B's corpus, no ``--skew``: the
   default build at the repo's largest size.  It takes the pipelined plan
   (20,000 docs <= 0xFFFE) and its provisional ids outgrow uint16, so its
   windows are int32 keys; md5 equal to Path B's and to the same build
   with ``--device cpu``.  Its device work is one ``torch.sort``: it
   launches neither kernel.  Then its two windows are read again, on the
   main thread and by the reader thread alone, per window.
   Paths B and C are recorded by torch.profiler (device activity only),
   which gives each run's device-busy time and the idle share of its wall
   time.
5. Path D — the all-device plan (``--device-tokenize``) on Path B's
   corpus: raw bytes up, the finished index down, ``sort_cols == 3``, no
   fallback; md5 equal to Paths B and C and to the same build with
   ``--device cpu``; recorded by torch.profiler.  Two more legs on Path
   A's corpus: with added documents of 13-44-letter words (tail groups,
   the sparse tail fetch; md5 equal to their oracle's), and with
   ``--device-tokenize-width 8``, which must restart on the host plan
   (``device_tokenize_fallback`` set; md5 equal to Path A's oracle).
6. Path E — the streaming plan (``--stream-chunk-docs 5000``) on Path
   B's corpus: four windows into a packed accumulator, the finalize's
   dedup through ``unique_mask_count``; md5 equal to Path B's; recorded
   by torch.profiler.
7. Path F — the streaming all-device plan (``--device-tokenize
   --stream-chunk-docs 2500``) on Path B's corpus: eight byte windows
   into the word-row accumulator on the card, no fallback; md5 equal to
   Path B's; recorded by torch.profiler.  Two more legs: the same build
   through ``build_index`` with a stream checkpoint every two windows,
   killed by the crash hook after window 5 and run again (it must resume
   after window 4, delete the checkpoint and give Path B's md5); and
   ``--stream-chunk-docs 100 --device-tokenize-width 8`` on Path A's
   corpus, which must restart on the streaming plan (md5 equal to Path
   A's oracle).
8. Path G — the overlap plan (``--overlap-tail-fraction 0.3``) on Path
   B's corpus: two device windows sorted and fetched while the host
   scans on, the last 30% of the bytes sorted on the host; md5 equal to
   Path B's; recorded by torch.profiler.  Neither F nor G launches a
   kernel of ``csrc/``.
9. Path H — serving on Path B's corpus: the default CLI build with
   ``--artifact`` (md5 equal to Path B's, ``index.mri`` v2.1 byte-equal
   to the same build with ``--device cpu``), v1 and v2 written by the
   port's writer from the same arrays; then per format a
   ``DeviceEngine`` on the card answers df and postings at batches 1,
   32, 1024 and 8192 (Zipf-weighted words with absent, non-alpha and
   too-long ones mixed in), AND and OR over 2, 3 and 5 words, top_k for
   three letters and BM25 at k = 10 under each planner.  Every answer
   is held against a numpy reference (the reader's decode, set algebra,
   float64 BM25, rel 1e-4) and against the same engine on the CPU (BM25
   rel 1e-5; at batch 8192 on the first 256 lanes); each BM25 query
   runs twice on the card, bit-equal.  Then the median of five means of
   20 calls per op and batch on v2.1 (one mean of 3 on v1 and v2;
   CUDA events and host clock), the column
   bytes, the peak device memory and one torch.profiler trace of a
   batch-8192 postings call and a BM25 call.  No kernel of ``csrc/``.
10. Path I — the host query engine and the crossover router on Path H's
   three artifacts (no build): per format the host ``Engine`` (the
   native serve kernels required on v2/v2.1, numpy on v1), the
   ``DeviceEngine`` on the card and a fresh ``AutoEngine`` on the card
   answer Path H's batches and queries alike (df, lookup, postings, AND,
   OR, top_k; BM25 at k = 10 per planner: host and auto bit-equal,
   native and numpy bit-equal, the device within rel 1e-4); the auto
   engine's first batch of 8192 runs its probe (``host_s``,
   ``device_s``, winner printed); ``MRI_SERVE_CROSSOVER=1`` sends every
   batch to the card with the answers unchanged, ``=0`` never builds the
   device engine; ``query --engine host|device|auto`` prints the same
   bytes on v2.1; then the host engine's ms per op and batch (host
   clock), BM25 native and numpy; postings also on a fresh Zipf batch
   per call and with the LRU purged before each call, and the auto
   engine's postings at 8192 on the probe's winner.  No kernel of
   ``csrc/``.
11. Path J — the multi-shard builds on Path B's corpus, each a
   ``--device-shards 4`` CLI build with 4 logical shards on the one card
   and its md5 equal to Path C's: J1 the pipelined plan with
   ``--artifact`` (``index.mri`` byte-equal to Path H's v2.1), J2
   ``--emit-ownership letter``, J3 ``--pipeline-chunk-docs 0 --skew``
   (the one-shot ``dist_index``, ``bucket_histogram`` launched twice),
   J4 ``--stream-chunk-docs 5000``, J5 ``--device-tokenize``, J6
   ``--device-tokenize --emit-ownership letter``, J7 ``--device-tokenize
   --stream-chunk-docs 2500``; each recorded by torch.profiler and
   printed with ``device_shards``, ``dist_fetched_bytes``,
   ``dist_valid_pairs``, peak device memory and the card.  Then the
   exchange alone: ``dist_sort_prov_windows`` on distinct keys at Path
   C's pair count, at n = 1, 2, 4 and 8 shards and capacity factors 2.0
   and 0.25 (where the overflow retry must run), each equal to
   ``sort_prov_chunks`` on one device, by CUDA events and the host clock.
12. Path K — the build's resilience and integrity options, on Path B's
   corpus, each leg checked by md5 and exit code: K1 ``--checkpoint`` on
   Path B's argv (saved, then resumed: phase ``resume``, no read, the
   kernels launched as Path B launches them; a torn copy exits 2 under
   ``--resume strict`` and is quarantined under ``--resume auto``, whose
   rebuild also carries K2's transient fault and K5's options); K2
   ``--fault-spec`` read faults: a transient fault on every 97th document
   (Path B's md5, two retries a hit document) and a permanent one on doc
   id 5 on Path D's argv (exit 3, that id skipped, the md5 of Path C's
   files with doc 5 taken out); K3 Path F's argv with a stream checkpoint
   every two windows, killed in a child process by ``sigkill:window=5``
   (the rerun resumes after window 4), and crashed in the engine by
   ``stream-crash:window=3`` with its save torn by ``ckpt-corrupt:save=1``
   (the rerun quarantines it), each rerun with ``--resume auto`` to Path
   B's md5; K4 the emit of Path A's default build killed after 7 letters
   (``MRI_EMIT_KILL_AFTER_LETTERS``, native and Python writers, child
   processes): a.txt..g.txt equal to Path A's, no truncated file; K5
   ``--artifact --audit --trace-out`` on K1's auto rebuild, then
   ``--verify`` (0 untouched, 2 naming a flipped letter file and a flipped
   ``index.mri``; the trace valid JSON); K6 ``--profile-dir`` on K2's skip
   build (a torch.profiler trace with CUDA kernel events).  The emit kills
   run beside K1; the stream kill runs alone (the host reads files slowly
   while two processes read); ``phase path_k_done`` prints Path K's
   seconds.
13. Path L — the resident serve daemon over Path H's v2.1 artifact, no
   kernel of ``csrc/`` launched: L1 ``ServeDaemon(engine="device")`` in
   this process with default knobs, 16 client processes of 250 requests
   each (df and postings of one Zipf word, AND/OR of 2-3 words, BM25
   top-10 of 3, top-10 of a letter), every answer equal to the host
   ``Engine``'s (BM25 docs equal, scores within rel 1e-4): per-op client
   p50/p99, requests/s, coalesced batches; 16 × 50 of them again under
   torch.profiler (device busy, idle share) and the peak device memory;
   then, beside four connections of background traffic, five ``reload``
   ops (allocated device memory back within one engine's column bytes),
   a BM25 ``explain`` (terms resolved ``device``, decoded blocks, theta),
   ``flightdump``, ``metrics`` equal to ``stats`` and the ``trace``
   spans; an ``auto`` daemon (its probe on a batch of 8192) and a
   ``shards=4`` daemon answering two connections the same; L2 the
   ``serve`` CLI in a child process: HTTP ``/metrics``, the ``metrics``,
   ``flightdump`` and ``top --once --json`` clients, SIGHUP (one
   ``reload_ok``) and SIGTERM (exit 0 and the ``drained`` line).
14. Path M — the host backend (``--backend cpu``), which never touches
   the card, each leg's md5 checked and no ``cpu_fallback`` (the native
   host index and merge ran): M1 ``1 1 --host-threads 1`` on Path B's
   corpus (the pipelined ingest route), M2 ``8 4`` (eight scan workers
   on the steal queue, four letter reducers), M3 M2 under
   ``MRI_BUILD_SPILL_BYTES`` = 16 MiB (more than one spill run per
   worker, the k-way shard merge), each with Path C's md5; M4 M2 with
   ``--artifact`` at ``MRI_SERVE_FORMAT`` 1, 2 and 3: v1 byte-equal to
   Path H's v1, and a ``DeviceEngine`` on the card over M4's v2.1 (which
   carries the host build's tf and token doc lengths) answering Path H's
   batches and AND/OR queries as the card engine over Path H's v2.1
   does, BM25 top-10 per planner equal to the host ``Engine`` on the M4
   file (rel 1e-4; documents whose float64 scores tie within it may come
   in any order), then its ms per op; M5 ``4 2 --audit --fault-spec
   worker-death:window=2`` with ``MRI_CPU_WINDOW_BYTES=4096`` on Path
   A's corpus (a worker recovered, Path A's oracle md5, ``--verify``
   exit 0); M6 a ``SyntheticManifest`` of Path B's parameters built by
   the host backend and by the default plan on the card (in one
   generator chunk it draws Path B's documents, so both md5s equal Path
   C's).
   One ``path_m`` line holds each leg's phases, ``host_threads``, spill
   runs and the process's peak RSS during the leg, beside the card and
   the host's CPU model.
15. Path N — the live index (``segments/``) on Path B's corpus, in the
   phase ``path_n`` line: N1 the default card build with ``--artifact``
   over files 1-18,000 as the seed, then ``append --add`` of
   18,001-19,000 and 19,001-20,000 as two segments on the host; df and
   postings at batches 1 and 1,024 of Zipf words, AND/OR of 2-3 words
   and letter top-10 of the multi-segment engine equal the card's
   ``DeviceEngine`` over Path H's artifact (BM25 is not compared: the
   card's seed has no real tf); N2 ``delete --docs`` of 1,000 ids across
   the three segments, one again (no new tombstone), the same answers
   as a from-scratch card build of the 19,000 live files, ids mapped by
   rank; N3 a ``compact --fault-spec compact-crash`` child exits 2 with
   the manifest unchanged, ``compact --force`` at
   ``MRI_SEGMENT_COMPACT_TRIGGER=2`` folds the two appended segments,
   ``--verify`` exits 0, N2's answers again; N4 ``serve`` in a child over
   four appends of 500 files (the multi-segment engine): eight read
   clients of Path L's mix, each request carrying the last acknowledged
   generation as ``min_generation``, while a mutation client appends
   500 files, deletes 200 ids at ``MRI_SEGMENT_TOMBSTONE_FLUSH=8`` and
   compacts; every distinct read then equals a host ``Engine`` exactly
   and the card's ``DeviceEngine`` (BM25 rel 1e-4, ties in any order)
   over a from-scratch ``--backend cpu`` build of the live files; five
   deletes acknowledged buffered, SIGKILL, restart: the startup recovery
   replays them (``recover`` on a copy writes the same manifest) and the
   answers equal the new reference; N5 ``serve --replica-of`` that
   primary (armed with one ``fetch-partial``) on an empty directory at
   ``MRI_REPLICA_POLL_MS=200``: the torn ship rejected and retried, every
   file byte-equal, one more primary append followed within 10 s.  ms
   per append, delete, compact, recover and engine open, per-op query
   ms, read p50/p99 under mutations, ack ms, convergence ms, peak device
   memory and both kernels' launches (0: the seed is the pipelined plan).
16. Path O — the doc-sharded cluster (``cluster/``, host code as in the
   JAX package) on Path B's corpus, in the phase ``path_o`` line: O1
   ``shard --shards 4 --verify`` (round-robin, 5,000 files a shard: ms
   of each shard's host build, of the global-stats pass and of the
   command), ``--verify-only`` (0, then 2 naming shard 2 after a flipped
   ``docs.list`` byte), the monolith on Path M4's argv; O2 five ``serve``
   children (shard 0 on two replicas, the shard engine) and a ``router``
   child, half of Path L's traffic (16 x 125) through the router equal to the host
   ``Engine`` over the monolith exactly and to the card's
   ``DeviceEngine`` over it (BM25 rel 1e-4, ties in any order), and the
   same traffic against one ``serve --engine host`` child over the
   monolith (requests/s, p50/p99 per op of both); O4 a second router
   with ``--hedge-ms 5`` and a slowed shard-0 replica (hedges and hedge
   wins, the answers unchanged); O3 shard 0's first replica SIGKILLed
   under traffic (every request answered once and correctly, failovers
   counted); O5 shard 1's only replica SIGKILLed (typed
   ``shard_unavailable`` under ``fail``; ``partial`` answers at
   ``docs_fraction`` 0.75 equal to ``ShardRestrictedOracle`` under
   ``allow``; a breaker ``open`` in ``top ROUTER --once --json``); O6 a
   ``ParagraphManifest`` over 355 generated files of Zipf paragraphs
   (5.8 MB), salted to 20,000 documents, built on the card by the
   default plan and the streaming all-device plan, each md5 equal to
   ``oracle_index``, and its vocabulary curve.
17. Path P — the multi-process mesh on Path B's corpus, in child
   processes joined by ``parallel/distributed.initialize`` at a free
   local port (one group runs P1-P3 in turn, another P4, whose process
   starts up beside the first group and joins when it ends), every child
   killed past 600 s: P1 the all-device
   plan with ``emit_ownership="letter"`` at 4 shards (``build``'s
   ``InvertedIndexModel``), P2 the pipelined plan with letter ownership
   at 4 shards, P3 ``DistDeviceStreamEngine`` over Path F's windows
   (2,500 documents; the accumulators regrow), each in 2 processes of a
   gloo group (the backend rule: two processes share the one card) with
   2 local shards each on ``cuda:0``; P4 P1's build in a one-process
   NCCL group (4 local shards).  Process 0 holds owners [0, 1] and
   process 1 owners [2, 3]; P1, P2 and P4's shared letter files, and
   P3's owner blocks written as letter files, each give Path C's md5.
   Per process: wall ms, peak device memory, device-busy ms (its own
   torch.profiler trace), its start-up, the bytes it sent through
   ``all_to_all_single`` and its kernel launches (its counts set to 0
   just before the leg and read just after); the card's busy share (the
   processes' device-busy ms over the leg's wall).
18. Path Q — the sanitized native builds (``MRI_NATIVE_SANITIZE`` asan
   and ubsan, built by ``g++`` in the background from the start, beside
   the kernels' build) on this machine's host: per variant a child
   process (asan: ``libasan`` preloaded, ``detect_leaks=0``,
   ``protect_shadow_gap=0``; no card visible) loads its library, runs
   Path M1's ``1 1 --host-threads 1 --backend cpu`` build on Path A's
   corpus (md5 equal to Path A's) and the host ``Engine`` over Path I's
   query mix on Path H's v2.1 artifact (df, lookup and postings at
   batches 1-8192, AND/OR of 2, 3 and 5 words, BM25 top-10 per planner,
   top_k of three letters), every answer equal to the production
   library's in this process.  Any sanitizer report fails; each
   variant's build and run seconds, and its kernel launches (counts set
   to 0 in the child before its build), are printed.
19. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, exact equality, at the shapes Paths A, B, E and F's overflow
   leg gave it in this run, ragged sizes, all-padding and dense runs; then CUDA-event times of the kernel, the
   plain version and (histogram only) ``torch.bincount``, beside the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over 67 T/s, whichever is larger).  Each time is the median of five
   CUDA-event means, printed with its min and max, each taken after a
   device spin so that the host's enqueue is not what is timed.
   ``bucket_histogram`` is checked on misaligned views, ``n % 4`` in
   {1, 2, 3} and 1 to 128 buckets, and timed at both of Path B's launches
   (26 letters, 2 hash buckets) and on one-hot ids (a contention probe).
20. Engine: the warm device time of each engine program a path runs, at
   that path's shape from this run — index_u16 (Path A's numpy leg),
   index_prededuped_u16 (Path A's deduped pairs), index_packed (Path B),
   sort_prov_chunks (Path C's two int32 windows), index_bytes_device
   (Path D's bytes) — with the peak device memory of the last two; one
   StreamingIndexEngine.feed of Path E's last window, by the host clock
   and by CUDA events; and one DeviceStreamEngine.feed of Path F's last
   window, synchronized after each stage (upload, window_rows, merge),
   with the warm time of the finalize program on Path F's accumulator.

``python3 chip_smoke.py --mesh-only`` runs the build, the single-device
default build with ``--artifact`` on Path B's corpus and Path J alone, on
every card the machine has (4 shards, shard i on card i % cards);
``--serve-only`` runs the build, the default build with ``--artifact``
on Path B's corpus and Path L alone; ``--segments-only`` the build, the
same ``--artifact`` build and Path N alone; ``--cluster-only`` the build,
the same ``--artifact`` build and Path O alone; ``--multiprocess-only``
the build, Path C and Path P alone; ``--sanitize-only`` the build, Path
A's oracle, the same ``--artifact`` build and Path Q alone.

Every path runs through ``cli.main`` (the function behind
``python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch``)
or ``build_index`` in this process (Path L: ``ServeDaemon`` and the
``serve`` CLI's child; Path O: the ``serve`` and ``router`` CLIs'
children; Path P: ``InvertedIndexModel`` and ``DistDeviceStreamEngine``
in each process of a group; Path Q: the CLI and the host ``Engine`` in
sanitized children), with the kernels' launch counts set
to 0 just before and read just after each (for P and Q in each child); a kernel's ``launches`` in
the ``kernels`` line is their sum, ``launches_by_path`` the parts.  The
last lines are the card,
one ``{"kernels": [...]}`` JSON line, and ``{"ok": true, "device":
{...}}``.  Exits non-zero without those on a machine with no CUDA
device, or when the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
JAX_KERNELS = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu/ops/pallas/kernels.py"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12     # 32-bit ops on the CUDA cores (fp32 non-tensor peak)
INT32_MAX = 2**31 - 1
CRASH_KNOB = "MRI_TPU_STREAM_CRASH_AFTER_WINDOWS"  # the stream crash hook


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


HOLD_CYCLES = 100_000_000  # ~50 ms of device spin at the H100's clocks


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, repeats: int = 5
            ) -> tuple[float, float, float]:
    """Device time of one ``fn`` call in ms, by CUDA events: the mean over
    ``iters`` calls, taken ``repeats`` times; returns (median, min, max).
    The device spins first, so the host has queued every call before the
    first starts and the time is the device's, not the enqueue's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return runs[len(runs) // 2], runs[0], runs[-1]


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(torch, n: int, vocab: int, gen, alpha: float = 1.2):
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device="cuda")
    cdf = torch.cumsum(ranks ** (-alpha), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device="cuda", generator=gen)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1).to(torch.int32)


def sorted_keys(torch, n: int, n_valid: int, vocab: int, max_doc: int, gen):
    """Ascending packed keys as the engine sorts them: Zipf terms,
    uniform docs, INT32_MAX padding."""
    term = zipf_ids(torch, n_valid, vocab, gen)
    doc = torch.randint(1, max_doc + 1, (n_valid,), device="cuda", generator=gen,
                        dtype=torch.int32)
    keys = torch.full((n,), INT32_MAX, dtype=torch.int32, device="cuda")
    keys[:n_valid] = term * (max_doc + 2) + doc
    return torch.sort(keys).values


def phase_kernels(torch, K, shapes) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []

    # -- unique_mask_count -------------------------------------------------
    err = 0

    def cmp_unique(keys, limit, label):
        nonlocal err
        mask, count = K.unique_mask_count(keys, limit)
        pmask, pcount = K.unique_mask_count_plain(keys, limit)
        torch.cuda.synchronize()
        bad = int((mask != pmask).sum()) + abs(int(count) - int(pcount))
        err = max(err, bad)
        check(bad == 0, f"unique_mask_count != plain on {label}: {bad} differences")

    a_n, a_valid, a_vocab, a_docs = shapes["A"]
    b_n, b_valid, b_vocab, b_docs = shapes["B"]
    keys_a = sorted_keys(torch, a_n, a_valid, a_vocab, a_docs, gen)
    keys_b = sorted_keys(torch, b_n, b_valid, b_vocab, b_docs, gen)
    limit_a = a_vocab * (a_docs + 2)
    limit_b = b_vocab * (b_docs + 2)
    cmp_unique(keys_a, limit_a, f"path A shape n={a_n}")
    cmp_unique(keys_b, limit_b, f"path B shape n={b_n}")
    # the streaming plan's finalize runs on its whole (doubled)
    # accumulator: Path E's, and Path F overflow leg's restart on it
    for label in ("E", "F_overflow"):
        s_n, s_valid, s_vocab, s_docs = shapes[label]
        cmp_unique(sorted_keys(torch, s_n, s_valid, s_vocab, s_docs, gen),
                   s_vocab * (s_docs + 2), f"path {label} shape n={s_n}")
    for n in (1, 8191, 1_000_003):
        cmp_unique(sorted_keys(torch, n, n - n // 7, 5000, 355, gen), 5000 * 357, f"ragged n={n}")
    cmp_unique(torch.full((8192,), INT32_MAX, dtype=torch.int32, device="cuda"), 100,
               "all padding")
    dense = torch.repeat_interleave(
        torch.arange(64, dtype=torch.int32, device="cuda") * 7, 3 * 8192 // 64)
    cmp_unique(dense, 1 << 30, "dense runs")
    mask, count = K.unique_mask_count(torch.empty(0, dtype=torch.int32, device="cuda"), 5)
    check(mask.numel() == 0 and int(count) == 0, "unique_mask_count n=0 not (empty, 0)")

    ms, lo, hi = cuda_ms(torch, lambda: K.unique_mask_count(keys_b, limit_b))
    plain_ms = cuda_ms(torch, lambda: K.unique_mask_count_plain(keys_b, limit_b))[0]
    b_ms, b_by = bound(5 * b_n + 4, 4 * b_n)
    results.append({
        "name": "unique_mask_count", "route": "cuda",
        "source": f"{PKG}/csrc/unique_mask_count.cu",
        "replaces": f"{JAX_KERNELS}:124", "n": b_n,
        "max_abs_err": err, "parity": err == 0, "ms": ms, "kernel_ms": ms,
        "ms_min": lo, "ms_max": hi,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })

    # -- bucket_histogram --------------------------------------------------
    err = 0

    def cmp_hist(values, nb, label):
        nonlocal err
        got = K.bucket_histogram(values, nb)
        want = K.bucket_histogram_plain(values, nb)
        torch.cuda.synchronize()
        bad = int((got - want).abs().max())
        err = max(err, bad)
        check(bad == 0, f"bucket_histogram != plain on {label}: max err {bad}")

    terms = zipf_ids(torch, b_valid, b_vocab, gen)
    letter_of_term = torch.randint(0, 26, (b_vocab,), device="cuda", generator=gen,
                                   dtype=torch.int32)
    letters = letter_of_term[terms.long()]
    buckets = terms % 2
    one_hot = torch.full((b_valid,), 5, dtype=torch.int32, device="cuda")
    cmp_hist(letters, 26, f"path B letters n={b_valid}")
    cmp_hist(buckets, 2, f"path B hash buckets n={b_valid}")
    cmp_hist(one_hot, 26, f"one hot n={b_valid}")
    mixed = torch.randint(-3, 128 + 3, (1_000_003,), device="cuda", generator=gen,
                          dtype=torch.int32)
    for nb in (1, 2, 8, 26, 32, 33, 127, 128):
        cmp_hist(mixed % (nb + 6) - 3, nb, f"out-of-range mix nb={nb}")
    for offset in (1, 2, 3):  # views that start 4, 8, 12 bytes past a 16-byte boundary
        cmp_hist(letters[offset:], 26, f"letters[{offset}:]")
        cmp_hist(mixed[offset:offset + 4097], 33, f"mixed[{offset}:{offset + 4097}] nb=33")
    for n in (1, 2, 3, 5, 6, 7, 8191, 8193, 8194, 8195):  # n % 4 in {1, 2, 3}
        cmp_hist(torch.randint(-2, 28, (n,), device="cuda", generator=gen,
                               dtype=torch.int32), 26, f"ragged n={n}")
    cmp_hist(letters[::3], 26, "strided letters[::3]")
    cmp_hist(torch.full((8192,), 26, dtype=torch.int32, device="cuda"), 26, "all padding")
    cmp_hist(torch.full((3 * 8192,), 5, dtype=torch.int32, device="cuda"), 26, "one hot bucket")

    # Path B's two launches (letters, hash buckets), then one-hot ids as a
    # contention probe; each beside its plain version and torch.bincount.
    hist_shapes = []
    for label, values, nb in (("letters", letters, 26), ("hash_buckets", buckets, 2),
                              ("one_hot", one_hot, 26)):
        ms, lo, hi = cuda_ms(torch, lambda: K.bucket_histogram(values, nb))
        shape = {"label": label, "n": b_valid, "num_buckets": nb, "ms": ms,
                 "ms_min": lo, "ms_max": hi}
        shape["plain_ms"] = cuda_ms(torch, lambda: K.bucket_histogram_plain(values, nb))[0]
        shape["library_ms"] = cuda_ms(torch, lambda: torch.bincount(values, minlength=nb))[0]
        shape["bound_ms"], shape["bound_by"] = bound(4 * b_valid + 4 * nb, 2 * b_valid)
        hist_shapes.append(shape)
    main_shape = hist_shapes[0]
    results.append({
        "name": "bucket_histogram", "route": "cuda",
        "source": f"{PKG}/csrc/bucket_histogram.cu",
        "replaces": f"{JAX_KERNELS}:183", "n": b_valid, "num_buckets": 26,
        "max_abs_err": err, "parity": err == 0,
        "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
        "ms_min": main_shape["ms_min"], "ms_max": main_shape["ms_max"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
        "shapes": hist_shapes,
    })
    return results


def random_keys(torch, n_valid: int, padded: int, vocab: int, max_doc: int, gen):
    """Unsorted packed keys (Zipf terms, uniform docs), INT32_MAX padding."""
    term = zipf_ids(torch, n_valid, vocab, gen)
    doc = torch.randint(1, max_doc + 1, (n_valid,), device="cuda", generator=gen,
                        dtype=torch.int32)
    keys = torch.full((padded,), INT32_MAX, dtype=torch.int32, device="cuda")
    keys[:n_valid] = term * (max_doc + 2) + doc
    return keys


def u16_feed(torch, n_valid: int, padded: int, vocab: int, max_doc: int, gen):
    """The int16 view of a uint16 ``[terms | docs]`` feed, 0xFFFF padding."""
    pad = torch.full((padded - n_valid,), 0xFFFF, dtype=torch.int32, device="cuda")
    terms = torch.cat([zipf_ids(torch, n_valid, vocab, gen), pad])
    docs = torch.cat([torch.randint(1, max_doc + 1, (n_valid,), device="cuda", generator=gen,
                                    dtype=torch.int32), pad])
    return torch.cat([terms, docs]).to(torch.int16)  # the uint16 feed's bits


def round_up(n: int, m: int) -> int:
    return ((max(n, 1) + m - 1) // m) * m


def phase_engine(torch, E, shapes) -> dict:
    """Warm device time of the engine program each path runs, at that
    path's shape (padded n, valid n, vocab, docs) from this run."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    a_n, a_valid, a_vocab, a_docs = shapes["A_numpy"]
    feed = u16_feed(torch, a_valid, a_n, a_vocab, a_docs, gen)
    out["index_u16_ms"] = cuda_ms(
        torch, lambda: E.index_u16(feed, vocab_size=a_vocab, max_doc_id=a_docs), iters=10)
    d_n, d_valid, d_vocab, d_docs = shapes["A_dedup"]
    feed = u16_feed(torch, d_valid, d_n, d_vocab, d_docs, gen)
    nfetch = min(d_n, round_up(d_valid, 1 << 14))
    out["index_prededuped_u16_ms"] = cuda_ms(
        torch, lambda: E.index_prededuped_u16(feed, max_doc_id=d_docs, out_size=nfetch),
        iters=10)
    b_n, b_valid, b_vocab, b_docs = shapes["B"]
    keys = random_keys(torch, b_valid, b_n, b_vocab, b_docs, gen)
    letters = torch.randint(0, 26, (b_vocab,), device="cuda", generator=gen, dtype=torch.int32)
    out["index_packed_ms"] = cuda_ms(
        torch, lambda: E.index_packed(keys, letters, vocab_size=b_vocab, max_doc_id=b_docs),
        iters=10)
    c_n, c_valid, c_vocab, c_docs = shapes["C"]
    half = c_valid // 2
    chunks = [random_keys(torch, v, round_up(v, 1 << 14), c_vocab, c_docs, gen)
              for v in (half, c_valid - half)]
    nfetch = min(sum(c.shape[0] for c in chunks), round_up(c_valid, 1 << 14))
    del keys, feed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out["sort_prov_chunks_ms"] = cuda_ms(
        torch, lambda: E.sort_prov_chunks(chunks, stride=c_docs + 2, out_size=nfetch), iters=10)
    out["sort_prov_chunks_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    return out


def engine_device_plans(torch, m, stats_d: dict, chunk_docs: int) -> dict:
    """Path D's device program on Path D's bytes (warm time, peak memory
    beyond its inputs) and one streaming feed of Path E's last window
    (host clock and CUDA events), from the corpus ``m`` of this run."""
    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        manifest as manifest_mod)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        device_tokenizer as DT, streaming as S)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
        streaming as text_streaming)

    out = {}
    contents, ids = manifest_mod.load_documents(m)
    total = sum(len(c) for c in contents)
    buf = np.full(round_up(total, 1 << 16), 0x20, np.uint8)
    buf[:total] = np.frombuffer(b"".join(contents), np.uint8)
    ends = np.cumsum([len(c) for c in contents]).astype(np.int32)
    del contents
    count, max_len = DT.host_token_stats(buf, ends)
    kw = dict(width=stats_d["device_tokenize_width"], tok_cap=round_up(count + 1, 1 << 15),
              num_docs=len(ids), sort_cols=-(-max(max_len, 1) // 4))
    args = [torch.from_numpy(a).cuda() for a in (buf, ends, np.asarray(ids, np.int32))]
    check(kw["sort_cols"] == stats_d["sort_cols"],
          f"engine: sort_cols {kw['sort_cols']} != path D's {stats_d['sort_cols']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = DT.index_bytes_device(*args, **kw)
    counts = res["counts"].cpu().tolist()
    out["index_bytes_device_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    check(counts[:2] == [stats_d["unique_terms"], stats_d["unique_pairs"]],
          f"engine: index_bytes_device counts {counts} disagree with path D")
    del res
    out["index_bytes_device_ms"] = cuda_ms(
        torch, lambda: DT.index_bytes_device(*args, **kw), iters=3, warmup=1, repeats=3)
    out["index_bytes_device_shape"] = {"n": int(buf.shape[0]), "tok_cap": kw["tok_cap"],
                                       "tokens": count, "sort_cols": kw["sort_cols"]}
    del args

    tok = text_streaming.StreamingTokenizer(num_threads=4)
    windows = [tok.feed(c, i) for c, i in
               manifest_mod.iter_document_chunks(m, chunk_docs)]
    eng = S.StreamingIndexEngine(max_doc_id=len(m), device="cuda", window_pad=1 << 16)
    for w in windows[:-1]:
        eng.feed(w.prov_term_ids, w.doc_ids, tok.vocab_size)
    last = windows[-1]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    eng.feed(last.prov_term_ids, last.doc_ids, tok.vocab_size)
    end.record()
    torch.cuda.synchronize()
    out["stream_feed_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["stream_feed_event_ms"] = start.elapsed_time(end)
    out["stream_feed_shape"] = {"pairs": int(last.prov_term_ids.shape[0]),
                                "capacity": eng.capacity, "mode": eng.mode}
    return out


def engine_device_stream(torch, m, stats_f: dict, chunk_docs: int, pad_multiple: int) -> dict:
    """Path F's device stream engine alone, on Path F's windows of the
    corpus ``m``: the first windows fed as the plan feeds them, then the
    last one through a ``stage_hook`` that synchronizes after each stage
    (host clock and CUDA events per stage), then the warm time of the
    finalize program on the full accumulator."""
    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        manifest as manifest_mod)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
        inverted_index as MI)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        device_streaming as DS, device_tokenizer as DT)

    width = stats_f["device_tokenize_width"]
    eng = DS.DeviceStreamEngine(width=width, device="cuda")
    windows = list(manifest_mod.iter_document_chunks(m, chunk_docs))
    check(len(windows) == stats_f["stream_windows"],
          f"engine: {len(windows)} windows, path F fed {stats_f['stream_windows']}")

    def packed(contents, ids):
        total = sum(len(c) for c in contents)
        buf, ends, idv = MI._pack_window(contents, ids, round_up(total, pad_multiple))
        count, max_len = DT.host_token_stats(buf, ends)
        return buf, ends, idv, count, max_len

    for contents, ids in windows[:-1]:
        buf, ends, idv, count, max_len = packed(contents, ids)
        eng.feed(buf, ends, idv, tok_count=count, max_len=max_len)
    buf, ends, idv, count, max_len = packed(*windows[-1])
    del windows
    marks = []

    def hook(name, _value):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(), ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    first.record()
    eng.feed(buf, ends, idv, tok_count=count, max_len=max_len, stage_hook=hook)
    stages, prev_t, prev_ev = {}, t0, first
    for name, t, ev in marks:
        stages[name] = {"wall_ms": (t - prev_t) * 1e3, "event_ms": prev_ev.elapsed_time(ev)}
        prev_t, prev_ev = t, ev
    out = {"device_stream_feed_stages": stages,
           "device_stream_feed_shape": {"tokens": count, "bytes": int(buf.shape[0]),
                                        "capacity": eng.capacity,
                                        "rows": eng.rows_curve[-1]},
           "device_stream_feed_peak_bytes": torch.cuda.max_memory_allocated()}
    check(eng.capacity == stats_f["accumulator_capacity"],
          f"engine: capacity {eng.capacity} != path F's {stats_f['accumulator_capacity']}")
    acc, groups = eng._acc, eng._num_groups
    out["device_stream_finalize_ms"] = cuda_ms(
        torch, lambda: DS.finalize_rows_body(acc, num_groups=groups), iters=5, warmup=1,
        repeats=3)
    res = eng.finalize()
    counts = res["counts"].cpu().tolist()
    check(counts[:2] == [stats_f["unique_terms"], stats_f["unique_pairs"]],
          f"engine: device stream counts {counts} disagree with path F")
    return out


def device_busy(trace_path: Path, top: int = 6) -> dict:
    """Summed duration of the kernels, copies and fills in a
    torch.profiler Chrome trace: ``{"ms": total or None when the trace
    holds none, "by_cat": {category: [events, ms]}, "top_kernels":
    [[name, launches, ms], ...]}`` (the ``top`` kernels by summed time,
    summed by full name; names cut to 90 characters only when listed)."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    by_cat: dict = {}
    by_kernel: dict = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            n, ms = by_cat.get(e["cat"], (0, 0.0))
            by_cat[e["cat"]] = (n + 1, ms + e.get("dur", 0) / 1e3)
        if e.get("cat") == "kernel":
            n, ms = by_kernel.get(e.get("name", "?"), (0, 0.0))
            by_kernel[e.get("name", "?")] = (n + 1, ms + e.get("dur", 0) / 1e3)
    total = sum(ms for _, ms in by_cat.values())
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return {"ms": total if by_cat else None, "by_cat": by_cat,
            "top_kernels": [[name[:90], n, round(ms, 4)] for name, (n, ms) in ranked]}


def run_cli(cli, argv: list[str]) -> tuple[int, dict | None]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def write_corpus_dir(synthetic, manifest_mod, root: Path, docs) -> Path:
    paths = synthetic.write_corpus(root / "docs", docs)
    list_path = root / "list.txt"
    manifest_mod.write_manifest(list_path, paths)
    return list_path


def drive_path(torch, K, formatter, run, out_dir: Path, label: str,
               trace: Path | None = None) -> tuple[dict, dict]:
    """One counted run of a path: ``run()`` returns the build's stats;
    the launch counts are set to 0 just before and read just after.
    With ``trace``, the run is recorded by torch.profiler (device
    activity only) and its device-busy time summed from the trace."""
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    profiler = None
    t0 = time.perf_counter()
    if trace is not None:
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.start()
    t1 = time.perf_counter()
    stats = run()
    t2 = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    t3 = time.perf_counter()
    launches = {"unique_mask_count": K.unique_mask_count.launches,
                "bucket_histogram": K.bucket_histogram.launches}
    check(stats is not None, f"{label}: no stats")
    stats["md5"] = formatter.letters_md5(out_dir)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    stats["wall_ms"] = (t2 - t1) * 1e3
    if profiler is not None:
        stats["profiler_start_stop_ms"] = ((t1 - t0) + (t3 - t2)) * 1e3
        profiler.export_chrome_trace(str(trace))
        busy = device_busy(trace)
        stats["device_busy_ms"], stats["device_busy_by_cat"] = busy["ms"], busy["by_cat"]
        stats["device_top_kernels"] = busy["top_kernels"]
    return stats, launches


def cli_run(cli, label: str, list_path: Path, out_dir: Path, extra: list[str]):
    """A ``run`` for :func:`drive_path`: the CLI with ``--stats``."""

    def run():
        rc, stats = run_cli(cli, ["4", "26", str(list_path), "--stats",
                                  "--output-dir", str(out_dir), *extra])
        check(rc == 0, f"{label}: CLI exit {rc}")
        return stats

    return run


def check_pipelined(stats: dict, label: str) -> None:
    check("tokenize_feed" in stats["phases_ms"] and "finalize_vocab" in stats["phases_ms"]
          and stats.get("upload_windows", 0) >= 1,
          f"{label} did not take the pipelined plan: phases {sorted(stats['phases_ms'])}")


def check_device_tokenize(stats: dict, label: str) -> None:
    check("host_views" in stats["phases_ms"] and "device_tokenize_fallback" not in stats,
          f"{label} did not stay on the all-device plan: phases {sorted(stats['phases_ms'])}, "
          f"fallback {stats.get('device_tokenize_fallback')}")


def print_path(name: str, stats: dict, launches: dict, **extra) -> None:
    fields = {k: stats.get(k) for k in (
        "tokens", "unique_pairs", "unique_terms", "engine", "host_threads", "upload_windows",
        "window_modes", "window_plan_bytes", "window_read_ms", "window_wait_ms",
        "window_scan_ms", "pipelined_fallback", "letter_imbalance", "bucket_imbalance",
        "device_tokenize_width", "sort_cols", "fetched_bytes", "device_tokenize_fallback",
        "stream_windows", "accumulator_mode", "accumulator_capacity", "vocab_curve",
        "unique_rows_curve", "resumed_from_window", "checkpoint_saves", "checkpoint_ms",
        "checkpoint_ms_per_save", "checkpoint_skips", "overlap_tail_fraction", "device_pairs",
        "device_shards", "dist_fetched_bytes", "dist_valid_pairs", "emit_ownership",
        "letter_owners", "exchange_retries", "exchange_capacity", "merge_retries",
        "accumulator_capacity_per_owner")
        if k in stats}
    print(f"phase {name}: {json.dumps(fields)} md5={stats['md5']} launches={launches} "
          + " ".join(f"{k}={v}" for k, v in extra.items())
          + f" wall_ms={stats['wall_ms']:.3f} total_ms={stats['total_ms']} "
          f"phases_ms={json.dumps(stats['phases_ms'])} "
          f"max_memory_allocated={stats['max_memory_allocated']}", flush=True)
    if "device_busy_ms" in stats:
        busy = stats["device_busy_ms"]
        print(f"phase {name}_device: wall_ms={stats['wall_ms']:.3f} "
              f"profiler_start_stop_ms={stats['profiler_start_stop_ms']:.3f} device_busy_ms="
              + (f"{busy:.3f} idle_share={1 - busy / stats['wall_ms']:.6f}"
                 if busy is not None else "not measured (no device events in the trace)")
              + f" by_category={json.dumps(stats['device_busy_by_cat'])}"
              + f" top_kernels={json.dumps(stats['device_top_kernels'])}", flush=True)


SERVE_BATCHES = (1, 32, 1024, 8192)
CPU_POSTINGS_LANES = 1024  # lanes of a batch whose postings the CPU engine also answers
CPU_POSTINGS_LANES_8192 = 256  # at batch 8192 (about 3.5 M of its 110 M postings)
PLANNERS = ("exhaustive", "bmw", "maxscore")


def timed(torch, fn, device: str, iters: int = 20, repeats: int = 5) -> dict:
    """One call to warm up, then ``repeats`` means of ``iters`` calls, by
    CUDA events (on the card) and by the host clock: the medians in ms."""
    fn()
    ev, host = [], []
    for _ in range(repeats):
        if device == "cuda":
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if device == "cuda":
            end.record()
            torch.cuda.synchronize()
            ev.append(start.elapsed_time(end) / iters)
        host.append((time.perf_counter() - t0) * 1e3 / iters)
    ev.sort()
    host.sort()
    return {"event_ms": ev[len(ev) // 2] if ev else None, "host_ms": host[len(host) // 2]}


def timed_each(fn, args: list, before=None) -> dict:
    """One call of ``fn`` per argument, ``before()`` (untimed) ahead of
    each: the median in ms by the host clock."""
    host = []
    for a in args:
        if before is not None:
            before()
        t0 = time.perf_counter()
        fn(a)
        host.append((time.perf_counter() - t0) * 1e3)
    host.sort()
    return {"event_ms": None, "host_ms": host[len(host) // 2]}


class ServeReference:
    """The plain numpy answers of one artifact, from the port reader's
    ``decode_postings`` / ``decode_tf`` (memoized per term), a term ->
    index dict, set algebra and float64 BM25 (the JAX engine's formula)."""

    K1, B = 1.2, 0.75

    def __init__(self, art, TA):
        import numpy as np

        self.np, self.art = np, art
        _, terms, _ = TA.term_table(art)
        self.index = {t: i for i, t in enumerate(terms.tolist())}
        self.doc_lens, self.ndocs, self.avgdl = TA.bm25_corpus(art)
        self._posts: dict = {}

    def postings(self, i: int):
        p = self._posts.get(i)
        if p is None:
            p = self._posts[i] = (self.art.decode_postings(i), self.art.decode_tf(i))
        return p

    def lookup(self, encoded: bytes):
        return self.index.get(encoded) if encoded else None

    def bm25(self, ids: list[int], k: int) -> list[tuple[int, float]]:
        np = self.np
        scores = np.zeros(len(self.doc_lens), dtype=np.float64)
        for i in ids:
            docs, tf = self.postings(i)
            tf = tf.astype(np.float64)
            df = len(docs)
            idf = np.log(1.0 + (self.ndocs - df + 0.5) / (df + 0.5))
            denom = tf + self.K1 * (1.0 - self.B + self.B * self.doc_lens[docs] / self.avgdl)
            scores[docs] += idf * tf * (self.K1 + 1.0) / denom
        hit = np.nonzero(scores > 0)[0]
        order = hit[np.lexsort((hit, -scores[hit]))][:k]
        return [(int(d), float(scores[d])) for d in order]


def zipf_terms(np, rng, ranked: list[bytes], n: int, alpha: float = 1.2) -> list[str]:
    """``n`` query words drawn by Zipf weight over the df-ranked
    vocabulary, with absent words, non-alpha words and words longer than
    the vocabulary width mixed in."""
    p = np.arange(1, len(ranked) + 1, dtype=np.float64) ** -alpha
    picks = rng.choice(len(ranked), size=n, p=p / p.sum())
    junk = ["qqqqzzzzj", "zzxqv", "x1y2", "don't", "Café", "abcdefghijklmnop", ""]
    kinds = rng.random(n)
    return [junk[int(k * 1000) % len(junk)] if k < 0.06 else ranked[i].decode()
            for i, k in zip(picks.tolist(), kinds.tolist())]


def check_bm25(got, want, rel: float, label: str) -> None:
    check([d for d, _ in got] == [d for d, _ in want], f"{label}: docs {got} != {want}")
    for (_, g), (_, w) in zip(got, want):
        check(abs(g - w) <= rel * abs(w), f"{label}: score {g} vs {w} beyond rel {rel}")


def check_bm25_ties(got, want, rel: float, label: str) -> None:
    """:func:`check_bm25` where scores may tie within ``rel``: the card's
    float32 cannot order documents whose float64 scores differ by less
    (on the host build's artifact, words in every document add an idf
    of about 2.5e-5 each, so real tf spreads such scores by 1e-8).  The
    scores agree position by position, each document both return agrees,
    and every document scoring above the last one's tie band is there."""
    check(len(got) == len(want), f"{label}: {len(got)} docs != {len(want)}")
    for (_, g), (_, w) in zip(got, want):
        check(abs(g - w) <= rel * abs(w), f"{label}: score {g} vs {w} beyond rel {rel}")
    mine = dict(got)
    for d, w in want:
        if d in mine:
            check(abs(mine[d] - w) <= rel * abs(w), f"{label}: doc {d} {mine[d]} vs {w}")
        else:
            check(w <= want[-1][1] * (1 + rel), f"{label}: doc {d} ({w}) missing: {got}")


def serve_format(torch, TA, DeviceEngine, path: Path, fmt: int, device: str, card: str,
                 seed: int, trace: Path | None) -> dict:
    """Path H on one artifact: load the engine on ``device`` (and on the
    CPU, the plain version), answer df/postings at each batch, AND/OR
    over 2, 3 and 5 words, top_k for three letters and BM25 under each
    planner; hold every answer against the numpy reference and the CPU
    engine (at batch 8192, the CPU engine answers the first 256 lanes),
    BM25 run twice on ``device`` bit-equal; then
    time each op and batch, and trace one batch-8192 postings call and
    one BM25 call."""
    import numpy as np

    rng = np.random.default_rng(seed)
    art = TA.load_artifact(path)
    ref = ServeReference(art, TA)
    check(art.version == fmt, f"path H v{fmt}: artifact version {art.version}")
    ranked = [art.term(int(i)) for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = DeviceEngine(path, device=device)
    load_ms = (time.perf_counter() - t0) * 1e3
    column_bytes = eng.column_bytes
    cpu = DeviceEngine(path, device="cpu")
    out = {"format": fmt, "artifact_bytes": art.nbytes, "column_bytes": column_bytes,
           "load_ms": load_ms, "tiers": eng.describe()["device"]["tiers"]}
    batches = {}
    for n in SERVE_BATCHES:
        words = zipf_terms(np, rng, ranked, n)
        b = eng.encode_batch(words)
        batches[n] = b
        dfs, posts = eng.df(b), eng.postings(b)
        cdfs = cpu.df(b)
        check(dfs.tolist() == cdfs.tolist(), f"path H v{fmt} df@{n} != cpu engine")
        # lanes are independent: at 8192 the CPU engine answers the
        # first lanes only (the whole batch is about 110 M postings)
        cposts = cpu.postings(b[:CPU_POSTINGS_LANES if n < 8192 else CPU_POSTINGS_LANES_8192])
        total = 0
        for j, enc in enumerate(b.tolist()):
            i = ref.lookup(enc)
            want_df = 0 if i is None else int(art.df[i])
            check(int(dfs[j]) == want_df, f"path H v{fmt} df@{n} lane {j}: {dfs[j]} != {want_df}")
            if i is None:
                check(posts[j] is None, f"path H v{fmt} postings@{n} lane {j} not None")
                continue
            want = ref.postings(i)[0]
            total += len(want)
            check(np.array_equal(posts[j], want), f"path H v{fmt} postings@{n} lane {j} != numpy")
            if j < len(cposts):
                check(np.array_equal(posts[j], cposts[j]), f"path H v{fmt} postings@{n} != cpu")
        out[f"postings_total@{n}"] = total
    queries = {}
    for arity in (2, 3, 5):
        qs = []
        while len(qs) < 5:
            q = list(dict.fromkeys(zipf_terms(np, rng, ranked, arity * 3)))
            q = [w for w in q if ref.lookup(eng.encode_batch([w]).tolist()[0]) is not None]
            if len(q) >= arity:
                qs.append(q[:arity])
        queries[arity] = qs
        for q in qs:
            b = eng.encode_batch(q)
            ids = [ref.lookup(x) for x in b.tolist()]
            sets = [ref.postings(i)[0] for i in ids]
            want_and, want_or = sets[0], sets[0]
            for s in sets[1:]:
                want_and, want_or = np.intersect1d(want_and, s), np.union1d(want_or, s)
            got_and, got_or = eng.query_and(b), eng.query_or(b)
            check(np.array_equal(got_and, want_and) and np.array_equal(got_and, cpu.query_and(b)),
                  f"path H v{fmt} AND {q}")
            check(np.array_equal(got_or, want_or) and np.array_equal(got_or, cpu.query_or(b)),
                  f"path H v{fmt} OR {q}")
    for letter in ("a", "m", "z"):
        li = ord(letter) - 97
        lo = int(art.letter_dir[li])
        want = [(art.term(int(i)), int(art.df[i])) for i in art.df_order[lo:lo + 10]]
        got = eng.top_k(letter, 10)
        check(got == want == cpu.top_k(letter, 10), f"path H v{fmt} top_k {letter}")
    saved = os.environ.get("MRI_SERVE_PLANNER")
    try:
        for planner in PLANNERS:
            os.environ["MRI_SERVE_PLANNER"] = planner
            for arity in (2, 3, 5):
                for q in queries[arity]:
                    b = eng.encode_batch(q)
                    got = eng.top_k_scored(b, 10)
                    label = f"path H v{fmt} bm25 {planner} {q}"
                    check(len(got) == 10, f"{label}: {len(got)} docs")
                    check_bm25(got, ref.bm25([ref.lookup(x) for x in b.tolist()], 10), 1e-4,
                               label + " vs numpy")
                    check_bm25(got, cpu.top_k_scored(b, 10), 1e-5, label + " vs cpu engine")
                    again = eng.top_k_scored(b, 10)
                    check([(d, np.float32(s).tobytes()) for d, s in again]
                          == [(d, np.float32(s).tobytes()) for d, s in got],
                          f"{label}: not bit-equal from run to run")
            out[f"planner_{planner}"] = eng.planner.describe()["ranked"]
        cpu.close()
        out["checks_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # -- times: per op and batch, the device engine alone -------------
        times = {}
        # v2.1, the default format, at full depth; v1 and v2 at 3 calls
        depth = {} if fmt == 3 else {"iters": 3, "repeats": 1}
        for n, b in batches.items():
            for op in ("df", "postings"):
                t = timed(torch, lambda op=op, b=b: getattr(eng, op)(b), device, **depth)
                t["lookups_per_s"] = n / (t["host_ms"] / 1e3)
                times[f"{op}@{n}"] = t
        for arity in (2, 3, 5):
            b = eng.encode_batch(queries[arity][0])
            times[f"and@{arity}"] = timed(torch, lambda b=b: eng.query_and(b), device, **depth)
            times[f"or@{arity}"] = timed(torch, lambda b=b: eng.query_or(b), device, **depth)
        times["top_k@10"] = timed(torch, lambda: eng.top_k("m", 10), device, **depth)
        b3 = eng.encode_batch(queries[3][0])
        for planner in PLANNERS:
            os.environ["MRI_SERVE_PLANNER"] = planner
            times[f"bm25_{planner}@3"] = timed(torch, lambda: eng.top_k_scored(b3, 10), device,
                                               **depth)
        os.environ["MRI_SERVE_PLANNER"] = "exhaustive"
        if trace is not None and device == "cuda":
            profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            profiler.start()
            t1 = time.perf_counter()
            eng.postings(batches[8192])
            eng.top_k_scored(b3, 10)
            wall_ms = (time.perf_counter() - t1) * 1e3
            profiler.stop()
            profiler.export_chrome_trace(str(trace))
            busy = device_busy(trace)
            out["trace"] = {"wall_ms": wall_ms, "device_busy_ms": busy["ms"],
                            "idle_share": (1 - busy["ms"] / wall_ms) if busy["ms"] else None,
                            "by_cat": busy["by_cat"], "top_kernels": busy["top_kernels"]}
    finally:
        if saved is None:
            os.environ.pop("MRI_SERVE_PLANNER", None)
        else:
            os.environ["MRI_SERVE_PLANNER"] = saved
    if device == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["times"] = times
    out["timing_s"] = time.perf_counter() - t0
    out["batches"], out["queries"] = batches, queries  # Path I asks the same
    eng.close()
    art.close()
    print(f"phase path_h_v{fmt}: card={card} artifact_bytes={out['artifact_bytes']} "
          f"column_bytes={column_bytes} load_ms={load_ms:.3f} checks_s={out['checks_s']:.1f} "
          f"timing_s={out['timing_s']:.1f} "
          f"peak_memory_bytes={out.get('peak_memory_bytes')} tiers={out['tiers']} "
          + " ".join(f"postings_total@{n}={out[f'postings_total@{n}']}" for n in SERVE_BATCHES)
          + f" planners={json.dumps({p: out[f'planner_{p}'] for p in PLANNERS})}", flush=True)
    for name, t in times.items():
        extra = (f" lookups_per_s={t['lookups_per_s']:.1f}" if "lookups_per_s" in t else "")
        ev = f"{t['event_ms']:.4f}" if t["event_ms"] is not None else "not measured"
        print(f"phase path_h_v{fmt}_time: card={card} op={name} event_ms={ev} "
              f"host_ms={t['host_ms']:.4f}{extra}", flush=True)
    if "trace" in out:
        tr = out["trace"]
        print(f"phase path_h_v{fmt}_device: card={card} postings@8192+bm25 wall_ms="
              f"{tr['wall_ms']:.3f} device_busy_ms={tr['device_busy_ms']} "
              f"idle_share={tr['idle_share']} by_category={json.dumps(tr['by_cat'])} "
              f"top_kernels={json.dumps(tr['top_kernels'])}", flush=True)
    return out


def decode_all(np, art):
    """Every posting of a v2/v2.1 artifact, in lex term order, by one
    vectorized numpy pass over all blocks (a reference independent of
    the engine: two-word bit windows, then a per-block cumsum)."""
    cnt = art.blk_cnt.astype(np.int64)
    blk = np.repeat(np.arange(len(cnt)), cnt)
    starts = np.cumsum(cnt) - cnt
    j = np.arange(int(cnt.sum())) - starts[blk]
    w = art.blk_width.astype(np.int64)[blk]
    bit = art.blk_woff[:-1][blk] * 32 + np.maximum(j - 1, 0) * w
    words = np.concatenate([art.post_words, np.zeros(2, np.uint32)]).astype(np.uint64)
    word = bit >> 5
    pair = words[word] | (words[word + 1] << np.uint64(32))
    mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
    delta = ((pair >> (bit & 31).astype(np.uint64)) & mask).astype(np.int64) + 1
    vals = np.where(j == 0, art.blk_first[blk].astype(np.int64), delta)
    c = np.cumsum(vals)
    return (c - (c[starts] - vals[starts])[blk]).astype(np.int32)


def path_h(torch, K, cli, formatter, list_b: Path, tmp: Path, md5_b: str, card: str,
           device: str = "cuda") -> tuple[dict, dict, dict]:
    """Path H — serving on Path B's corpus: the default build with
    ``--artifact`` (v2.1), its ``index.mri`` byte-equal to the same build
    on the CPU, v1 and v2 written from the same arrays, then each format
    served by :func:`serve_format`.  Returns what each format served, the
    launches and the artifacts' paths by format."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine, artifact as TA)

    t0 = time.perf_counter()
    stats, launches = drive_path(
        torch, K, formatter, cli_run(cli, "path H", list_b, tmp / "H_out",
                                     ["--artifact", "--device", device]),
        tmp / "H_out", "path H")
    check_pipelined(stats, "path H")
    check(stats["md5"] == md5_b, f"path H md5 {stats['md5']} != path B {md5_b}")
    rc, stats_cpu = run_cli(cli, ["4", "26", str(list_b), "--artifact", "--device", "cpu",
                                  "--output-dir", str(tmp / "H_cpu"), "--stats"])
    check(rc == 0, f"path H --device cpu: exit {rc}")
    main_bytes = (tmp / "H_out" / "index.mri").read_bytes()
    check(main_bytes == (tmp / "H_cpu" / "index.mri").read_bytes(),
          "path H: index.mri differs from the --device cpu build's")
    paths = {3: tmp / "H_out" / "index.mri"}
    sizes = {3: len(main_bytes)}
    build_ms = {3: stats["artifact_build_ms"]}
    # v1 and v2 by the port's writer from the same arrays the build
    # packed: the v2.1 file decoded whole (numpy), then the emit-shaped
    # arrays through build_from_emit_arrays, as a MRI_SERVE_FORMAT=1|2
    # build would call it (each further build would re-read the corpus)
    import numpy as np

    with TA.load_artifact(paths[3]) as v21:
        emit = {"vocab": TA.term_table(v21)[1], "order": np.array(v21.df_order),
                "df": np.array(v21.df), "postings": decode_all(np, v21),
                "max_doc_id": v21.max_doc_id}
        emit["offsets"] = np.cumsum(emit["df"], dtype=np.int64) - emit["df"]
        saved = os.environ.get("MRI_SERVE_FORMAT")
        try:
            for fmt in (1, 2):
                os.environ["MRI_SERVE_FORMAT"] = str(fmt)
                paths[fmt] = tmp / f"H_v{fmt}.mri"
                t1 = time.perf_counter()
                sizes[fmt] = TA.build_from_emit_arrays(paths[fmt], **emit)
                build_ms[fmt] = (time.perf_counter() - t1) * 1e3
        finally:
            if saved is None:
                os.environ.pop("MRI_SERVE_FORMAT", None)
            else:
                os.environ["MRI_SERVE_FORMAT"] = saved
        with TA.load_artifact(paths[2]) as v2, TA.load_artifact(paths[1]) as v1:
            # v2 packs the same blocks; v1 holds the same runs
            for name in ("blk_first", "blk_max", "blk_width", "post_words", "doc_lens"):
                check(np.array_equal(getattr(v2, name), getattr(v21, name)),
                      f"path H: v2 {name} differs from v2.1's")
            check(np.array_equal(np.cumsum(v1.postings.astype(np.int64))
                                 - np.repeat(np.cumsum(v1.postings.astype(np.int64))[
                                     v1.post_offsets[:-1]] - v1.postings[v1.post_offsets[:-1]],
                                             np.diff(v1.post_offsets)), emit["postings"]),
                  "path H: v1 postings differ from v2.1's")
    print_path("path_h", stats, launches, path_b_md5=md5_b,
               cpu_phases_ms=json.dumps(stats_cpu["phases_ms"]))
    print(f"phase path_h_build: card={card} artifact_bytes={json.dumps(sizes)} "
          f"artifact_build_ms={json.dumps(build_ms)} "
          f"build_s={time.perf_counter() - t0:.1f}", flush=True)
    served = {fmt: serve_format(torch, TA, DeviceEngine, paths[fmt], fmt, device, card,
                                seed=17 + fmt, trace=tmp / f"H_v{fmt}_trace.json")
              for fmt in (3, 2, 1)}
    # the whole path's launches: the counts were set to 0 before its build
    launches = {"unique_mask_count": K.unique_mask_count.launches,
                "bucket_histogram": K.bucket_histogram.launches}
    print(f"phase path_h_done: card={card} seconds={time.perf_counter() - t0:.1f} "
          f"launches={launches}", flush=True)
    return served, launches, paths


@contextlib.contextmanager
def env(**values):
    """Set (a str) or unset (None) environment variables for a block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bm25_bits(pairs) -> list:
    return [(d, struct.pack("<d", s)) for d, s in pairs]


def same_postings(np, a, b) -> bool:
    return len(a) == len(b) and all(
        (x is None and y is None) or (x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a, b))


def device_op_calls(eng) -> int:
    dev = eng.device_engine
    return 0 if dev is None else sum(v["calls"] for v in dev.op_stats().values())


def serve_host_format(torch, S, path: Path, fmt: int, served: dict, card: str,
                      device: str) -> dict:
    """Path I on one artifact: the host ``Engine`` (native kernels
    required on v2/v2.1, numpy on v1), the ``DeviceEngine`` on ``device``
    and a fresh ``AutoEngine`` on ``device`` answer Path H's query sets
    alike; the auto engine's first batch of 8192 runs the probe; then the
    host engine's times."""
    import numpy as np

    native = fmt >= 2
    t0 = time.perf_counter()
    with env(MRI_SERVE_NATIVE="1" if native else "0", MRI_SERVE_CROSSOVER=None):
        host = S.Engine(path)
        auto = S.AutoEngine(path, device=device)
    with env(MRI_SERVE_NATIVE="0"):
        numpy_host = S.Engine(path) if native else host
    dev = S.DeviceEngine(path, device=device)
    label = f"path I v{fmt}"
    out = {"format": fmt}
    try:
        for n, b in served["batches"].items():
            dfs = host.df(b)
            check(dfs.tolist() == dev.df(b).tolist() == auto.df(b).tolist(),
                  f"{label} df@{n} differs across engines")
            if n >= 8192:
                out["probe"] = auto.describe()["auto"]["probe"]
                check(out["probe"] is not None and out["probe"]["batch"] == n,
                      f"{label}: the first batch of {n} ran no probe")
            hi, hf = host.lookup(b)
            for other in (dev, auto):
                oi, of = other.lookup(b)
                check(of.tolist() == hf.tolist() and oi[of].tolist() == hi[hf].tolist(),
                      f"{label} lookup@{n} differs")
            posts = host.postings(b)
            check(same_postings(np, posts, dev.postings(b)), f"{label} postings@{n} != device")
            check(same_postings(np, posts, auto.postings(b)), f"{label} postings@{n} != auto")
        if out.get("probe", {}).get("winner") == "host":
            check(auto.describe()["auto"]["crossover"] == 1 << 62,
                  f"{label}: the host won the probe but the crossover moved")
        for arity, qs in served["queries"].items():
            for q in qs:
                b = host.encode_batch(q)
                for op in ("query_and", "query_or"):
                    got = getattr(host, op)(b)
                    check(np.array_equal(got, getattr(dev, op)(b))
                          and np.array_equal(got, getattr(auto, op)(b)),
                          f"{label} {op} {q} differs across engines")
        for letter in ("a", "m", "z"):
            check(host.top_k(letter, 10) == dev.top_k(letter, 10) == auto.top_k(letter, 10),
                  f"{label} top_k {letter} differs across engines")
        for planner in PLANNERS:
            with env(MRI_SERVE_PLANNER=planner):
                for arity, qs in served["queries"].items():
                    for q in qs:
                        b = host.encode_batch(q)
                        got = host.top_k_scored(b, 10)
                        ql = f"{label} bm25 {planner} {q}"
                        check(len(got) == 10, f"{ql}: {len(got)} docs")
                        check(bm25_bits(auto.top_k_scored(b, 10)) == bm25_bits(got),
                              f"{ql}: auto != host")
                        check(bm25_bits(numpy_host.top_k_scored(b, 10)) == bm25_bits(got),
                              f"{ql}: native != numpy")
                        check_bm25(dev.top_k_scored(b, 10), got, 1e-4, f"{ql}: device vs host")
                        encs = [b, host.encode_batch(q[:2])]
                        check(host.top_k_scored_batch(encs, 10)
                              == [got, host.top_k_scored(encs[1], 10)],
                              f"{ql}: the coalesced batch != serial")
        nat = host.describe()["native"]
        out["native"] = nat
        if native:
            check(nat["active"] and nat["fallbacks"] == 0 and nat["ops"] > 0,
                  f"{label}: native block {nat}")
        out["checks_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()

        # -- host times, per op and batch (host clock) -----------------
        times = {}
        for n, b in served["batches"].items():
            big = n >= 8192
            for op in ("df", "postings"):
                t = timed(torch, lambda op=op, b=b: getattr(host, op)(b), "cpu",
                          iters=3 if big else 20, repeats=3 if big else 5)
                t["lookups_per_s"] = n / (t["host_ms"] / 1e3)
                times[f"{op}@{n}"] = t
        # the loop above repeats one batch, so after its warm-up every
        # postings call is an LRU hit; here each call gets a fresh Zipf
        # batch (the LRU keeps what earlier batches left), or the same
        # batch with the LRU purged first (every term decoded)
        art = host.artifact
        ranked = [art.term(int(i))
                  for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
        rng = np.random.default_rng(1000 + fmt)
        for n, b in served["batches"].items():
            calls = 3 if n >= 8192 else 10
            fresh = [host.encode_batch(zipf_terms(np, rng, ranked, n))
                     for _ in range(calls + 1)]
            host.postings(fresh[0])
            for kind, t in (
                    ("fresh", timed_each(host.postings, fresh[1:])),
                    ("cold", timed_each(host.postings, [b] * calls,
                                        before=host.cache.purge))):
                t["lookups_per_s"] = n / (t["host_ms"] / 1e3)
                times[f"postings_{kind}@{n}"] = t
        # the router's own postings leg at 8192, on the probe's winner
        t = timed(torch, lambda: auto.postings(served["batches"][8192]), "cpu",
                  iters=3, repeats=3)
        t["engine"] = "auto:" + str((out.get("probe") or {}).get("winner"))
        times["auto_postings@8192"] = t
        for arity, qs in served["queries"].items():
            b = host.encode_batch(qs[0])
            times[f"and@{arity}"] = timed(torch, lambda b=b: host.query_and(b), "cpu")
            times[f"or@{arity}"] = timed(torch, lambda b=b: host.query_or(b), "cpu")
        times["top_k@10"] = timed(torch, lambda: host.top_k("m", 10), "cpu")
        b3 = host.encode_batch(served["queries"][3][0])
        backends = {"native": host, "numpy": numpy_host} if native else {"numpy": host}
        for planner in PLANNERS:
            with env(MRI_SERVE_PLANNER=planner):
                for name, eng in backends.items():
                    times[f"bm25_{planner}_{name}@3"] = timed(
                        torch, lambda eng=eng: eng.top_k_scored(b3, 10), "cpu")
        out["times"] = times
        out["timing_s"] = time.perf_counter() - t1
    finally:
        for eng in (auto, dev, host, numpy_host):
            eng.close()
    probe = out.get("probe") or {}
    print(f"phase path_i_v{fmt}: card={card} checks_s={out['checks_s']:.1f} "
          f"timing_s={out['timing_s']:.1f} native={json.dumps(out['native'])} "
          f"probe_batch={probe.get('batch')} host_s={probe.get('host_s')} "
          f"device_s={probe.get('device_s')} winner={probe.get('winner')}", flush=True)
    for name, t in times.items():
        extra = f" lookups_per_s={t['lookups_per_s']:.1f}" if "lookups_per_s" in t else ""
        print(f"phase path_i_v{fmt}_time: card={card} engine={t.get('engine', 'host')} "
              f"op={name} "
              f"host_ms={t['host_ms']:.4f}{extra}", flush=True)
    return out


def path_i(torch, cli, paths: dict, served: dict, card: str, device: str = "cuda") -> dict:
    """Path I — the host engine, its native serve kernels and the
    crossover router on Path H's artifacts (no build): per format
    :func:`serve_host_format`; then the router's crossover knob on v2.1
    (1: every batch to the card, answers unchanged; 0: the card never
    built), and ``query --engine host|device|auto`` printing the same
    bytes on v2.1."""
    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import serve as S

    t0 = time.perf_counter()
    out = {fmt: serve_host_format(torch, S, paths[fmt], fmt, served[fmt], card, device)
           for fmt in (3, 2, 1)}
    v21 = paths[3]
    batches = served[3]["batches"]
    with S.Engine(v21) as host:
        with env(MRI_SERVE_CROSSOVER="1"), S.AutoEngine(v21, device=device) as auto:
            for n in (1, 32, 1024):
                b = batches[n]
                before = device_op_calls(auto)
                check(auto.df(b).tolist() == host.df(b).tolist()
                      and same_postings(np, auto.postings(b), host.postings(b)),
                      f"path I crossover 1: answers @{n} moved")
                check(device_op_calls(auto) == before + 2,
                      f"path I crossover 1: batch {n} did not go to the card")
            check(auto.describe()["auto"]["crossover"] == 1, "path I crossover 1 not read")
        with env(MRI_SERVE_CROSSOVER="0"), S.AutoEngine(v21, device=device) as auto:
            check(auto.df(batches[8192]).tolist() == host.df(batches[8192]).tolist(),
                  "path I crossover 0: df@8192 moved")
            d = auto.describe()["auto"]
            check(not d["device_ready"] and d["probe"] is None,
                  f"path I crossover 0 built the device engine: {d}")
    words = [w.decode() for w in batches[32].tolist() if w][:12] + ["nope", "x1y2"]
    legs = {"df+postings": [], "and": ["--op", "and"], "or": ["--op", "or"],
            "top_k": ["--top-k", "10", "--letter", "m"]}
    for leg, extra in legs.items():
        got = {}
        for engine in ("host", "device", "auto"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["query", str(v21), "--engine", engine, "--device", device,
                               *words, *extra])
            check(rc == 0, f"path I query --engine {engine} {leg}: exit {rc}")
            got[engine] = buf.getvalue()
        check(got["host"] and got["host"] == got["device"] == got["auto"],
              f"path I query {leg}: stdout differs across --engine host|device|auto")
    print(f"phase path_i_done: card={card} seconds={time.perf_counter() - t0:.1f} "
          f"cli_legs={list(legs)} crossover_knob=ok", flush=True)
    return out


# Path J: the multi-shard builds, each a --device-shards 4 CLI build on
# Path B's corpus: (label, extra CLI args, stat checks)
MESH_LEGS = (
    ("J1", ["--artifact"], {"upload_windows": 2}),
    ("J2", ["--emit-ownership", "letter"], {"letter_owners": 4, "emit_ownership": "letter"}),
    ("J3", ["--pipeline-chunk-docs", "0", "--skew"], {"engine": "dist"}),
    ("J4", ["--stream-chunk-docs", "5000"], {"stream_windows": 4}),
    ("J5", ["--device-tokenize"], {"sort_cols": 3}),
    ("J6", ["--device-tokenize", "--emit-ownership", "letter"],
     {"letter_owners": 4, "emit_ownership": "letter"}),
    ("J7", ["--device-tokenize", "--stream-chunk-docs", "2500"], {"stream_windows": 8}),
)


def path_j(torch, K, cli, formatter, list_b: Path, tmp: Path, md5_c: str, h_artifact: Path,
           card: str, device: str = "cuda") -> dict:
    """Path J — the multi-shard builds on the card: the seven legs of
    :data:`MESH_LEGS`, each with 4 logical shards on the one card, its
    letter-file md5 equal to Path C's (J1's ``index.mri`` byte-equal to
    Path H's v2.1 artifact), recorded by torch.profiler.  Returns the
    launches by leg."""
    launches_by_leg = {}
    t0 = time.perf_counter()
    for label, extra, want in MESH_LEGS:
        out = tmp / f"{label}_out"
        stats, launches = drive_path(
            torch, K, formatter,
            cli_run(cli, f"path {label}", list_b, out,
                    ["--device-shards", "4", "--device", device, *extra]),
            out, f"path {label}", trace=tmp / f"{label}_trace.json")
        check(stats.get("device_shards") == 4,
              f"path {label}: device_shards {stats.get('device_shards')}, want 4")
        for key, value in want.items():
            check(stats.get(key) == value, f"path {label}: {key} {stats.get(key)}, want {value}")
        check("device_tokenize_fallback" not in stats and "pipelined_fallback" not in stats,
              f"path {label} restarted on another plan")
        check(stats["md5"] == md5_c, f"path {label} md5 {stats['md5']} != path C {md5_c}")
        if label == "J1":
            check((out / "index.mri").read_bytes() == h_artifact.read_bytes(),
                  "path J1: index.mri differs from Path H's v2.1 artifact")
        if label == "J3":
            check(launches["bucket_histogram"] == 2,
                  f"path J3 launched bucket_histogram {launches['bucket_histogram']} times, want 2")
        print_path(f"path_{label.lower()}", stats, launches, card=repr(card), path_c_md5=md5_c)
        busy = stats["device_busy_ms"]
        print(f"phase path_{label.lower()}_summary: " + json.dumps({
            "card": card, "total_ms": stats["total_ms"], "phases_ms": stats["phases_ms"],
            **{k: stats.get(k) for k in ("device_shards", "dist_fetched_bytes",
                                         "dist_valid_pairs")},
            "max_memory_allocated": stats["max_memory_allocated"], "device_busy_ms": busy,
            "idle_share": (1 - busy / stats["wall_ms"]) if busy is not None
            else "not measured (no device events in the trace)"}), flush=True)
        launches_by_leg[label] = launches
    print(f"phase path_j_done: card={card} seconds={time.perf_counter() - t0:.1f}", flush=True)
    return launches_by_leg


def path_j_exchange(torch, c_pairs: int, c_vocab: int, max_doc: int, card: str) -> dict:
    """The mesh exchange alone on the card: ``dist_sort_prov_windows``
    over two windows of ``c_pairs`` distinct provisional keys (Path C's
    pair count, vocabulary and stride; terms and docs uniform), at n =
    1, 2, 4 and 8 logical
    shards and capacity factors 2.0 and 0.25 (where the overflow retry
    must run), each result equal to ``sort_prov_chunks`` on one device.
    Times: CUDA events around the whole call (it ends in host reads) and
    the host clock, beside the single-device sort's warm event time."""
    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        engine as E)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
        dist_engine as DE, mesh as M)

    stride = max_doc + 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    draws = c_pairs + c_pairs // 8
    terms = torch.randint(0, c_vocab, (draws,), device="cuda", generator=gen, dtype=torch.int32)
    docs = torch.randint(1, max_doc + 1, (draws,), device="cuda", generator=gen,
                         dtype=torch.int32)
    keys = torch.unique(terms * stride + docs)  # distinct, as the combiner feeds them
    keys = keys[torch.randperm(keys.shape[0], device="cuda", generator=gen)[:c_pairs]]
    check(keys.shape[0] == c_pairs, f"exchange leg: only {keys.shape[0]} distinct keys")
    host_keys = keys.cpu().numpy()
    half = c_pairs // 2
    windows = []
    for part in (host_keys[:half], host_keys[half:]):
        buf = np.full(round_up(part.size, 1 << 14), INT32_MAX, np.int32)
        buf[: part.size] = part
        windows.append(buf)
    df = np.bincount(host_keys // stride, minlength=c_vocab).astype(np.int64)
    offsets = np.cumsum(df) - df
    one_dev = [torch.from_numpy(w).cuda() for w in windows]
    want = E.host_u16(E.sort_prov_chunks(one_dev, stride=stride, out_size=c_pairs).cpu().numpy())
    out = {"pairs": c_pairs, "single_device_sort_ms": cuda_ms(
        torch, lambda: E.sort_prov_chunks(one_dev, stride=stride, out_size=c_pairs), iters=10)[0]}
    exchanges = []
    real = DE._exchange_owned

    def counted(*a, **kw):
        exchanges.append(kw["capacity"])
        return real(*a, **kw)

    DE._exchange_owned = counted
    try:
        for n in (1, 2, 4, 8):
            mesh = M.make_mesh(n, "cuda")
            for factor in (2.0, 0.25):
                shards = [M.shard(w, mesh) for w in windows]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                runs = []
                for _ in range(3):  # the first is the warm-up
                    del exchanges[:]
                    stats = {}
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t = time.perf_counter()
                    start.record()
                    got = DE.dist_sort_prov_windows(
                        shards, stride=stride, mesh=mesh, offsets_prov=offsets,
                        num_pairs=c_pairs, capacity_factor=factor, stats=stats)
                    end.record()
                    torch.cuda.synchronize()
                    runs.append((start.elapsed_time(end), (time.perf_counter() - t) * 1e3))
                    check(np.array_equal(got, want),
                          f"exchange leg n={n} factor={factor}: postings differ from the "
                          "single-device sort")
                check(stats["dist_valid_pairs"] == c_pairs,
                      f"exchange leg n={n} factor={factor}: {stats['dist_valid_pairs']} pairs")
                retried = len(exchanges) == 2
                check(retried or n == 1 or factor == 2.0,
                      f"exchange leg n={n} factor={factor}: the overflow retry did not run")
                row = {"n": n, "factor": factor, "exchanges": len(exchanges),
                       "event_ms": [round(r[0], 4) for r in runs[1:]],
                       "host_ms": [round(r[1], 3) for r in runs[1:]],
                       "dist_fetched_bytes": stats["dist_fetched_bytes"],
                       "peak_bytes": torch.cuda.max_memory_allocated()}
                out[f"n{n}_f{factor}"] = row
                print(f"phase path_j_exchange: card={card} {json.dumps(row)}", flush=True)
                del shards
    finally:
        DE._exchange_owned = real
    print(f"phase path_j_exchange_single: card={card} pairs={c_pairs} "
          f"sort_prov_chunks_event_ms={out['single_device_sort_ms']:.4f}", flush=True)
    return out


# -- Path K: the build's resilience options on the card ---------------------

def start_child(argv: list[str], log: Path, **env_extra) -> subprocess.Popen:
    """The port's CLI in a child process (its output into ``log``)."""
    with open(log, "wb") as f:
        return subprocess.Popen([sys.executable, "-m", PKG, *argv], cwd=str(ROOT),
                                env={**os.environ, "PYTHONPATH": str(ROOT), **env_extra},
                                stdout=f, stderr=subprocess.STDOUT)


def wait_child(proc: subprocess.Popen, log: Path, label: str, timeout: float = 300) -> int:
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"{label}: child hung past {timeout} s: "
                           f"{log.read_text(errors='replace')[-2000:]}")


def md5_without_doc(formatter, out_dir: Path, doc_id: int) -> str:
    """md5 of the letter files in ``out_dir`` with ``doc_id`` taken out of
    every postings list — terms left with none dropped, each letter
    re-sorted by (df desc, word asc), the reference's order
    (main.c:55-64): the index of the same corpus without that document."""
    import hashlib

    h = hashlib.md5()
    needle = f" {doc_id} ".encode()
    for letter in range(26):
        rows = []
        for line in (out_dir / formatter.letter_filename(letter)).read_bytes().splitlines():
            word, ids = line[:-1].split(b":[", 1)
            padded = b" " + ids + b" "
            if needle in padded:
                ids = padded.replace(needle, b" ", 1).strip()
            if ids:
                rows.append((-(ids.count(b" ") + 1), word, ids))
        rows.sort()
        h.update(b"".join(w + b":[" + i + b"]\n" for _, w, i in rows))
    return h.hexdigest()


def verify_cli(cli, out_dir: Path) -> tuple[int, str]:
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = cli.main(["--verify", str(out_dir)])
    return rc, err.getvalue()


def path_k(torch, K, cli, formatter, faults, list_a: Path, list_b: Path, tmp: Path,
           stats_b: dict, md5_c: str, a_out: Path, card: str) -> dict:
    """Path K: the resilience and integrity options on Path B's corpus
    (the emit kill on Path A's, in two child processes beside K1).  The
    card's host reads files slowly while two processes read at once, so
    the child killed at stream window 5 runs alone.  Returns K1's resume
    launches."""
    import shutil
    import signal

    t0 = time.perf_counter()
    md5_b = stats_b["md5"]
    ndocs = int(list_b.read_text().split()[0])

    def build(label: str, list_path: Path, out: Path, extra: list[str], want_rc: int = 0):
        rc, stats = run_cli(cli, ["4", "26", str(list_path), "--stats",
                                  "--output-dir", str(out), *extra])
        check(rc == want_rc, f"{label}: CLI exit {rc}, want {want_rc}")
        if stats is not None:
            stats["md5"] = formatter.letters_md5(out)
        return stats

    # the emit kills read Path A's 355 files: they run beside K1
    ck_kill = tmp / "K3_kill.ckpt.npz"
    f_argv = ["--device-tokenize", "--stream-chunk-docs", "2500", "--stream-checkpoint-every",
              "2", "--resume", "auto"]
    children = {}
    for backend in ("native", "python"):
        children[f"K4_{backend}"] = start_child(
            ["4", "26", str(list_a), "--output-dir", str(tmp / f"K4_{backend}"),
             "--emit-backend", backend], tmp / f"K4_{backend}.log",
            MRI_EMIT_KILL_AFTER_LETTERS="7")
    try:
        # -- K1: the pairs checkpoint, saved then resumed ---------------------
        ck1 = tmp / "K1_pairs.npz"
        k1_argv = ["--skew", "--checkpoint", str(ck1)]
        s_save = build("path K1 save", list_b, tmp / "K1_save", k1_argv)
        check("checkpoint" in s_save["phases_ms"] and s_save["md5"] == md5_b,
              f"path K1 save: phases {sorted(s_save['phases_ms'])}, md5 {s_save['md5']}")
        s_res, launches = drive_path(torch, K, formatter,
                                     cli_run(cli, "path K1 resume", list_b, tmp / "K1_resume",
                                             k1_argv), tmp / "K1_resume", "path K1 resume")
        check(s_res.get("resumed_from") == str(ck1) and "resume" in s_res["phases_ms"]
              and not {"load", "tokenize"} & set(s_res["phases_ms"]),
              f"path K1 resume did not resume: phases {sorted(s_res['phases_ms'])}")
        check(launches == {"unique_mask_count": 1, "bucket_histogram": 2},
              f"path K1 resume launches {launches}, want Path B's 1 and 2")
        check((s_res["unique_pairs"], s_res["unique_terms"])
              == (stats_b["unique_pairs"], stats_b["unique_terms"]),
              "path K1 resume: the kernels' inputs differ from Path B's")
        check(s_res["md5"] == md5_b, f"path K1 resume md5 {s_res['md5']} != path B {md5_b}")
        with open(ck1, "r+b") as f:
            f.truncate(ck1.stat().st_size // 3)
        build("path K1 strict", list_b, tmp / "K1_strict", k1_argv, want_rc=2)
        k4_rc = {backend: wait_child(children[f"K4_{backend}"], tmp / f"K4_{backend}.log",
                                     f"path K4 {backend}") for backend in ("native", "python")}
        # K3's child killed at stream window 5, alone on the host's reads
        t = time.perf_counter()
        children["K3_sigkill"] = start_child(
            ["4", "26", str(list_b), "--output-dir", str(tmp / "K3k_out"), *f_argv,
             "--stream-checkpoint", str(ck_kill)], tmp / "K3_sigkill.log",
            MRI_FAULTS="sigkill:window=5")
        md5_skip = md5_without_doc(formatter, tmp / "C_out", 5)
        skip_ref_ms = (time.perf_counter() - t) * 1e3
        rc_kill = wait_child(children["K3_sigkill"], tmp / "K3_sigkill.log", "path K3 sigkill")
        kill_child_ms = (time.perf_counter() - t) * 1e3
        # the --resume auto rebuild also carries K2's transient read fault
        # (the retries absorb it: the output stays Path B's) and K5's
        # --audit and --trace-out, on an --artifact build
        trace_path = tmp / "K5_trace.json"
        try:
            s_auto = build("path K1 auto", list_b, tmp / "K5_out",
                           [*k1_argv, "--resume", "auto", "--artifact", "--audit",
                            "--trace-out", str(trace_path),
                            "--fault-spec", "read-error:every=97:times=2"])
        finally:
            faults.install(None)
        check(s_auto.get("quarantined_checkpoint") == f"{ck1}.corrupt"
              and s_auto["md5"] == md5_b,
              f"path K1 auto: quarantined {s_auto.get('quarantined_checkpoint')}, "
              f"md5 {s_auto['md5']}")
        print(f"phase path_k1: card={card} save_ms={s_save['total_ms']} "
              f"save_phases_ms={json.dumps(s_save['phases_ms'])} "
              f"resume_ms={s_res['total_ms']} resume_phases_ms={json.dumps(s_res['phases_ms'])} "
              f"launches={launches} auto_ms={s_auto['total_ms']} "
              f"checkpoint_bytes={ck1.stat().st_size} "
              f"md5={md5_b}", flush=True)

        # -- K2: the transient fault rode K1's auto rebuild; the permanent
        # one on Path D's argv, recorded by torch.profiler (K6) ---------------
        try:
            sp = build("path K2 skip", list_b, tmp / "K6_out",
                       ["--device-tokenize", "--profile-dir", str(tmp / "K6_prof"),
                        "--fault-spec", "read-error:doc=4:times=-1"], want_rc=3)
        finally:
            faults.install(None)
        deg, deg_s = s_auto["degradation"], sp["degradation"]
        check(s_auto["md5"] == md5_c and deg["skipped_docs"] == []
              and deg["read_retries"] == 2 * len(range(0, ndocs, 97)),
              f"path K2 transient: md5 {s_auto['md5']}, degradation {deg}")
        check(deg_s["skipped_docs"] == [5] and deg_s["read_retries"] == 2
              and sp["md5"] == md5_skip,
              f"path K2 skip: {deg_s}, md5 {sp['md5']} != {md5_skip}")
        print(f"phase path_k2: card={card} transient_total_ms={s_auto['total_ms']} "
              f"transient_phases_ms={json.dumps(s_auto['phases_ms'])} "
              f"read_retries={deg['read_retries']} skip_total_ms={sp['total_ms']} "
              f"skip_phases_ms={json.dumps(sp['phases_ms'])} skipped_docs={deg_s['skipped_docs']} "
              f"md5_transient={s_auto['md5']} md5_skip={sp['md5']} "
              f"skip_reference_ms={skip_ref_ms:.1f}", flush=True)

        # -- K3: crash and resume on the streaming all-device plan -----------
        ck3 = tmp / "K3.ckpt.npz"
        k3_argv = [*f_argv, "--stream-checkpoint", str(ck3)]
        # the engine crashes at window 3 with its window-2 save torn: the
        # rerun quarantines the torn file and rebuilds
        faults.install("ckpt-corrupt:save=1; stream-crash:window=3")
        try:
            run_cli(cli, ["4", "26", str(list_b), "--output-dir", str(tmp / "K3_out"), *k3_argv])
        except RuntimeError as e:
            check("injected stream crash after window 3" in str(e), f"path K3 crash: {e}")
        else:
            raise SmokeFailure("path K3 crash: the injected crash did not fire")
        finally:
            faults.install(None)
        check(ck3.exists(), "path K3 stream-crash left no checkpoint")
        s_cc = build("path K3 crash rerun", list_b, tmp / "K3_out", k3_argv)
        check(s_cc.get("quarantined_checkpoint") == f"{ck3}.corrupt"
              and "resumed_from_window" not in s_cc and s_cc["md5"] == md5_b
              and not ck3.exists(),
              f"path K3 crash rerun: {s_cc.get('quarantined_checkpoint')}, md5 {s_cc['md5']}")
        rc = rc_kill
        check(rc == -signal.SIGKILL and ck_kill.exists(),
              f"path K3 sigkill: child exit {rc}, checkpoint {ck_kill.exists()}: "
              f"{(tmp / 'K3_sigkill.log').read_text(errors='replace')[-1500:]}")
        s_kill = build("path K3 sigkill resume", list_b, tmp / "K3k_out",
                       [*f_argv, "--stream-checkpoint", str(ck_kill)])
        check(s_kill.get("resumed_from_window") == 4 and s_kill["md5"] == md5_b
              and not ck_kill.exists(),
              f"path K3 sigkill resume: window {s_kill.get('resumed_from_window')}, "
              f"md5 {s_kill['md5']}")
        print(f"phase path_k3: card={card} crash_rerun_ms={s_cc['total_ms']} "
              f"sigkill_resume_ms={s_kill['total_ms']} sigkill_child_exit={rc} "
              f"sigkill_child_ms={kill_child_ms:.1f} "
              f"checkpoint_ms_per_save={s_kill.get('checkpoint_ms_per_save')} md5={md5_b}",
              flush=True)

        # -- K4: the emit killed after 7 letters ------------------------------
        k4 = {}
        for backend in ("native", "python"):
            out = tmp / f"K4_{backend}"
            rc = k4_rc[backend]
            check(rc == -signal.SIGKILL, f"path K4 {backend}: child exit {rc}")
            whole = []
            for letter in range(26):
                name = formatter.letter_filename(letter)
                if (out / name).exists():
                    check((out / name).read_bytes() == (a_out / name).read_bytes(),
                          f"path K4 {backend}: {name} differs from Path A's")
                    whole.append(name)
                else:
                    left = sorted(p.name for p in out.glob(name + "*"))
                    check(left in ([], [name + ".tmp"]), f"path K4 {backend}: left {left}")
            check(whole == [formatter.letter_filename(i) for i in range(7)],
                  f"path K4 {backend}: letters {whole}, want a.txt..g.txt")
            k4[backend] = len(whole)
        print(f"phase path_k4: card={card} whole_letters={json.dumps(k4)} child_exit="
              f"{-signal.SIGKILL}", flush=True)

        # -- K5: the auto rebuild's manifest and --verify --------------------
        manifest = json.loads((tmp / "K5_out" / "index.manifest.json").read_text())
        names = [formatter.letter_filename(i) for i in range(26)] + ["index.mri"]
        check(sorted(manifest["files"]) == sorted(names) and "audit_ms" in s_auto,
              f"path K5: manifest {sorted(manifest['files'])}, audit_ms {s_auto.get('audit_ms')}")
        doc = json.loads(trace_path.read_text())
        check(s_auto.get("trace_out") == str(trace_path) and "traceEvents" in doc,
              f"path K5 trace: trace_out {s_auto.get('trace_out')}")
        t = time.perf_counter()
        rc, err = verify_cli(cli, tmp / "K5_out")
        verify_ms = (time.perf_counter() - t) * 1e3
        check(rc == 0, f"path K5: --verify of the untouched dir exit {rc}: {err}")
        shutil.copytree(tmp / "K5_out", tmp / "K5_copy")
        for name in ("a.txt", "index.mri"):
            p = tmp / "K5_copy" / name
            data = bytearray(p.read_bytes())
            data[len(data) // 2] ^= 0x01
            p.write_bytes(bytes(data))
            rc, err = verify_cli(cli, tmp / "K5_copy")
            check(rc == 2 and f"verify: {name}: checksum mismatch" in err,
                  f"path K5: --verify with {name} flipped: exit {rc}: {err}")
            data[len(data) // 2] ^= 0x01
            p.write_bytes(bytes(data))
        shutil.rmtree(tmp / "K5_copy")
        print(f"phase path_k5: card={card} audit_ms={s_auto['audit_ms']} verify_ms={verify_ms:.3f} "
              f"files={len(manifest['files'])} trace_events={len(doc['traceEvents'])} "
              f"md5={s_auto['md5']}", flush=True)

        # -- K6: the skip build's torch.profiler trace --------------------------
        traces = sorted((tmp / "K6_prof").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"path K6: traces {traces}")
        busy = device_busy(traces[0])
        check(busy["by_cat"].get("kernel", (0, 0))[0] > 0,
              f"path K6: no CUDA kernel event in {traces[0].name}: {busy['by_cat']}")
        print(f"phase path_k6: card={card} profiled_total_ms={sp['total_ms']} "
              f"device_busy={json.dumps(busy)} md5={sp['md5']}", flush=True)
    finally:
        faults.install(None)
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"phase path_k_done: card={card} seconds={time.perf_counter() - t0:.1f}", flush=True)
    return launches


# -- Path L: the resident serve daemon on the card ----------------------------

L_CONNS, L_PER_CONN = 16, 250  # client connections x requests each (L1)
L_PROFILED = 50  # requests a connection in L1's profiled window
L_LEG_CONNS = 2  # connections of the auto and 4-shard legs
L_MIX = (("df", 0.35), ("postings", 0.30), ("and", 0.10), ("or", 0.10), ("bm25", 0.10),
         ("letter", 0.05))
L_RELOADS = 5


def l_requests(np, rng, ranked: list[bytes], n: int, base_id: int) -> list[dict]:
    """``n`` protocol requests of Path L's mix: single Zipf words for df
    and postings (the coalesced path), 2-3 words for AND/OR, BM25 top-10
    over 3 words, top-10 of a letter by df."""
    ops = rng.choice(len(L_MIX), size=n, p=[w for _, w in L_MIX])
    words = zipf_terms(np, rng, ranked, 4 * n)
    out = []
    for i, k in enumerate(ops.tolist()):
        op, w = L_MIX[k][0], words[4 * i:4 * i + 4]
        r = {"id": base_id + i}
        if op in ("df", "postings"):
            r.update(op=op, terms=w[:1])
        elif op in ("and", "or"):
            r.update(op=op, terms=w[:2 + i % 2])
        elif op == "bm25":
            r.update(op="top_k", score="bm25", k=10, terms=w[:3])
        else:
            r.update(op="top_k", letter=chr(97 + int(rng.integers(26))), k=10)
        out.append(r)
    return out


def l_kind(r: dict) -> str:
    return "bm25" if r.get("score") == "bm25" else ("letter" if r["op"] == "top_k" else r["op"])


def l_expected(host, r: dict) -> dict:
    """The payload the daemon must answer ``r`` with, from the host
    ``Engine`` called directly (the daemon's own formatting)."""
    kind = l_kind(r)
    if kind == "letter":
        return {"ok": True, "top": [[t.decode("ascii", "replace"), int(d)]
                                    for t, d in host.top_k(r["letter"], r["k"])]}
    b = host.encode_batch(r["terms"])
    if kind == "df":
        return {"ok": True, "df": host.df(b).tolist()}
    if kind == "postings":
        return {"ok": True, "postings": [None if x is None else x.tolist()
                                         for x in host.postings(b)]}
    if kind == "bm25":
        return {"ok": True, "docs": [[d, s] for d, s in host.top_k_scored(b, r["k"])]}
    docs = host.query_and(b) if kind == "and" else host.query_or(b)
    return {"ok": True, "docs": docs.tolist()}


def l_check(got: dict, want: dict, label: str) -> None:
    """Path I's rule: equal answers; BM25 docs equal, scores within rel
    1e-4 of the host engine's float64."""
    got = {k: v for k, v in got.items() if k not in ("id", "trace_id")}
    if "docs" in want and want["docs"] and isinstance(want["docs"][0], list):
        check_bm25([tuple(x) for x in got.pop("docs", [])], [tuple(x) for x in want["docs"]],
                   1e-4, label)
        want = {k: v for k, v in want.items() if k != "docs"}
    check(got == want, f"{label}: {json.dumps(got)[:300]} != {json.dumps(want)[:300]}")


class LClient:
    """One protocol connection, line at a time."""

    def __init__(self, addr, timeout: float = 120.0):
        import socket

        self.sock = socket.create_connection(addr, timeout=timeout)
        self.f = self.sock.makefile("rb")

    def rpc(self, **req) -> dict:
        self.sock.sendall((json.dumps(req) + "\n").encode())
        line = self.f.readline()
        check(bool(line), "path L: the daemon closed a connection")
        return json.loads(line)

    def close(self) -> None:
        self.f.close()
        self.sock.close()


#: one client connection in its own interpreter (no torch, no package):
#: connect, say ready, wait for the go line, send its requests closed
#: loop, write the answers and latencies (CLOCK_MONOTONIC, comparable
#: across the machine's processes) to the result file
L_CLIENT = r"""
import json, socket, sys, time
host, port, reqs_path, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
reqs = json.load(open(reqs_path))
sock = socket.create_connection((host, port), timeout=120)
f = sock.makefile("rb")
print("ready", flush=True)
sys.stdin.readline()
answers, lat = [], []
t0 = time.monotonic()
for r in reqs:
    t = time.monotonic()
    sock.sendall((json.dumps(r) + "\n").encode())
    answers.append(json.loads(f.readline()))
    lat.append(time.monotonic() - t)
t1 = time.monotonic()
f.close()
sock.close()
json.dump({"answers": answers, "lat": lat, "t0": t0, "t1": t1}, open(out_path, "w"))
"""


def l_traffic(addr, conns: list[list[dict]], tmp: Path
              ) -> tuple[list[list[dict]], dict, float]:
    """Every connection's requests closed-loop, each from its own client
    process (so the clients' JSON work does not share the daemon's
    interpreter), all started together: (answers per connection, client
    latencies in s per kind, wall s from the first send to the last
    answer)."""
    procs = []
    try:
        for i, reqs in enumerate(conns):
            (tmp / f"L_req_{i}.json").write_text(json.dumps(reqs))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", L_CLIENT, addr[0], str(addr[1]),
                 str(tmp / f"L_req_{i}.json"), str(tmp / f"L_ans_{i}.json")],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for proc in procs:
            check(proc.stdout.readline().strip() == "ready", "path L: a client did not connect")
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
        for i, proc in enumerate(procs):
            check(proc.wait(timeout=600) == 0, f"path L: client {i} exited {proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdin.close()
            proc.stdout.close()
    answers, lat, spans = [], {}, []
    for i, reqs in enumerate(conns):
        res = json.loads((tmp / f"L_ans_{i}.json").read_text())
        answers.append(res["answers"])
        spans.append((res["t0"], res["t1"]))
        for r, v in zip(reqs, res["lat"]):
            lat.setdefault(l_kind(r), []).append(v)
    return answers, lat, max(t for _, t in spans) - min(t for t, _ in spans)


def l_quantiles(np, lat: dict) -> dict:
    return {k: {"n": len(v), "p50_ms": float(np.percentile(v, 50)) * 1e3,
                "p99_ms": float(np.percentile(v, 99)) * 1e3} for k, v in sorted(lat.items())}


def l_serve_check(daemon_cls, path: Path, conns, want, label: str, tmp: Path, **kw) -> dict:
    """A second daemon over the same artifact (``kw``: its engine and
    shards): the same requests, the same answers as L1's reference."""
    d = daemon_cls(str(path), **kw)
    d.start()
    try:
        answers, lat, wall = l_traffic(d.address, conns, tmp)
        for got_c, want_c in zip(answers, want):
            for got, exp in zip(got_c, want_c):
                l_check(got, exp, label)
        return {"engine": d.stats()["engine"], "wall_s": wall,
                "requests": sum(len(c) for c in conns)}
    finally:
        d.drain()


def path_l(torch, cli, h_path: Path, tmp: Path, card: str, device: str = "cuda") -> dict:
    """Path L — the resident serve daemon over Path H's v2.1 artifact.

    L1 in this process: ``ServeDaemon(engine="device")`` with default
    knobs, 16 connections x 250 requests of the mix, every answer held
    against the host ``Engine``; client p50/p99 per op, requests/s, the
    coalesced batches, then the same traffic under torch.profiler for
    the device busy time and idle share, and the peak device memory.
    Under background traffic: five ``reload`` ops (memory back within
    one engine's column bytes), then ``metrics`` against ``stats``,
    ``trace`` spans, one BM25 ``explain`` and ``flightdump``.  Two more
    daemons answer the same: ``engine="auto"`` (its probe on the card)
    and ``shards=4``.  L2: the ``serve`` CLI in a child process, its
    HTTP ``/metrics``, the ``metrics``/``flightdump``/``top`` clients,
    SIGHUP and SIGTERM."""
    import threading
    import urllib.request

    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        Engine, artifact as TA)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
        ServeDaemon)

    on_card = device == "cuda"
    t_path = time.perf_counter()
    out: dict = {"card": card}
    with TA.load_artifact(h_path) as art:
        ranked = [art.term(int(i)) for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
    rng = np.random.default_rng(29)
    conns = [l_requests(np, rng, ranked, L_PER_CONN, 1 + i * L_PER_CONN) for i in range(L_CONNS)]
    with Engine(h_path) as host:
        t0 = time.perf_counter()
        # the Zipf mix repeats requests: each distinct one asked once
        memo: dict = {}

        def expected(r):
            key = json.dumps({k: v for k, v in r.items() if k != "id"}, sort_keys=True)
            if key not in memo:
                memo[key] = l_expected(host, r)
            return memo[key]

        want = [[expected(r) for r in c] for c in conns]
        out["host_reference_s"] = time.perf_counter() - t0
        probe_terms = zipf_terms(np, rng, ranked, 8192)
        want_probe = host.df(host.encode_batch(probe_terms)).tolist()

    stage_s = {"host_reference": out["host_reference_s"]}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    d = ServeDaemon(str(h_path), engine="device", device=device)
    d.start()
    stage_s["daemon_start"] = time.perf_counter() - t0
    try:
        eng = d.stats()["engine"]
        check(eng["engine"] == "device" and eng["device"]["platform"] == device,
              f"path L1: the daemon serves from {eng['engine']} on {eng['device']['platform']}")
        column_bytes = eng["device"]["column_bytes"]
        # warm every op once (first launches, the lazy BM25 columns)
        t0 = time.perf_counter()
        c = LClient(d.address)
        for r in conns[0][:40]:
            c.rpc(**r)
        stage_s["warm"] = time.perf_counter() - t0
        c0 = d.stats()["counters"]
        answers, lat, wall = l_traffic(d.address, conns, tmp)
        c1 = d.stats()["counters"]
        for i, (got_c, want_c) in enumerate(zip(answers, want)):
            for got, exp in zip(got_c, want_c):
                l_check(got, exp, f"path L1 connection {i}")
        n_req = L_CONNS * L_PER_CONN
        batches = c1["batches"] - c0["batches"]
        batched = c1["batched_requests"] - c0["batched_requests"]
        cache_hits = d.stats()["result_cache"]["hits"]
        out["l1"] = {"requests": n_req, "wall_s": wall, "requests_per_s": n_req / wall,
                     "per_op": l_quantiles(np, lat), "batches": batches,
                     "batched_requests": batched,
                     "requests_per_batch": batched / batches if batches else None,
                     "result_cache_hits": cache_hits, "column_bytes": column_bytes}
        out["l1"]["host_reference_s"] = out["host_reference_s"]
        print(f"phase path_l1: card={card} {json.dumps(out['l1'])}", flush=True)
        # the first L_PROFILED requests of every connection again (the
        # result cache purged by a reload first, so the engine sees
        # them), recorded by torch.profiler
        t0 = time.perf_counter()
        check(c.rpc(id=0, op="reload").get("reloaded") is True, "path L1: reload before profile")
        stage_s["reload_idle"] = time.perf_counter() - t0
        if on_card:
            trace = tmp / "L1_trace.json"
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            _, _, wall_p = l_traffic(d.address, [cn[:L_PROFILED] for cn in conns], tmp)
            t0 = time.perf_counter()
            prof.stop()
            prof.export_chrome_trace(str(trace))
            busy = device_busy(trace)
            stage_s["profile_stop_export"] = time.perf_counter() - t0
            out["l1_device"] = {
                "requests": L_CONNS * L_PROFILED, "wall_ms": wall_p * 1e3,
                "device_busy_ms": busy["ms"],
                "idle_share": None if busy["ms"] is None else 1 - busy["ms"] / (wall_p * 1e3),
                "by_category": busy["by_cat"], "top_kernels": busy["top_kernels"],
                "peak_memory_allocated": torch.cuda.max_memory_allocated()}
            check(busy["ms"] is not None and busy["ms"] > 0,
                  "path L1: no device activity in the profiled traffic")
            print(f"phase path_l1_device: card={card} {json.dumps(out['l1_device'])}", flush=True)

        # -- under background traffic: reloads, metrics, trace, explain ----
        stop = threading.Event()
        bg_errors, bg_done = [], []

        def background(reqs, exp):
            try:
                bc = LClient(d.address)
                while not stop.is_set():
                    for r, w in zip(reqs, exp):
                        l_check(bc.rpc(**r), w, "path L1 background")
                        if stop.is_set():
                            break
                    bg_done.append(len(reqs))  # one whole pass
                bc.close()
            except Exception as e:
                bg_errors.append(f"{type(e).__name__}: {e}")

        bg = [threading.Thread(target=background, args=(conns[i][:60], want[i][:60]))
              for i in range(4)]
        t_bg = time.perf_counter()
        for t in bg:
            t.start()
        try:
            check(c.rpc(id=1, op="reload").get("reloaded") is True, "path L1: reload 1")
            if on_card:
                torch.cuda.synchronize()
                level = torch.cuda.memory_allocated()
            mem = []
            t0 = time.perf_counter()
            for i in range(L_RELOADS - 1):
                r = c.rpc(id=2 + i, op="reload")
                check(r.get("reloaded") is True, f"path L1: reload {i + 2}: {r}")
                if on_card:
                    torch.cuda.synchronize()
                    mem.append(torch.cuda.memory_allocated())
            stage_s["reload_under_traffic_each"] = (time.perf_counter() - t0) / (L_RELOADS - 1)
            if on_card:
                check(all(abs(m - level) <= column_bytes for m in mem),
                      f"path L1: memory after reloads {mem} vs {level} +- {column_bytes}")
                out["reload_memory"] = {"after_first": level, "after_each": mem,
                                        "column_bytes": column_bytes}
            # a pruning planner, so the report carries the threshold
            with env(MRI_SERVE_PLANNER="bmw"):
                r = c.rpc(id=11, op="top_k", score="bm25", k=10,
                          terms=[t.decode() for t in ranked[2:5]], explain=True)
            ex = r["explain"]
            check({t["path"] for t in ex["terms"]} == {"device"}
                  and ex["totals"]["blocks_decoded"] > 0 and ex["planner"]["theta"],
                  f"path L1 explain: {json.dumps(ex)[:400]}")
            flight = c.rpc(id=12, op="flightdump")
            check(flight.get("ok") and flight["flight"]["requests"],
                  "path L1: empty flightdump")
            # the traffic ran beside all of it: every thread a whole pass
            deadline = time.monotonic() + 120
            while len(bg_done) < len(bg) and not bg_errors:
                check(time.monotonic() < deadline, "path L1: the background traffic stalled")
                time.sleep(0.01)
        finally:
            stop.set()
            for t in bg:
                t.join()
        check(not bg_errors, f"path L1 background: {bg_errors[:3]}")
        stage_s["under_traffic"] = time.perf_counter() - t_bg
        st = c.rpc(id=20, op="stats")["stats"]
        text = c.rpc(id=21, op="metrics")["text"]
        lines = {ln.split()[0]: ln.split()[1] for ln in text.splitlines()
                 if ln and not ln.startswith("#") and "{" not in ln}
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
            daemon as daemon_mod)
        for key, name in daemon_mod._COUNTER_NAMES:
            got = int(lines[name])
            check(got >= st["counters"][key] if key == "responses"
                  else got == st["counters"][key],
                  f"path L1 metrics: {name} {got} vs stats {st['counters'][key]}")
        check(st["counters"]["reload_ok"] == L_RELOADS + 1 and st["counters"]["internal_errors"] == 0,
              f"path L1 counters: {st['counters']}")
        traces = c.rpc(id=22, op="trace", n=64)["traces"]
        spans = {s["name"] for t in traces if t["op"] in ("df", "postings", "and", "or", "top_k")
                 for s in t["spans"]}
        check({"queue_wait", "coalesce", "engine"} <= spans, f"path L1 trace spans {spans}")
        c.close()
        out["l1_after"] = {"background_requests": sum(bg_done),
                           "counters": st["counters"], "explain_theta": ex["planner"]["theta"],
                           "explain_blocks_decoded": ex["totals"]["blocks_decoded"],
                           "flight_requests": len(flight["flight"]["requests"])}
        print(f"phase path_l1_ops: card={card} reload_memory={json.dumps(out.get('reload_memory'))}"
              f" {json.dumps(out['l1_after'])}", flush=True)
    finally:
        d.drain()

    # -- L2's child starts here: its interpreter and engine load while the
    # two legs run (they are checked for answers, not timed per request)
    log = tmp / "L2_serve.log"
    t0 = time.perf_counter()
    with open(log, "wb") as errf:
        proc = subprocess.Popen(
            [sys.executable, "-m", PKG, "serve", str(h_path), "--engine", "device", "--device",
             device, "--listen", "127.0.0.1:0", "--listen-metrics", "0"], cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=subprocess.PIPE, stderr=errf)
    try:
        # -- the router with its probe on the card, and 4 logical shards ------
        t_legs = time.perf_counter()
        legs = conns[:L_LEG_CONNS]
        with env(MRI_SERVE_CROSSOVER=None):
            d = ServeDaemon(str(h_path), engine="auto", device=device)
            d.start()
            try:
                c = LClient(d.address)
                got = c.rpc(id=1, op="df", terms=probe_terms)
                check(got.get("df") == want_probe, "path L auto: the probe batch's df differ")
                c.close()
                answers, _, wall = l_traffic(d.address, legs, tmp)
                for got_c, want_c in zip(answers, want):
                    for got, exp in zip(got_c, want_c):
                        l_check(got, exp, "path L auto")
                auto = d.stats()["engine"]["auto"]
                check(auto["probe"] is not None and auto["probe"]["batch"] == 8192,
                      f"path L auto: no probe on the batch of 8192: {auto}")
                out["auto"] = {"probe": auto["probe"], "wall_s": wall}
            finally:
                d.drain()
        sh = l_serve_check(ServeDaemon, h_path, legs, want, "path L shards=4", tmp,
                           engine="device", device=device, shards=4)
        check(sh["engine"]["device"]["shards"] == 4, f"path L shards: {sh['engine']['device']}")
        out["shards4"] = {"devices": sh["engine"]["device"]["devices"], "wall_s": sh["wall_s"],
                          "requests": sh["requests"]}
        stage_s["legs"] = time.perf_counter() - t_legs
        print(f"phase path_l_legs: card={card} auto={json.dumps(out['auto'])} "
              f"shards4={json.dumps(out['shards4'])}", flush=True)


        # -- L2: the serve CLI in its child process ---------------------------
        t_l2 = time.perf_counter()
        line = proc.stdout.readline()
        check(bool(line), f"path L2: serve died: {log.read_text(errors='replace')[-2000:]}")
        ready = json.loads(line)
        check(ready["event"] == "listening" and ready["engine"] == "device",
              f"path L2 listening line {ready}")
        startup_s = time.perf_counter() - t0
        addr = (ready["host"], ready["port"])
        target = f"{ready['host']}:{ready['port']}"
        c = LClient(addr)
        for r, w in zip(conns[0][:50], want[0][:50]):
            l_check(c.rpc(**r), w, "path L2")
        with urllib.request.urlopen(f"http://127.0.0.1:{ready['metrics_port']}/metrics",
                                    timeout=30) as resp:
            scrape = resp.read().decode()
        check("mri_serve_requests_total 50" in scrape, "path L2: /metrics has not counted 50")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main(["metrics", target])
        check(rc == 0 and "mri_serve_requests_total 50" in text.getvalue(),
              f"path L2 metrics: exit {rc}")
        for argv in (["flightdump", target], ["top", target, "--once", "--json"]):
            rc, doc = run_cli(cli, argv)
            check(rc == 0 and doc, f"path L2 {argv[0]}: exit {rc}")
        check(doc["healthz"]["ready"] and doc["stats"]["counters"]["requests"] == 50,
              f"path L2 top: {json.dumps(doc)[:300]}")
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 60
        while c.rpc(op="stats")["stats"]["counters"]["reload_ok"] != 1:
            check(time.monotonic() < deadline, "path L2: SIGHUP reload never counted")
            time.sleep(0.05)
        c.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        drained = json.loads(proc.stdout.readline())
        check(rc == 0 and drained["event"] == "drained"
              and drained["counters"]["requests"] == 50
              and drained["counters"]["reload_ok"] == 1,
              f"path L2: exit {rc}, {drained}")
        # startup_s: from the child's start to its listening line, beside the legs
        out["l2"] = {"startup_s": startup_s, "exit": rc, "drained": drained["counters"]}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    stage_s["l2_after_legs"] = time.perf_counter() - t_l2
    print(f"phase path_l2: card={card} {json.dumps(out['l2'])}", flush=True)
    print(f"phase path_l_done: card={card} seconds={time.perf_counter() - t_path:.1f} "
          f"stages_s={json.dumps({k: round(v, 3) for k, v in stage_s.items()})}", flush=True)
    return out


# -- Path M: the host backend (backend='cpu') ---------------------------------

M_SPILL_BYTES = 16 << 20  # several spill runs per worker at K = 8 on Path B's corpus
M_TIMED_OPS = ("df@8192", "postings@1024", "and@3", "or@3", "bm25_exhaustive@3")


def host_cpu() -> str:
    """The host's CPU model and core count (every Path M number is a host
    number): ``/proc/cpuinfo``, else ``lscpu``, else ``platform``."""
    import platform

    model = None
    with contextlib.suppress(OSError):
        for line in open("/proc/cpuinfo"):
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    if not model:
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
            model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                          if ln.startswith("Model name")), None)
    return f"{model or platform.processor() or platform.machine()} x{os.cpu_count()}"


def peak_rss_reset() -> None:
    """Start a new peak-RSS window for this process (Linux ``clear_refs``
    5 resets VmHWM); where that is refused the peak is the process's."""
    with contextlib.suppress(OSError):
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")


def peak_rss_bytes() -> tuple[int, str]:
    """``(bytes, scope)``: the peak RSS since :func:`peak_rss_reset`
    (``VmHWM``, scope ``leg``), or where the kernel keeps no ``VmHWM``,
    the process's peak since it started (``getrusage``, scope
    ``process``)."""
    import resource

    with contextlib.suppress(OSError):
        for line in open("/proc/self/status"):
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024, "leg"
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, "process"


def m_leg(K, formatter, cli, label: str, argv: list[str], out_dir: Path, **env_extra) -> dict:
    """One counted host-backend CLI build: exit 0, no ``cpu_fallback``
    (the native code ran), no kernel of ``csrc/`` launched."""
    K.reset_launch_counts()
    peak_rss_reset()
    t0 = time.perf_counter()
    with env(**env_extra):
        rc, stats = run_cli(cli, [*argv, "--backend", "cpu", "--stats",
                                  "--output-dir", str(out_dir)])
    check(rc == 0 and stats is not None, f"{label}: CLI exit {rc}")
    check("cpu_fallback" not in stats, f"{label}: fell back to the oracle "
          f"({stats.get('cpu_fallback')})")
    stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
    stats["peak_rss_bytes"], stats["peak_rss_scope"] = peak_rss_bytes()
    stats["md5"] = formatter.letters_md5(out_dir)
    stats["launches"] = {"unique_mask_count": K.unique_mask_count.launches,
                         "bucket_histogram": K.bucket_histogram.launches}
    check(not any(stats["launches"].values()),
          f"{label} launched a kernel of csrc/: {stats['launches']}")
    return stats


def m_summary(stats: dict) -> dict:
    """What the ``path_m`` line keeps of a leg."""
    keep = {k: stats[k] for k in ("md5", "wall_ms", "total_ms", "phases_ms", "host_threads",
                                  "reduce_workers", "io_windows", "merge_ms", "stage_read_ms",
                                  "stage_tokenize_ms", "stage_emit_ms", "spill",
                                  "build_shards", "artifact_bytes", "artifact_build_ms",
                                  "degradation", "audit_ms", "peak_rss_bytes",
                                  "peak_rss_scope", "launches")
            if k in stats}
    if "spill" in keep:
        keep["spill_runs_per_worker"] = keep["spill"]["flushes"] / stats["host_threads"]
    return keep


def m4_serve(torch, S, m4: Path, h21: Path, served: dict, card: str) -> dict:
    """M4's v2.1 artifact (the host build's) on a ``DeviceEngine`` on the
    card: df, postings, AND and OR on Path H's batches equal to the card
    engine's answers on Path H's v2.1; BM25 top-10 per planner equal to
    the host ``Engine`` on the same M4 file (rel 1e-4, documents tied within
    it in any order); then ms per op."""
    import numpy as np

    out = {}
    dev, ref = S.DeviceEngine(m4, device="cuda"), S.DeviceEngine(h21, device="cuda")
    try:
        for n, b in served["batches"].items():
            check(dev.df(b).tolist() == ref.df(b).tolist(), f"path M4 df@{n} != path H's")
            check(same_postings(np, dev.postings(b), ref.postings(b)),
                  f"path M4 postings@{n} != path H's")
        for arity, qs in served["queries"].items():
            for q in qs:
                b = dev.encode_batch(q)
                check(np.array_equal(dev.query_and(b), ref.query_and(b)), f"path M4 AND {q}")
                check(np.array_equal(dev.query_or(b), ref.query_or(b)), f"path M4 OR {q}")
        with S.Engine(m4) as host:
            for planner in PLANNERS:
                with env(MRI_SERVE_PLANNER=planner):
                    for qs in served["queries"].values():
                        for q in qs:
                            check_bm25_ties(dev.top_k_scored(dev.encode_batch(q), 10),
                                            host.top_k_scored(host.encode_batch(q), 10), 1e-4,
                                            f"path M4 bm25 {planner} {q} vs the host engine")
        b8192, b1024 = served["batches"][8192], served["batches"][1024]
        b3 = dev.encode_batch(served["queries"][3][0])
        ops = {"df@8192": lambda: dev.df(b8192), "postings@1024": lambda: dev.postings(b1024),
               "and@3": lambda: dev.query_and(b3), "or@3": lambda: dev.query_or(b3),
               "bm25_exhaustive@3": lambda: dev.top_k_scored(b3, 10)}
        with env(MRI_SERVE_PLANNER="exhaustive"):
            for name in M_TIMED_OPS:
                out[name] = timed(torch, ops[name], "cuda", iters=5, repeats=3)
    finally:
        dev.close()
        ref.close()
    return out


def path_m(torch, K, cli, formatter, faults, synthetic, build_index, IndexConfig,
           list_a: Path, list_b: Path, tmp: Path, md5_oracle_a: str, md5_c: str,
           h_paths: dict, served: dict, card: str) -> dict:
    """Path M — the host backend, which never touches the card, on Path
    B's corpus (M1-M4), Path A's (M5) and a virtual corpus (M6); the card
    serves M4's artifact and builds M6's default plan.  Returns the
    path's launches (none)."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import serve as S

    t0 = time.perf_counter()
    legs = {}
    # M1: one scan worker, the pipelined ingest route
    m1 = m_leg(K, formatter, cli, "path M1", ["1", "1", str(list_b), "--host-threads", "1"],
               tmp / "M1_out")
    check("ingest_scan" in m1["phases_ms"] and m1["host_threads"] == 1
          and "reduce_workers" not in m1, f"path M1 did not take the pipelined route: "
          f"{sorted(m1['phases_ms'])} threads {m1['host_threads']}")
    legs["M1"] = m1
    # M2: 8 scan workers on the steal queue, 4 letter reducers
    m2 = m_leg(K, formatter, cli, "path M2", ["8", "4", str(list_b)], tmp / "M2_out")
    check(m2["host_threads"] == 8 and m2["reduce_workers"] == 4,
          f"path M2: {m2['host_threads']} workers, {m2.get('reduce_workers')} reducers")
    legs["M2"] = m2
    # M3: M2 under a spill budget several runs per worker deep
    m3 = m_leg(K, formatter, cli, "path M3", ["8", "4", str(list_b)], tmp / "M3_out",
               MRI_BUILD_SPILL_BYTES=str(M_SPILL_BYTES))
    check(m3["spill"]["flushes"] > 2 * m3["host_threads"] and m3["spill"]["runs_quarantined"] == 0,
          f"path M3: spill {m3['spill']}, want more than one run per worker")
    legs["M3"] = m3
    for name in ("M1", "M2", "M3"):
        check(legs[name]["md5"] == md5_c, f"path {name} md5 {legs[name]['md5']} != path C {md5_c}")
    # M4: M2 with --artifact at each format
    m4_files = {}
    for fmt in (1, 2, 3):
        out = tmp / f"M4_v{fmt}"
        s = m_leg(K, formatter, cli, f"path M4 v{fmt}", ["8", "4", str(list_b), "--artifact"],
                  out, MRI_SERVE_FORMAT=str(fmt))
        check(s["md5"] == md5_c, f"path M4 v{fmt} md5 {s['md5']} != path C {md5_c}")
        m4_files[fmt] = out / "index.mri"
        legs[f"M4_v{fmt}"] = s
    check(m4_files[1].read_bytes() == h_paths[1].read_bytes(),
          "path M4: the host build's v1 index.mri differs from path H's v1")
    legs["M4_v3"]["device_engine_ms"] = m4_serve(torch, S, m4_files[3], h_paths[3], served[3],
                                                 card)
    # M5: worker recovery under --audit on Path A's corpus
    m5 = m_leg(K, formatter, cli, "path M5",
               ["4", "2", str(list_a), "--audit", "--fault-spec", "worker-death:window=2"],
               tmp / "M5_out", MRI_CPU_WINDOW_BYTES="4096")
    faults.install(None)
    check(m5["degradation"]["worker_recoveries"] >= 1 and not m5["degradation"]["skipped_docs"],
          f"path M5: degradation {m5['degradation']}")
    check(m5["md5"] == md5_oracle_a, f"path M5 md5 {m5['md5']} != path A's {md5_oracle_a}")
    rc, err = verify_cli(cli, tmp / "M5_out")
    check(rc == 0, f"path M5 --verify: exit {rc}: {err}")
    legs["M5"] = m5
    # M6: a virtual corpus of Path B's parameters, host backend and card;
    # in one generator chunk it draws Path B's very documents
    m6 = {}
    manifest = synthetic.synthetic_manifest(num_docs=20_000, vocab_size=100_000,
                                            tokens_per_doc=1000, alpha=1.2, seed=11)
    for name, cfg in (("cpu", IndexConfig(backend="cpu", num_mappers=8, num_reducers=4)),
                      ("cuda", IndexConfig(num_mappers=4, num_reducers=26))):
        K.reset_launch_counts()
        peak_rss_reset()
        t1 = time.perf_counter()
        s = build_index(manifest, cfg, output_dir=str(tmp / f"M6_{name}"))
        s["wall_ms"] = (time.perf_counter() - t1) * 1e3
        s["peak_rss_bytes"], s["peak_rss_scope"] = peak_rss_bytes()
        s["md5"] = formatter.letters_md5(tmp / f"M6_{name}")
        s["launches"] = {"unique_mask_count": K.unique_mask_count.launches,
                         "bucket_histogram": K.bucket_histogram.launches}
        check("cpu_fallback" not in s, f"path M6 {name}: fell back to the oracle")
        m6[name] = s
    check(m6["cpu"]["md5"] == m6["cuda"]["md5"] == md5_c,
          f"path M6: host backend md5 {m6['cpu']['md5']}, card {m6['cuda']['md5']}, "
          f"path C {md5_c}: want all equal")
    check(not any(m6["cpu"]["launches"].values()), "path M6 cpu launched a kernel of csrc/")
    legs["M6_cpu"], legs["M6_cuda"] = m6["cpu"], m6["cuda"]
    launches = {k: sum(leg["launches"][k] for leg in legs.values())
                for k in ("unique_mask_count", "bucket_histogram")}
    print("phase path_m: " + json.dumps({
        "card": card, "host_cpu": host_cpu(), "path_c_md5": md5_c,
        "legs": {name: m_summary(leg) | ({"device_engine_ms": leg["device_engine_ms"]}
                                          if "device_engine_ms" in leg else {})
                 for name, leg in legs.items()}}), flush=True)
    print(f"phase path_m_done: card={card} seconds={time.perf_counter() - t0:.1f} "
          f"launches={launches}", flush=True)
    return launches


# -- Path N: the live index (segments/) ----------------------------------------

N_READ_CONNS = 8       # N4's read clients while the mutation client runs
N_READS = 120          # requests in each read client's list (cycled until the mutations end)
N_FLUSH = 8            # MRI_SEGMENT_TOMBSTONE_FLUSH of N4's daemon
N_BUFFERED = 5         # acknowledged deletes still buffered at N4's SIGKILL
N_POLL_MS = 200        # MRI_REPLICA_POLL_MS of N5's replica
N_CONVERGE_S = 10.0    # N5: the replica reaches the primary's generation within this
#: compaction folds this many adjacent segments a round (N3 and N4): the
#: two cheapest, so the seed's vocabulary stays out of the per-term loop
N_COMPACT_TRIGGER = "2"


def n_list(manifest_mod, tmp: Path, name: str, paths) -> Path:
    lst = tmp / f"{name}_list.txt"
    manifest_mod.write_manifest(lst, [str(p) for p in paths])
    return lst


def n_queries(np, rng, ranked: list[bytes]) -> dict:
    """Zipf words: 16 batches of 1, 4 of 1,024; 32 AND/OR queries of 2-3
    words; every letter for top-10."""
    return {"b1": [zipf_terms(np, rng, ranked, 1) for _ in range(16)],
            "b1024": [zipf_terms(np, rng, ranked, 1024) for _ in range(4)],
            "bool": [zipf_terms(np, rng, ranked, 2 + i % 2) for i in range(32)],
            "letters": "abcdefghijklmnopqrstuvwxyz"}


def n_ids(np, a, live, label: str) -> list:
    """Global doc ids as ``live``'s ranks (1-based; ``live`` ascending),
    or unchanged when ``live`` is None; a deleted id fails."""
    a = np.asarray(a, dtype=np.int64)
    if live is None:
        return a.tolist()
    pos = np.searchsorted(live, a)
    check(bool(len(a) == 0 or ((pos < len(live)).all()
                               and (live[np.minimum(pos, len(live) - 1)] == a).all())),
          f"{label}: a deleted document was answered")
    return (pos + 1).tolist()


def n_compare(np, multi, ref, q: dict, label: str, live=None) -> None:
    """``multi``'s df and postings (batches 1 and 1,024), AND and OR of 2-3
    words and letter top-10 equal ``ref``'s, ``multi``'s ids mapped to
    ``ref``'s by rank in ``live`` when given."""
    for batch in q["b1"] + q["b1024"]:
        bm, br = multi.encode_batch(batch), ref.encode_batch(batch)
        check(multi.df(bm).tolist() == ref.df(br).tolist(),
              f"{label}: df of a batch of {len(batch)} differ")
        for w, a, b in zip(batch, multi.postings(bm), ref.postings(br)):
            check((a is None) == (b is None)
                  and (a is None or n_ids(np, a, live, label) == b.tolist()),
                  f"{label}: postings of {w!r} differ")
    for words in q["bool"]:
        for op in ("query_and", "query_or"):
            got = n_ids(np, getattr(multi, op)(multi.encode_batch(words)), live, label)
            check(got == getattr(ref, op)(ref.encode_batch(words)).tolist(),
                  f"{label}: {op} {words} differ")
    for letter in q["letters"]:
        check(multi.top_k(letter, 10) == ref.top_k(letter, 10),
              f"{label}: top-10 of {letter!r} differ")


def n_op_ms(eng, q: dict) -> dict:
    """Host-clock ms of one call (the answer on the host), median over
    the query sets, each op warmed once."""
    ops = {"df@1": (lambda b: eng.df(eng.encode_batch(b)), q["b1"]),
           "postings@1": (lambda b: eng.postings(eng.encode_batch(b)), q["b1"]),
           "df@1024": (lambda b: eng.df(eng.encode_batch(b)), q["b1024"]),
           "postings@1024": (lambda b: eng.postings(eng.encode_batch(b)), q["b1024"]),
           "and@2-3": (lambda b: eng.query_and(eng.encode_batch(b)), q["bool"]),
           "or@2-3": (lambda b: eng.query_or(eng.encode_batch(b)), q["bool"])}
    out = {}
    for name, (fn, args) in ops.items():
        fn(args[0])
        out[name] = timed_each(fn, args)["host_ms"]
    return out


def n_serve(log: Path, root: Path, *extra: str, **env_extra) -> subprocess.Popen:
    """``serve DIR`` in a child on its default engine (stdout piped for
    the listening line, stderr into ``log``)."""
    with open(log, "ab") as errf:
        return subprocess.Popen(
            [sys.executable, "-m", PKG, "serve", str(root), "--listen", "127.0.0.1:0", *extra],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT), **env_extra},
            stdout=subprocess.PIPE, stderr=errf)


def n_ready(proc: subprocess.Popen, log: Path, label: str) -> dict:
    line = proc.stdout.readline()
    check(bool(line), f"{label}: serve died: {log.read_text(errors='replace')[-2000:]}")
    ready = json.loads(line)
    check(ready["event"] == "listening" and ready["engine"] == "multi",
          f"{label}: listening line {ready}, want the multi-segment engine")
    return ready


def n_stop(proc: subprocess.Popen) -> int | None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.stdout.close()
    return proc.returncode


class NReference:
    """The answers a live directory's daemon must give: a from-scratch
    ``--backend cpu --artifact`` build of the live files, served by the
    host ``Engine`` (held exactly, BM25 floats included) and by the
    card's ``DeviceEngine`` (BM25 within rel 1e-4, ties in any order)."""

    def __init__(self, np, cli, manifest_mod, tmp: Path, name: str, paths, live, device: str):
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
            DeviceEngine, Engine)

        self.np, self.live = np, live
        out = tmp / f"{name}_ref"
        rc, _ = run_cli(cli, ["4", "26", str(n_list(manifest_mod, tmp, name,
                                                    [paths[g - 1] for g in live.tolist()])),
                              "--backend", "cpu", "--artifact", "--output-dir", str(out)])
        check(rc == 0, f"path N {name} reference build: exit {rc}")
        self.host = Engine(out)
        self.dev = DeviceEngine(out, device=device)
        self._memo: dict = {}

    def close(self) -> None:
        self.host.close()
        self.dev.close()

    def check(self, r: dict, got: dict, label: str) -> None:
        key = json.dumps({k: v for k, v in r.items() if k not in ("id", "min_generation")},
                         sort_keys=True)
        if key not in self._memo:
            self._memo[key] = (l_expected(self.host, r), l_expected(self.dev, r))
        want_host, want_dev = self._memo[key]
        np, live = self.np, self.live
        got = {k: v for k, v in got.items() if k not in ("id", "trace_id")}
        kind = l_kind(r)
        if kind == "postings":
            got["postings"] = [None if p is None else n_ids(np, p, live, label)
                               for p in got.get("postings", [])]
        elif kind == "bm25":
            docs = got.get("docs", [])
            got["docs"] = [[m, s] for m, (_, s) in
                           zip(n_ids(np, [d for d, _ in docs], live, label), docs)]
        elif kind in ("and", "or"):
            got["docs"] = n_ids(np, got.get("docs", []), live, label)
        check(got == want_host, f"{label}: {json.dumps(r)[:200]}: {json.dumps(got)[:200]} != "
              f"host {json.dumps(want_host)[:200]}")
        if kind == "bm25":
            check_bm25_ties([tuple(x) for x in got["docs"]], [tuple(x) for x in want_dev["docs"]],
                            1e-4, f"{label} vs the card")
        else:
            check(got == want_dev, f"{label}: {json.dumps(r)[:200]} != the card's answer")


def n_traffic(np, addr, conns: list, mutations, acked: dict) -> tuple[dict, dict]:
    """N4's traffic: ``len(conns)`` read clients, each cycling its request
    list (at least once) until ``mutations(client)`` returns, every
    request carrying the generation of the last acknowledged mutation as
    ``min_generation``; every answer must be ``ok``.  Returns the read
    latencies in s per kind while the mutations ran, and the result of
    ``mutations``."""
    import threading

    done = threading.Event()
    lat: dict = {}
    errs: list = []
    result: dict = {}

    def reader(reqs):
        try:
            c = LClient(addr)
            try:
                passes = 0
                while passes == 0 or not done.is_set():
                    for r in reqs:
                        t = time.monotonic()
                        ans = c.rpc(**r, min_generation=acked["gen"])
                        dt = time.monotonic() - t
                        check("error" not in ans, f"path N4 read {r}: {ans}")
                        if not done.is_set():
                            lat.setdefault(l_kind(r), []).append(dt)
                    passes += 1
            finally:
                c.close()
        except Exception as e:  # surfaced on the main thread
            errs.append(e)

    def writer():
        try:
            c = LClient(addr)
            try:
                result.update(mutations(c))
            finally:
                c.close()
        except Exception as e:
            errs.append(e)
        finally:
            done.set()

    threads = [threading.Thread(target=reader, args=(reqs,)) for reqs in conns]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "path N4: a client hung")
    if errs:
        raise errs[0]
    return lat, result


def n_tree(root: Path, man) -> dict:
    """The manifest and every file a generation names, by relative path."""
    out = {"segments.manifest.json": (root / "segments.manifest.json").read_bytes()}
    for e in man.entries:
        for name in ("index.mri",) + ((e.tombstones,) if e.tombstones else ()):
            p = root / "segments" / e.name / name
            out[str(p.relative_to(root))] = p.read_bytes()
    return out


def path_n(torch, K, cli, manifest_mod, list_b: Path, h_path: Path, tmp: Path, card: str,
           device: str = "cuda") -> dict:
    """Path N — the live index (``segments/``) on Path B's corpus.

    N1: the default card build with ``--artifact`` over the first 90% of
    the files, then ``append --add`` of the next two 5% as two segments:
    df and postings at batches 1 and 1,024, AND/OR and letter top-10 of
    the multi-segment engine equal the card's ``DeviceEngine`` over Path
    H's artifact of all the files (the same ids).  N2: ``delete --docs``
    of 5% of the ids across the three segments, one of them again (no
    new tombstone); the same answers as a from-scratch card build of the
    live files, ids mapped by rank.  N3: a ``compact
    --fault-spec compact-crash`` child exits 2 and the generation serves
    unchanged; ``compact --force`` (the two cheapest segments), then
    ``--verify`` and N2's answers again.  N4: a directory of four appends
    of 2.5% of the files served by the ``serve`` CLI in a child (its
    default engine: the multi-segment engine); eight read clients send
    Path L's mix carrying the last acknowledged generation as
    ``min_generation`` while a mutation client appends 2.5% more, deletes
    1% at ``MRI_SEGMENT_TOMBSTONE_FLUSH`` = 8 and compacts; then every
    distinct read equals a host ``Engine`` (exactly) and the card's
    ``DeviceEngine`` (BM25 rel 1e-4) over a from-scratch ``--backend
    cpu`` build of the live files.  Five more deletes are acknowledged
    buffered, the daemon is SIGKILLed and restarted: its startup recovery
    replays them (``recover`` on a copy gives the same manifest), and the
    answers equal the new reference.  N5: ``serve --replica-of`` the
    restarted primary (armed with one ``fetch-partial``) on an empty
    directory: the torn ship is rejected and retried, the replica starts
    at the primary's generation with every file byte-equal, and follows
    one more append within ``N_CONVERGE_S``."""
    import shutil

    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import segments
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine, Engine, artifact as TA, create_engine)

    on_card = device == "cuda"
    dev = [] if on_card else ["--device", "cpu"]
    t_path = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    paths = list(manifest_mod.read_manifest(list_b).paths)
    n = len(paths)
    # the appended segments' sizes set both compactions' cost (N3, N4)
    n_app, n_small = n // 20, n // 40
    n_seed = n - 2 * n_app
    out: dict = {"card": card, "files": n}
    ms: dict = {}
    stage_s: dict = {}
    t_stage = [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stage_s[name] = now - t_stage[0]
        t_stage[0] = now

    with TA.load_artifact(h_path) as art:
        ranked = [art.term(int(i)) for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
    rng = np.random.default_rng(31)
    q = n_queries(np, rng, ranked)

    # -- N1: seed on the card, two appends on the host -------------------------
    live_dir = tmp / "N_live"
    t0 = time.perf_counter()
    rc, st = run_cli(cli, ["4", "26", str(n_list(manifest_mod, tmp, "N_seed", paths[:n_seed])),
                           "--artifact", "--stats", "--output-dir", str(live_dir), *dev])
    check(rc == 0, f"path N1 seed build: exit {rc}")
    check_pipelined(st, "path N1 seed")
    ms["seed_build"] = (time.perf_counter() - t0) * 1e3
    if on_card:
        out["seed_build_peak_memory"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ms["append_segment"] = []
    for a, b in ((n_seed, n_seed + n_app), (n_seed + n_app, n)):
        t0 = time.perf_counter()
        rc, res = run_cli(cli, ["append", str(live_dir), "--add", *paths[a:b]])
        ms["append_segment"].append((time.perf_counter() - t0) * 1e3)
        check(rc == 0 and res["doc_ids"][0] == a + 1 and res["docs"] == b - a,
              f"path N1 append {a + 1}..{b}: exit {rc}, {json.dumps(res)[:300]}")
    check(res["segments"] == 3 and res["generation"] == 3, f"path N1: {res}")
    t0 = time.perf_counter()
    multi = create_engine(str(live_dir))  # no engine named: the multi-segment engine
    ms["open_multi"] = (time.perf_counter() - t0) * 1e3
    check(multi.engine_name == "multi", f"path N1 opened {multi.engine_name}")
    with DeviceEngine(h_path, device=device) as full, Engine(h_path) as host_full:
        n_compare(np, multi, full, q, "path N1")
        out["n1"] = {"seed_pairs": st.get("unique_pairs"), "multi_ms": n_op_ms(multi, q),
                     "device_full_ms": n_op_ms(full, q), "host_full_ms": n_op_ms(host_full, q),
                     "segments": [(s["name"], s["docs"], s["vocab"], s["bytes"])
                                  for s in multi.describe()["segments"]]}
    multi.close()
    stage("n1")

    # -- N2: deletes across the three segments ----------------------------------
    victims = np.sort(rng.choice(n, size=n // 20, replace=False) + 1)
    for lo, hi in ((0, n_seed), (n_seed, n_seed + n_app), (n_seed + n_app, n)):
        check(bool(((victims > lo) & (victims <= hi)).any()), "path N2: a segment without deletes")
    t0 = time.perf_counter()
    rc, res = run_cli(cli, ["delete", str(live_dir), "--docs", *map(str, victims.tolist())])
    ms["delete"] = (time.perf_counter() - t0) * 1e3
    check(rc == 0 and res["newly_tombstoned"] == len(victims), f"path N2 delete: {rc} {res}")
    rc, res = run_cli(cli, ["delete", str(live_dir), "--docs", str(int(victims[0]))])
    check(rc == 0 and res["newly_tombstoned"] == 0, f"path N2 re-delete: {rc} {res}")
    # N3's crashed compaction runs in its child beside N2's reference build
    # and checks: it holds the mutation lock through its merge, and reads
    # need no lock
    before = (live_dir / "segments.manifest.json").read_bytes()
    crash_log = tmp / "N3_crash.log"
    crash = start_child(["compact", str(live_dir), "--fault-spec", "compact-crash"], crash_log,
                        MRI_SEGMENT_COMPACT_TRIGGER=N_COMPACT_TRIGGER)
    live = np.setdiff1d(np.arange(1, n + 1), victims)
    rc, _ = run_cli(cli, ["4", "26", str(n_list(manifest_mod, tmp, "N2_live",
                                                [paths[g - 1] for g in live.tolist()])),
                          "--artifact", "--output-dir", str(tmp / "N2_ref"), *dev])
    check(rc == 0, f"path N2 reference build: exit {rc}")
    ref2 = DeviceEngine(tmp / "N2_ref", device=device)
    with create_engine(str(live_dir)) as multi:
        n_compare(np, multi, ref2, q, "path N2", live=live)
        out["n2"] = {"deleted": len(victims), "multi_ms": n_op_ms(multi, q),
                     "device_ref_ms": n_op_ms(ref2, q)}
    stage("n2")

    # -- N3: compaction, the crashed one (started in N2) first -------------------
    rc = wait_child(crash, crash_log, "path N3 compact-crash")
    text = crash_log.read_text(errors="replace")
    check(rc == 2 and "injected compaction crash" in text,
          f"path N3 compact-crash: exit {rc}: {text[-1000:]}")
    check((live_dir / "segments.manifest.json").read_bytes() == before,
          "path N3: the crashed compaction changed the manifest")
    with create_engine(str(live_dir)) as multi:
        n_compare(np, multi, ref2, q, "path N3 after the crash", live=live)
    with env(MRI_SEGMENT_COMPACT_TRIGGER=N_COMPACT_TRIGGER):
        t0 = time.perf_counter()
        rc, res = run_cli(cli, ["compact", str(live_dir), "--force"])
        ms["compact"] = (time.perf_counter() - t0) * 1e3
    check(rc == 0 and res["compacted"] and res["segments"] == 2,
          f"path N3 compact: exit {rc}, {res}")
    rc, err = verify_cli(cli, live_dir)
    check(rc == 0, f"path N3 --verify: exit {rc}: {err[-500:]}")
    t0 = time.perf_counter()
    with create_engine(str(live_dir)) as multi:
        ms["open_multi_compacted"] = (time.perf_counter() - t0) * 1e3
        n_compare(np, multi, ref2, q, "path N3", live=live)
        out["n3"] = {"compact": {k: res[k] for k in ("inputs", "tombstones_dropped", "bytes",
                                                    "compact_ms")},
                     "multi_ms": n_op_ms(multi, q)}
    ref2.close()
    stage("n3")

    # -- N4: the daemon over a directory built by appends ------------------------
    n4 = tmp / "N4_live"
    for i in range(4):
        rc, res = run_cli(cli, ["append", str(n4), "--add",
                                *paths[i * n_small:(i + 1) * n_small]])
        check(rc == 0, f"path N4 append {i}: exit {rc}")
    n4_env = {"MRI_SEGMENT_TOMBSTONE_FLUSH": str(N_FLUSH),
              "MRI_SEGMENT_COMPACT_TRIGGER": N_COMPACT_TRIGGER}
    log = tmp / "N4_serve.log"
    proc = n_serve(log, n4, **n4_env)
    try:
        ready = n_ready(proc, log, "path N4")
        addr = (ready["host"], ready["port"])
        reads = [l_requests(np, rng, ranked, N_READS, 1 + i * N_READS)
                 for i in range(N_READ_CONNS)]
        span = 5 * n_small
        doomed = np.sort(rng.choice(span, size=n // 100, replace=False) + 1)
        acked = {"gen": 4}
        acks: dict = {}

        def mutations(c):
            def ack(op, **kw):
                t = time.monotonic()
                r = c.rpc(op=op, **kw)
                acks.setdefault(op, []).append(time.monotonic() - t)
                check(r.get("ok") is True, f"path N4 {op}: {json.dumps(r)[:300]}")
                acked["gen"] = max(acked["gen"], r["result"]["generation"])
                return r["result"]

            res = ack("append", files=paths[4 * n_small:span])
            check(res["doc_ids"][0] == 4 * n_small + 1, f"path N4 append: {res}")
            for i in range(0, len(doomed), N_FLUSH):
                ack("delete", docs=doomed[i:i + N_FLUSH].tolist())
            res = ack("compact")
            check(res["compacted"], f"path N4 compact: {res}")
            return {"compact": res}

        stage("n4_appends_and_start")
        lat, mres = n_traffic(np, addr, reads, mutations, acked)
        stage("n4_traffic")
        live4 = np.setdiff1d(np.arange(1, span + 1), doomed)
        ref4 = NReference(np, cli, manifest_mod, tmp, "N4", paths, live4, device)
        stage("n4_reference")
        c = LClient(addr)
        distinct = {json.dumps({k: v for k, v in r.items() if k != "id"}, sort_keys=True): r
                    for conn in reads for r in conn}
        for r in distinct.values():
            ref4.check(r, c.rpc(**r), "path N4")
        ref4.close()
        stage("n4_checks")
        # five acknowledged deletes left buffered, then SIGKILL
        last = np.setdiff1d(live4, [1])[:N_BUFFERED]
        for i, d in enumerate(last.tolist()):
            r = c.rpc(id=900 + i, op="delete", docs=[d])
            check(r.get("ok") and r["result"].get("buffered") and r["result"]["wal_seq"] > 0,
                  f"path N4 buffered delete: {r}")
        gen_killed = c.rpc(op="healthz")["generation"]
        c.close()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        n_stop(proc)
    man = segments.load_manifest(n4)
    check(man.generation == gen_killed, f"path N4: generation {man.generation} after the kill")
    copy = tmp / "N4_copy"
    shutil.copytree(n4, copy)
    t0 = time.perf_counter()
    rc, rep = run_cli(cli, ["recover", str(copy)])
    ms["recover"] = (time.perf_counter() - t0) * 1e3
    check(rc == 0 and rep["replayed"] == N_BUFFERED, f"path N4 recover: {rc} {rep}")
    live5 = np.setdiff1d(live4, last)
    ref5 = NReference(np, cli, manifest_mod, tmp, "N5", paths, live5, device)
    stage("n4_kill_recover_reference")
    t0 = time.perf_counter()
    proc = n_serve(log, n4, "--fault-spec", "fetch-partial", **n4_env)
    rep_log = tmp / "N5_replica.log"
    replica = None
    try:
        ready = n_ready(proc, log, "path N4 restart")
        restart_s = time.perf_counter() - t0
        addr = (ready["host"], ready["port"])
        c = LClient(addr)
        gen = c.rpc(op="healthz")["generation"]
        check(gen == gen_killed + N_BUFFERED, f"path N4 restart: generation {gen}, want "
              f"{gen_killed + N_BUFFERED} (the buffered deletes replayed)")
        check((copy / "segments.manifest.json").read_bytes()
              == (n4 / "segments.manifest.json").read_bytes(),
              "path N4: startup recovery and recover on a copy differ")
        # -- N5's replica starts here, its interpreter loading while the
        # restarted primary's answers are checked
        t0 = time.perf_counter()
        replica = n_serve(rep_log, tmp / "N5_replica", "--replica-of",
                          f"{addr[0]}:{addr[1]}", MRI_REPLICA_POLL_MS=str(N_POLL_MS))
        for r in distinct.values():
            ref5.check(r, c.rpc(**r), "path N4 restart")
        ref5.close()
        stage("n4_restart_checks")

        # -- N5: a replica of the restarted primary ----------------------------------
        rready = n_ready(replica, rep_log, "path N5")
        bootstrap_s = time.perf_counter() - t0
        rcl = LClient((rready["host"], rready["port"]))
        h = rcl.rpc(op="healthz")
        check(h["generation"] == gen, f"path N5: replica at {h['generation']}, primary at {gen}")
        check("attempt 1" in rep_log.read_text(errors="replace"),
              "path N5: the fetch-partial ship was not rejected")
        check(n_tree(tmp / "N5_replica", segments.load_manifest(n4))
              == n_tree(n4, segments.load_manifest(n4)), "path N5: files differ after bootstrap")
        r = c.rpc(op="append", files=paths[span:span + n_small // 10])
        check(r.get("ok") is True, f"path N5 primary append: {r}")
        new_gen = r["result"]["generation"]
        t0 = time.perf_counter()
        while True:
            h = rcl.rpc(op="healthz")
            if h["generation"] == new_gen and h["ready"]:
                break
            check(time.perf_counter() - t0 < N_CONVERGE_S,
                  f"path N5: replica at {h['generation']} after {N_CONVERGE_S} s, want {new_gen}")
            time.sleep(0.01)
        converge_ms = (time.perf_counter() - t0) * 1e3
        man = segments.load_manifest(n4)
        check(n_tree(tmp / "N5_replica", man) == n_tree(n4, man),
              "path N5: files differ after following")
        batch = q["b1024"][0]
        check(rcl.rpc(op="df", terms=batch)["df"] == c.rpc(op="df", terms=batch)["df"],
              "path N5: the replica's df differ from the primary's")
        check(rcl.rpc(op="delete", docs=[2]).get("error") == "mutation_rejected",
              "path N5: the replica took a mutation")
        rcl.close()
        c.close()
        stage("n5")
    finally:
        if replica is not None:
            check(n_stop(replica) == 0, f"path N5 replica exit {replica.returncode}")
        check(n_stop(proc) == 0, f"path N4 primary exit {proc.returncode}")

    out["n4"] = {"reads_while_mutating": l_quantiles(np, lat),
                 "ack_ms": {op: {"n": len(v), "p50": float(np.percentile(v, 50)) * 1e3,
                                 "max": max(v) * 1e3} for op, v in acks.items()},
                 "compact": {k: mres["compact"][k] for k in ("inputs", "tombstones_dropped",
                                                             "compact_ms")},
                 "distinct_reads_checked": len(distinct), "restart_s": restart_s}
    out["n5"] = {"bootstrap_s": bootstrap_s, "converge_ms": converge_ms,
                 "generation": new_gen, "poll_ms": N_POLL_MS}
    out["ms"] = ms
    out["stages_s"] = stage_s
    # after the seed build: the engines' columns and the reference builds
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated() if on_card else None
    launches = {"unique_mask_count": K.unique_mask_count.launches,
                "bucket_histogram": K.bucket_histogram.launches}
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_path
    print(f"phase path_n: card={card} {json.dumps(out)}", flush=True)
    return launches


# -- Path O: the doc-sharded cluster (cluster/) ---------------------------------

O_SHARDS = 4            # O1's round-robin shards of Path B's 20,000 files
O_CONNS, O_PER_CONN = L_CONNS, L_PER_CONN // 2  # O2: half of Path L's traffic
O3_CONNS, O3_PER_CONN = 8, 125  # O3's connections (Path L's mix) while shard 0's primary dies
O_KILL_AFTER = 300      # O3: requests the router has admitted before the SIGKILL
O_HEDGE_SPEC = "shard-slow:shard=0:replica=0:ms=40:times=3"
O5_REQUESTS = 240       # O5: requests under partial_policy allow held against the oracle
O_PARAGRAPH_FILES = 355         # O6: the reference's chapter files (SURVEY §2.2)
O_PARAGRAPHS = 13_400           # ... its paragraphs
O_PARAGRAPH_BYTES = 5_790_000   # ... its bytes
O_PARAGRAPH_DOCS = 20_000       # O6: the manifest cycled (salted) to this many documents


class StampedLines(io.TextIOBase):
    """A stdout that keeps each line with the host-clock second it was
    written at (the ``shard`` subcommand's progress events)."""

    def __init__(self):
        self.lines: list = []
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


def o_child(log: Path, *argv: str, **env_extra) -> subprocess.Popen:
    """The port's CLI in a child (``serve``/``router``): stdout piped for
    its ``listening`` line, stderr appended to ``log``."""
    with open(log, "ab") as errf:
        return subprocess.Popen(
            [sys.executable, "-m", PKG, *argv], cwd=str(ROOT),
            env={**os.environ, "PYTHONPATH": str(ROOT), **env_extra},
            stdout=subprocess.PIPE, stderr=errf, text=True)


def o_ready(proc: subprocess.Popen, log: Path, label: str, t0: float) -> dict:
    line = proc.stdout.readline()
    check(bool(line), f"{label}: died before listening: {log.read_text(errors='replace')[-2000:]}")
    ready = json.loads(line)
    check(ready["event"] == "listening", f"{label}: first line {ready}")
    ready["start_s"] = time.perf_counter() - t0
    return ready


def o_stop(proc: subprocess.Popen, label: str) -> dict | None:
    """SIGTERM a child and read its ``drained`` line (None if it was
    already gone)."""
    drained = None
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            check(proc.wait(timeout=60) == 0, f"{label}: drain exit {proc.returncode}")
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise SmokeFailure(f"{label}: did not drain within 60 s") from None
        tail = proc.stdout.read().strip().splitlines()
        drained = json.loads(tail[-1]) if tail else None
    proc.stdout.close()
    return drained


def o_paragraph_dir(np, synthetic, root: Path, seed: int) -> dict:
    """O6's source: ``O_PARAGRAPH_FILES`` files of blank-line separated
    Zipf paragraphs over a 33,000-word vocabulary (Path A's), each
    paragraph opening with a capital and ending with a full stop, their
    lengths lognormal, about ``O_PARAGRAPH_BYTES`` in all, from ``seed``."""
    rng = np.random.default_rng(seed)
    vocab = synthetic.make_vocab(33_000, seed=seed)
    p = np.arange(1, len(vocab) + 1, dtype=np.float64) ** -1.05
    p /= p.sum()
    word_bytes = float((p * np.array([len(w) for w in vocab])).sum()) + 1.0
    mean_words = O_PARAGRAPH_BYTES / word_bytes / O_PARAGRAPHS
    lens = np.clip(rng.lognormal(np.log(mean_words) - 0.18, 0.6, O_PARAGRAPHS), 3, 2000)
    lens = lens.astype(np.int64)
    ids = rng.choice(len(vocab), size=int(lens.sum()), p=p)
    words = np.array(vocab, dtype=object)[ids]
    ends = np.cumsum(lens)
    paras = [b" ".join(words[e - n:e]).capitalize() + b"." for n, e in zip(lens.tolist(),
                                                                            ends.tolist())]
    root.mkdir(parents=True)
    per = np.array_split(np.arange(len(paras)), O_PARAGRAPH_FILES)
    total = 0
    for i, idx in enumerate(per):
        blob = b"\n\n".join(paras[j] for j in idx.tolist()) + b"\n"
        (root / f"chapter_{i:03d}.txt").write_bytes(blob)
        total += len(blob)
    return {"files": O_PARAGRAPH_FILES, "paragraphs": len(paras), "bytes": total}


def path_o(torch, K, cli, manifest_mod, synthetic, build_index, IndexConfig, oracle_index,
           formatter, list_b: Path, tmp: Path, card: str, device: str = "cuda") -> dict:
    """Path O — the doc-sharded cluster (``cluster/``: host code, as in
    the JAX package) on Path B's corpus, the card's ``DeviceEngine`` the
    reference it is held against.

    O1: ``shard LIST --shards 4 --out CL --verify`` (round-robin, 5,000
    files a shard; ms of each shard's host build, of the global-stats
    pass and of the command); ``--verify-only`` exits 0, and 2 naming
    shard 2 after one byte of its ``docs.list`` is flipped; the monolith
    is Path M4's argv (``8 4 --artifact --backend cpu``).  O2: five
    ``serve`` children (shard 0 on two replicas; no engine named: the
    shard engine) and a ``router`` child; half of Path L's traffic through the
    router, every answer equal to the host ``Engine`` over the monolith
    exactly (BM25 floats included) and to the card's ``DeviceEngine``
    over it (BM25 rel 1e-4, ties in any order); the same traffic against
    one ``serve --engine host`` child over the monolith; requests/s and
    p50/p99 per op of both.  O4: a second router with ``--hedge-ms 5
    --fault-spec`` ``O_HEDGE_SPEC``: hedges and hedge wins, the answers
    unchanged, then its drain.  O3: Path L's mix on ``O3_CONNS``
    connections through the first router while shard 0's first replica
    is SIGKILLed: every request answered once and correctly,
    ``failovers`` >= 1.  O5: shard 1's only replica SIGKILLed: every
    data op a typed ``shard_unavailable`` naming shard 1 under the
    default policy; under ``allow`` each answer ``partial`` with
    ``docs_fraction`` 0.75 and equal to ``ShardRestrictedOracle`` over
    the live shards (BM25 floats included); ``breakers_open`` >= 1 and
    ``top ROUTER --once --json`` showing the dead replica's breaker
    ``open``.  O6: a ``ParagraphManifest`` over a generated paragraph
    directory (the reference's file, paragraph and byte counts), salted
    to ``O_PARAGRAPH_DOCS`` documents, built on the card by the default
    plan and the streaming all-device plan, each md5 equal to
    ``oracle_index``; its vocabulary curve."""
    import threading

    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster import (
        partition as part_mod)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus.realtext import (
        ParagraphManifest)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine, Engine, artifact as TA)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
        ShardRestrictedOracle)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text.tokenizer import (
        MAX_WORD_LETTERS)

    on_card = device == "cuda"
    t_path = time.perf_counter()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    n_docs = len(manifest_mod.read_manifest(list_b))
    out: dict = {"card": card}
    stage_s: dict = {}
    t_stage = [time.perf_counter()]

    def stage(name: str) -> None:
        now = time.perf_counter()
        stage_s[name] = now - t_stage[0]
        t_stage[0] = now

    # -- O1: partition, verify, the monolith ------------------------------------
    cl = tmp / "O_cluster"
    builds: list = []
    real_build = part_mod._build_shard

    def timed_build(*a, **kw):
        t = time.perf_counter()
        try:
            return real_build(*a, **kw)
        finally:
            builds.append((t, time.perf_counter()))

    lines = StampedLines()
    part_mod._build_shard = timed_build
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(lines):
            rc = cli.main(["shard", str(list_b), "--shards", str(O_SHARDS), "--out", str(cl),
                           "--verify"])
        t1 = time.perf_counter()
    finally:
        part_mod._build_shard = real_build
    check(rc == 0, f"path O1 shard: exit {rc}")
    events = {json.loads(line)["event"]: (t, json.loads(line)) for t, line in lines.lines
              if line.startswith("{") and json.loads(line)["event"] != "progress"}
    check(set(events) == {"partitioned", "verified"} and events["verified"][1]["verified"],
          f"path O1: events {sorted(events)}")
    cluster = events["partitioned"][1]
    check(cluster["shards"] == O_SHARDS and cluster["total_docs"] == n_docs,
          f"path O1: {cluster}")
    out["o1"] = {"shard_build_ms": [(b - a) * 1e3 for a, b in builds],
                 "global_stats_ms": (events["partitioned"][0] - builds[-1][1]) * 1e3,
                 "verify_ms": (events["verified"][0] - events["partitioned"][0]) * 1e3,
                 "command_ms": (t1 - t0) * 1e3,
                 "ndocs": cluster["ndocs"], "avgdl": cluster["avgdl"]}
    sides = [json.loads((cl / f"shard-{s}" / "cluster_shard.json").read_text())
             for s in range(O_SHARDS)]
    check([len(sd["gids"]) for sd in sides] == [n_docs // O_SHARDS] * O_SHARDS,
          f"path O1: round-robin shards of {n_docs // O_SHARDS} files")
    out["o1"]["shard_terms"] = [len(sd["global_df"]) for sd in sides]
    # the shard daemons start now: their interpreters load while the
    # checks below and the monolith's build run
    logs = tmp / "O_logs"
    logs.mkdir()
    spec_reps = [2, 1, 1, 1]
    t_start = time.perf_counter()
    shard_procs = [[o_child(logs / f"shard{s}_r{r}.log", "serve", str(cl / f"shard-{s}"),
                            "--listen", "127.0.0.1:0") for r in range(n)]
                   for s, n in enumerate(spec_reps)]
    procs = [p for reps in shard_procs for p in reps]
    routers: list = []
    try:
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            rc = cli.main(["shard", str(list_b), "--shards", str(O_SHARDS), "--out", str(cl),
                           "--verify-only"])
        check(rc == 0, f"path O1 --verify-only: exit {rc}: {err.getvalue()}")
        victim = cl / "shard-2" / "docs.list"
        orig = victim.read_bytes()
        victim.write_bytes(orig[:-2] + bytes([orig[-2] ^ 1]) + orig[-1:])
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            rc = cli.main(["shard", str(list_b), "--shards", str(O_SHARDS), "--out", str(cl),
                           "--verify-only"])
        victim.write_bytes(orig)
        check(rc == 2 and err.getvalue().startswith(
                  "error: shard 2: docs.list does not byte-match"),
              f"path O1 flipped docs.list: exit {rc}: {err.getvalue()}")
        mono = tmp / "O_mono"
        t0 = time.perf_counter()
        rc, _ = run_cli(cli, ["8", "4", str(list_b), "--artifact", "--backend", "cpu",
                              "--output-dir", str(mono)])
        check(rc == 0, f"path O1 monolith: exit {rc}")
        out["o1"]["monolith_ms"] = (time.perf_counter() - t0) * 1e3
        with Engine(mono) as host:
            _, ndocs, avgdl = host._bm25_corpus()
        check((ndocs, avgdl) == (cluster["ndocs"], cluster["avgdl"]),
              f"path O1: global stats {cluster['ndocs']}, {cluster['avgdl']} != the "
              f"monolith's {ndocs}, {avgdl}")
        stage("o1")

        # -- O2: five shard daemons, a router, Path L's traffic -----------------
        t_mono = time.perf_counter()
        mono_proc = o_child(logs / "mono.log", "serve", str(mono), "--engine", "host",
                            "--listen", "127.0.0.1:0")
        procs.append(mono_proc)
        ready = [[o_ready(p, logs / f"shard{s}_r{r}.log", f"path O2 shard {s} replica {r}",
                          t_start) for r, p in enumerate(reps)]
                 for s, reps in enumerate(shard_procs)]
        check(all(r["engine"] == "shard" for reps in ready for r in reps),
              f"path O2: shard daemons' engines {[r['engine'] for rr in ready for r in rr]}")
        spec = ",".join("|".join(f"{r['host']}:{r['port']}" for r in reps) for reps in ready)
        t1 = time.perf_counter()
        r1 = o_child(logs / "router1.log", "router", "--shards", spec,
                     "--listen", "127.0.0.1:0")
        routers.append(r1)

        with TA.load_artifact(mono / "index.mri") as art:
            ranked = [art.term(int(i))
                      for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
        rng = np.random.default_rng(37)
        conns = [l_requests(np, rng, ranked, O_PER_CONN, 1 + i * O_PER_CONN)
                 for i in range(O_CONNS)]
        memo: dict = {}
        host = Engine(mono)
        dev = DeviceEngine(mono / "index.mri", device=device)
        try:
            def expected(r):
                key = json.dumps({k: v for k, v in r.items() if k != "id"}, sort_keys=True)
                if key not in memo:
                    want_h = l_expected(host, r)
                    want_d = l_expected(dev, r)
                    if l_kind(r) == "bm25":
                        check_bm25_ties([tuple(x) for x in want_d["docs"]],
                                        [tuple(x) for x in want_h["docs"]], 1e-4,
                                        f"path O2 the card vs the host on {key}")
                    else:
                        check(want_d == want_h, f"path O2: the card's answer to {key} "
                              f"{json.dumps(want_d)[:200]} != the host's "
                              f"{json.dumps(want_h)[:200]}")
                    memo[key] = want_h
                return memo[key]

            def exact(got: dict, want: dict, label: str) -> None:
                got = {k: v for k, v in got.items() if k not in ("id", "trace_id")}
                check(got == want, f"{label}: {json.dumps(got)[:300]} != "
                      f"{json.dumps(want)[:300]}")

            t_ref = time.perf_counter()
            want = [[expected(r) for r in c] for c in conns]
            out["reference_s"] = time.perf_counter() - t_ref
            out["distinct_requests"] = len(memo)
            mono_ready = o_ready(mono_proc, logs / "mono.log", "path O2 monolith serve", t_mono)
            check(mono_ready["engine"] == "host",
                  f"path O2: monolith engine {mono_ready['engine']}")
            r1_ready = o_ready(r1, logs / "router1.log", "path O2 router", t1)
            check(r1_ready["shards"] == O_SHARDS and r1_ready["replicas"] == spec_reps,
                  f"path O2 router: {r1_ready}")
            r1_addr = (r1_ready["host"], r1_ready["port"])
            # each child's seconds from its spawn to its listening line (the
            # shard daemons' overlap O1's checks and monolith build, the
            # router's and the monolith daemon's the reference answers)
            out["start_s"] = {"shards": [[r["start_s"] for r in reps] for reps in ready],
                              "monolith": mono_ready["start_s"],
                              "router": r1_ready["start_s"]}
            stage("o2_start_and_reference")
            legs = {}
            for name, addr in (("router", r1_addr),
                               ("monolith", (mono_ready["host"], mono_ready["port"]))):
                (tmp / f"O2_{name}").mkdir()
                t_leg = time.perf_counter()
                answers, lat, wall = l_traffic(addr, conns, tmp / f"O2_{name}")
                leg_s = time.perf_counter() - t_leg
                for got_c, want_c in zip(answers, want):
                    for got, w in zip(got_c, want_c):
                        exact(got, w, f"path O2 {name}")
                n_req = sum(len(c) for c in conns)
                # leg_s: the clients' spawn, connect, traffic and exit
                legs[name] = {"requests": n_req, "wall_s": wall, "requests_per_s": n_req / wall,
                              "leg_s": leg_s, "client_ms": l_quantiles(np, lat)}
            out["o2"] = legs
            with contextlib.closing(LClient(r1_addr)) as c:
                st = c.rpc(op="stats")["stats"]
            out["o2"]["router_counters"] = {k: v for k, v in st["counters"].items() if v}
            out["o2"]["result_cache"] = st["result_cache"]
            stage("o2_traffic")

            # -- O4: a second router, hedging a slowed replica -------------------
            t1 = time.perf_counter()
            r2 = o_child(logs / "router2.log", "router", "--shards", spec, "--listen",
                         "127.0.0.1:0", "--hedge-ms", "5", "--fault-spec", O_HEDGE_SPEC)
            routers.append(r2)
            r2_ready = o_ready(r2, logs / "router2.log", "path O4 router", t1)
            r2_addr = (r2_ready["host"], r2_ready["port"])
            hedge_terms = [t.decode() for t in ranked[:2]]
            hedge_want = expected({"op": "df", "terms": hedge_terms})
            with contextlib.closing(LClient(r2_addr)) as c:
                for i in range(3):
                    exact(c.rpc(id=i, op="df", terms=hedge_terms), hedge_want, "path O4 df")
                deadline = time.monotonic() + 5.0
                while True:
                    hc = c.rpc(op="stats")["stats"]["counters"]
                    if hc["hedges"] >= 1 and hc["hedge_wins"] >= 1 \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.02)
            check(hc["hedges"] >= 1 and hc["hedge_wins"] >= 1,
                  f"path O4: hedges {hc['hedges']}, hedge wins {hc['hedge_wins']}")
            drained = o_stop(r2, "path O4 router")
            routers.remove(r2)
            check(drained is not None and drained["event"] == "drained",
                  f"path O4 router: no drained line ({drained})")
            out["o4"] = {"hedges": hc["hedges"], "hedge_wins": hc["hedge_wins"],
                         "scatter_rpcs": hc["scatter_rpcs"], "start_s": r2_ready["start_s"]}
            stage("o4")

            # -- O3: shard 0's first replica SIGKILLed mid-traffic ----------------
            rng3 = np.random.default_rng(41)
            conns3 = [l_requests(np, rng3, ranked, O3_PER_CONN, 100_000 + i * O3_PER_CONN)
                      for i in range(O3_CONNS)]
            want3 = [[expected(r) for r in c] for c in conns3]
            with contextlib.closing(LClient(r1_addr)) as c:
                base = c.rpc(op="stats")["stats"]["counters"]
            res3: dict = {}

            def traffic3():
                try:
                    (tmp / "O3").mkdir()
                    res3["out"] = l_traffic(r1_addr, conns3, tmp / "O3")
                except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                    res3["error"] = e

            th = threading.Thread(target=traffic3)
            th.start()
            killed_at = None
            with contextlib.closing(LClient(r1_addr)) as c:
                deadline = time.monotonic() + 120
                while th.is_alive() and time.monotonic() < deadline:
                    now = c.rpc(op="stats")["stats"]["counters"]
                    if now["requests"] - base["requests"] >= O_KILL_AFTER:
                        shard_procs[0][0].send_signal(signal.SIGKILL)
                        killed_at = now["requests"] - base["requests"]
                        break
                    time.sleep(0.002)
            th.join(timeout=600)
            check(not th.is_alive() and "error" not in res3,
                  f"path O3 traffic: {res3.get('error')}")
            check(killed_at is not None, "path O3: the traffic ended before the kill")
            shard_procs[0][0].wait(timeout=30)
            answers, lat, wall = res3["out"]
            n3 = 0
            for got_c, want_c in zip(answers, want3):
                check(len(got_c) == len(want_c), "path O3: a connection lost answers")
                for got, w in zip(got_c, want_c):
                    exact(got, w, "path O3 acknowledged answer")
                    n3 += 1
            with contextlib.closing(LClient(r1_addr)) as c:
                after = c.rpc(op="stats")["stats"]
            fo = after["counters"]["failovers"] - base["failovers"]
            check(fo >= 1, f"path O3: failovers {fo}")
            out["o3"] = {"requests": n3, "killed_after_requests": killed_at,
                         "failovers": fo,
                         "shard_errors": after["counters"]["shard_errors"]
                         - base["shard_errors"],
                         "requests_per_s": n3 / wall, "client_ms": l_quantiles(np, lat)}
            stage("o3")

            # -- O5: every replica of shard 1 SIGKILLed -----------------------------
            shard_procs[1][0].send_signal(signal.SIGKILL)
            shard_procs[1][0].wait(timeout=30)
            probe = [t.decode() for t in ranked[:3]]
            data_ops = [{"op": "df", "terms": probe}, {"op": "postings", "terms": probe},
                        {"op": "and", "terms": probe[:2]}, {"op": "or", "terms": probe},
                        {"op": "top_k", "terms": probe, "k": 10, "score": "bm25"},
                        {"op": "top_k", "letter": "s", "k": 10}]
            oracle = ShardRestrictedOracle.round_robin(host, O_SHARDS, covered={0, 2, 3})
            rng5 = np.random.default_rng(43)
            reqs5 = data_ops + l_requests(np, rng5, ranked, O5_REQUESTS, 200_000)
            n5 = 0
            with contextlib.closing(LClient(r1_addr)) as c:
                for i, r in enumerate(data_ops):
                    got = c.rpc(id=i, **r)
                    check(got.get("error") == "shard_unavailable" and got.get("shard") == 1,
                          f"path O5 fail policy {r}: {got}")
                t5 = time.perf_counter()
                for r in reqs5:
                    got = c.rpc(partial_policy="allow", **r)
                    check(got.get("ok") and got.get("partial") is True
                          and got["coverage"] == {"shards_answered": 3, "shards_total": 4,
                                                  "missing": [1], "docs_fraction": 0.75},
                          f"path O5 allow {r}: {json.dumps(got)[:300]}")
                    got = {k: v for k, v in got.items() if k not in ("partial", "coverage")}
                    exact(got, l_expected(oracle, r), f"path O5 partial vs the oracle {r}")
                    n5 += 1
                allow_s = time.perf_counter() - t5
                deadline = time.monotonic() + 15
                while c.rpc(op="stats")["stats"]["cluster"]["breakers_open"] < 1:
                    check(time.monotonic() < deadline, "path O5: no breaker opened")
                    c.rpc(op="df", terms=probe, partial_policy="allow")
                    time.sleep(0.05)
            target = f"{r1_addr[0]}:{r1_addr[1]}"
            deadline = time.monotonic() + 10
            while True:
                rc, sample = run_cli(cli, ["top", target, "--once", "--json"])
                check(rc == 0 and sample is not None, f"path O5 top: exit {rc}")
                breaker = sample["stats"]["cluster"]["shards"][1]["replicas"][0]["breaker"]
                if breaker == "open" or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            check(breaker == "open", f"path O5: top shows shard 1's breaker {breaker}")
            frame = io.StringIO()
            with contextlib.redirect_stdout(frame):
                check(cli.main(["top", target, "--once"]) == 0, "path O5 top frame")
            check("coverage: 3/4 shards answerable  [DEGRADED]" in frame.getvalue(),
                  f"path O5 top frame: {frame.getvalue()[-600:]}")
            out["o5"] = {"allow_requests": n5, "allow_ms_per_request": allow_s * 1e3 / n5,
                         "breakers_open": sample["stats"]["cluster"]["breakers_open"],
                         "shard1_breaker": breaker}
        finally:
            host.close()
            dev.close()
        drained = o_stop(routers.pop(), "path O router")
        check(drained is not None and drained["event"] == "drained",
              f"path O router: no drained line ({drained})")
        out["router_drained_counters"] = {k: v for k, v in drained["counters"].items() if v}
        stage("o5")
    finally:
        for p in routers + procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if not p.stdout.closed:
                p.stdout.close()

    # -- O6: the paragraph corpus on the card ------------------------------------
    launches = {"unique_mask_count": K.unique_mask_count.launches,
                "bucket_histogram": K.bucket_histogram.launches}
    out["max_memory_allocated_o1_o5"] = torch.cuda.max_memory_allocated() if on_card else None
    src = tmp / "O_paragraphs"
    out["o6_source"] = o_paragraph_dir(np, synthetic, src, seed=47)
    t0 = time.perf_counter()
    m = ParagraphManifest(src, num_docs=O_PARAGRAPH_DOCS, salt_cycles=True)
    out["o6_source"].update(manifest_ms=(time.perf_counter() - t0) * 1e3,
                            source_paragraphs=m.source_paragraphs, docs=len(m),
                            manifest_bytes=m.total_bytes)
    check(m.source_files == O_PARAGRAPH_FILES and len(m) == O_PARAGRAPH_DOCS,
          f"path O6 manifest: {m.source_files} files, {len(m)} docs")
    t0 = time.perf_counter()
    oracle_index(m, str(tmp / "O6_oracle"))
    out["o6_source"]["oracle_ms"] = (time.perf_counter() - t0) * 1e3
    md5_oracle = formatter.letters_md5(tmp / "O6_oracle")
    for name, cfg in (("default", IndexConfig(num_mappers=4, num_reducers=26, device=device)),
                      ("stream_all_device", IndexConfig(num_mappers=4, num_reducers=26,
                                                        device_tokenize=True,
                                                        stream_chunk_docs=2500,
                                                        device=device))):
        s, leg = drive_path(torch, K, formatter,
                            lambda cfg=cfg, name=name: build_index(
                                m, cfg, output_dir=str(tmp / f"O6_{name}")),
                            tmp / f"O6_{name}", f"path O6 {name}")
        check(s["md5"] == md5_oracle, f"path O6 {name}: md5 {s['md5']} != oracle {md5_oracle}")
        check("device_tokenize_fallback" not in s, f"path O6 {name}: fell back")
        print_path(f"path_o6_{name}", s, leg, oracle_md5=md5_oracle, card=repr(card))
        out[f"o6_{name}"] = {"total_ms": s["total_ms"], "unique_terms": s["unique_terms"],
                             "max_memory_allocated": s["max_memory_allocated"],
                             "unique_rows_curve": s.get("unique_rows_curve")}
        launches = {k: launches[k] + leg[k] for k in launches}
    # the vocabulary curve: distinct cleaned words after each 2,500
    # documents (the streaming plan's windows), by the reference's rule
    keep = set(range(97, 123))
    drop = bytes(b for b in range(256) if b not in keep)
    seen: set = set()
    curve = []
    for lo in range(0, len(m), 2500):
        for i in range(lo, min(lo + 2500, len(m))):
            for tok in m.read_doc(i).lower().split():
                w = tok.translate(None, drop)[:MAX_WORD_LETTERS]
                if w:
                    seen.add(w)
        curve.append(len(seen))
    check(curve[-1] == out["o6_default"]["unique_terms"] == out["o6_stream_all_device"][
        "unique_terms"], f"path O6: vocabulary curve {curve} against the builds' unique terms")
    out["o6_vocab_curve"] = curve
    stage("o6")

    out["launches"] = launches
    out["stage_s"] = stage_s
    out["seconds"] = time.perf_counter() - t_path
    print(f"phase path_o: card={card} {json.dumps(out)}", flush=True)
    return launches


# -- Path P: the multi-process mesh ------------------------------------------

P_CHILD_TIMEOUT_S = 600
P_STREAM_CHUNK_DOCS = 2500  # Path F's windows


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stop_all(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def launch_counts(K) -> dict:
    """This process's launches of each kernel of ``csrc/`` since the last
    ``K.reset_launch_counts()``."""
    return {"unique_mask_count": K.unique_mask_count.launches,
            "bucket_histogram": K.bucket_histogram.launches}


def add_launches(counts) -> dict:
    """The sum of several :func:`launch_counts`."""
    total = {"unique_mask_count": 0, "bucket_histogram": 0}
    for c in counts:
        for name in total:
            total[name] += c[name]
    return total


def p_child(argv: list[str]) -> int:
    """One process of a Path P group: join it, then run each leg in turn
    (all processes start a leg together, after a barrier) under
    torch.profiler (device activity only); each leg's trace and result
    JSON (with this process's kernel launches in the leg) go under
    ``<root>/<leg>/``."""
    pid, world, coord, legs, list_b, root, gate = argv
    t_entry = time.time()
    import numpy as np
    import torch
    import torch.distributed as dist

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
        IndexConfig, InvertedIndexModel, read_manifest)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        kernels as K)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
        distributed)

    t_imported = time.time()
    manifest = read_manifest(list_b)
    torch.cuda.init()
    t_ready = time.time()
    while gate and not Path(gate).exists():  # a later group starts up early, then waits
        time.sleep(0.05)
    t_gate = time.time()
    distributed.initialize(coord, int(world), int(pid))
    info = distributed.runtime_info()
    setup = {"imports_s": t_imported - t_entry, "manifest_and_cuda_s": t_ready - t_imported,
             "gate_wait_s": t_gate - t_ready, "initialize_s": time.time() - t_gate}
    for leg in legs.split(","):
        out_dir = Path(root) / leg
        torch.cuda.reset_peak_memory_stats()
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.start()
        dist.barrier()
        K.reset_launch_counts()
        t_start = time.time()
        if leg == "P3":
            report = p3_stream(np, manifest, out_dir / "out")
        else:
            cfg = dict(num_mappers=4, num_reducers=26, device_shards=4,
                       emit_ownership="letter", output_dir=str(out_dir / "out"),
                       device_tokenize=leg in ("P1", "P4"))
            report = InvertedIndexModel(IndexConfig(**cfg)).run(manifest)
        torch.cuda.synchronize()
        t_end = time.time()
        launches = launch_counts(K)
        profiler.stop()
        profiler.export_chrome_trace(str(out_dir / f"trace{pid}.json"))
        keep = ("phases_ms", "total_ms", "letter_owners", "lines_written", "unique_pairs",
                "dist_sent_bytes", "dist_fetched_bytes", "dist_valid_pairs",
                "exchange_retries", "stream_windows", "merge_retries",
                "accumulator_capacity_per_owner", "owners", "upload_windows")
        (out_dir / f"result{pid}.json").write_text(json.dumps({
            "info": info, "setup": setup, "t_start": t_start, "t_end": t_end,
            "wall_ms": (t_end - t_start) * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
            "report": {k: report[k] for k in keep if k in report}}))
    return 0


def p3_stream(np, manifest, out_dir: Path) -> dict:
    """P3 in one process: ``DistDeviceStreamEngine`` over Path F's
    windows (the model's window packing), this process's owner blocks
    saved as ``owner<o>.npz``."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        manifest as manifest_mod, scheduler)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
        inverted_index as model)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        device_tokenizer as DT)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
        dist_device_streaming as DDS, mesh as M)

    n, width, pad = 4, 48, 1 << 16  # the model's defaults
    mesh = M.make_mesh(n, "cuda")
    eng = DDS.DistDeviceStreamEngine(width=width, mesh=mesh)
    for contents, ids in manifest_mod.iter_document_chunks(manifest, P_STREAM_CHUNK_DOCS):
        parts = [(contents[lo:hi], ids[lo:hi])
                 for lo, hi in scheduler.plan_contiguous_ranges([len(c) for c in contents], n)]
        shard_len = round_up(max(max((sum(len(c) for c in cs) for cs, _ in parts),
                                     default=1), 1), pad)
        docs_cap = max(max(len(c) for c, _ in parts), 1)
        bufs, ends_l, ids_l = [], [], []
        tok_count = max_len = 0
        for contents_s, ids_s in parts:
            buf, ends, idv = model._pack_window(contents_s, ids_s, shard_len, docs_cap)
            cnt, ml = DT.host_token_stats(buf, ends)
            tok_count, max_len = max(tok_count, cnt), max(max_len, ml)
            bufs.append(buf)
            ends_l.append(ends)
            ids_l.append(idv)
        check(max_len <= width, f"P3: a {max_len}-letter word in Path B's corpus")
        eng.feed(bufs, ends_l, ids_l, tok_count=tok_count, max_len=max_len)
    stats: dict = {}
    owners = eng.finalize(sort_cols=-(-max(eng.max_word_len, 1) // 4),
                          max_doc_id=len(manifest), stats=stats)
    for o, ow in owners.items():
        np.savez(out_dir / f"owner{o}.npz", words=DT.decode_word_groups(ow["unique_groups"], width),
                 df=ow["df"], postings=ow["postings"])
    return {"owners": sorted(owners), "stream_windows": eng.windows_fed,
            "merge_retries": eng.merge_retries, "accumulator_capacity_per_owner": eng.capacity,
            "unique_pairs": sum(ow["num_pairs"] for ow in owners.values()),
            "dist_sent_bytes": mesh.sent_bytes, **stats}


def p3_letters(np, formatter, blocks_dir: Path, out_dir: Path, max_doc_id: int) -> None:
    """The union of P3's owner blocks written as letter files (the merged
    emit of the mesh device plans), so that its md5 holds the union
    against Path B's pairs and df."""
    vocab, df, post = [], [], []
    for f in sorted(blocks_dir.glob("owner*.npz")):
        blk = np.load(f)
        vocab.append(blk["words"])
        df.append(blk["df"].astype(np.int64))
        post.append(blk["postings"].astype(np.int32))
    width = max(v.dtype.itemsize for v in vocab)
    vocab = np.concatenate([v.astype(f"S{width}") for v in vocab])
    df64 = np.concatenate(df)
    offsets = np.cumsum(df64) - df64  # blocks concatenated in owner order
    letters = vocab.view(np.uint8).reshape(len(vocab), width)[:, 0].astype(np.int64) - ord("a")
    formatter.emit_index(out_dir, vocab=vocab, letter_of_term=letters,
                         order=np.lexsort((vocab, -df64, letters)), df=df64, offsets=offsets,
                         postings=np.concatenate(post), max_doc_id=max_doc_id,
                         backend="native")


def p_start(legs: tuple, world: int, list_b: Path, root: Path, gate: Path | None = None
            ) -> dict:
    """Start one Path P group: ``world`` children (``p_child``) that join
    at a free port and run ``legs`` in turn; with ``gate`` they start up
    and wait for that file before joining."""
    for leg in legs:
        (root / leg / "out").mkdir(parents=True)
    coord = f"127.0.0.1:{free_port()}"
    group = {"legs": legs, "world": world, "t_popen": time.time(), "procs": [], "logs": []}
    for pid in range(world):
        group["logs"].append(root / f"{'_'.join(legs)}_proc{pid}.log")
        with open(group["logs"][-1], "wb") as f:
            group["procs"].append(subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                 "import chip_smoke; sys.exit(chip_smoke.p_child(sys.argv[2:]))", str(ROOT),
                 str(pid), str(world), coord, ",".join(legs), str(list_b), str(root),
                 str(gate or "")],
                cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT))
    return group


def p_finish(torch, np, formatter, group: dict, root: Path, md5_c: str, card: str) -> dict:
    """Wait for a group's children (each must exit 0 within
    P_CHILD_TIMEOUT_S of its start), then check and print each leg
    (:func:`p_check_leg`)."""
    legs, world = group["legs"], group["world"]
    for pid, p in enumerate(group["procs"]):
        left = P_CHILD_TIMEOUT_S - (time.time() - group["t_popen"])
        wait_child(p, group["logs"][pid], f"path P {legs} process {pid}", timeout=max(left, 1))
    for pid, p in enumerate(group["procs"]):
        check(p.returncode == 0, f"path P {legs} process {pid} exit {p.returncode}: "
              f"{group['logs'][pid].read_text(errors='replace')[-3000:]}")
    return {leg: p_check_leg(torch, np, formatter, leg, world, root / leg, md5_c, card,
                             group["t_popen"])
            for leg in legs}


def p_check_leg(torch, np, formatter, leg: str, world: int, leg_dir: Path, md5_c: str,
                card: str, t_popen: float) -> dict:
    """A Path P leg's checks (each process's runtime info and owners, the
    backend by the rule, the md5 against Path C's, bytes sent) and its
    line: per process its wall, peak device memory, device-busy ms,
    bytes sent and kernel launches; the card's busy share, the processes'
    device-busy ms summed over the leg's wall (without MPS the card runs
    one process's context at a time).  Returns the leg's md5, wall, lines
    and its processes' launches summed."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
        distributed)

    results = [json.loads((leg_dir / f"result{pid}.json").read_text()) for pid in range(world)]
    for pid, r in enumerate(results):
        r["device_busy_ms"] = device_busy(leg_dir / f"trace{pid}.json")["ms"]
        check(r["info"]["process_count"] == world and r["info"]["process_index"] == pid,
              f"path {leg} process {pid}: runtime_info {r['info']}")
    want_backend = distributed.choose_backend(world, torch.cuda.device_count())
    check({r["info"]["backend"] for r in results} == {want_backend},
          f"path {leg}: backends {[r['info']['backend'] for r in results]}, "
          f"want {want_backend}")
    if leg == "P3":
        owners = [r["report"]["owners"] for r in results]
        check(owners == [[0, 1], [2, 3]], f"path P3: owners by process {owners}")
        check(all(r["report"]["accumulator_capacity_per_owner"] > 1 << 15 for r in results),
              "path P3: no accumulator regrow")
        p3_letters(np, formatter, leg_dir / "out", leg_dir / "letters", 20_000)
        md5 = formatter.letters_md5(leg_dir / "letters")
    else:
        md5 = formatter.letters_md5(leg_dir / "out")
        check(all(r["report"]["letter_owners"] == 4 for r in results),
              f"path {leg}: letter_owners {[r['report'].get('letter_owners') for r in results]}")
    check(md5 == md5_c, f"path {leg} md5 {md5} != path C {md5_c}")
    if world > 1:
        check(all(r["report"].get("dist_sent_bytes", 0) > 0 for r in results),
              f"path {leg}: a process sent nothing through all_to_all_single")
    wall_ms = (max(r["t_end"] for r in results) - min(r["t_start"] for r in results)) * 1e3
    busy = [r["device_busy_ms"] for r in results]
    share = sum(busy) / wall_ms if None not in busy else "not measured"
    procs_line = [{"process": pid, "wall_ms": round(r["wall_ms"], 3),
                   "max_memory_allocated": r["max_memory_allocated"],
                   "device_busy_ms": r["device_busy_ms"],
                   "all_to_all_single_bytes_sent": r["report"].get("dist_sent_bytes", 0),
                   "launches": r["launches"],
                   # the process's start: interpreter to the leg's barrier
                   # (P4's includes its wait for the first group)
                   "setup": {k: round(v, 3) for k, v in r["setup"].items()},
                   "start_s": round(r["t_start"] - t_popen, 3),
                   "report": r["report"]} for pid, r in enumerate(results)]
    print(f"phase path_{leg.lower()}: card={card} backend={want_backend} world={world} "
          f"md5={md5} leg_wall_ms={wall_ms:.3f} card_busy_share={share} "
          f"processes={json.dumps(procs_line)}", flush=True)
    return {"md5": md5, "wall_ms": wall_ms, "processes": procs_line,
            "launches": add_launches(r["launches"] for r in results)}


def path_p(torch, formatter, list_b: Path, tmp: Path, md5_c: str, card: str) -> dict:
    """Path P — the multi-process mesh on Path B's corpus: P1 the
    all-device plan with letter ownership, P2 the pipelined plan with
    letter ownership, P3 ``DistDeviceStreamEngine`` over Path F's windows,
    in turn in one group of two processes (gloo: they share the card)
    with 2 local shards each; P4 P1's build in a one-process group (NCCL,
    4 local shards).  Returns the children's kernel launches in their
    legs, summed (the path launches no kernel of ``csrc/``)."""
    import numpy as np

    t0 = time.perf_counter()
    root = tmp / "P"
    gloo = p_start(("P1", "P2", "P3"), 2, list_b, root)
    # P4's process starts up beside the first group and joins when it ends
    nccl = p_start(("P4",), 1, list_b, root, gate=root / "go_P4")
    try:
        legs = p_finish(torch, np, formatter, gloo, root, md5_c, card)
        (root / "go_P4").touch()
        legs.update(p_finish(torch, np, formatter, nccl, root, md5_c, card))
    finally:  # a failed group leaves no process behind
        stop_all(gloo["procs"] + nccl["procs"])
    launches = add_launches(leg["launches"] for leg in legs.values())
    print(f"phase path_p_done: card={card} seconds={time.perf_counter() - t0:.1f} "
          f"legs={list(legs)} launches={launches}", flush=True)
    check(not any(launches.values()), f"path P launched a kernel of csrc/: {launches}")
    return launches


# -- Path Q: the sanitized native builds on the host -------------------------

Q_VARIANTS = ("asan", "ubsan")
Q_REPORTS = ("ERROR: AddressSanitizer", "runtime error:", "SUMMARY: AddressSanitizer",
             "SUMMARY: UndefinedBehaviorSanitizer", "LeakSanitizer")
Q_CHILD_TIMEOUT_S = 600


def q_env(variant: str) -> dict:
    """The environment of a sanitized child: the variant, and for asan
    libasan preloaded, no leak check and no shadow-gap protection (CUDA's
    libraries map memory there); no card (the host backend never needs
    one)."""
    extra = {"MRI_NATIVE_SANITIZE": variant, "CUDA_VISIBLE_DEVICES": ""}
    if variant == "asan":
        libasan = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                                 text=True, timeout=60, check=True).stdout.strip()
        extra.update(LD_PRELOAD=libasan, ASAN_OPTIONS="detect_leaks=0:protect_shadow_gap=0")
    return {**os.environ, **extra}


def start_sanitized_builds() -> dict:
    """Both sanitized libraries built in the background (``g++``, one
    process each, while the kernels build): ``{variant: process}``, each
    printing its library's name and build seconds."""
    return {variant: subprocess.Popen(
        [sys.executable, "-c", "import sys, time; sys.path.insert(0, sys.argv[1]); "
         "from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch "
         "import native; t = time.perf_counter(); so = native._compile(sys.argv[2]); "
         "print(so.name, time.perf_counter() - t)", str(ROOT), variant],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for variant in Q_VARIANTS}


def q_mix(np, artifact: Path, seed: int = 1066) -> dict:
    """Path I's query mix on ``artifact``: Zipf batches of 1, 32, 1024
    and 8192 words, five queries each of 2, 3 and 5 present words."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        Engine)

    rng = np.random.default_rng(seed)
    with env(MRI_SERVE_NATIVE="0"), Engine(artifact) as eng:
        art = eng.artifact
        ranked = [art.term(int(i)) for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
        batches = {n: zipf_terms(np, rng, ranked, n) for n in SERVE_BATCHES}
        queries = {}
        for arity in (2, 3, 5):
            qs = []
            while len(qs) < 5:
                q = [w for w in dict.fromkeys(zipf_terms(np, rng, ranked, arity * 3))
                     if int(eng.df(eng.encode_batch([w]))[0]) > 0]
                if len(q) >= arity:
                    qs.append(q[:arity])
            queries[arity] = qs
    return {"batches": batches, "queries": queries}


def q_answers(artifact: Path, mix: dict) -> dict:
    """md5 of each answer of the host ``Engine`` (native kernels
    required) to ``mix``: df, lookup and postings per batch, AND/OR per
    query, top_k of three letters, BM25 top-10 per planner."""
    import hashlib

    import numpy as np

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        Engine)

    def md5(*arrays) -> str:
        h = hashlib.md5()
        for a in arrays:
            h.update(b"None" if a is None else np.ascontiguousarray(a).tobytes() + b"|")
        return h.hexdigest()

    out = {}
    with env(MRI_SERVE_NATIVE="1"), Engine(artifact) as host:
        for n, words in mix["batches"].items():
            b = host.encode_batch(words)
            idx, found = host.lookup(b)
            out[f"df@{n}"] = md5(host.df(b))
            out[f"lookup@{n}"] = md5(idx[found], found)
            out[f"postings@{n}"] = md5(*host.postings(b))
        for arity, qs in mix["queries"].items():
            for j, q in enumerate(qs):
                b = host.encode_batch(q)
                out[f"and@{arity}.{j}"] = md5(host.query_and(b))
                out[f"or@{arity}.{j}"] = md5(host.query_or(b))
                for planner in PLANNERS:
                    with env(MRI_SERVE_PLANNER=planner):
                        out[f"bm25_{planner}@{arity}.{j}"] = repr(
                            bm25_bits(host.top_k_scored(b, 10)))
        for letter in ("a", "m", "z"):
            out[f"top_k@{letter}"] = repr(host.top_k(letter, 10))
        nat = host.describe()["native"]
        check(nat["active"] and nat["fallbacks"] == 0 and nat["ops"] > 0,
              f"path Q: native block {nat}")
    return out


def q_child(argv: list[str]) -> int:
    """One Path Q variant in this (sanitized) process: load the variant's
    library, Path M1's host build on Path A's corpus, the host engine
    over the query mix; one JSON line, with this process's kernel
    launches in the two."""
    variant, list_a, out_dir, artifact, mix_path = argv
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
        cli, native)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        kernels as K)
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
        formatter)

    t = time.perf_counter()
    check(native.load() is not None, f"path Q {variant}: {native.load_error()}")
    so = native._compile(variant)
    check(native._SO_NAME_RE[variant].match(so.name) is not None,
          f"path Q {variant}: loaded {so.name}")
    load_s = time.perf_counter() - t
    K.reset_launch_counts()
    t = time.perf_counter()
    rc, stats = run_cli(cli, ["1", "1", list_a, "--host-threads", "1", "--backend", "cpu",
                              "--stats", "--output-dir", out_dir])
    check(rc == 0 and stats is not None and "cpu_fallback" not in stats,
          f"path Q {variant} M1: exit {rc}, {stats and stats.get('cpu_fallback')}")
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    mix = json.loads(Path(mix_path).read_text())
    mix["batches"] = {int(n): w for n, w in mix["batches"].items()}
    answers = q_answers(Path(artifact), mix)
    print(json.dumps({"library": so.name, "load_s": load_s, "m1_s": build_s,
                      "m1_total_ms": stats["total_ms"], "engine_s": time.perf_counter() - t,
                      "md5": formatter.letters_md5(out_dir), "answers": answers,
                      "launches": launch_counts(K)}), flush=True)
    return 0


def path_q(list_a: Path, md5_a: str, artifact: Path, tmp: Path, card: str,
           builds: dict) -> dict:
    """Path Q — the sanitized native builds on this machine's host: per
    variant (asan, ubsan) a child loads the build started by
    :func:`start_sanitized_builds`, runs Path M1's ``--backend cpu`` build
    on Path A's corpus (md5 equal to Path A's) and the host ``Engine``
    over Path I's query mix on ``artifact`` (every answer equal to this
    process's production library's); any sanitizer report fails.  Returns
    the children's kernel launches, summed (they see no card)."""
    import numpy as np

    t0 = time.perf_counter()
    build_s = {}
    for variant, proc in builds.items():
        try:
            text = proc.communicate(timeout=Q_CHILD_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            stop_all([proc])
            raise SmokeFailure(f"path Q {variant} build hung past {Q_CHILD_TIMEOUT_S} s")
        check(proc.returncode == 0, f"path Q {variant} build: exit {proc.returncode}: "
              f"{text[-3000:]}")
        build_s[variant] = float(text.split()[-1])
    mix = q_mix(np, artifact)
    (tmp / "Q_mix.json").write_text(json.dumps(mix))
    want = q_answers(artifact, mix)
    procs = {}
    for variant in Q_VARIANTS:
        (tmp / f"Q_{variant}_out").mkdir()
        log = tmp / f"Q_{variant}.log"
        with open(log, "wb") as f:
            procs[variant] = (subprocess.Popen(
                [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                 "import chip_smoke; sys.exit(chip_smoke.q_child(sys.argv[2:]))", str(ROOT),
                 variant, str(list_a), str(tmp / f"Q_{variant}_out"), str(artifact),
                 str(tmp / "Q_mix.json")],
                cwd=str(ROOT), env=q_env(variant), stdout=f, stderr=subprocess.STDOUT), log,
                time.perf_counter())
    out = {}
    try:
        for variant, (proc, log, t1) in procs.items():
            wait_child(proc, log, f"path Q {variant}", timeout=Q_CHILD_TIMEOUT_S)
            run_s = time.perf_counter() - t1
            text = log.read_text(errors="replace")
            reports = [r for r in Q_REPORTS if r in text]
            check(proc.returncode == 0 and not reports,
                  f"path Q {variant}: exit {proc.returncode}, reports {reports}: {text[-4000:]}")
            got = json.loads(text.strip().splitlines()[-1])
            check(got["md5"] == md5_a, f"path Q {variant} M1 md5 {got['md5']} != path A {md5_a}")
            diff = sorted(k for k in want if got["answers"].get(k) != want[k])
            check(not diff and len(got["answers"]) == len(want),
                  f"path Q {variant}: answers differ from the production build's: {diff[:8]}")
            out[variant] = {"library": got["library"], "build_s": round(build_s[variant], 3),
                            "run_s": round(run_s, 3), "load_s": round(got["load_s"], 3),
                            "m1_s": round(got["m1_s"], 3), "m1_total_ms": got["m1_total_ms"],
                            "engine_s": round(got["engine_s"], 3), "answers": len(want),
                            "launches": got["launches"]}
    finally:
        stop_all(proc for proc, _, _ in procs.values())
    launches = add_launches(v["launches"] for v in out.values())
    print(f"phase path_q: card={card} host={host_cpu()} md5={md5_a} "
          f"variants={json.dumps(out)} seconds={time.perf_counter() - t0:.1f}", flush=True)
    check(not any(launches.values()), f"path Q launched a kernel of csrc/: {launches}")
    return launches


def multiprocess_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card: str,
                          kind: str) -> int:
    """``--multiprocess-only``: Path C (the default build on Path B's
    corpus, whose md5 Path P must give) and Path P alone."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_c, launches_c = drive_path(
            torch, K, formatter, cli_run(cli, "path C", list_b, tmp / "C_out", []),
            tmp / "C_out", "path C")
        check_pipelined(stats_c, "path C")
        print_path("path_c", stats_c, launches_c, card=repr(card))
        path_p(torch, formatter, list_b, tmp, stats_c["md5"], card)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def sanitize_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card: str,
                      kind: str, sanitized: dict) -> int:
    """``--sanitize-only``: Path A's corpus and its oracle md5, the
    default build with ``--artifact`` on Path B's corpus (Path H's v2.1
    artifact) and Path Q alone."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_a = write_corpus_dir(synthetic, manifest_mod, tmp / "A", synthetic.zipf_corpus(
            num_docs=355, vocab_size=33_000, tokens_per_doc=2900, seed=7))
        rc, _ = run_cli(cli, ["4", "26", str(list_a), "--backend", "oracle",
                              "--output-dir", str(tmp / "A_oracle")])
        check(rc == 0, f"path A oracle: exit {rc}")
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_h, launches_h = drive_path(
            torch, K, formatter, cli_run(cli, "path H", list_b, tmp / "H_out", ["--artifact"]),
            tmp / "H_out", "path H")
        print_path("path_h", stats_h, launches_h, card=repr(card))
        path_q(list_a, formatter.letters_md5(tmp / "A_oracle"), tmp / "H_out" / "index.mri",
               tmp, card, sanitized)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def cluster_only_run(torch, K, cli, formatter, synthetic, manifest_mod, build_index,
                     IndexConfig, oracle_index, card: str, kind: str) -> int:
    """``--cluster-only``: the default build with ``--artifact`` on Path
    B's corpus (Path H's v2.1 artifact) and Path O alone, for iterating
    on the cluster; the run with no arguments drives every path."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_h, launches_h = drive_path(
            torch, K, formatter, cli_run(cli, "path H", list_b, tmp / "H_out", ["--artifact"]),
            tmp / "H_out", "path H")
        print_path("path_h", stats_h, launches_h, card=repr(card))
        path_o(torch, K, cli, manifest_mod, synthetic, build_index, IndexConfig, oracle_index,
               formatter, list_b, tmp, card)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def serve_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card: str, kind: str
                   ) -> int:
    """``--serve-only``: the default build with ``--artifact`` on Path B's
    corpus (Path H's v2.1 artifact) and Path L alone, for iterating on
    the daemon; the run with no arguments drives every path."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_h, launches_h = drive_path(
            torch, K, formatter, cli_run(cli, "path H", list_b, tmp / "H_out", ["--artifact"]),
            tmp / "H_out", "path H")
        print_path("path_h", stats_h, launches_h, card=repr(card))
        K.reset_launch_counts()
        path_l(torch, cli, tmp / "H_out" / "index.mri", tmp, card)
        launches = {"unique_mask_count": K.unique_mask_count.launches,
                    "bucket_histogram": K.bucket_histogram.launches}
        check(not any(launches.values()), f"path L launched a kernel of csrc/: {launches}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def segments_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card: str, kind: str
                      ) -> int:
    """``--segments-only``: the default build with ``--artifact`` on Path
    B's corpus (Path H's v2.1 artifact, N1's reference) and Path N alone,
    for iterating on the live index; the run with no arguments drives
    every path."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_h, launches_h = drive_path(
            torch, K, formatter, cli_run(cli, "path H", list_b, tmp / "H_out", ["--artifact"]),
            tmp / "H_out", "path H")
        print_path("path_h", stats_h, launches_h, card=repr(card))
        launches = path_n(torch, K, cli, manifest_mod, list_b, tmp / "H_out" / "index.mri", tmp,
                          card)
        check(not any(launches.values()), f"path N launched a kernel of csrc/: {launches}")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def mesh_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card: str, kind: str
                  ) -> int:
    """``--mesh-only``: Path J alone, on however many cards the machine
    has (shard i on card i % cards), against the single-device default
    build with ``--artifact`` on Path B's corpus (Path C and Path H's
    v2.1 artifact in one build).  For a machine with several cards; the
    run with no arguments needs one card and drives every path."""
    with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
        tmp = Path(tmp)
        list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
            num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
        stats_c, launches_c = drive_path(
            torch, K, formatter,
            cli_run(cli, "path C", list_b, tmp / "C_out", ["--device-shards", "1", "--artifact"]),
            tmp / "C_out", "path C", trace=tmp / "C_trace.json")
        check_pipelined(stats_c, "path C")
        print_path("path_c", stats_c, launches_c, card=repr(card))
        path_j(torch, K, cli, formatter, list_b, tmp, stats_c["md5"], tmp / "C_out" / "index.mri",
               card)
        path_j_exchange(torch, stats_c["unique_pairs"], stats_c["unique_terms"], 20_000, card)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


MODES = ("--mesh-only", "--serve-only", "--segments-only", "--cluster-only",
         "--multiprocess-only", "--sanitize-only")


def main() -> int:
    import threading

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
            IndexConfig, build_index, cli, faults, native, oracle_index)
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
            manifest as manifest_mod, scheduler, synthetic)
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
            engine as E, kernels as K)
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
            formatter)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    sanitized: dict = {}  # Path Q's background builds, stopped on every exit
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        cards = smi.stdout.strip().splitlines()
        card = cards[0]
        kind = torch.cuda.get_device_name(0)
        if len(cards) > 1:
            print(f"phase cards: {json.dumps(cards)}", flush=True)
        print(f"phase card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| {kind} | cards {torch.cuda.device_count()}", flush=True)
        mode = sys.argv[1:]
        check(mode in ([], *([m] for m in MODES)),
              f"unknown arguments {mode} (only one of {', '.join(MODES)})")
        # g++ for the host scan and Path Q's sanitized builds run beside
        # nvcc's kernel builds
        if mode in ([], ["--sanitize-only"]):
            sanitized.update(start_sanitized_builds())
        native_build = {}

        def build_native():
            t = time.perf_counter()
            native_build["ok"] = native.load() is not None
            native_build["seconds"] = time.perf_counter() - t

        scan_build = threading.Thread(target=build_native)
        scan_build.start()
        built = K.build()
        scan_build.join()
        check(native_build["ok"], f"native scan build failed: {native.load_error()}")
        print(f"phase build: kernels {built['seconds']:.1f} s, "
              f"native scan {native_build['seconds']:.1f} s", flush=True)
        for stem, log in built["ptxas"].items():
            for line in log.splitlines():
                if "registers" in line or "error" in line.lower():
                    print(f"  ptxas {stem}: {line.strip()}")
        if mode == ["--mesh-only"]:
            return mesh_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card, kind)
        if mode == ["--serve-only"]:
            return serve_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card, kind)
        if mode == ["--segments-only"]:
            return segments_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card,
                                     kind)
        if mode == ["--cluster-only"]:
            return cluster_only_run(torch, K, cli, formatter, synthetic, manifest_mod,
                                    build_index, IndexConfig, oracle_index, card, kind)
        if mode == ["--multiprocess-only"]:
            return multiprocess_only_run(torch, K, cli, formatter, synthetic, manifest_mod,
                                         card, kind)
        if mode == ["--sanitize-only"]:
            return sanitize_only_run(torch, K, cli, formatter, synthetic, manifest_mod, card,
                                     kind, sanitized)

        launches_by_path = {}
        with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
            tmp = Path(tmp)
            # -- Path A: the reference envelope, two legs -------------------
            docs_a = synthetic.zipf_corpus(num_docs=355, vocab_size=33_000,
                                           tokens_per_doc=2900, seed=7)
            list_a = write_corpus_dir(synthetic, manifest_mod, tmp / "A", docs_a)
            rc, _ = run_cli(cli, ["4", "26", str(list_a), "--backend", "oracle",
                                  "--output-dir", str(tmp / "A_oracle")])
            check(rc == 0, f"path A oracle: exit {rc}")
            md5_oracle = formatter.letters_md5(tmp / "A_oracle")
            manifest_a = manifest_mod.read_manifest(list_a)
            stats_a1, launches_a1 = drive_path(
                torch, K, formatter,
                lambda: build_index(manifest_a, IndexConfig(num_mappers=4, num_reducers=26,
                                                            use_native=False),
                                    output_dir=str(tmp / "A1_out")),
                tmp / "A1_out", "path A numpy leg")
            check(stats_a1.get("engine") == "u16", f"path A numpy leg took engine "
                  f"{stats_a1.get('engine')}")
            check(launches_a1["unique_mask_count"] > 0,
                  "path A numpy leg launched no unique_mask_count")
            check(stats_a1["md5"] == md5_oracle,
                  f"path A numpy leg md5 {stats_a1['md5']} != oracle {md5_oracle}")
            print_path("path_a_numpy", stats_a1, launches_a1, oracle_md5=md5_oracle)
            launches_by_path["A_numpy"] = launches_a1

            stats_a2, launches_a2 = drive_path(
                torch, K, formatter, cli_run(cli, "path A", list_a, tmp / "A2_out", []),
                tmp / "A2_out", "path A default")
            check_pipelined(stats_a2, "path A default")
            check(stats_a2["upload_windows"] == 2 and stats_a2["window_modes"] == ["u16", "u16"],
                  f"path A default: windows {stats_a2['upload_windows']} "
                  f"modes {stats_a2['window_modes']}, want two u16 windows")
            check(stats_a2["md5"] == md5_oracle,
                  f"path A default md5 {stats_a2['md5']} != oracle {md5_oracle}")
            print_path("path_a_default", stats_a2, launches_a2, oracle_md5=md5_oracle)
            launches_by_path["A_default"] = launches_a2

            # -- Path B: native combiner, one-shot packed engine, --skew ----
            list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
                num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
            stats_b, launches_b = drive_path(
                torch, K, formatter, cli_run(cli, "path B", list_b, tmp / "B_out", ["--skew"]),
                tmp / "B_out", "path B", trace=tmp / "B_trace.json")
            check(stats_b.get("engine") == "packed", f"path B took engine {stats_b.get('engine')}")
            for name, n in launches_b.items():
                check(n > 0, f"path B launched no {name}")
            rc, stats_b_cpu = run_cli(cli, ["4", "26", str(list_b), "--skew", "--device", "cpu",
                                            "--output-dir", str(tmp / "B_cpu"), "--stats"])
            check(rc == 0, f"path B --device cpu: exit {rc}")
            md5_b_cpu = formatter.letters_md5(tmp / "B_cpu")
            check(stats_b["md5"] == md5_b_cpu, f"path B md5 {stats_b['md5']} != cpu {md5_b_cpu}")
            print_path("path_b", stats_b, launches_b, cpu_md5=md5_b_cpu,
                       cpu_phases_ms=json.dumps(stats_b_cpu["phases_ms"]))
            launches_by_path["B"] = launches_b

            # -- Path C: the default build at Path B's size ------------------
            stats_c, launches_c = drive_path(
                torch, K, formatter, cli_run(cli, "path C", list_b, tmp / "C_out", []),
                tmp / "C_out", "path C", trace=tmp / "C_trace.json")
            check_pipelined(stats_c, "path C")
            check(stats_c["window_modes"] and set(stats_c["window_modes"]) == {"keys"},
                  f"path C window modes {stats_c['window_modes']}, want int32 keys")
            rc, stats_c_cpu = run_cli(cli, ["4", "26", str(list_b), "--device", "cpu",
                                            "--output-dir", str(tmp / "C_cpu"), "--stats"])
            check(rc == 0, f"path C --device cpu: exit {rc}")
            md5_c_cpu = formatter.letters_md5(tmp / "C_cpu")
            check(stats_c["md5"] == md5_c_cpu == stats_b["md5"],
                  f"path C md5 {stats_c['md5']} != cpu {md5_c_cpu} or path B {stats_b['md5']}")
            print_path("path_c", stats_c, launches_c, cpu_md5=md5_c_cpu, path_b_md5=stats_b["md5"],
                       cpu_phases_ms=json.dumps(stats_c_cpu["phases_ms"]))
            launches_by_path["C"] = launches_c
            # Path C's two windows read again, on the main thread alone and
            # by the reader thread with no scan beside it: says whether a
            # window's read is slow for its files or for the scan beside it
            manifest_b = manifest_mod.read_manifest(list_b)
            windows = scheduler.plan_contiguous_windows(manifest_b, 2)
            main_ms = []
            items = manifest_mod.iter_document_ranges(manifest_b, windows)
            for _ in windows:
                t = time.perf_counter()
                next(items)
                main_ms.append(round((time.perf_counter() - t) * 1e3, 3))
            alone_ms: list = []
            for _ in manifest_mod.prefetch_document_ranges(manifest_b, windows, read_ms=alone_ms):
                pass
            print(f"phase path_c_reads: main_thread_ms={main_ms} "
                  f"reader_thread_alone_ms={alone_ms}", flush=True)

            # -- Path D: the all-device plan on Path B's corpus ---------------
            stats_d, launches_d = drive_path(
                torch, K, formatter,
                cli_run(cli, "path D", list_b, tmp / "D_out", ["--device-tokenize"]),
                tmp / "D_out", "path D", trace=tmp / "D_trace.json")
            check_device_tokenize(stats_d, "path D")
            check(stats_d["sort_cols"] == 3, f"path D sort_cols {stats_d['sort_cols']}, want 3")
            rc, stats_d_cpu = run_cli(cli, ["4", "26", str(list_b), "--device-tokenize",
                                            "--device", "cpu", "--stats",
                                            "--output-dir", str(tmp / "D_cpu")])
            check(rc == 0, f"path D --device cpu: exit {rc}")
            md5_d_cpu = formatter.letters_md5(tmp / "D_cpu")
            check(stats_d["md5"] == md5_d_cpu == stats_b["md5"] == stats_c["md5"],
                  f"path D md5 {stats_d['md5']} != cpu {md5_d_cpu} or path B {stats_b['md5']} "
                  f"or path C {stats_c['md5']}")
            print_path("path_d", stats_d, launches_d, cpu_md5=md5_d_cpu,
                       path_b_md5=stats_b["md5"], path_c_md5=stats_c["md5"],
                       cpu_phases_ms=json.dumps(stats_d_cpu["phases_ms"]))
            launches_by_path["D"] = launches_d

            # Path D on Path A's corpus with words of 13-44 letters added:
            # tail groups and the sparse tail fetch
            long_docs = [b" ".join(bytes(97 + (3 * d + 5 * w + 7 * j) % 26
                                         for j in range(13 + (d + w) % 32))
                                   for w in range(60)) for d in range(20)]
            list_dl = write_corpus_dir(synthetic, manifest_mod, tmp / "DL", docs_a + long_docs)
            rc, _ = run_cli(cli, ["4", "26", str(list_dl), "--backend", "oracle",
                                  "--output-dir", str(tmp / "DL_oracle")])
            check(rc == 0, f"path D long words oracle: exit {rc}")
            md5_dl_oracle = formatter.letters_md5(tmp / "DL_oracle")
            stats_dl, launches_dl = drive_path(
                torch, K, formatter,
                cli_run(cli, "path D long words", list_dl, tmp / "DL_out", ["--device-tokenize"]),
                tmp / "DL_out", "path D long words")
            check_device_tokenize(stats_dl, "path D long words")
            check(stats_dl["sort_cols"] == 11,
                  f"path D long words sort_cols {stats_dl['sort_cols']}, want 11")
            check(stats_dl["md5"] == md5_dl_oracle,
                  f"path D long words md5 {stats_dl['md5']} != oracle {md5_dl_oracle}")
            print_path("path_d_long_words", stats_dl, launches_dl, oracle_md5=md5_dl_oracle)
            launches_by_path["D_long_words"] = launches_dl

            # Path D on Path A's corpus with 8-byte rows: must restart on
            # the host plan, and say so
            stats_do, launches_do = drive_path(
                torch, K, formatter,
                cli_run(cli, "path D overflow", list_a, tmp / "DO_out",
                        ["--device-tokenize", "--device-tokenize-width", "8"]),
                tmp / "DO_out", "path D overflow")
            check("device_tokenize_fallback" in stats_do
                  and "aborted_device_tokenize" in stats_do["phases_ms"],
                  f"path D overflow did not restart: phases {sorted(stats_do['phases_ms'])}")
            check_pipelined(stats_do, "path D overflow")
            check(stats_do["md5"] == md5_oracle,
                  f"path D overflow md5 {stats_do['md5']} != oracle {md5_oracle}")
            print_path("path_d_overflow", stats_do, launches_do, oracle_md5=md5_oracle)
            launches_by_path["D_overflow"] = launches_do

            # -- Path E: the streaming plan on Path B's corpus ----------------
            stats_e, launches_e = drive_path(
                torch, K, formatter,
                cli_run(cli, "path E", list_b, tmp / "E_out", ["--stream-chunk-docs", "5000"]),
                tmp / "E_out", "path E", trace=tmp / "E_trace.json")
            check("stream" in stats_e["phases_ms"] and stats_e.get("stream_windows") == 4,
                  f"path E: phases {sorted(stats_e['phases_ms'])}, "
                  f"windows {stats_e.get('stream_windows')}, want the streaming plan's 4")
            check(stats_e["accumulator_mode"] == "packed",
                  f"path E accumulator mode {stats_e['accumulator_mode']}, want packed")
            check(launches_e["unique_mask_count"] > 0, "path E launched no unique_mask_count")
            check(stats_e["md5"] == stats_b["md5"],
                  f"path E md5 {stats_e['md5']} != path B {stats_b['md5']}")
            print_path("path_e", stats_e, launches_e, path_b_md5=stats_b["md5"])
            launches_by_path["E"] = launches_e

            # -- Path F: the streaming all-device plan on Path B's corpus -----
            stats_f, launches_f = drive_path(
                torch, K, formatter,
                cli_run(cli, "path F", list_b, tmp / "F_out",
                        ["--device-tokenize", "--stream-chunk-docs", "2500"]),
                tmp / "F_out", "path F", trace=tmp / "F_trace.json")
            check("stream_feed" in stats_f["phases_ms"] and stats_f.get("stream_windows") == 8
                  and "device_tokenize_fallback" not in stats_f,
                  f"path F: phases {sorted(stats_f['phases_ms'])}, windows "
                  f"{stats_f.get('stream_windows')}, fallback "
                  f"{stats_f.get('device_tokenize_fallback')}; want 8 device stream windows")
            check(stats_f["md5"] == stats_b["md5"],
                  f"path F md5 {stats_f['md5']} != path B {stats_b['md5']}")
            print_path("path_f", stats_f, launches_f, path_b_md5=stats_b["md5"])
            launches_by_path["F"] = launches_f

            # the same build through build_index with a stream checkpoint
            # every two windows, killed after window 5 by the crash hook,
            # then run again: it must resume after window 4
            ckpt = tmp / "F_stream.ckpt.npz"
            cfg_f = IndexConfig(num_mappers=4, num_reducers=26, device_tokenize=True,
                                stream_chunk_docs=2500, stream_checkpoint=str(ckpt),
                                stream_checkpoint_every=2)

            def crash_then_resume():
                os.environ[CRASH_KNOB] = "5"
                try:
                    build_index(manifest_b, cfg_f, output_dir=str(tmp / "FR_out"))
                except RuntimeError as e:
                    check("injected stream crash" in str(e), f"path F resume: {e}")
                else:
                    raise SmokeFailure("path F resume: the injected crash did not fire")
                finally:
                    del os.environ[CRASH_KNOB]
                check(ckpt.exists(), "path F resume: the crash left no checkpoint")
                return build_index(manifest_b, cfg_f, output_dir=str(tmp / "FR_out"))

            stats_fr, launches_fr = drive_path(torch, K, formatter, crash_then_resume,
                                               tmp / "FR_out", "path F resume")
            check(stats_fr.get("resumed_from_window") == 4 and not ckpt.exists(),
                  f"path F resume: resumed_from_window {stats_fr.get('resumed_from_window')}, "
                  f"checkpoint left: {ckpt.exists()}; want 4 and none")
            check(stats_fr["md5"] == stats_b["md5"],
                  f"path F resume md5 {stats_fr['md5']} != path B {stats_b['md5']}")
            print_path("path_f_resume", stats_fr, launches_fr, path_b_md5=stats_b["md5"])
            launches_by_path["F_resume"] = launches_fr

            # Path F on Path A's corpus with 8-byte rows: must restart on
            # the streaming plan, and say so
            stats_fo, launches_fo = drive_path(
                torch, K, formatter,
                cli_run(cli, "path F overflow", list_a, tmp / "FO_out",
                        ["--device-tokenize", "--stream-chunk-docs", "100",
                         "--device-tokenize-width", "8"]),
                tmp / "FO_out", "path F overflow")
            check("device_tokenize_fallback" in stats_fo
                  and {"aborted_device_tokenize", "stream"} <= set(stats_fo["phases_ms"]),
                  f"path F overflow did not restart on the streaming plan: phases "
                  f"{sorted(stats_fo['phases_ms'])}")
            check(stats_fo["md5"] == md5_oracle,
                  f"path F overflow md5 {stats_fo['md5']} != oracle {md5_oracle}")
            print_path("path_f_overflow", stats_fo, launches_fo, oracle_md5=md5_oracle)
            launches_by_path["F_overflow"] = launches_fo

            # -- Path G: the overlap plan on Path B's corpus ------------------
            stats_g, launches_g = drive_path(
                torch, K, formatter,
                cli_run(cli, "path G", list_b, tmp / "G_out", ["--overlap-tail-fraction", "0.3"]),
                tmp / "G_out", "path G", trace=tmp / "G_trace.json")
            check("host_tail" in stats_g["phases_ms"] and stats_g.get("upload_windows") == 2
                  and stats_g.get("device_pairs", 0) > 0,
                  f"path G: phases {sorted(stats_g['phases_ms'])}, windows "
                  f"{stats_g.get('upload_windows')}, device pairs {stats_g.get('device_pairs')}; "
                  "want the overlap plan's 2 device windows")
            check(stats_g["md5"] == stats_b["md5"],
                  f"path G md5 {stats_g['md5']} != path B {stats_b['md5']}")
            print_path("path_g", stats_g, launches_g, path_b_md5=stats_b["md5"])
            launches_by_path["G"] = launches_g

            # -- Path H: serving on Path B's corpus ---------------------------
            served, launches_by_path["H"], h_paths = path_h(
                torch, K, cli, formatter, list_b, tmp, stats_b["md5"], card)

            # -- Path I: the host engine and the router on Path H's files ------
            K.reset_launch_counts()
            path_i(torch, cli, h_paths, served, card)
            launches_by_path["I"] = {"unique_mask_count": K.unique_mask_count.launches,
                                     "bucket_histogram": K.bucket_histogram.launches}
            check(not any(launches_by_path["I"].values()),
                  f"path I launched a kernel of csrc/: {launches_by_path['I']}")

            # -- Path J: the multi-shard builds, 4 shards on the card ---------
            launches_by_path.update(path_j(torch, K, cli, formatter, list_b, tmp,
                                           stats_c["md5"], h_paths[3], card))
            path_j_exchange(torch, stats_c["unique_pairs"], stats_c["unique_terms"], 20_000,
                            card)

            # -- Path K: resilience on the card --------------------------------
            launches_by_path["K1"] = path_k(torch, K, cli, formatter, faults, list_a, list_b,
                                            tmp, stats_b, stats_c["md5"], tmp / "A2_out", card)

            # -- Path L: the resident serve daemon on Path H's v2.1 artifact ---
            K.reset_launch_counts()
            path_l(torch, cli, h_paths[3], tmp, card)
            launches_by_path["L"] = {"unique_mask_count": K.unique_mask_count.launches,
                                     "bucket_histogram": K.bucket_histogram.launches}
            check(not any(launches_by_path["L"].values()),
                  f"path L launched a kernel of csrc/: {launches_by_path['L']}")

            # -- Path M: the host backend, its artifact served on the card ------
            launches_by_path["M"] = path_m(
                torch, K, cli, formatter, faults, synthetic, build_index, IndexConfig,
                list_a, list_b, tmp, md5_oracle, stats_c["md5"], h_paths, served, card)

            # -- Path N: the live index on Path B's corpus -----------------------
            launches_by_path["N"] = path_n(torch, K, cli, manifest_mod, list_b, h_paths[3], tmp,
                                           card)
            check(not any(launches_by_path["N"].values()),
                  f"path N launched a kernel of csrc/: {launches_by_path['N']}")

            # -- Path O: the doc-sharded cluster on Path B's corpus ---------------
            launches_by_path["O"] = path_o(torch, K, cli, manifest_mod, synthetic, build_index,
                                           IndexConfig, oracle_index, formatter, list_b, tmp,
                                           card)

            # Paths D, E and F's device programs alone, while their files exist
            eng_plans = engine_device_plans(torch, manifest_b, stats_d, 5000)
            eng_plans.update(engine_device_stream(torch, manifest_b, stats_f, 2500,
                                                  cfg_f.pad_multiple))

            # -- Path P: the multi-process mesh on Path B's corpus ----------------
            launches_by_path["P"] = path_p(torch, formatter, list_b, tmp, stats_c["md5"],
                                           card)

            # -- Path Q: the sanitized native builds on the host ------------------
            launches_by_path["Q"] = path_q(list_a, md5_oracle, h_paths[3], tmp, card,
                                           sanitized)

        # -- kernels against their plain versions, at this run's shapes ----
        # (padded n, valid n, vocab, docs): Path A's numpy leg keeps every
        # token; Path B feeds the combiner's deduped pairs
        a_pairs = stats_a2["unique_pairs"]
        b_pairs = stats_b["unique_pairs"]
        kernels = phase_kernels(torch, K, {
            "A": (round_up(stats_a1["tokens"], 1 << 16), stats_a1["tokens"],
                  stats_a1["unique_terms"], 355),
            "B": (round_up(b_pairs, 1 << 16), b_pairs, stats_b["unique_terms"], 20_000),
            "E": (stats_e["accumulator_capacity"], stats_e["unique_pairs"],
                  stats_e["unique_terms"], 20_000),
            "F_overflow": (stats_fo["accumulator_capacity"], stats_fo["unique_pairs"],
                           stats_fo["unique_terms"], 355)})
        for k in kernels:
            print(f"phase kernels: {k['name']} exact={k['parity']} ms={k['ms']:.4f} "
                  f"(min {k['ms_min']:.4f} max {k['ms_max']:.4f}) "
                  f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
                  f"library_ms={k['library_ms']}", flush=True)
            for shape in k.get("shapes", []):
                print(f"  {k['name']} {json.dumps(shape)}", flush=True)

        # -- warm engine programs at this run's shapes ----------------------
        eng = phase_engine(torch, E, {
            "A_numpy": (1 << 20, stats_a1["tokens"], stats_a1["unique_terms"], 355),
            "A_dedup": (round_up(a_pairs, 1 << 16), a_pairs, stats_a2["unique_terms"], 355),
            "B": (round_up(b_pairs, 1 << 16), b_pairs, stats_b["unique_terms"], 20_000),
            "C": (None, stats_c["unique_pairs"], stats_c["unique_terms"], 20_000)})
        eng.update(eng_plans)
        extra = {k: eng.pop(k) for k in list(eng) if not isinstance(eng[k], tuple)}
        print("phase engine: " + " ".join(
            f"{name}={t[0]:.4f} (min {t[1]:.4f} max {t[2]:.4f})" for name, t in eng.items())
            + " " + " ".join(f"{k}={json.dumps(v)}" for k, v in extra.items()), flush=True)
    except (SmokeFailure, OSError, RuntimeError, ValueError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        stop_all(sanitized.values())

    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in launches_by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"phase done: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
