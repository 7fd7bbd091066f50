"""The ``MRI_*`` environment knobs this package reads.

Each is declared once with its name, type, default and bounds, the same
as the JAX package's declaration of it, so one setting drives both
packages.  :func:`get` reads one; a malformed value raises a
``ValueError`` naming the variable, which the CLI turns into exit 2.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple


class _Knob(NamedTuple):
    cast: Callable[[str], Any]
    default: Any
    choices: tuple | None = None
    minimum: Any = None
    exclusive: bool = False  # the minimum itself is refused


_KNOBS: dict[str, _Knob] = {
    # snapshot-tax budget: a projected stream-checkpoint save slower
    # than this many seconds is skipped (recorded, not paid)
    "MRI_TPU_CKPT_BUDGET_S": _Knob(float, 120.0),
    # assumed device->host rate (MB/s) seeding the checkpoint cost
    # projection; re-calibrated from each measured save
    "MRI_TPU_CKPT_LINK_MBPS": _Knob(float, 8.0),
    # most consecutive over-budget checkpoint skips before one save is
    # forced
    "MRI_TPU_CKPT_STRETCH": _Knob(int, 4),
    # test hook: raise after this device-stream window (0: disabled)
    "MRI_TPU_STREAM_CRASH_AFTER_WINDOWS": _Knob(int, 0),
    # -- the host backend (backend='cpu') --
    # bytes per host scan window (unset: the backend's ~2 MB); tests
    # force tiny values for multi-window plans on small corpora
    "MRI_CPU_WINDOW_BYTES": _Knob(int, None),
    # seeded shuffle of the steal queue's window order (unset: manifest
    # order)
    "MRI_STEAL_SHUFFLE_SEED": _Knob(int, None),
    # per-window lease deadline in seconds: a worker holding a lease
    # past it is retired and its windows requeued (unset: no watchdog)
    "MRI_WINDOW_DEADLINE_S": _Knob(float, None),
    # scan-worker respawn budget after worker deaths (clamped to >= 0)
    "MRI_WORKER_RESPAWNS": _Knob(int, 1),
    # term-hash shard count of the out-of-core build's spill runs
    "MRI_BUILD_SHARDS": _Knob(int, 8, minimum=1),
    # per-worker postings budget in bytes: when set, scan workers spill
    # term-hash-sharded runs at this estimated footprint and the reduce
    # k-way-merges them (unset: the in-memory merge)
    "MRI_BUILD_SPILL_BYTES": _Knob(int, None, minimum=1),
    # crash hook: SIGKILL the process after N complete spill run files
    "MRI_SPILL_KILL_AFTER": _Knob(int, None),
    # -- fault injection and read retries --
    # fault spec armed at the first faults.active() call (subprocess
    # arming); the grammar of --fault-spec
    "MRI_FAULTS": _Knob(str, None),
    # read attempts per document (counts the first try)
    "MRI_READ_RETRIES": _Knob(int, 3, minimum=1),
    # initial retry backoff in ms (doubles per retry)
    "MRI_READ_BACKOFF_MS": _Knob(float, 5.0, minimum=0),
    # total per-document retry deadline in seconds
    "MRI_READ_DEADLINE_S": _Knob(float, 1.0, minimum=0, exclusive=True),
    # crash hook: SIGKILL the process after N complete letter files
    "MRI_EMIT_KILL_AFTER_LETTERS": _Knob(int, None),
    # -- query serving --
    # engine when 'query' gets no --engine flag: host, device or auto
    # (validated by serve.engine.resolve_engine; unset: device)
    "MRI_SERVE_ENGINE": _Knob(str, None),
    # native (C++) serve kernels for v2 decode/AND/BM25: auto (on when
    # the library loads), 1 (required: engine creation fails without
    # it) or 0 (numpy only); answers are byte-identical either way
    "MRI_SERVE_NATIVE": _Knob(str, "auto", choices=("auto", "0", "1")),
    # --engine auto host->device batch-size crossover: unset probes it,
    # 0 pins the host, N > 0 routes batches >= N to the device engine
    "MRI_SERVE_CROSSOVER": _Knob(int, None, minimum=0),
    # artifact format the builders write: 1 (delta postings), 2 (block
    # bitpacked) or 3 (v2.1: v2 plus per-block max-score columns)
    "MRI_SERVE_FORMAT": _Knob(int, 3, choices=(1, 2, 3)),
    # v2 postings block size in doc ids (power of two)
    "MRI_SERVE_BLOCK_SIZE": _Knob(int, 128, minimum=2),
    # v2.1 max-score column width in bits
    "MRI_SERVE_SCORE_BITS": _Knob(int, 8, choices=(8, 16)),
    # top_k scoring mode when the query names none
    "MRI_SERVE_SCORE": _Knob(str, "df", choices=("df", "bm25")),
    # ranked-query planner
    "MRI_SERVE_PLANNER": _Knob(str, "auto", choices=("auto", "exhaustive", "bmw", "maxscore")),
    # device-engine logical shard count (unset: every visible card; one
    # on the CPU)
    "MRI_SERVE_SHARDS": _Knob(int, None),
    # most decode-window elements (rows x width) per device call
    "MRI_SERVE_DEVICE_DECODE_BUDGET": _Knob(int, 1 << 24),
    # -- the resident serve daemon --
    # micro-batch coalescing window in microseconds (0: dispatch at once)
    "MRI_SERVE_COALESCE_US": _Knob(int, 200, minimum=0),
    # admission queue depth; requests past it are shed as 'overloaded'
    "MRI_SERVE_QUEUE_DEPTH": _Knob(int, 1024, minimum=1),
    # most coalesced requests dispatched as one engine batch
    "MRI_SERVE_MAX_BATCH": _Knob(int, 1024, minimum=1),
    # graceful-drain budget in seconds after SIGTERM/SIGINT
    "MRI_SERVE_DRAIN_S": _Knob(float, 5.0, minimum=0, exclusive=True),
    # CoDel admission target in ms (0: fixed queue-depth shedding only)
    "MRI_SERVE_CODEL_TARGET_MS": _Knob(float, 0.0, minimum=0.0),
    # CoDel interval in ms: how long the delay must stay over target
    "MRI_SERVE_CODEL_INTERVAL_MS": _Knob(float, 100.0, minimum=1.0),
    # generation-keyed whole-payload result cache on the reader threads
    "MRI_SERVE_RESULT_CACHE": _Knob(int, 1, choices=(0, 1)),
    # result cache entry bound (LRU past it)
    "MRI_SERVE_RESULT_CACHE_ENTRIES": _Knob(int, 4096, minimum=1),
    # result cache byte bound over the payloads' JSON size (0: none)
    "MRI_SERVE_RESULT_CACHE_BYTES": _Knob(int, 8 << 20, minimum=0),
    # weighted-fair dequeue shares: 'name=w,name=w,*=w'
    "MRI_SERVE_TENANT_WEIGHTS": _Knob(str, ""),
    # per-tenant token-bucket admission: 'name=rps[:burst],*=rps[:burst]'
    "MRI_SERVE_TENANT_RATE": _Knob(str, ""),
    # distinct tenants tracked before new names fold into 'other'
    "MRI_SERVE_TENANT_MAX": _Knob(int, 32, minimum=1),
    # the serve CLI collects once and gc.freeze()s the warm heap
    "MRI_SERVE_GC_FREEZE": _Knob(int, 1, choices=(0, 1)),
    # per-tenant lane depth (0: MRI_SERVE_QUEUE_DEPTH)
    "MRI_SERVE_TENANT_QUEUE_DEPTH": _Knob(int, 0, minimum=0),
    # -- the live index (segments/) --
    # segment count at which compaction kicks in; also the width of the
    # adjacent run each round folds
    "MRI_SEGMENT_COMPACT_TRIGGER": _Knob(int, 4, minimum=2),
    # segment-count backstop: the daemon compacts after an append while
    # the live set exceeds it
    "MRI_SEGMENT_MAX_SEGMENTS": _Knob(int, 16, minimum=1),
    # daemon delete batching: one tombstone generation every N delete ops
    "MRI_SEGMENT_TOMBSTONE_FLUSH": _Knob(int, 1, minimum=1),
    # the mutation write-ahead log (0: publish-only durability; replay
    # of an existing log still runs)
    "MRI_SEGMENT_WAL": _Knob(int, 1, choices=(0, 1)),
    # primary lease TTL in seconds inside segments.lock (0: no leasing)
    "MRI_SEGMENT_LEASE_TTL_S": _Knob(float, 0.0, minimum=0),
    # replica catch-up poll period in ms ('serve --replica-of')
    "MRI_REPLICA_POLL_MS": _Knob(int, 500, minimum=1),
    # -- the cluster router (cluster/) --
    # hedging delay in ms: a shard RPC unanswered this long is re-sent to
    # another replica of the same shard. -1 adapts per shard (rolling p95
    # of recent RPC latency, 1 ms floor), 0 disables hedging, positive
    # values are a fixed delay
    "MRI_CLUSTER_HEDGE_MS": _Knob(float, -1.0, minimum=-1.0),
    # health-probe period in ms: each replica's 'healthz' is polled on its
    # pipelined connection and the readiness reasons (draining/stalled/
    # overloaded/replica_lagging) steer replica selection away before
    # requests fail
    "MRI_CLUSTER_HEALTH_MS": _Knob(int, 500, minimum=1),
    # admission cap: client requests in flight (scattered but not yet
    # gathered) beyond this are shed with 'overloaded', mirroring the
    # daemon's bounded queue
    "MRI_CLUSTER_INFLIGHT": _Knob(int, 1024, minimum=1),
    # ceiling in ms on one shard RPC (including failover retries) when the
    # client request carries no deadline_ms of its own
    "MRI_CLUSTER_RPC_TIMEOUT_MS": _Knob(float, 30000.0, minimum=1.0),
    # default partial-result policy for requests carrying no
    # partial_policy field: 'fail' (any unanswerable shard fails the whole
    # request) or 'allow[:min_coverage=F]' (answer from the shards that
    # did answer, flagged with partial+coverage metadata, provided at
    # least fraction F of the corpus answered; F defaults to 0)
    "MRI_CLUSTER_PARTIAL": _Knob(str, "fail"),
    # retry/hedge token budget per shard, as a ratio of live
    # (first-attempt) traffic: each original shard leg deposits this many
    # tokens and every retry or hedge spends one, so brownout
    # amplification is capped near (1 + ratio)x instead of compounding;
    # 0 disables retries and hedges (first attempt only)
    "MRI_CLUSTER_RETRY_BUDGET": _Knob(float, 0.1, minimum=0.0),
    # -- observability of the daemon --
    # per-request tracing: auto trace ids and the trace ring
    "MRI_OBS_ENABLE": _Knob(int, 1, choices=(0, 1)),
    # capacity of the ring of recent request traces (the 'trace' op)
    "MRI_OBS_TRACE_RING": _Knob(int, 256, minimum=1),
    # slow-query threshold in ms: one JSON line on mri_torch.obs (0: off)
    "MRI_OBS_SLOW_MS": _Knob(float, 0.0, minimum=0),
    # flight recorder capacity (0: off)
    "MRI_OBS_FLIGHT_RING": _Knob(int, 64, minimum=0),
    # OpenMetrics exemplars on the daemon's latency histograms
    "MRI_OBS_EXEMPLARS": _Knob(int, 1, choices=(0, 1)),
    # rolling-window sampler period in ms
    "MRI_OBS_SAMPLE_MS": _Knob(int, 1000, minimum=10),
    # latency SLO threshold in ms
    "MRI_OBS_SLO_LATENCY_MS": _Knob(float, 50.0, minimum=0.001),
    # SLO objective shared by the availability and latency SLOs
    "MRI_OBS_SLO_TARGET": _Knob(float, 0.999, minimum=0.0),
    # watchdog stall threshold in ms (0: no watchdog)
    "MRI_OBS_STALL_MS": _Knob(float, 5000.0, minimum=0),
    # healthz 'overloaded' once the 10 s shed fraction reaches this
    "MRI_OBS_OVERLOAD_SHED_RATE": _Knob(float, 0.5, minimum=0.0),
    # mri_torch.* log rendering once obs.logging.configure() has run
    "MRI_OBS_LOG_FORMAT": _Knob(str, "text", choices=("text", "json")),
    # per-(logger, event) structured-log rate limit in records/s (0: off)
    "MRI_OBS_LOG_RATE_LIMIT": _Knob(int, 200, minimum=0),
}


def get(name: str) -> Any:
    """The knob's parsed value from the environment, or its default."""
    knob = _KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    try:
        val = knob.cast(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a valid {knob.cast.__name__}") from None
    if knob.choices is not None and val not in knob.choices:
        raise ValueError(f"{name}={raw!r} not in {knob.choices}")
    if knob.minimum is not None and (
            val < knob.minimum or (knob.exclusive and val == knob.minimum)):
        bound = f"> {knob.minimum}" if knob.exclusive else f">= {knob.minimum}"
        raise ValueError(f"{name} must be {bound}, got {raw!r}")
    return val
