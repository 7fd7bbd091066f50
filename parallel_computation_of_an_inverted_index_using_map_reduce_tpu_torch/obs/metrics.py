"""Thread-safe metrics registry: counters, gauges, log-bucket histograms
(the JAX package's ``obs/metrics.py``).

Every serve-plane tally (daemon admission counters, engine decode
counters, cache hit/miss, per-op latency) is an object from this module;
the ``stats`` / ``describe()`` dicts are views over it, and
``Registry.render_text()`` exposes the same numbers in Prometheus
text-exposition format, byte for byte the JAX package's text for the
same counts (its ``# HELP`` lines come from :data:`KNOWN_METRICS`).

Registries are cheap instance objects, not process singletons: each
daemon and each engine owns one, so two daemons in one process never
share counts and a hot reload starts the new engine's telemetry from
zero.  The one process-global registry, :func:`default_registry`, holds
only process-wide events: fault-injection firings and dropped log
records.
"""

from __future__ import annotations

import bisect
import math
import threading
import time


class Counter:
    """Monotonic (but resettable) counter with its own lock."""

    __slots__ = ("name", "help", "_lock", "_n")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._n = 0  # guarded by: self._lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        """Zero the counter.  Exists for the legacy ``cache.clear()``
        contract, which resets its tallies."""
        with self._lock:
            self._n = 0


class Gauge:
    """A value that goes up and down (queue depth, vocab size)."""

    __slots__ = ("name", "help", "_lock", "_v")

    def __init__(self, name: str, help: str = ""):  # noqa: A002
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._v = 0.0  # guarded by: self._lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


#: Raw samples retained per histogram for exact quantiles.  Past the
#: cap the histogram stops retaining (buckets/sum/count stay exact,
#: quantiles fall back to the retained prefix and are flagged).
SAMPLE_CAP = 65536


class Histogram:
    """Fixed log-spaced buckets plus a capped raw-sample buffer.

    Buckets are ``base * growth**i`` upper bounds (``le`` semantics,
    like Prometheus); the defaults span 1 us .. ~68 s, which covers
    every op latency in this repo.  While under :data:`SAMPLE_CAP`
    observations, :meth:`quantile` is *exact* (numpy linear
    interpolation over the raw samples), not a bucket estimate.
    """

    __slots__ = ("name", "help", "_lock", "_bounds", "_counts",
                 "_count", "_sum", "_min", "_max", "_samples",
                 "_truncated", "_exemplars")

    def __init__(self, name: str, help: str = "", *,  # noqa: A002
                 base: float = 1e-6, growth: float = 2.0,
                 nbuckets: int = 27):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._bounds = [base * growth ** i for i in range(nbuckets)]
        # one slot per bound plus the +Inf overflow slot
        self._counts = [0] * (nbuckets + 1)  # guarded by: self._lock
        self._count = 0  # guarded by: self._lock
        self._sum = 0.0  # guarded by: self._lock
        self._min = math.inf  # guarded by: self._lock
        self._max = -math.inf  # guarded by: self._lock
        self._samples: list[float] = []  # guarded by: self._lock
        self._truncated = False  # guarded by: self._lock
        # per-bucket (trace_id, value, unix_ts) of a recent
        # representative observation; allocated on first exemplar so
        # exemplar-free histograms pay nothing
        self._exemplars: list | None = None  # guarded by: self._lock

    def observe(self, v: float, exemplar: str | None = None) -> None:
        """Record ``v``; ``exemplar`` optionally attaches a trace id as
        the bucket's OpenMetrics exemplar (last writer wins, which
        keeps each bucket's exemplar recent)."""
        v = float(v)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < SAMPLE_CAP:
                self._samples.append(v)
            else:
                self._truncated = True
            if exemplar is not None:
                if self._exemplars is None:
                    self._exemplars = [None] * len(self._counts)
                self._exemplars[i] = (str(exemplar), v, time.time())

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def bounds(self) -> list[float]:
        return list(self._bounds)

    def cumulative_counts(self) -> list[int]:
        """Per-bound cumulative counts (observations <= bound), one
        entry per bound plus the final +Inf total — the shape of the
        Prometheus ``_bucket`` series."""
        with self._lock:
            out, acc = [], 0
            for c in self._counts:
                acc += c
                out.append(acc)
            return out

    def quantile(self, p: float) -> float:
        """p-th percentile (0..100), numpy ``linear`` interpolation.

        Exact while the raw-sample buffer is complete; past
        :data:`SAMPLE_CAP` it interpolates over the retained prefix.
        """
        with self._lock:
            s = sorted(self._samples)
        if not s:
            return math.nan
        pos = (len(s) - 1) * (float(p) / 100.0)
        lo = int(math.floor(pos))
        frac = pos - lo
        hi = min(lo + 1, len(s) - 1)
        return s[lo] * (1.0 - frac) + s[hi] * frac

    @property
    def exact(self) -> bool:
        with self._lock:
            return not self._truncated

    def exemplars(self) -> list:
        """Per-bucket exemplar snapshot (one slot per bound plus +Inf);
        ``None`` slots have never seen an exemplar."""
        with self._lock:
            if self._exemplars is None:
                return [None] * len(self._counts)
            return list(self._exemplars)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else None,
                "max": self._max if self._count else None,
            }


#: Canonical metric documentation: (name, kind, meaning), the JAX
#: package's tuple, so each family's ``# HELP`` line is the same in both
#: packages' scrape text.  Names with ``<..>`` placeholders describe
#: dynamically-created families.
KNOWN_METRICS = (
    # daemon admission / dispatch plane
    ("mri_serve_requests_total", "counter",
     "Data requests admitted past validation (the legacy `requests`)."),
    ("mri_serve_responses_total", "counter",
     "Response lines written back to clients."),
    ("mri_serve_shed_total", "counter",
     "Requests shed by admission control (pending queue full)."),
    ("mri_serve_deadline_expired_total", "counter",
     "Requests whose `deadline_ms` passed before dispatch."),
    ("mri_serve_draining_rejected_total", "counter",
     "Requests rejected because the daemon was draining."),
    ("mri_serve_bad_request_total", "counter",
     "Malformed lines and unknown ops."),
    ("mri_serve_internal_errors_total", "counter",
     "Requests that failed inside the engine."),
    ("mri_serve_client_disconnects_total", "counter",
     "Connections that dropped mid-write."),
    ("mri_serve_slow_client_closes_total", "counter",
     "Connections closed for not draining their response queue."),
    ("mri_serve_reload_ok_total", "counter",
     "Successful hot reloads (engine swapped)."),
    ("mri_serve_reload_rejected_total", "counter",
     "Hot reloads rejected; the old artifact kept serving."),
    ("mri_serve_batches_total", "counter",
     "Coalesced micro-batches dispatched to the engine."),
    ("mri_serve_batched_requests_total", "counter",
     "Requests executed inside those micro-batches."),
    ("mri_serve_connections_total", "counter",
     "Client connections accepted."),
    ("mri_serve_queue_depth", "gauge",
     "Pending-queue depth at scrape time."),
    ("mri_serve_inflight", "gauge",
     "Admitted-but-unanswered requests at scrape time."),
    ("mri_serve_draining", "gauge",
     "1 while the daemon is draining, else 0."),
    ("mri_serve_request_seconds", "histogram",
     "End-to-end data-request latency (admission to response enqueue)."),
    ("mri_serve_queue_wait_seconds", "histogram",
     "Time spent waiting in the pending queue before dispatch pop."),
    # engine-side caches (per-engine registry)
    ("mri_serve_cache_hits_total", "counter",
     "Postings LRU cache hits."),
    ("mri_serve_cache_misses_total", "counter",
     "Postings LRU cache misses."),
    ("mri_serve_cache_evictions_total", "counter",
     "Postings LRU cache evictions."),
    ("mri_serve_tf_cache_hits_total", "counter",
     "Term-frequency LRU cache hits (BM25 path)."),
    ("mri_serve_tf_cache_misses_total", "counter",
     "Term-frequency LRU cache misses."),
    ("mri_serve_tf_cache_evictions_total", "counter",
     "Term-frequency LRU cache evictions."),
    # engine decode plane
    ("mri_engine_blocks_decoded_total", "counter",
     "v2 posting blocks (v1: whole lists) bit-unpacked."),
    ("mri_engine_blocks_skipped_total", "counter",
     "v2 posting blocks skipped via the block-max table."),
    ("mri_engine_bytes_decoded_total", "counter",
     "Bytes materialized by posting decode."),
    ("mri_engine_vocab_terms", "gauge",
     "Vocabulary size of the loaded artifact."),
    ("mri_engine_artifact_bytes", "gauge",
     "On-disk size of the loaded artifact."),
    ("mri_engine_op_<op>_seconds", "histogram",
     "Per-op engine latency (df, postings, and, or, top_k, ...)."),
    # query planner (per-engine registry)
    ("mri_planner_ranked_exhaustive_total", "counter",
     "Ranked queries the planner scored exhaustively."),
    ("mri_planner_ranked_bmw_total", "counter",
     "Ranked queries evaluated with Block-Max WAND pruning."),
    ("mri_planner_ranked_maxscore_total", "counter",
     "Ranked queries evaluated with MaxScore pruning."),
    ("mri_planner_and_gallop_total", "counter",
     "AND intersection steps taken by the galloping-probe arm."),
    ("mri_planner_and_merge_total", "counter",
     "AND intersection steps taken by the linear-merge arm."),
    ("mri_planner_blocks_scored_total", "counter",
     "Posting blocks pruned ranked evaluation had to score."),
    ("mri_planner_blocks_skipped_total", "counter",
     "Posting blocks whose max-score bound kept them unscored."),
    # incremental indexing (segment-managed dirs; daemon + engine)
    ("mri_segments_active", "gauge",
     "Segments in the live manifest generation."),
    ("mri_generation", "gauge",
     "Generation number of the live segment manifest."),
    ("mri_compactions_total", "counter",
     "Segment compactions completed (runs merged + published)."),
    ("mri_tombstoned_docs", "gauge",
     "Documents masked by tombstone bitmaps in the live generation."),
    ("mri_serve_mutations_total", "counter",
     "Live mutations (append/delete/compact) applied by the daemon."),
    ("mri_serve_mutation_rejected_total", "counter",
     "Live mutations rejected; the old generation kept serving."),
    # durability & replication (WAL + segment shipping; daemon registry)
    ("mri_wal_records_total", "counter",
     "Mutation WAL records fsync'd (the durability point every "
     "acknowledgement waits on)."),
    ("mri_wal_replayed_total", "counter",
     "WAL records applied by crash recovery (acknowledged mutations "
     "rolled forward after a crash)."),
    ("mri_replica_lag_generations", "gauge",
     "Manifest generations a replica was behind its primary at the "
     "last successful catch-up round (0 = caught up)."),
    ("mri_serve_stale_generation_total", "counter",
     "Requests refused because the client's min_generation token is "
     "ahead of the serving generation (read-your-writes fence)."),
    # operational health (rolling SLIs, SLOs, watchdog; daemon registry)
    ("mri_slo_<slo>_ratio_<window>", "gauge",
     "Rolling good-event ratio of one SLO (availability, latency) "
     "over one window (10s, 1m, 5m); 1 when the window saw no events."),
    ("mri_slo_<slo>_burn_<window>", "gauge",
     "SLO burn rate over one window: error-rate / error-budget, where "
     "the budget is 1 - MRI_OBS_SLO_TARGET; above 1 the daemon burns "
     "its budget faster than the objective allows."),
    ("mri_watchdog_stalls_total", "counter",
     "Watchdog-detected stalls: a monitored daemon thread's heartbeat "
     "aged past MRI_OBS_STALL_MS."),
    ("mri_watchdog_heartbeat_age_seconds", "gauge",
     "Age of the oldest monitored-thread heartbeat at scrape time."),
    ("mri_obs_log_dropped_total", "counter",
     "Structured log records dropped by the per-event rate limiter "
     "(MRI_OBS_LOG_RATE_LIMIT)."),
    # fault injection (process-global default registry)
    ("mri_faults_fired_total", "counter",
     "Fault-injection rules fired, all kinds."),
    ("mri_fault_<kind>_fired_total", "counter",
     "Fault-injection firings of one kind (read_error, ...)."),
    # scale-out cluster (router registry: the admission plane reuses
    # the mri_serve_* families above — the router is a serve-plane
    # daemon, so SLO/windows/top math applies unchanged — while shard
    # families arrive in the router scrape labelled
    # {shard="K",replica="R"} via merge_expositions label injection)
    ("mri_cluster_shards", "gauge",
     "Doc-shards the router scatters every data op to."),
    ("mri_cluster_replicas_ready", "gauge",
     "Replica endpoints whose last health probe answered ready."),
    ("mri_router_scatter_rpcs_total", "counter",
     "Shard RPCs issued by scatter fan-out (hedges/retries included)."),
    ("mri_cluster_hedges_total", "counter",
     "Hedge RPCs fired after MRI_CLUSTER_HEDGE_MS (or the shard's "
     "rolling p95) with no primary answer."),
    ("mri_cluster_hedge_wins_total", "counter",
     "Hedged shard RPCs the hedge replica answered first."),
    ("mri_cluster_failovers_total", "counter",
     "Shard RPCs re-routed to another replica after a connection "
     "failure or a not-ready health probe."),
    ("mri_cluster_shard_errors_total", "counter",
     "Shard RPC failures (connection loss / error responses) the "
     "router observed before any retry."),
    # brownout degradation plane (router + daemon registries)
    ("mri_cluster_shard_unavailable_total", "counter",
     "Requests failed with the typed shard_unavailable error: a "
     "shard's replica set was exhausted (or its leg timed out) under "
     "partial_policy=fail, or coverage fell below min_coverage."),
    ("mri_cluster_partial_total", "counter",
     "Degraded answers served with partial=true coverage metadata "
     "(partial_policy=allow riding out missing shards)."),
    ("mri_cluster_retry_denied_total", "counter",
     "Retries/hedges suppressed by the per-shard retry budget "
     "(MRI_CLUSTER_RETRY_BUDGET token bucket empty)."),
    ("mri_cluster_breakers_open", "gauge",
     "Replica circuit breakers currently not closed (open or "
     "half-open) across every shard."),
    ("mri_cluster_breaker_state_s<shard>_r<replica>", "gauge",
     "One replica's circuit-breaker state: 0 closed, 1 half-open, "
     "2 open."),
    ("mri_serve_codel_sheds_total", "counter",
     "Requests shed by CoDel adaptive admission (typed overloaded "
     "answer): queue delay stayed over MRI_SERVE_CODEL_TARGET_MS for "
     "a full interval."),
    ("mri_serve_codel_state", "gauge",
     "CoDel admission controller state: 1 while in the dropping "
     "regime, else 0."),
)

_HELP = {name: help for name, _kind, help in KNOWN_METRICS}


def _fmt(v) -> str:
    """Prometheus sample value: integers without a trailing .0."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _exemplar_suffix(ex) -> str:
    """OpenMetrics exemplar suffix for one bucket line ('' when none)."""
    if ex is None:
        return ""
    trace_id, v, ts = ex
    return f' # {{trace_id="{trace_id}"}} {_fmt(v)} {ts:.3f}'


class Registry:
    """Get-or-create home for named metrics plus the text renderer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}  # guarded by: self._lock

    def _get(self, name: str, cls, help: str, **kw):  # noqa: A002
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help or _HELP.get(name, ""), **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered "
                                f"as {type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:  # noqa: A002
        return self._get(name, Histogram, help, **kw)

    def metrics(self) -> list:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def render_text(self, *, exemplars: bool = False) -> str:
        """Prometheus text exposition (``# TYPE``-annotated).

        With ``exemplars=True``, histogram bucket lines that have seen
        an exemplar carry an OpenMetrics exemplar suffix —
        ``... # {trace_id="<id>"} <value> <unix_ts>`` — linking the
        bucket to a recent representative request in the trace ring.
        Plain-Prometheus scrapers that split on whitespace and skip
        ``{``-labelled names are unaffected (the suffix sits after the
        sample value).
        """
        out = []
        for m in self.metrics():
            if isinstance(m, Counter):
                if m.help:
                    out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} counter")
                out.append(f"{m.name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                if m.help:
                    out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} gauge")
                out.append(f"{m.name} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                if m.help:
                    out.append(f"# HELP {m.name} {m.help}")
                out.append(f"# TYPE {m.name} histogram")
                cum = m.cumulative_counts()
                exm = m.exemplars() if exemplars else [None] * (
                    len(cum) + 1)
                for bound, c, ex in zip(m.bounds, cum, exm):
                    line = f'{m.name}_bucket{{le="{repr(bound)}"}} {c}'
                    out.append(line + _exemplar_suffix(ex))
                out.append(f'{m.name}_bucket{{le="+Inf"}} {cum[-1]}'
                           + _exemplar_suffix(exm[len(cum) - 1]
                                              if exemplars else None))
                out.append(f"{m.name}_sum {_fmt(m.sum)}")
                out.append(f"{m.name}_count {m.count}")
        return "\n".join(out) + "\n" if out else ""

    def as_dict(self) -> dict:
        """Scalar view: counter/gauge values and histogram snapshots."""
        out = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                out[m.name] = m.snapshot()
            else:
                out[m.name] = m.value
        return out


def _label_sample(line: str, label_txt: str) -> str:
    """Inject a rendered label set into one sample line, preserving
    existing labels (histogram ``le``) and any exemplar suffix."""
    head, sep, ex = line.partition(" # ")
    try:
        body, val = head.rsplit(" ", 1)
    except ValueError:
        return line
    if body.endswith("}"):
        body = body[:-1] + "," + label_txt + "}"
    else:
        body = body + "{" + label_txt + "}"
    return body + " " + val + (sep + ex if sep else "")


def merge_expositions(parts, labels=None) -> str:
    """Concatenate text expositions into one legal exposition.

    Unlabelled parts keep the historical semantics: later duplicate
    metric families are dropped by name (first occurrence wins).
    Several registries can legitimately carry the same family — e.g.
    the serve daemon's own registry and a multi-segment engine's both
    track ``mri_generation`` — but one exposition must name each
    family's ``# HELP``/``# TYPE`` exactly once.

    ``labels`` (optional, parallel to ``parts``) maps a part to a
    label dict (or None) injected into every one of its sample lines —
    the scatter-gather router merges its own registry with D shard
    scrapes whose families all collide, so per-part ``{shard="K"}``
    labels keep every series while HELP/TYPE stay deduplicated.
    """
    seen: set[str] = set()
    out: list[str] = []
    for pi, text in enumerate(parts):
        if not text:
            continue
        part_labels = labels[pi] if labels is not None else None
        label_txt = ",".join(
            f'{k}="{v}"' for k, v in part_labels.items()) \
            if part_labels else ""
        keep = True
        for line in text.splitlines():
            if line.startswith(("# HELP ", "# TYPE ")):
                name = line.split(" ", 3)[2]
                if line.startswith("# TYPE "):
                    keep = name not in seen
                    seen.add(name)
                else:
                    # HELP precedes TYPE: peek whether its family is new
                    keep = name not in seen
                if keep:
                    out.append(line)
                continue
            if label_txt:
                # labelled samples always survive — the labels are the
                # disambiguation — only their HELP/TYPE dedups above
                out.append(_label_sample(line, label_txt))
            elif keep:
                out.append(line)
    return "\n".join(out) + "\n" if out else ""


_default = Registry()


def default_registry() -> Registry:
    """The process-global registry (fault firings only — everything
    serve-plane lives on per-daemon / per-engine registries)."""
    return _default

