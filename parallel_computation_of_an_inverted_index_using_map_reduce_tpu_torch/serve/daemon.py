"""Resident serving daemon over one loaded ``index.mri`` artifact (the
JAX package's ``serve/daemon.py``, serving from the card's device engine
by default).

``query`` pays the artifact open + engine warmup on every invocation;
:class:`ServeDaemon` loads once, accepts concurrent connections speaking
a JSON-lines protocol, and coalesces whatever is pending into
micro-batches for the engine's vectorized batch path.

The headline is the robustness envelope, not raw QPS:

admission control
    The pending queue is bounded (``MRI_SERVE_QUEUE_DEPTH``).  A full
    queue sheds the request with a counted ``{"error":"overloaded"}``
    response — never a silent drop, never an unbounded queue.
deadlines
    Requests may carry ``deadline_ms``; work whose deadline passed is
    dropped *before* dispatch and answered ``deadline_expired``
    (counted) — stale work never occupies the engine.
graceful drain
    :meth:`drain` (the CLI's SIGTERM/SIGINT) stops accepting, finishes
    in-flight work within ``MRI_SERVE_DRAIN_S``, flushes stragglers as
    counted ``draining`` errors, joins every thread, flushes stats,
    and returns for a clean exit 0.  A second signal forces exit 1.
crash-safe hot reload
    :meth:`reload` (the CLI's SIGHUP, or the ``reload`` protocol
    command) opens and checksum-verifies the replacement artifact off
    the dispatcher, then swaps engines atomically under the dispatch
    lock.  Verification failure keeps the old artifact serving and
    counts ``reload_rejected`` — the tmp+rename/``ArtifactError``
    discipline extended to live traffic.

Threading model: one accept thread, one dispatcher (the only thread
that touches the engine's batch path), and a reader/writer pair per
connection.  Writers own their socket exclusively (responses are
single ``sendall`` lines — never torn) and are fed through a bounded
outbound queue, so a stalled peer can only ever cost its own
connection (counted ``slow_client_closes``), never the dispatcher.

Protocol — one JSON object per line, one response line per request::

    {"id": 1, "op": "df",       "terms": ["the", "magic"]}
    {"id": 2, "op": "postings", "terms": ["magic"], "deadline_ms": 50}
    {"id": 3, "op": "and",      "terms": ["big", "cat"]}
    {"id": 4, "op": "or",       "terms": ["big", "cat"]}
    {"id": 5, "op": "top_k",    "letter": "a", "k": 3}
    {"id": 5, "op": "top_k",    "score": "bm25", "k": 3,
                                "terms": ["big", "cat"]}
    {"id": 6, "op": "stats"}        # admin: answered inline
    {"id": 7, "op": "healthz"}      # admin: answered inline
    {"id": 8, "op": "reload"}       # admin: swap to the new index.mri
    {"id": 9, "op": "metrics"}      # admin: Prometheus text exposition
    {"id": 10, "op": "trace", "n": 8}   # admin: recent request traces
    {"id": 11, "op": "append", "files": ["d.txt"]}   # admin: live append
    {"id": 12, "op": "delete", "docs": [7, 9]}       # admin: tombstone
    {"id": 13, "op": "compact"}     # admin: merge a segment run
    {"id": 14, "op": "flightdump"}  # admin: flight-recorder contents
    {"id": 15, "op": "top_k", "score": "bm25", "k": 3,
               "terms": ["big", "cat"], "explain": true}  # cost report
    {"id": 16, "op": "snapshot"}    # admin: manifest for replication
    {"id": 17, "op": "fetch_segment", "segment": "seg_2_1",
               "file": "index.mri"}  # admin: ship one segment file
    {"id": 18, "op": "wal_tail", "after_seq": 12}  # admin: WAL tail
    {"id": 19, "op": "df", "terms": ["cat"],
               "min_generation": 7}  # read-your-writes fence
    {"id": 20, "op": "df", "terms": ["cat"],
               "tenant": "search-ui"}  # multi-tenant QoS lane

Live mutations (the ``append``/``delete``/``compact`` ops) run on the
reader thread under the reload lock — never the dispatcher — publish a
new segment-manifest generation on disk, open a fresh engine over it
(the host ``MultiSegmentEngine``, as in the JAX package), and swap
under the dispatch lock exactly like a hot reload.  Any failure keeps
the OLD generation serving and counts ``mutation_rejected``.  Deletes
batch per ``MRI_SEGMENT_TOMBSTONE_FLUSH`` (a generation is published
every N delete ops; a ``compact`` or drain flushes the remainder).

Durability: with ``MRI_SEGMENT_WAL`` on (default), every mutation's
checksummed WAL record is fsync'd BEFORE its manifest swap and before
the ack leaves the wire — buffered delete ops included, so a SIGKILL
between an acknowledged delete and its batched tombstone flush is
replayed by the startup recovery (``segments.recover``) that runs
before the first engine opens.  Replication: ``snapshot`` /
``fetch_segment`` / ``wal_tail`` serve a replica's catch-up round
(``--replica-of`` or ``replicate``); a replica is read-only, reports
``replica_lagging`` in healthz until a round succeeds, and adopts
shipped generations with a quiet engine swap.  Read-your-writes across
failover: mutation acks echo a ``generation`` token, and any request
may carry ``min_generation`` — a node still behind that generation
answers ``stale_generation`` instead of serving stale state.  With
``MRI_SEGMENT_LEASE_TTL_S`` > 0 mutations renew a TTL'd primary lease
inside ``segments.lock`` first; a live foreign holder rejects the
mutation with a ``lease_lost`` detail.

Result cache: repeat data queries are answered from a
generation-keyed whole-payload cache (:mod:`.result_cache`,
``MRI_SERVE_RESULT_CACHE``) on the reader thread — a hit never touches
the dispatch queue or the engine, and the answer is byte-identical to
the engine's because the cache key carries the published manifest
generation (a hot reload, which may change content at an unchanged
generation, purges outright).  ``explain`` requests always run the engine.

Multi-tenant QoS: requests may carry a ``tenant`` name.  Each tenant
gets its own bounded dispatch lane (weighted-fair dequeue per
``MRI_SERVE_TENANT_WEIGHTS``), an optional token-bucket admission rate
(``MRI_SERVE_TENANT_RATE``), its own CoDel gate (the delay
machinery composes per tenant), per-tenant counters/latency histogram
on the registry (rolled into the rolling windows + SLO burn, surfaced
in ``stats()["tenants"]``), and a ``tenant``-filtered ``flightdump``
slice.  Untagged requests ride the ``default`` tenant and behave
exactly like the pre-tenant daemon.

Success: ``{"id":1,"ok":true,"df":[5241,3]}``.  Failure:
``{"id":2,"error":"<kind>","detail":"..."}`` with kind one of
``overloaded`` / ``deadline_expired`` / ``draining`` /
``bad_request`` / ``internal`` / ``reload_rejected`` /
``mutation_rejected`` / ``stale_generation`` — every one counted in
``stats``.

Threads and the card: only the dispatcher runs the engine's batch path.
A reload builds the new engine on the caller's thread; the device
engine waits for its own uploads at the end of construction, so the
swapped-in columns are complete before the dispatcher reads them, and
the old engine's ``close()`` drops its columns.

Observability: every tally is an ``obs.metrics`` counter on the
daemon's registry; ``stats()["counters"]`` is a byte-compatible view
over it and the ``metrics`` op (or ``--listen-metrics PORT``) renders
the same numbers as ``# TYPE``-annotated Prometheus text.  Requests
may carry a ``trace_id`` (auto-generated under ``MRI_OBS_ENABLE``)
which is echoed on the response; each finished request records
contiguous queue-wait → coalesce → engine spans into a bounded ring
(the ``trace`` op) and requests slower than ``MRI_OBS_SLOW_MS`` emit
one structured JSON line on the ``mri_torch.obs`` logger.

Cost attribution: a data request carrying ``"explain": true`` runs
SOLO (outside the coalesced df/postings groups, so its costs are its
own) under an :mod:`..obs.attribution` collector, and the response
carries an ``explain`` object — per-term resolution, planner decision
with its θ progression, blocks scored/skipped, bytes decoded, cache
hits, per-stage µs.  Every completed request (explain or not) also
lands in the :class:`..obs.attribution.FlightRecorder` — a bounded
ring (``MRI_OBS_FLIGHT_RING``) dumped as one JSON file on dispatcher
crash, abnormal drain, the CLI's SIGQUIT, or on demand through the
``flightdump`` admin op.  Latency histograms attach OpenMetrics
exemplars (``MRI_OBS_EXEMPLARS``) so a scrape's slow bucket links back
to a concrete trace_id in the ring.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import re
import socket
import threading
import time
from collections import deque
from pathlib import Path

from .. import faults
from ..obs import attribution as obs_attrib
from ..obs import logging as obs_logging
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import tracing as obs_tracing
from ..obs import watchdog as obs_watchdog
from ..obs import windows as obs_windows
from ..utils import envknobs
from . import result_cache as result_cache_mod
from .artifact import ArtifactError
from .engine import create_engine

log = logging.getLogger("mri_torch.serve.daemon")

COALESCE_ENV = "MRI_SERVE_COALESCE_US"
QUEUE_ENV = "MRI_SERVE_QUEUE_DEPTH"
BATCH_ENV = "MRI_SERVE_MAX_BATCH"
DRAIN_ENV = "MRI_SERVE_DRAIN_S"
CODEL_TARGET_ENV = "MRI_SERVE_CODEL_TARGET_MS"
CODEL_INTERVAL_ENV = "MRI_SERVE_CODEL_INTERVAL_MS"

#: Per-connection outbound response queue bound: past this, the peer
#: is not reading and the connection is closed (counted) rather than
#: letting responses pile up or the dispatcher block.
OUTBOUND_DEPTH = 1024

DATA_OPS = ("df", "postings", "and", "or", "top_k")
ADMIN_OPS = ("stats", "healthz", "reload", "metrics", "trace",
             "append", "delete", "compact", "flightdump", "slo",
             "snapshot", "fetch_segment", "wal_tail")

OVERLOAD_ENV = "MRI_OBS_OVERLOAD_SHED_RATE"

_SENTINEL = object()

#: legacy ``counters`` key -> Prometheus metric name, in the
#: historical insertion order (``stats()["counters"]`` preserves it)
_COUNTER_NAMES = (
    ("requests", "mri_serve_requests_total"),
    ("responses", "mri_serve_responses_total"),
    ("shed", "mri_serve_shed_total"),
    ("deadline_expired", "mri_serve_deadline_expired_total"),
    ("draining_rejected", "mri_serve_draining_rejected_total"),
    ("bad_request", "mri_serve_bad_request_total"),
    ("internal_errors", "mri_serve_internal_errors_total"),
    ("client_disconnects", "mri_serve_client_disconnects_total"),
    ("slow_client_closes", "mri_serve_slow_client_closes_total"),
    ("reload_ok", "mri_serve_reload_ok_total"),
    ("reload_rejected", "mri_serve_reload_rejected_total"),
    ("batches", "mri_serve_batches_total"),
    ("batched_requests", "mri_serve_batched_requests_total"),
    ("connections", "mri_serve_connections_total"),
    ("mutations", "mri_serve_mutations_total"),
    ("mutation_rejected", "mri_serve_mutation_rejected_total"),
    ("stale_generation", "mri_serve_stale_generation_total"),
    ("codel_sheds", "mri_serve_codel_sheds_total"),
)


class _CoDelGate:
    """Controlled-delay admission: shed on sustained queue DELAY, not
    queue depth.

    The fixed bounded queue sheds only when it is completely full — by
    then every queued request has already paid the worst-case wait,
    and under sustained overload the daemon times out work it already
    queued ("late and expensive").  This gate adapts CoDel (RFC 8289,
    in its server-admission variant) to the dispatcher: the dispatcher
    reports every popped request's queue delay via :meth:`on_delay`;
    once the delay has stayed above ``target_s`` for a full
    ``interval_s`` the gate enters the *dropping* state, where

    * reader threads shed new arrivals at the control-law rate
      (:meth:`should_shed`, next shed at ``interval/sqrt(count)`` —
      pressure grows the longer the overload lasts), and
    * the dispatcher sheds ALREADY-QUEUED requests whose delay
      exceeds the target (:meth:`late_shed`) — cheap, pre-execution —
      so the requests that DO execute carry bounded queueing.

    The first on_delay below target exits dropping.  ``target_s`` 0
    disables the gate entirely (fixed-queue behavior)."""

    def __init__(self, target_s: float, interval_s: float,
                 gauge=None, clock=time.monotonic):
        self.target_s = target_s
        self.interval_s = interval_s
        self._gauge = gauge  # mri_serve_codel_state: 1 while dropping
        self._clock = clock
        self._lock = threading.Lock()
        self._first_above: float | None = None
        self._dropping = False
        self._drop_next = 0.0
        self._count = 0

    @property
    def enabled(self) -> bool:
        return self.target_s > 0

    @property
    def dropping(self) -> bool:
        return self._dropping

    def on_delay(self, delay_s: float) -> None:
        """Dispatcher feed: the queue delay of a just-popped request."""
        if not self.enabled:
            return
        now = self._clock()
        with self._lock:
            if delay_s < self.target_s:
                self._first_above = None
                if self._dropping:
                    self._dropping = False
                    if self._gauge is not None:
                        self._gauge.set(0)
            elif self._first_above is None:
                self._first_above = now
            elif not self._dropping \
                    and now - self._first_above >= self.interval_s:
                self._dropping = True
                # CoDel restart heuristic: a recent dropping episode
                # resumes near its old rate instead of from scratch
                self._count = self._count - 2 if self._count > 2 else 1
                self._drop_next = now
                if self._gauge is not None:
                    self._gauge.set(1)

    def should_shed(self) -> bool:
        """Reader-thread admission check: shed this arrival?"""
        if not self.enabled:
            return False
        with self._lock:
            if not self._dropping:
                return False
            now = self._clock()
            if now < self._drop_next:
                return False
            self._count += 1
            self._drop_next = now + \
                self.interval_s / (self._count ** 0.5)
            return True

    def late_shed(self, delay_s: float) -> bool:
        """Dispatcher dequeue check: while dropping, a request that
        already waited past the target is shed before execution."""
        if not self.enabled:
            return False
        with self._lock:
            return self._dropping and delay_s > self.target_s

    def state(self) -> dict:
        with self._lock:
            return {"dropping": self._dropping, "count": self._count}


#: tenant names on the wire: short, metric-safe-ish, no whitespace
_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

#: overflow lane once MRI_SERVE_TENANT_MAX distinct names are tracked
OTHER_TENANT = "other"


def _sanitize_tenant(name: str) -> str:
    """Metric-name-safe label for a tenant (dots/dashes to underscores;
    two names that sanitize identically share metric series — the
    admission lanes stay distinct)."""
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


def _parse_tenant_weights(spec: str) -> dict:
    """``MRI_SERVE_TENANT_WEIGHTS`` grammar: ``name=w,name=w,*=w``
    (integer weights >= 1; ``*`` is the default for unlisted names)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, w = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"tenant weight {part!r} is not name=weight")
        try:
            wi = int(w)
        except ValueError:
            raise ValueError(f"tenant weight {part!r}: weight must be "
                             "an integer") from None
        if wi < 1:
            raise ValueError(
                f"tenant weight {part!r}: weight must be >= 1")
        out[name.strip()] = wi
    return out


def _parse_tenant_rates(spec: str) -> dict:
    """``MRI_SERVE_TENANT_RATE`` grammar: ``name=rps[:burst],...``
    (floats; burst defaults to one second of rps, floor 1)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, rate = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(
                f"tenant rate {part!r} is not name=rps[:burst]")
        rps_s, _, burst_s = rate.partition(":")
        try:
            rps = float(rps_s)
            burst = float(burst_s) if burst_s else max(1.0, rps)
        except ValueError:
            raise ValueError(f"tenant rate {part!r}: rps/burst must "
                             "be numbers") from None
        if rps <= 0 or burst < 1:
            raise ValueError(f"tenant rate {part!r}: rps must be > 0 "
                             "and burst >= 1")
        out[name.strip()] = (rps, burst)
    return out


class _TokenBucket:
    """Classic token bucket: ``rps`` refill, ``burst`` cap, one token
    per admitted request.  Thread-safe (reader threads race)."""

    def __init__(self, rps: float, burst: float, clock=time.monotonic):
        self.rps = float(rps)
        self.burst = float(burst)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst  # guarded by: self._lock
        self._t = clock()          # guarded by: self._lock

    def allow(self) -> bool:
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rps)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


class _TenantState:
    """One tenant's QoS lane: weight, optional admission bucket, its
    own CoDel gate, per-tenant counters/histogram (tracked by the
    rolling windows) and an SLO tracker over them."""

    __slots__ = ("name", "label", "weight", "bucket", "codel",
                 "c_requests", "c_shed", "c_deadline", "c_errors",
                 "c_cache_hits", "h_request", "hist_name", "slo")

    def __init__(self, name: str, *, registry, rolling, weight: int,
                 rate, codel):
        self.name = name
        self.label = _sanitize_tenant(name)
        base = f"mri_serve_tenant_{self.label}"
        self.c_requests = registry.counter(f"{base}_requests_total")
        self.c_shed = registry.counter(f"{base}_shed_total")
        self.c_deadline = registry.counter(
            f"{base}_deadline_expired_total")
        self.c_errors = registry.counter(f"{base}_errors_total")
        self.c_cache_hits = registry.counter(
            f"{base}_result_cache_hits_total")
        self.hist_name = f"{base}_request_seconds"
        self.h_request = registry.histogram(self.hist_name)
        rolling.track(
            counters=(f"{base}_requests_total", f"{base}_shed_total",
                      f"{base}_deadline_expired_total",
                      f"{base}_errors_total"),
            histograms=(self.hist_name,))
        self.weight = max(1, int(weight))
        self.bucket = None if rate is None else _TokenBucket(*rate)
        self.codel = codel
        # per-tenant burn: same math as the daemon-wide tracker over
        # this lane's series; the lane's requests counter already
        # counts its sheds (incremented at arrival), so no extra_total
        self.slo = obs_slo.SLOTracker(
            rolling,
            total=f"{base}_requests_total",
            bad=(f"{base}_errors_total", f"{base}_shed_total",
                 f"{base}_deadline_expired_total"),
            extra_total=(),
            latency_hist=self.hist_name)


class _FairQueue:
    """Weighted-fair dispatch queue, drop-in for the old bounded
    ``queue.Queue``: ``put_nowait`` / ``get`` / ``get_nowait`` /
    ``qsize`` keep their signatures (``queue.Full`` / ``queue.Empty``
    included) so the dispatcher and drain paths are unchanged.  One
    bounded FIFO lane per tenant; ``get`` serves lanes round-robin
    with each lane taking up to ``weight`` consecutive items at the
    head before rotating to the back.  A full lane sheds only its own
    tenant.  With a single tenant this degenerates to exactly the old
    single FIFO."""

    def __init__(self, depth: int):
        self.depth = depth
        self._cv = threading.Condition()
        self._lanes: dict = {}    # tstate -> deque  # guarded by: self._cv
        self._active: deque = deque()  # lanes with items, RR order  # guarded by: self._cv
        self._queued: set = set()  # tstates present in _active  # guarded by: self._cv
        self._credit = 0  # head lane's remaining turn  # guarded by: self._cv
        self._size = 0    # guarded by: self._cv

    def put_nowait(self, item) -> None:
        ts = item.tstate
        with self._cv:
            lane = self._lanes.get(ts)
            if lane is None:
                lane = self._lanes[ts] = deque()
            if len(lane) >= self.depth:
                raise queue.Full
            lane.append(item)
            self._size += 1
            if ts not in self._queued:
                self._active.append(ts)
                self._queued.add(ts)
                if len(self._active) == 1:
                    self._credit = ts.weight
            self._cv.notify()

    def _pop_locked(self):
        ts = self._active[0]
        lane = self._lanes[ts]
        item = lane.popleft()
        self._size -= 1
        self._credit -= 1
        if not lane:
            self._active.popleft()
            self._queued.discard(ts)
            if self._active:
                self._credit = self._active[0].weight
        elif self._credit <= 0:
            self._active.rotate(-1)
            self._credit = self._active[0].weight
        return item

    def get(self, timeout: float | None = None):
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._size == 0:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise queue.Empty
                self._cv.wait(rem)
            return self._pop_locked()

    def get_nowait(self):
        with self._cv:
            if self._size == 0:
                raise queue.Empty
            return self._pop_locked()

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def lane_depth(self, ts) -> int:
        with self._cv:
            lane = self._lanes.get(ts)
            return len(lane) if lane else 0


class _Request:
    """One admitted data request, from queue admission to its single
    ``finish`` (exactly one response per request — ok or counted
    error — enforced by the ``done`` flag)."""

    __slots__ = ("conn", "rid", "op", "terms", "letter", "k", "score",
                 "seq", "expires_at", "done", "trace_id", "t_admit",
                 "t_pop", "t_exec", "planner", "explain", "attrib",
                 "tenant", "tstate", "cached", "ckey", "cgen")

    def __init__(self, conn, rid, op, terms, letter, k, score, seq,
                 expires_at, trace_id=None, t_admit=0.0, explain=False,
                 tenant=None, tstate=None):
        self.conn = conn
        self.rid = rid
        self.op = op
        self.terms = terms
        self.letter = letter
        self.k = k
        self.score = score
        self.seq = seq
        self.expires_at = expires_at
        self.done = False
        self.trace_id = trace_id
        self.t_admit = t_admit  # monotonic admission timestamp
        self.t_pop = None  # dispatcher popped it off the queue
        self.t_exec = None  # batch reached the engine lock
        self.planner = None  # ranked queries: the planner's decision
        self.explain = explain  # run solo under a cost collector
        self.attrib = None  # the collector, once the request executed
        self.tenant = tenant  # wire tenant name ("default" if untagged)
        self.tstate = tstate  # its _TenantState (QoS lane)
        self.cached = False  # answered from the result cache
        self.ckey = None  # epoch-free result-cache key (None: uncacheable)
        self.cgen = None  # generation snapshot taken with the engine


class _Conn:
    """One accepted connection: reader thread (parse + admit), writer
    thread (sole socket writer), bounded outbound queue between the
    daemon and the writer."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, daemon: "ServeDaemon", sock: socket.socket, addr):
        self.daemon = daemon
        self.sock = sock
        self.addr = addr
        self.outbound: queue.Queue = queue.Queue(maxsize=OUTBOUND_DEPTH)
        self.lock = threading.Lock()
        self.pending = 0  # admitted, not yet enqueued  # guarded by: self.lock
        self.read_eof = False
        self.dead = False
        self.reader_done = False
        self.writer_done = False
        cid = next(self._ids)
        self.reader = threading.Thread(
            target=daemon._reader_loop, args=(self,),
            name=f"mri-serve-read-{cid}", daemon=True)
        self.writer = threading.Thread(
            target=daemon._writer_loop, args=(self,),
            name=f"mri-serve-write-{cid}", daemon=True)

    def start(self) -> None:
        self.reader.start()
        self.writer.start()

    def enqueue(self, seq: int, payload: dict) -> bool:
        """Queue one response line for the writer.  False (and the
        connection is condemned) when the peer is too slow to drain
        OUTBOUND_DEPTH responses."""
        data = (json.dumps(payload, separators=(",", ":")) + "\n").encode()
        try:
            self.outbound.put_nowait((seq, data))
            return True
        except queue.Full:
            if not self.dead:
                self.daemon._count("slow_client_closes")
            self.kill()
            return False

    def enqueue_sentinel(self) -> None:
        try:
            self.outbound.put_nowait(_SENTINEL)
        except queue.Full:
            self.kill()  # writer exits on the closed socket instead

    def kill(self) -> None:
        """Force-close the socket: both loops unblock and exit."""
        self.dead = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    @property
    def finished(self) -> bool:
        return self.reader_done and self.writer_done


class ServeDaemon:
    """The resident server.  ``start()`` binds and spawns threads;
    ``drain()`` is the graceful single-exit path (idempotent);
    ``reload()`` hot-swaps the artifact.  See the module docstring for
    the protocol and robustness contract."""

    def __init__(self, path, host: str = "127.0.0.1", port: int = 0, *,
                 engine: str | None = None, cache_terms: int = 4096,
                 shards: int | None = None,
                 coalesce_us: int | None = None,
                 queue_depth: int | None = None,
                 max_batch: int | None = None,
                 drain_s: float | None = None,
                 metrics_port: int | None = None,
                 replica_of: str | None = None,
                 device=None):
        self._path = path
        # the segment layer's directory: ``path``, or the directory of an
        # ``index.mri`` path (the JAX daemon refuses a file path here;
        # ROADMAP §C)
        p = Path(path)
        self._root = p.parent if p.is_file() else p
        self._replica_of = replica_of
        if replica_of is None:
            # startup recovery BEFORE the first engine opens: WAL
            # records acknowledged by a crashed predecessor are part of
            # the index, not debris — roll the directory forward to the
            # exact last-acked generation.  Replicas skip this: their
            # adopted tail may reference source files that only exist
            # on the primary, so they converge by segment shipping.
            from .. import segments
            rep = segments.recover(self._root)
            if rep.get("replayed"):
                log.info("startup recovery: %s", json.dumps(rep))
        else:
            # bootstrap catch-up so a replica born on an empty dir has
            # a generation to open; an unreachable primary only warns —
            # an existing local generation serves stale while the poll
            # loop heals (a dir with nothing to serve still fails the
            # engine open below)
            from .. import segments
            from ..segments import replica as segrep
            addr = segrep.parse_addr(replica_of)
            try:
                segrep.replicate(self._root, addr)
            except (segments.SegmentError, OSError) as e:
                log.warning("initial replica catch-up from %s failed: "
                            "%s", replica_of, e)
        self._device = device
        self._engine_choice = engine
        self._cache_terms = cache_terms
        self._shards = shards
        self.coalesce_us = coalesce_us if coalesce_us is not None \
            else envknobs.get(COALESCE_ENV)
        self.queue_depth = queue_depth if queue_depth is not None \
            else envknobs.get(QUEUE_ENV)
        self.max_batch = max_batch if max_batch is not None \
            else envknobs.get(BATCH_ENV)
        self.drain_s = drain_s if drain_s is not None \
            else envknobs.get(DRAIN_ENV)
        self.codel_target_ms = envknobs.get(CODEL_TARGET_ENV)
        self.codel_interval_ms = envknobs.get(CODEL_INTERVAL_ENV)

        self._engine_lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._engine = create_engine(path, engine, cache_terms=cache_terms,
                                     shards=shards, device=device)  # guarded by: self._engine_lock
        td = envknobs.get("MRI_SERVE_TENANT_QUEUE_DEPTH")
        self._tenant_depth = td if td > 0 else self.queue_depth
        self._queue = _FairQueue(self._tenant_depth)
        self._inflight = 0  # admitted minus finished  # guarded by: self._count_lock
        self._seq = 0  # data-request ordinal (faults)  # guarded by: self._count_lock
        # every tally is an obs counter on this per-daemon registry;
        # _counts maps the legacy stats key to its counter object (the
        # mapping itself is immutable after construction)
        self.registry = obs_metrics.Registry()
        self._counts = {key: self.registry.counter(name)
                        for key, name in _COUNTER_NAMES}
        self._g_queue_depth = self.registry.gauge("mri_serve_queue_depth")
        self._g_inflight = self.registry.gauge("mri_serve_inflight")
        self._g_draining = self.registry.gauge("mri_serve_draining")
        self._codel = _CoDelGate(
            self.codel_target_ms / 1e3, self.codel_interval_ms / 1e3,
            gauge=self.registry.gauge("mri_serve_codel_state"))
        self._h_request = \
            self.registry.histogram("mri_serve_request_seconds")
        self._h_queue_wait = \
            self.registry.histogram("mri_serve_queue_wait_seconds")
        self._count_lock = threading.Lock()
        self._obs_enabled = obs_tracing.enabled()
        self._slow_ms = obs_tracing.slow_ms()
        self._trace_ring = obs_tracing.TraceRing()
        self._exemplars = obs_attrib.exemplars_enabled()
        self._flight = obs_attrib.FlightRecorder(
            slow_threshold_ms=self._slow_ms)
        # operational health: rolling SLIs sampled off this registry,
        # SLO math over them, and the stall watchdog.  The sampler
        # diffs cumulative state — zero new hot-path feed sites.
        self._rolling = obs_windows.RollingWindows(
            self.registry,
            counters=[name for _key, name in _COUNTER_NAMES],
            histograms=("mri_serve_request_seconds",))
        self._slo = obs_slo.SLOTracker(self._rolling)
        # generation-keyed whole-payload cache, probed on reader
        # threads and filled by the dispatcher under the engine lock
        self._result_cache = result_cache_mod.ResultCache(
            registry=self.registry)
        # multi-tenant QoS: lanes materialize on a tenant's first
        # request; untagged traffic rides "default", whose CoDel gate
        # IS the daemon-wide gate (pre-tenant behavior preserved)
        self._tenant_lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}  # guarded by: self._tenant_lock
        self._tenant_weights = _parse_tenant_weights(
            envknobs.get("MRI_SERVE_TENANT_WEIGHTS"))
        self._tenant_rates = _parse_tenant_rates(
            envknobs.get("MRI_SERVE_TENANT_RATE"))
        self._tenant_max = envknobs.get("MRI_SERVE_TENANT_MAX")
        self._tenant("default")
        self._watchdog = obs_watchdog.Watchdog(
            on_stall=self._on_stall, on_recover=self._on_recover,
            registry=self.registry)
        self._overload_shed_rate = envknobs.get(OVERLOAD_ENV)
        self._reloading = False
        self._conns: set[_Conn] = set()  # guarded by: self._conn_lock
        self._conn_lock = threading.Lock()
        self._draining = False
        self._drain_started = False  # guarded by: self._drain_guard
        self._drain_guard = threading.Lock()
        self._drained = threading.Event()
        self._dispatch_stop = threading.Event()
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._dispatcher: threading.Thread | None = None
        self._metrics_port = metrics_port
        self._metrics_listener: socket.socket | None = None
        self._metrics_thread: threading.Thread | None = None
        # live-mutation state (segment-managed dirs); buffered delete
        # ops flush every MRI_SEGMENT_TOMBSTONE_FLUSH ops (guarded by:
        # self._reload_lock, like every mutation)
        self._pending_deletes: list[int] = []
        self._delete_ops = 0
        self._tomb_flush = envknobs.get("MRI_SEGMENT_TOMBSTONE_FLUSH")
        # a failed delete flush leaves acked WAL records above the
        # manifest's wal_seq; the next mutation replays them first so
        # truncation can never pass an unapplied acked record
        self._stale_wal = False  # guarded by: self._reload_lock
        self._lease_owner = f"pid{os.getpid()}"  # rebound on start()
        # last published generation — the read-your-writes token echoed
        # on mutation acks and checked against ``min_generation``
        from .. import segments
        try:
            man = segments.load_manifest(self._root)
        except segments.SegmentError:
            man = None
        self._generation = 0 if man is None else man.generation
        self._replica_stop = threading.Event()
        self._replica_thread: threading.Thread | None = None
        # a replica is born lagging: not ready until one catch-up
        # round against the primary has succeeded
        self._replica_lagging = replica_of is not None
        self._g_replica_lag = \
            self.registry.gauge("mri_replica_lag_generations")
        self._host = host
        self._port = port
        self.final_stats: dict | None = None

    # -- lifecycle ----------------------------------------------------

    def start(self) -> None:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self._host, self._port))
        ls.listen(128)
        ls.settimeout(0.2)
        self._listener = ls
        self._host, self._port = ls.getsockname()[:2]
        self._lease_owner = f"{self._host}:{self._port}#{os.getpid()}"
        self._watchdog.register("dispatcher")
        self._watchdog.register("accept")
        self._rolling.start()
        self._watchdog.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="mri-serve-dispatch",
            daemon=True)
        self._dispatcher.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mri-serve-accept", daemon=True)
        self._accept_thread.start()
        if self._metrics_port is not None:
            ms = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ms.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ms.bind(("127.0.0.1", self._metrics_port))
            ms.listen(8)
            ms.settimeout(0.2)
            self._metrics_listener = ms
            self._metrics_port = ms.getsockname()[1]
            self._metrics_thread = threading.Thread(
                target=self._metrics_loop, name="mri-serve-metrics",
                daemon=True)
            self._metrics_thread.start()
        if self._replica_of is not None:
            self._replica_thread = threading.Thread(
                target=self._replica_loop, name="mri-serve-replica",
                daemon=True)
            self._replica_thread.start()
        log.info("serving %s on %s:%d (engine=%s coalesce_us=%d "
                 "queue_depth=%d max_batch=%d)", self._path, self._host,
                 self._port, self._engine.engine_name, self.coalesce_us,
                 self.queue_depth, self.max_batch)

    @property
    def address(self) -> tuple[str, int]:
        return self._host, self._port

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def metrics_address(self) -> tuple[str, int] | None:
        """(host, port) of the HTTP scrape listener, when enabled."""
        if self._metrics_listener is None:
            return None
        return "127.0.0.1", self._metrics_port

    def _count(self, key: str, n: int = 1) -> None:
        self._counts[key].inc(n)

    # -- multi-tenant QoS ----------------------------------------------

    def _tenant(self, name: str) -> _TenantState:
        """The tenant's lane, created on first sight.  Past
        ``MRI_SERVE_TENANT_MAX`` distinct names, new ones fold into the
        shared ``other`` lane (bounded metric cardinality)."""
        with self._tenant_lock:
            ts = self._tenants.get(name)
            if ts is not None:
                return ts
            if len(self._tenants) >= self._tenant_max:
                name = OTHER_TENANT
                ts = self._tenants.get(name)
                if ts is not None:
                    return ts
            gate = self._codel if name == "default" else _CoDelGate(
                self.codel_target_ms / 1e3,
                self.codel_interval_ms / 1e3)
            ts = _TenantState(
                name, registry=self.registry, rolling=self._rolling,
                weight=self._tenant_weights.get(
                    name, self._tenant_weights.get("*", 1)),
                rate=self._tenant_rates.get(
                    name, self._tenant_rates.get("*")),
                codel=gate)
            self._tenants[name] = ts
            return ts

    def _tenant_list(self) -> list:
        with self._tenant_lock:
            return list(self._tenants.values())

    # -- operational health --------------------------------------------

    def _ready_reasons(self) -> list:
        """Why the daemon is NOT ready to serve right now ([] = ready).
        Ordered: the first reason becomes the legacy ``status``."""
        reasons = []
        if self._draining:
            reasons.append("draining")
        if self._reloading:
            reasons.append("reloading")
        if self._watchdog.stalled():
            reasons.append("stalled")
        if self._replica_of is not None and self._replica_lagging:
            reasons.append("replica_lagging")
        limit = self._overload_shed_rate
        if limit > 0:
            counts = self._rolling.counts(10.0)
            shed = counts.get("mri_serve_shed_total", 0)
            attempts = shed + counts.get("mri_serve_requests_total", 0)
            if attempts > 0 and shed / attempts >= limit:
                reasons.append("overloaded")
        return reasons

    def _on_stall(self, name: str, age_ms: float) -> None:
        """Watchdog callback (monitor thread), once per stall episode:
        one structured event + a flight-recorder dump to autopsy."""
        obs_logging.emit(log, "stall", level=logging.WARNING,
                         thread=name, age_ms=round(age_ms, 1),
                         stall_ms=self._watchdog.stall_ms)
        self.dump_flight("stall")

    def _on_recover(self, name: str) -> None:
        obs_logging.emit(log, "stall_recovered", thread=name)

    # -- accept / per-connection threads -------------------------------

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._draining:
            self._watchdog.beat("accept")
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                self._prune_conns()
                continue
            except OSError:
                break  # listener closed by drain()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self, sock, addr)
            with self._conn_lock:
                self._conns.add(conn)
            self._count("connections")
            conn.start()

    def _prune_conns(self) -> None:
        with self._conn_lock:
            done = [c for c in self._conns if c.finished]
            self._conns.difference_update(done)

    def _reader_loop(self, conn: _Conn) -> None:
        f = None
        try:
            f = conn.sock.makefile("rb")
            for raw in f:
                self._handle_line(conn, raw)
                if conn.dead:
                    break
        except (OSError, ValueError):
            pass
        finally:
            # The makefile wrapper holds an _io_refs reference on the
            # socket: until it is closed, socket.close() only marks the
            # object closed and the OS fd stays open (a leak the conftest
            # guard would flag).  Close it here, deterministically.
            if f is not None:
                with contextlib.suppress(OSError):
                    f.close()
            with conn.lock:
                conn.read_eof = True
                idle = conn.pending == 0
            if idle:
                conn.enqueue_sentinel()
            conn.reader_done = True

    def _writer_loop(self, conn: _Conn) -> None:
        inj = faults.active()
        try:
            while True:
                item = conn.outbound.get()
                if item is _SENTINEL:
                    break
                seq, data = item
                if inj and seq and inj.on_serve_response(seq):
                    self._count("client_disconnects")
                    break
                try:
                    conn.sock.sendall(data)
                except OSError:
                    self._count("client_disconnects")
                    break
                self._count("responses")
        finally:
            conn.kill()
            conn.writer_done = True

    # -- request admission ---------------------------------------------

    def _handle_line(self, conn: _Conn, raw: bytes) -> None:
        line = raw.strip()
        if not line:
            return
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            self._count("bad_request")
            conn.enqueue(0, {"error": "bad_request", "detail": str(e)})
            return
        rid = req.get("id")
        op = req.get("op")
        tid = req.get("trace_id")
        if tid is not None and not isinstance(tid, str):
            tid = str(tid)
        if op in ADMIN_OPS:
            self._handle_admin(conn, rid, op, req)
            return
        err = self._validate(req, op)
        if err:
            self._count("bad_request")
            payload = {"error": "bad_request", "detail": err}
            if rid is not None:
                payload["id"] = rid
            if tid is not None:
                payload["trace_id"] = tid
            conn.enqueue(0, payload)
            return
        if self._draining:
            self._count("draining_rejected")
            payload = {"error": "draining",
                       "detail": "daemon is shutting down"}
            if rid is not None:
                payload["id"] = rid
            if tid is not None:
                payload["trace_id"] = tid
            conn.enqueue(0, payload)
            return
        mg = req.get("min_generation")
        if mg is not None and self._generation < mg:
            # read-your-writes: the client holds a generation token from
            # a mutation ack this node (a lagging replica) has not yet
            # caught up to — refusing is correct, serving stale is not
            self._count("stale_generation")
            payload = {"error": "stale_generation",
                       "detail": f"serving generation "
                                 f"{self._generation}, client requires "
                                 f">= {mg}",
                       "generation": self._generation}
            if rid is not None:
                payload["id"] = rid
            if tid is not None:
                payload["trace_id"] = tid
            conn.enqueue(0, payload)
            return
        if tid is None and self._obs_enabled:
            tid = obs_tracing.gen_trace_id()
        t_admit = time.monotonic()
        self._counts["requests"].inc()
        tname = req.get("tenant") or "default"
        tstate = self._tenant(tname)
        tstate.c_requests.inc()
        with self._count_lock:
            self._seq += 1
            seq = self._seq
        deadline_ms = req.get("deadline_ms")
        expires_at = t_admit + deadline_ms / 1e3 \
            if deadline_ms is not None else None
        item = _Request(conn, rid, op, req.get("terms"),
                        req.get("letter"), int(req.get("k") or 0),
                        req.get("score") or "df", seq, expires_at,
                        trace_id=tid, t_admit=t_admit,
                        explain=bool(req.get("explain", False)),
                        tenant=tname, tstate=tstate)
        with conn.lock:
            conn.pending += 1
        inj = faults.active()
        if inj is not None and inj.on_serve_admit(seq):
            # injected overload storm: this daemon pretends it cannot
            # absorb the request — the typed refusal the router's
            # breaker/budget machinery is soaked against.  Faults fire
            # before the result cache so chaos scenarios keep biting
            # even when the probed query is hot.
            self._count("shed")
            self._finish(item, {"error": "overloaded",
                                "detail": "injected overload storm "
                                          "(fault spec)"},
                         admitted=False)
            return
        if not item.explain:
            item.ckey = result_cache_mod.key_for(
                op, item.terms, item.letter, item.k, item.score)
        hit = self._result_cache.lookup(item.ckey, self._generation)
        if hit is not None:
            if inj is not None:
                # request-targeted faults fire whether the answer
                # comes from the engine or the cache: a hit is still
                # request handling, and chaos specs key on seq
                try:
                    inj.on_serve_request(seq)
                except faults.HandlerCrash as e:
                    self._count("internal_errors")
                    self._finish(item, {"error": "internal",
                                        "detail": str(e)},
                                 admitted=False)
                    return
            # answered from the reader thread: a hot query never
            # touches the dispatch queue, token bucket or CoDel gate —
            # it costs no engine time, so it spends no admission budget
            item.cached = True
            tstate.c_cache_hits.inc()
            self._finish(item, hit, admitted=False)
            return
        if tstate.bucket is not None and not tstate.bucket.allow():
            self._count("shed")
            self._finish(item, {"error": "overloaded",
                                "detail": f"tenant {tname!r} over its "
                                          "admission rate"},
                         admitted=False)
            return
        if tstate.codel.should_shed():
            # adaptive admission: the queue's DELAY (not depth) says
            # the daemon is past saturation — shed now, cheaply, while
            # the request has cost nothing
            self._count("shed")
            self._count("codel_sheds")
            self._finish(item, {"error": "overloaded",
                                "detail": "queue delay over CoDel "
                                          "target "
                                          f"{self.codel_target_ms}ms"},
                         admitted=False)
            return
        try:
            self._queue.put_nowait(item)
            with self._count_lock:
                self._inflight += 1
        except queue.Full:
            self._count("shed")
            self._finish(item, {"error": "overloaded",
                                "detail": f"pending queue at depth "
                                          f"{self._tenant_depth}"},
                         admitted=False)

    @staticmethod
    def _validate(req: dict, op) -> str | None:
        """One-line reason when the request is malformed, else None."""
        if op not in DATA_OPS:
            return (f"unknown op {op!r} "
                    f"(choices: {DATA_OPS + ADMIN_OPS})")
        dl = req.get("deadline_ms")
        if dl is not None and (not isinstance(dl, (int, float))
                               or isinstance(dl, bool) or dl <= 0):
            return f"deadline_ms must be a positive number, got {dl!r}"
        tn = req.get("tenant")
        if tn is not None and (not isinstance(tn, str)
                               or not _TENANT_RE.match(tn)):
            return ("tenant must be 1-64 chars of [A-Za-z0-9._-], "
                    f"got {tn!r}")
        ex = req.get("explain")
        if ex is not None and not isinstance(ex, bool):
            return f"explain must be a boolean, got {ex!r}"
        mg = req.get("min_generation")
        if mg is not None and (not isinstance(mg, int)
                               or isinstance(mg, bool) or mg < 0):
            return (f"min_generation must be a non-negative integer, "
                    f"got {mg!r}")
        if op == "top_k":
            score = req.get("score") or "df"
            if score not in ("df", "bm25"):
                return f"top_k score must be df or bm25, got {score!r}"
            k = req.get("k")
            if not isinstance(k, int) or isinstance(k, bool) or k < 0:
                return f"top_k needs integer k >= 0, got {k!r}"
            if score == "bm25":
                terms = req.get("terms")
                if not isinstance(terms, list) or not terms \
                        or not all(isinstance(t, str) for t in terms):
                    return ("top_k score=bm25 needs terms=[str, ...], "
                            f"got {terms!r}")
                return None
            letter = req.get("letter")
            if not (isinstance(letter, str) and len(letter) == 1
                    and "a" <= letter <= "z"):
                return f"top_k needs letter=a..z, got {letter!r}"
            return None
        terms = req.get("terms")
        if not isinstance(terms, list) \
                or not all(isinstance(t, str) for t in terms):
            return f"{op} needs terms=[str, ...], got {terms!r}"
        return None

    def _handle_admin(self, conn: _Conn, rid, op: str, req: dict) -> None:
        """Admin ops answer inline from the reader thread — they must
        work while the dispatcher is wedged in a batch."""
        if op == "healthz":
            # liveness vs readiness: ``ok`` stays unconditionally True
            # for old clients (the process answered — it is alive);
            # ``ready``/``reasons`` carry the serving verdict
            reasons = self._ready_reasons()
            payload = {"ok": True,
                       "live": True,
                       "ready": not reasons,
                       "reasons": reasons,
                       "status": reasons[0] if reasons else "ok",
                       "queue_depth": self._queue.qsize(),
                       # additive: the router's health prober learns
                       # each shard's serving generation from here and
                       # keys its result cache on the full vector
                       "generation": self._generation}
        elif op == "slo":
            payload = {"ok": True, "slo": self._slo.report()}
        elif op == "stats":
            payload = {"ok": True, "stats": self.stats()}
        elif op == "metrics":
            payload = {"ok": True, "text": self.render_metrics()}
        elif op == "trace":
            n = req.get("n")
            n = n if isinstance(n, int) and not isinstance(n, bool) \
                and n > 0 else 32
            payload = {"ok": True,
                       "traces": self._trace_ring.snapshot(n)}
        elif op == "flightdump":
            flight = self._flight.dump("admin")
            tn = req.get("tenant")
            if isinstance(tn, str) and tn and isinstance(flight, dict):
                # per-tenant slice: keep only this lane's requests in
                # both lists (headline fields stay daemon-wide)
                for lst in ("requests", "slow"):
                    flight[lst] = [
                        e for e in flight.get(lst, ())
                        if e.get("trace", {}).get("tenant") == tn]
                flight["tenant"] = tn
            payload = {"ok": True, "flight": flight}
            where = req.get("write_to")
            if isinstance(where, str) and where:
                payload["path"] = self._flight.dump_to_file(where, "admin")
        elif op in ("append", "delete", "compact"):
            err = None
            if op == "append":
                files = req.get("files")
                if not isinstance(files, list) or not files or \
                        not all(isinstance(f, str) for f in files):
                    err = f"append needs files=[str, ...], got {files!r}"
            elif op == "delete":
                docs = req.get("docs")
                if not isinstance(docs, list) or not docs or \
                        not all(isinstance(d, int)
                                and not isinstance(d, bool)
                                for d in docs):
                    err = f"delete needs docs=[int, ...], got {docs!r}"
            if err is not None:
                self._count("bad_request")
                payload = {"error": "bad_request", "detail": err}
            else:
                ok, out = self.mutate(op, files=req.get("files"),
                                      docs=req.get("docs"),
                                      force=bool(req.get("force", True)))
                if ok:
                    payload = {"ok": True, "result": out}
                else:
                    payload = {"error": "mutation_rejected", "detail": out}
        elif op in ("snapshot", "fetch_segment", "wal_tail"):
            # read-only views over PUBLISHED state (manifest, immutable
            # segment files, the WAL tail) — a replica's catch-up round
            # is snapshot → fetch_segment per missing file → wal_tail
            from .. import segments
            from ..segments import replica as segrep
            try:
                if op == "snapshot":
                    payload = {"ok": True,
                               "snapshot":
                                   segrep.snapshot_payload(self._root),
                               "lease": segments.read_lease(self._root)}
                elif op == "fetch_segment":
                    payload = {"ok": True,
                               **segrep.segment_file_payload(
                                   self._root,
                                   str(req.get("segment") or ""),
                                   str(req.get("file") or ""))}
                else:  # wal_tail
                    after = req.get("after_seq", 0)
                    if not isinstance(after, int) \
                            or isinstance(after, bool) or after < 0:
                        raise segments.ReplicaError(
                            f"after_seq must be a non-negative "
                            f"integer, got {after!r}")
                    payload = {"ok": True,
                               "records": segrep.wal_tail_payload(
                                   self._root, after)}
            except segments.SegmentError as e:
                self._count("bad_request")
                payload = {"error": "bad_request", "detail": str(e)}
        else:  # reload
            t0 = time.monotonic()
            ok, detail = self.reload()
            self._admin_trace("reload", t0,
                              status="ok" if ok else "reload_rejected")
            if ok:
                payload = {"ok": True, "reloaded": True}
            else:
                payload = {"error": "reload_rejected", "detail": detail}
        if rid is not None:
            payload["id"] = rid
        tid = req.get("trace_id")
        if tid is not None:
            payload["trace_id"] = tid if isinstance(tid, str) else str(tid)
        conn.enqueue(0, payload)

    # -- dispatch ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        """Crash boundary for the dispatcher thread: an exception
        escaping the batch loop takes the serving plane down, so the
        flight recorder is dumped first — the black box survives."""
        try:
            self._dispatch_inner()
        except BaseException:
            self.dump_flight("crash")
            raise

    def _dispatch_inner(self) -> None:
        while True:
            # heartbeat every iteration INCLUDING the idle path: an
            # empty queue is quiet, not stalled
            self._watchdog.beat("dispatcher")
            try:
                first = self._queue.get(timeout=0.02)
            except queue.Empty:
                if self._dispatch_stop.is_set():
                    return
                # an empty queue IS a zero-delay observation: without
                # it a drained-but-still-dropping gate would keep
                # admission-shedding a modest retry stream forever —
                # only dequeues exit dropping, and sheds never dequeue.
                # Every tenant's gate gets the observation: an idle
                # queue is idle for all lanes at once.
                for ts in self._tenant_list():
                    ts.codel.on_delay(0.0)
                continue
            inj = faults.active()
            if inj is not None:
                inj.on_dispatch_batch()
            first.t_pop = time.monotonic()
            batch = [first]
            if self.coalesce_us > 0 and self.max_batch > 1 \
                    and not self._draining:
                until = first.t_pop + self.coalesce_us / 1e6
                while len(batch) < self.max_batch:
                    rem = until - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        rider = self._queue.get(timeout=rem)
                    except queue.Empty:
                        break
                    rider.t_pop = time.monotonic()
                    batch.append(rider)
            while len(batch) < self.max_batch:  # free riders
                try:
                    rider = self._queue.get_nowait()
                except queue.Empty:
                    break
                rider.t_pop = time.monotonic()
                batch.append(rider)
            if self._codel.enabled:
                # CoDel dequeue side: feed each request's queue delay
                # to ITS TENANT's gate (the default lane's gate is the
                # daemon-wide one), and while dropping shed the ones
                # that already waited past target BEFORE they reach
                # the engine — executed requests then carry bounded
                # queueing even under sustained overload, and one
                # tenant's self-inflicted queue delay closes only its
                # own admission gate
                kept = []
                for it in batch:
                    delay = it.t_pop - it.t_admit
                    gate = it.tstate.codel if it.tstate is not None \
                        else self._codel
                    gate.on_delay(delay)
                    if gate.late_shed(delay):
                        self._count("shed")
                        self._count("codel_sheds")
                        self._finish(
                            it, {"error": "overloaded",
                                 "detail": "queued past CoDel target "
                                           f"{self.codel_target_ms}"
                                           "ms"})
                        continue
                    kept.append(it)
                if not kept:
                    continue
                batch = kept
            self._execute(batch)

    def _finish(self, item: _Request, payload: dict, *,
                admitted: bool = True) -> None:
        """The one response for an admitted request (ok or error)."""
        if item.done:
            return
        item.done = True
        if item.tstate is not None:
            err = payload.get("error")
            if err == "overloaded":
                item.tstate.c_shed.inc()
            elif err == "deadline_expired":
                item.tstate.c_deadline.inc()
            elif err == "internal":
                item.tstate.c_errors.inc()
        if not item.cached and item.ckey is not None \
                and item.cgen is not None and payload.get("ok"):
            # fill before id/trace_id stamping: the cached payload must
            # stay request-agnostic so a later hit for a different
            # request id returns byte-identical *data* fields
            self._result_cache.fill(item.ckey, item.cgen, payload)
        if item.rid is not None:
            payload.setdefault("id", item.rid)
        if item.trace_id is not None:
            payload.setdefault("trace_id", item.trace_id)
        item.conn.enqueue(item.seq, payload)
        with item.conn.lock:
            item.conn.pending -= 1
            idle = item.conn.read_eof and item.conn.pending == 0
        if idle:
            item.conn.enqueue_sentinel()
        if admitted:
            with self._count_lock:
                self._inflight -= 1
        self._record_trace(item, payload)

    def _admin_trace(self, op: str, t0: float, *, status: str = "ok",
                     generation=None) -> None:
        """One trace-ring span for an admin op that changed daemon
        state.  Mutation ops (append/delete/compact) stamp the manifest
        ``generation`` they produced on the record AND its span, so a
        ring snapshot shows which generation each query span ran
        against.  Never raises."""
        if not self._obs_enabled:
            return
        dur_ms = round((time.monotonic() - t0) * 1e3, 3)
        span = {"name": op, "start_ms": 0.0, "dur_ms": dur_ms}
        trace = {
            "trace_id": obs_tracing.gen_trace_id(),
            "id": None, "op": op, "seq": 0,
            "status": status, "dur_ms": dur_ms,
            "spans": [span],
        }
        if generation is not None:
            trace["generation"] = int(generation)
            span["generation"] = int(generation)
        self._trace_ring.push(trace)

    def _record_trace(self, item: _Request, payload: dict) -> None:
        """Latency histograms + one trace record per finished request.
        Off the response path's critical invariants — never raises."""
        t_done = time.monotonic()
        t0 = item.t_admit
        self._h_request.observe(
            t_done - t0,
            exemplar=item.trace_id if self._exemplars else None)
        if item.tstate is not None:
            item.tstate.h_request.observe(t_done - t0)
        if item.t_pop is not None:
            self._h_queue_wait.observe(item.t_pop - t0)
        want_trace = self._obs_enabled and item.trace_id is not None
        if not (want_trace or self._flight.enabled):
            return
        spans = []

        def add(name, a, b):
            spans.append({"name": name,
                          "start_ms": round((a - t0) * 1e3, 3),
                          "dur_ms": round((b - a) * 1e3, 3)})

        if item.t_pop is None:  # cache hit, admission shed, drain flush
            add("result_cache" if item.cached else "admission",
                t0, t_done)
        elif item.t_exec is None:  # popped, never reached the engine
            add("queue_wait", t0, item.t_pop)
            add("dispatch", item.t_pop, t_done)
        else:
            add("queue_wait", t0, item.t_pop)
            add("coalesce", item.t_pop, item.t_exec)
            add("engine", item.t_exec, t_done)
            if item.planner is not None:
                # label the engine span with the ranked plan so slow
                # BM25 queries are attributable to their strategy
                spans[-1]["planner"] = item.planner
        dur_ms = (t_done - t0) * 1e3
        trace = {
            "trace_id": item.trace_id,
            "id": item.rid,
            "op": item.op,
            "seq": item.seq,
            "status": "ok" if payload.get("ok")
                      else payload.get("error", "error"),
            "dur_ms": round(dur_ms, 3),
            "spans": spans,
        }
        if item.tenant is not None:
            trace["tenant"] = item.tenant
        if want_trace:
            self._trace_ring.push(trace)
            if 0 < self._slow_ms <= dur_ms:
                obs_tracing.emit_slow(trace)
        if self._flight.enabled:
            self._flight.record(
                trace, item.attrib.report()
                if item.attrib is not None else None)

    def _execute(self, items: list[_Request]) -> None:
        inj = faults.active()
        with self._engine_lock:
            # expiry is judged NOW — after any wait for the engine, at
            # the last instant before dispatch — so stale work never
            # reaches the batch path no matter where the queue stalled
            now = time.monotonic()
            # snapshot the cache epoch under the same lock that pins
            # the engine: mutations swap the engine BEFORE bumping
            # self._generation, so the only possible mismatch pairs
            # NEW bytes with the OLD generation key — an entry the next
            # probe (at the new generation) can never return
            gen = self._generation
            for it in items:
                it.t_exec = now
                it.cgen = gen
            live = []
            for it in items:
                if it.expires_at is not None and now > it.expires_at:
                    self._count("deadline_expired")
                    self._finish(it, {"error": "deadline_expired",
                                      "detail": "deadline passed "
                                                "before dispatch"})
                else:
                    live.append(it)
            if not live:
                return
            self._count("batches")
            self._count("batched_requests", len(live))
            eng = self._engine
            ready = []
            for it in live:
                if inj is not None:
                    try:
                        inj.on_serve_request(it.seq)
                    except faults.HandlerCrash as e:
                        self._count("internal_errors")
                        self._finish(it, {"error": "internal",
                                          "detail": str(e)})
                        continue
                ready.append(it)
            # coalesced groups: one vectorized engine call answers every
            # df (resp. postings) request in the batch.  Explain
            # requests are excluded — they run solo below, so the cost
            # report charges them for their own work only.
            for op in ("df", "postings"):
                group = [it for it in ready
                         if it.op == op and not it.explain]
                if not group:
                    continue
                try:
                    terms = [t for it in group for t in it.terms]
                    batch = eng.encode_batch(terms)
                    if op == "df":
                        out = eng.df(batch)
                        pos = 0
                        for it in group:
                            n = len(it.terms)
                            self._finish(it, {
                                "ok": True,
                                "df": out[pos:pos + n].tolist()})
                            pos += n
                    else:
                        runs = eng.postings(batch)
                        pos = 0
                        for it in group:
                            n = len(it.terms)
                            part = runs[pos:pos + n]
                            self._finish(it, {
                                "ok": True,
                                "postings": [r.tolist() if r is not None
                                             else None for r in part]})
                            pos += n
                except Exception as e:  # group failed: every unanswered
                    for it in group:    # member gets a counted internal
                        if not it.done:
                            self._count("internal_errors")
                            self._finish(it, {"error": "internal",
                                              "detail": str(e)})
            # ranked groups: a router fanning one client's pipelined
            # BM25 queries across shards lands same-k bursts here — one
            # top_k_scored_batch call crosses into the native kernel
            # once for the whole group.  Solo requests keep the
            # per-query path (planner trace detail rides it), and
            # explain requests always run solo for honest attribution.
            ranked = [it for it in ready
                      if not it.done and not it.explain
                      and it.op == "top_k" and it.score == "bm25"]
            batcher = getattr(eng, "top_k_scored_batch", None)
            if len(ranked) > 1 and batcher is not None:
                by_k: dict[int, list] = {}
                for it in ranked:
                    by_k.setdefault(it.k, []).append(it)
                for k, group in by_k.items():
                    if len(group) < 2:
                        continue
                    try:
                        tops = batcher(
                            [eng.encode_batch(it.terms)
                             for it in group], k)
                        for it, top in zip(group, tops):
                            self._finish(it, {
                                "ok": True,
                                "docs": [[d, s] for d, s in top]})
                    except Exception as e:
                        for it in group:
                            if not it.done:
                                self._count("internal_errors")
                                self._finish(it, {"error": "internal",
                                                  "detail": str(e)})
            for it in ready:
                if it.done:
                    continue
                try:
                    if it.explain:
                        with obs_attrib.collect(it.op) as coll:
                            t_eng = time.monotonic()
                            payload = self._exec_one(eng, it)
                        coll.stage("queue",
                                   (it.t_pop - it.t_admit) * 1e6)
                        coll.stage("coalesce",
                                   (it.t_exec - it.t_pop) * 1e6)
                        coll.stage("engine",
                                   (time.monotonic() - t_eng) * 1e6)
                        it.attrib = coll
                        payload["explain"] = coll.report()
                    else:
                        payload = self._exec_one(eng, it)
                    self._finish(it, payload)
                except Exception as e:
                    self._count("internal_errors")
                    self._finish(it, {"error": "internal",
                                      "detail": str(e)})

    def _exec_one(self, eng, it: _Request) -> dict:
        """One data request against the engine; returns the ok payload.
        df/postings normally ride the coalesced group path — they land
        here solo when the request asked for an explain report."""
        if it.op == "df":
            out = eng.df(eng.encode_batch(it.terms))
            return {"ok": True, "df": out.tolist()}
        if it.op == "postings":
            runs = eng.postings(eng.encode_batch(it.terms))
            return {"ok": True,
                    "postings": [r.tolist() if r is not None else None
                                 for r in runs]}
        if it.op == "and":
            docs = eng.query_and(eng.encode_batch(it.terms))
            return {"ok": True, "docs": docs.tolist()}
        if it.op == "or":
            docs = eng.query_or(eng.encode_batch(it.terms))
            return {"ok": True, "docs": docs.tolist()}
        if it.op == "top_k" and it.score == "bm25":
            top = eng.top_k_scored(eng.encode_batch(it.terms), it.k)
            planner = getattr(eng, "planner", None)
            if planner is not None:
                # decision + pruning counters ride the trace record so
                # slow ranked queries are attributable to their strategy
                it.planner = planner.last_ranked
            return {"ok": True, "docs": [[d, s] for d, s in top]}
        top = eng.top_k(it.letter, it.k)  # top_k by df
        return {"ok": True,
                "top": [[t.decode("ascii", "replace"), int(d)]
                        for t, d in top]}

    # -- live mutations (segment-managed dirs) -------------------------

    def _flush_deletes_locked(self):
        """Publish every buffered delete op as ONE tombstone generation.
        Caller holds ``_reload_lock``.  Returns the mutation result, or
        None when the buffer was empty.  On failure the buffer is
        dropped (the caller reports the rejection) so a poisoned flush
        can never wedge later compactions."""
        if not self._pending_deletes:
            return None
        from .. import segments
        from ..segments import wal as wal_mod
        ids = sorted(set(self._pending_deletes))
        self._pending_deletes = []
        self._delete_ops = 0
        try:
            return segments.delete_docs(self._root, ids,
                                        registry=self.registry)
        except Exception:
            # the buffer is gone but its acked per-op WAL records are
            # not: the next mutation must replay them before logging
            # anything newer, or truncation would pass them unapplied
            self._stale_wal = wal_mod.wal_enabled()
            raise

    def mutate(self, op: str, *, files=None, docs=None,
               force: bool = True) -> tuple[bool, dict | str]:
        """Run one live-index mutation (``append`` / ``delete`` /
        ``compact``) and swap in an engine over the new generation.

        Runs on the caller's thread (a connection reader), serialized
        with hot reloads under ``_reload_lock`` — never the dispatcher.
        The mutation publishes its manifest generation atomically on
        disk first; only then is a fresh engine opened and swapped under
        the dispatch lock.  On ANY failure the old generation keeps
        serving and the attempt is counted ``mutation_rejected``.

        Durability (acknowledgement) ordering: every mutation's WAL
        record is fsync'd BEFORE its manifest swap — for buffered
        deletes the record is fsync'd here, before the ack, even though
        the tombstone generation publishes ops later.  With leasing
        enabled (``MRI_SEGMENT_LEASE_TTL_S`` > 0) the lease is renewed
        first; a live foreign holder rejects the mutation with
        ``lease_lost`` while reads keep serving."""
        from .. import segments
        from ..segments import wal as wal_mod
        if self._replica_of is not None:
            self._count("mutation_rejected")
            return False, ("replica is read-only: mutations go to the "
                           f"primary at {self._replica_of}")
        with self._reload_lock:
            t0 = time.monotonic()
            published = True
            try:
                segments.renew_lease(self._root, self._lease_owner)
                if self._stale_wal:
                    # a failed delete flush left acked records above
                    # the manifest's wal_seq — apply them before this
                    # mutation logs (and later truncates past) a
                    # higher seq
                    segments.replay(self._root, registry=self.registry)
                    self._stale_wal = False
                if op == "append":
                    # buffered deletes flush first: WAL seq order must
                    # match apply order, and the append's published
                    # wal_seq must never cover an unapplied delete
                    self._flush_deletes_locked()
                    res = segments.append_files(self._root, files,
                                                registry=self.registry)
                    auto = segments.compact_to_limit(
                        self._root, registry=self.registry)
                    if auto:
                        res = dict(res, auto_compactions=len(auto),
                                   segments=auto[-1]["segments"],
                                   generation=auto[-1]["generation"])
                elif op == "delete":
                    man = segments.load_manifest(self._root)
                    if man is None:
                        raise segments.SegmentError(
                            f"{self._root}: not segment-managed "
                            "(append first)")
                    bad = [d for d in docs if not any(
                        e.doc_base < d <= e.doc_base + e.docs
                        for e in man.entries)]
                    if bad:
                        raise segments.SegmentError(
                            f"doc ids {bad} are outside every segment "
                            f"(live span is 1..{man.doc_span})")
                    wal_seq = None
                    if self._delete_ops + 1 < self._tomb_flush \
                            and wal_mod.wal_enabled():
                        # durability point for a buffered ack: the
                        # tombstone generation publishes later, but
                        # this fsync'd record survives a crash now
                        # (replayed by recover; made idempotent by
                        # bitmap-OR semantics)
                        with segments.mutation_lock(self._root):
                            wal_seq = wal_mod.log_mutation(
                                self._root, "delete",
                                {"docs": sorted(set(docs))},
                                registry=self.registry)
                    self._pending_deletes.extend(docs)
                    self._delete_ops += 1
                    if self._delete_ops >= self._tomb_flush:
                        res = self._flush_deletes_locked()
                    else:
                        published = False
                        res = {"buffered": True,
                               "pending_docs":
                                   len(set(self._pending_deletes)),
                               "pending_ops": self._delete_ops,
                               "wal_seq": wal_seq,
                               "generation": self._generation}
                else:  # compact (flushes buffered deletes first, so the
                    #    merge sees every tombstone it should drop)
                    self._flush_deletes_locked()
                    res = segments.compact(self._root, force=force,
                                           registry=self.registry)
                if published:
                    new_engine = create_engine(
                        self._path, self._engine_choice,
                        cache_terms=self._cache_terms,
                        shards=self._shards, device=self._device)
            except (segments.SegmentError, ArtifactError, ValueError,
                    OSError, faults.InjectedCompactCrash) as e:
                self._count("mutation_rejected")
                self._admin_trace(op, t0, status="mutation_rejected")
                log.warning("%s rejected, old generation keeps "
                            "serving: %s", op, e)
                return False, str(e)
            if published:
                with self._engine_lock:
                    old, self._engine = self._engine, new_engine
                old.close()
                if isinstance(res, dict) \
                        and res.get("generation") is not None:
                    self._generation = int(res["generation"])
                # generation bumped (or content republished): entries
                # keyed under the old generation are dead — drop them
                self._result_cache.on_epoch(self._generation)
            self._count("mutations")
            dur_ms = round((time.monotonic() - t0) * 1e3, 3)
            # mutation op lands here; the span carries the generation it
            # produced.  A buffered delete publishes nothing — its ack
            # echoes the CURRENT generation as a read-your-writes token,
            # which must not masquerade as a produced one here.
            gen = res.get("generation") \
                if isinstance(res, dict) and published else None
            self._admin_trace(op, t0, generation=gen)
            log.info("%s: %s (%.1f ms)", op, json.dumps(res), dur_ms)
            return True, res

    # -- hot reload ----------------------------------------------------

    def reload(self) -> tuple[bool, str]:
        """Open + checksum-verify the artifact again and atomically swap
        engines.  On ANY failure the old engine keeps serving and the
        attempt is counted ``reload_rejected`` — a bad push can reject,
        never kill, the daemon.  Runs on the caller's thread (reader or
        the CLI's SIGHUP thread), off the dispatcher; only the O(1)
        swap itself holds the dispatch lock."""
        with self._reload_lock:
            self._reloading = True  # healthz readiness: "reloading"
            try:
                inj = faults.active()
                new_engine = None
                try:
                    new_engine = create_engine(
                        self._path, self._engine_choice,
                        cache_terms=self._cache_terms,
                        shards=self._shards, device=self._device)
                    if inj is not None:
                        inj.on_reload()
                except (ArtifactError, ValueError, OSError,
                        faults.InjectedReloadCorrupt) as e:
                    if new_engine is not None:
                        new_engine.close()
                    self._count("reload_rejected")
                    log.warning("hot reload rejected, keeping current "
                                "artifact: %s", e)
                    return False, str(e)
                with self._engine_lock:
                    old, self._engine = self._engine, new_engine
                old.close()
                # a reload can change artifact content at an UNCHANGED
                # generation (an out-of-band artifact push) — the
                # epoch key cannot see that, so drop everything
                self._result_cache.purge()
                self._count("reload_ok")
                log.info("hot reload: swapped in %s", self._path)
                return True, ""
            finally:
                self._reloading = False

    # -- replica catch-up ----------------------------------------------

    def _replica_loop(self) -> None:
        """Poll the primary every ``MRI_REPLICA_POLL_MS``: one
        :func:`~..segments.replica.replicate` round per tick, adopting
        the shipped generation when it changed.  Failures mark the
        replica lagging (healthz ``replica_lagging``) and keep
        polling — a partition heals by itself."""
        from .. import segments
        from ..segments import replica as segrep
        try:
            addr = segrep.parse_addr(self._replica_of)
        except segments.SegmentError as e:
            log.error("replica mode dead on arrival: %s", e)
            return
        period = max(0.001, envknobs.get(segrep.POLL_ENV) / 1e3)
        while True:
            try:
                res = segrep.replicate(self._root, addr,
                                       registry=self.registry)
                self._g_replica_lag.set(max(0, res["behind"]))
                if res["changed"] or self._replica_lagging:
                    self._adopt_generation(res["generation"])
                self._replica_lagging = False
                self._g_replica_lag.set(0)
            except (segments.SegmentError, ArtifactError, ValueError,
                    OSError) as e:
                self._replica_lagging = True
                log.warning("replica catch-up from %s failed: %s",
                            self._replica_of, e)
            if self._replica_stop.wait(period):
                return

    def _adopt_generation(self, generation: int) -> None:
        """Swap in an engine over a freshly shipped generation.  Quiet
        on purpose: adoption is not a reload — no ``reload_ok`` count,
        no ``reloading`` readiness blip — readers never notice."""
        with self._reload_lock:
            new_engine = create_engine(
                self._path, self._engine_choice,
                cache_terms=self._cache_terms, shards=self._shards,
                device=self._device)
            with self._engine_lock:
                old, self._engine = self._engine, new_engine
            old.close()
            self._generation = generation
            self._result_cache.on_epoch(generation)

    # -- stats ---------------------------------------------------------

    def stats(self) -> dict:
        counters = {key: c.value for key, c in self._counts.items()}
        with self._count_lock:
            inflight = self._inflight
        # serialized against reload's swap+close via _reload_lock, NOT
        # the dispatch lock: stats must answer even while the
        # dispatcher is wedged inside a batch
        engine = {}
        if not self._drained.is_set():
            with self._reload_lock:
                try:
                    engine = self._engine.describe()
                except Exception:  # racing a drain's engine close
                    engine = {}
        with self._conn_lock:
            connections = len(self._conns)
        return {
            "queue_depth": self._queue.qsize(),
            "inflight": inflight,
            "draining": self._draining,
            "connections": connections,
            "counters": counters,
            "engine": engine,
            "rolling": self._rolling_stats(),
            "slo": self._slo.report(),
            "config": {
                "coalesce_us": self.coalesce_us,
                "queue_depth": self.queue_depth,
                "max_batch": self.max_batch,
                "drain_s": self.drain_s,
                "codel_target_ms": self.codel_target_ms,
                "codel_interval_ms": self.codel_interval_ms,
            },
            "codel": self._codel.state(),
            "result_cache": self._result_cache.stats(),
            "tenants": self._tenant_stats(),
        }

    def _tenant_stats(self) -> dict:
        """Per-tenant QoS slice for ``stats()``: cumulative counters,
        live lane depth, 1m p95 and 1m SLO burn — one poll answers
        ``mri top``'s whole tenants table."""
        out = {}
        for ts in self._tenant_list():
            p95 = self._rolling.quantile(ts.hist_name, 60.0, 95.0)
            burn = {
                name: entry["windows"]["1m"]["burn"]
                for name, entry in ts.slo.report().items()}
            out[ts.name] = {
                "weight": ts.weight,
                "rate_rps": None if ts.bucket is None
                            else ts.bucket.rps,
                "requests": ts.c_requests.value,
                "shed": ts.c_shed.value,
                "deadline_expired": ts.c_deadline.value,
                "errors": ts.c_errors.value,
                "cache_hits": ts.c_cache_hits.value,
                "queue_depth": self._queue.lane_depth(ts),
                "p95_ms": None if p95 is None
                          else round(p95 * 1e3, 3),
                "burn_1m": burn,
            }
        return out

    def _rolling_stats(self) -> dict:
        """Per-window rates + latency quantiles for ``stats()``."""
        out = {}
        roll = self._rolling
        for label, span in obs_windows.WINDOWS:
            p50 = roll.quantile("mri_serve_request_seconds", span, 50.0)
            p99 = roll.quantile("mri_serve_request_seconds", span, 99.0)
            out[label] = {
                "qps": round(
                    roll.rate("mri_serve_requests_total", span), 3),
                "shed_per_s": round(
                    roll.rate("mri_serve_shed_total", span), 3),
                "deadline_per_s": round(roll.rate(
                    "mri_serve_deadline_expired_total", span), 3),
                "error_per_s": round(roll.rate(
                    "mri_serve_internal_errors_total", span), 3),
                "p50_ms": round(p50 * 1e3, 3) if p50 is not None
                          else None,
                "p99_ms": round(p99 * 1e3, 3) if p99 is not None
                          else None,
            }
        return out

    # -- flight recorder -----------------------------------------------

    @property
    def flight(self) -> obs_attrib.FlightRecorder:
        return self._flight

    def dump_flight(self, reason: str) -> str | None:
        """Write the flight recorder next to the served artifact as
        ``flight-<pid>-<reason>.json``; returns the path or ``None``.
        Crash-path safe — never raises."""
        return self._flight.dump_to_file(str(self._path), reason)

    # -- metrics exposition --------------------------------------------

    def render_metrics(self) -> str:
        """Prometheus text exposition: the daemon's registry, the
        current engine's registry, and the process-global registry
        (fault firings), merged with first-occurrence-wins dedup —
        live mutations put segment gauges on the daemon registry that a
        multi-segment engine also carries."""
        with self._count_lock:
            self._g_inflight.set(self._inflight)
        self._g_queue_depth.set(self._queue.qsize())
        self._g_draining.set(1 if self._draining else 0)
        self._slo.set_gauges(self.registry)
        self.registry.gauge("mri_watchdog_heartbeat_age_seconds").set(
            round(self._watchdog.max_age_s(), 6))
        parts = [self.registry.render_text(exemplars=self._exemplars)]
        if not self._drained.is_set():
            with self._reload_lock:
                try:
                    parts.append(self._engine.metrics.render_text())
                except Exception:  # racing a drain's engine close
                    pass
        parts.append(obs_metrics.default_registry().render_text())
        return obs_metrics.merge_expositions(parts)

    def _metrics_loop(self) -> None:
        """Minimal HTTP/1.0 scrape endpoint on the loopback listener:
        read (and ignore) the request, answer one 200 with the text
        exposition, close.  Serial on purpose — scrapes are rare."""
        assert self._metrics_listener is not None
        while not self._draining:
            try:
                sock, _ = self._metrics_listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed by drain()
            try:
                sock.settimeout(1.0)
                with contextlib.suppress(OSError):
                    sock.recv(65536)  # request head, ignored
                body = self.render_metrics().encode()
                head = (b"HTTP/1.0 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4; "
                        b"charset=utf-8\r\n"
                        b"Content-Length: " + str(len(body)).encode()
                        + b"\r\n\r\n")
                with contextlib.suppress(OSError):
                    sock.sendall(head + body)
            finally:
                with contextlib.suppress(OSError):
                    sock.close()

    # -- drain ---------------------------------------------------------

    def drain(self) -> int:
        """Graceful shutdown; returns the process exit code (0).
        Idempotent — the second call just waits for the first."""
        with self._drain_guard:
            if self._drain_started:
                racing = True
            else:
                self._drain_started = True
                racing = False
        if racing:
            self._drained.wait()
            return 0
        self._draining = True
        # health machinery goes first: a drain wedging a loop must not
        # fire spurious stall dumps, and the leak guard wants these
        # threads gone with the rest
        self._watchdog.stop()
        self._rolling.stop()
        self._replica_stop.set()
        if self._replica_thread is not None:
            self._replica_thread.join(timeout=5.0)
        deadline = time.monotonic() + self.drain_s
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        if self._metrics_listener is not None:
            try:
                self._metrics_listener.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        if self._metrics_thread is not None:
            self._metrics_thread.join(timeout=2.0)
        # finish in-flight work within the drain budget
        while time.monotonic() < deadline:
            with self._count_lock:
                idle = self._inflight == 0
            if idle:
                break
            time.sleep(0.005)
        self._dispatch_stop.set()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=max(2.0, self.drain_s))
        # budget expired with work still queued: flush it as counted,
        # well-formed errors — drain never silently drops a request
        flushed = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            self._count("draining_rejected")
            self._finish(item, {"error": "draining",
                                "detail": "daemon drained before "
                                          "dispatch"})
            flushed += 1
        if flushed:
            # abnormal drain — the budget expired with work queued;
            # dump the flight recorder so the backlog is diagnosable
            self.dump_flight("drain-flush")
        # unblock every reader (idle keep-alive clients never EOF on
        # their own), let writers flush, then force-close stragglers
        with self._conn_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.sock.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        grace = max(0.0, deadline - time.monotonic()) + 1.0
        for conn in conns:
            conn.reader.join(timeout=grace)
            conn.enqueue_sentinel()
        for conn in conns:
            conn.writer.join(timeout=grace)
            if conn.writer.is_alive():
                conn.kill()
                conn.writer.join(timeout=1.0)
        with self._conn_lock:
            self._conns.clear()
        # buffered deletes must not die with the process
        with self._reload_lock:
            try:
                self._flush_deletes_locked()
            except Exception as e:
                log.warning("drain: buffered delete flush failed: %s", e)
        # a clean exit hands the lease to the successor immediately
        # instead of making it wait out the TTL
        with contextlib.suppress(Exception):
            from .. import segments
            segments.release_lease(self._root, self._lease_owner)
        self.final_stats = self.stats()
        with self._engine_lock:
            self._engine.close()
        self._drained.set()
        log.info("drained: %s", json.dumps(self.final_stats["counters"]))
        return 0

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.drain()
