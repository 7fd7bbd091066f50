"""Deterministic fault injection and the build's resilience policy.

The reference dies on any I/O hiccup (a failed ``fopen`` merely warns,
main.c:97-100, but nothing retries, nothing reports, and a crash loses
the whole run).  This module makes failure handling a tested subsystem:
every failure mode the build claims to survive can be armed
deterministically and proven in a test.  It is the JAX package's
``faults.py``: the same spec grammar, hooks, retry policy and report,
so one spec string drives both packages.

Three layers live here:

``FaultInjector``
    Seedable, deterministic injection hooks.  Armed via
    :func:`install` (the CLI's ``--fault-spec``) or the ``MRI_FAULTS``
    env var (so a test can arm a child process it then SIGKILLs).  Spec
    grammar — clauses joined by ``;``, fields by ``:``::

        read-error:doc=2:times=2     transient OSError, first 2 attempts
        read-error:all:times=-1      permanent OSError on every doc
        read-error:every=3:times=1   every 3rd manifest index
        read-error:all:p=0.5:times=1 probabilistic (seed=N clause)
        slow-read:doc=1:ms=50        sleep before the read
        truncate:doc=4:bytes=10      document bytes cut short
        sigkill:window=2             SIGKILL at stream window boundary
        stream-crash:window=2        RuntimeError from the stream engine
        ckpt-corrupt:save=1          corrupt checkpoint bytes post-save
        chaos:seed=5:n=3             sample 3 faults from a seeded RNG
        seed=7                       RNG seed for ``p=`` rules

    and the kinds whose hooks belong to layers this package does not
    have yet, parsed alike and never fired here: ``reader-death``,
    ``worker-death``, ``reducer-death``, ``scan-error``,
    ``spill-corrupt`` and ``merge-crash`` (the host backend), and the
    serve daemon, segment, WAL and cluster kinds (``handler-crash``,
    ``client-disconnect``, ``slow-client``, ``reload-corrupt``,
    ``dispatcher-hang``, ``append-torn-manifest``, ``compact-crash``,
    ``tombstone-corrupt``, ``wal-torn-record``, ``fetch-partial``,
    ``lease-steal``, ``shard-dead``, ``shard-slow``,
    ``router-conn-reset``, ``shard-blackout``, ``overload-storm``).
    Their hook methods are here, so those layers only add call sites.

    ``doc`` / ``every`` match the 0-based manifest index; ``window``
    and ``save`` are 1-based ordinals (``win_i`` in the stream loop and
    "the Nth save"); ``worker`` / ``reducer`` are 0-based thread
    ordinals; ``req`` is the 1-based data-request ordinal of a serve
    daemon.  The death/scan/serve kinds default to ``times=1`` and
    their firing state is global, so a requeued window does not re-kill
    the survivor that rescans it.

    ``chaos:seed=S:n=K`` expands at parse time into K concrete rules
    sampled deterministically from ``seed``.  Optional bounds:
    ``windows=`` / ``workers=`` / ``reducers=`` / ``docs=`` / ``reqs=``
    cap the sampled ordinals, and ``kinds=a,b,c`` restricts the kinds
    drawn.

``RetryPolicy``
    Bounded retries with exponential backoff and a per-document
    deadline — the read path's policy (corpus/manifest.py), in place
    of the reference's single-shot warn-and-skip.

``DegradationReport``
    The structured outcome of a run's failure handling: retry counts
    and exactly which doc ids were skipped, with reasons.  The model
    attaches it to the run stats; the CLI turns a non-empty skip list
    into the degraded exit code (:data:`EXIT_DEGRADED`).
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import random
import signal
import threading
import time

from .obs import metrics as obs_metrics
from .utils import envknobs

log = logging.getLogger("mri_torch.faults")

ENV_VAR = "MRI_FAULTS"

#: CLI exit code for a run that completed but skipped documents after
#: exhausting its retry budget (0 = clean, 2 = error, 3 = degraded).
EXIT_DEGRADED = 3


class FaultSpecError(ValueError):
    """Malformed ``--fault-spec`` / ``MRI_FAULTS`` string."""


class InjectedReadError(OSError):
    """The injected transient/permanent read failure (an OSError, so
    the production retry/skip machinery handles it like a real one)."""


class ReaderThreadDeath(BaseException):
    """Injected *silent* reader-thread death.

    Deliberately a BaseException: the executor's reader loop catches it
    specially and exits without posting anything to the consumer — the
    fire-and-forget daemon-thread failure mode the consumer-side
    watchdog exists to detect.
    """


class WorkerDeath(RuntimeError):
    """Injected scan-worker death (``worker-death`` rule): escapes the
    worker's scan loop like any real crash would, exercising the lease
    requeue + respawn recovery in models/inverted_index."""


class ScanError(RuntimeError):
    """Injected native-scan failure on one window (``scan-error``
    rule) — the recoverable form; ``silent=1`` drops the window
    without raising instead, the corruption the audit ledger exists
    to catch."""


class HandlerCrash(RuntimeError):
    """Injected serve-daemon handler failure (``handler-crash`` rule):
    escapes one request's handling like any real bug would; the daemon
    must answer that request with a counted well-formed ``internal``
    error and keep serving every other connection."""


class InjectedReloadCorrupt(RuntimeError):
    """Injected hot-reload verification failure (``reload-corrupt``
    rule).  Raised from the reload hook as if the replacement
    ``index.mri`` failed its checksum: the daemon must keep serving
    the old artifact and count ``reload_rejected`` instead of dying.
    (A plain RuntimeError, not an ArtifactError subclass — faults.py
    sits below serve/ in the import graph.)"""


class InjectedPublishTear(RuntimeError):
    """Injected segment-manifest publish tear (``append-torn-manifest``
    rule): the STAGED manifest was truncated and the rename must never
    happen.  ``segments.manifest.save_manifest`` maps it to a
    SegmentError so the mutation aborts and the previous generation
    keeps serving.  (Plain RuntimeError — faults.py sits below
    segments/ in the import graph.)"""


class InjectedCompactCrash(RuntimeError):
    """Injected mid-compaction crash (``compact-crash`` rule): fires
    after the replacement segment is fully built but before the
    generation swap, leaving the old generation serving plus an orphan
    directory no manifest references — what a real crash leaves."""


class InjectedConnReset(ConnectionError):
    """Injected cluster connection loss (``shard-dead`` /
    ``router-conn-reset`` rules).  A ConnectionError on purpose: the
    router's replica pool handles it through the same OSError path a
    real RST takes, so failover is proven against production code,
    not a parallel test-only branch."""


class InjectedWalTorn(RuntimeError):
    """Injected WAL append tear (``wal-torn-record`` rule): the record
    bytes were truncated mid-payload and the fsync never ran, so the
    mutation fails *un-acked* — exactly the torn tail
    ``segments.wal.read_records`` must quarantine on the next read.
    ``segments.wal`` maps it to a ``WalError`` so callers see the
    usual SegmentError surface.  (Plain RuntimeError — faults.py sits
    below segments/ in the import graph.)"""


# -- injector ---------------------------------------------------------

_READ_KINDS = ("read-error", "slow-read", "truncate")
_DEATH_KINDS = ("reader-death", "sigkill", "stream-crash", "ckpt-corrupt",
                "worker-death", "reducer-death", "scan-error",
                "spill-corrupt", "merge-crash", "chaos")
_SERVE_KINDS = ("client-disconnect", "slow-client", "reload-corrupt",
                "handler-crash", "dispatcher-hang")
_SEGMENT_KINDS = ("append-torn-manifest", "compact-crash",
                  "tombstone-corrupt")
_WAL_KINDS = ("wal-torn-record", "fetch-partial", "lease-steal")
_CLUSTER_KINDS = ("shard-dead", "shard-slow", "router-conn-reset",
                  "shard-blackout", "overload-storm")

#: What ``chaos:`` may sample by default — every kind the parallel host
#: path recovers from in-run (sigkill is excluded: its story is the
#: cross-run ``--resume=auto`` path, not in-run re-execution).
CHAOS_KINDS = ("worker-death", "reducer-death", "scan-error",
               "reader-death", "read-error", "slow-read")

#: What ``chaos:kinds=...`` may additionally name for daemon soaks —
#: every serve-side fault the daemon absorbs without dying or sending
#: a torn response.  Not in the default draw: a build soak armed via
#: the same grammar should not sample request-ordinal rules that can
#: never fire.
SERVE_CHAOS_KINDS = ("client-disconnect", "slow-client", "handler-crash",
                     "reload-corrupt")

#: What ``chaos:kinds=...`` may name for segment soaks — the mutation
#: crash points the generation-swap discipline absorbs (old generation
#: keeps serving in every case).  Named-only for the same reason as the
#: serve kinds: a build soak should never sample them.
SEGMENT_CHAOS_KINDS = _SEGMENT_KINDS

#: What ``chaos:kinds=...`` may name for spill-armed build soaks —
#: the out-of-core tier's fault points (torn run file, dead shard
#: merger).  Named-only: they can only fire when
#: ``MRI_BUILD_SPILL_BYTES`` routes the build through the spill tier.
SPILL_CHAOS_KINDS = ("spill-corrupt", "merge-crash")

#: What ``chaos:kinds=...`` may name for durability/replication soaks
#: — the WAL tear, the partial segment ship, and the lease steal.
#: Named-only like the other serve-side families.
WAL_CHAOS_KINDS = _WAL_KINDS

#: What ``chaos:kinds=...`` may name for cluster soaks — the router's
#: fault points (a shard replica's connection dying or stalling, a
#: router client connection reset, every replica of one shard going
#: dark, a shard daemon shedding a synthetic overload storm).
#: Named-only: they fire inside router/shard processes.
CLUSTER_CHAOS_KINDS = _CLUSTER_KINDS


@dataclasses.dataclass
class _Rule:
    kind: str
    doc: int | None = None      # manifest index; None = all (read kinds)
    every: int | None = None
    p: float | None = None
    times: int = 1              # -1 = permanent (read-error)
    ms: float = 0.0             # slow-read
    bytes: int = 0              # truncate
    window: int = 0             # reader-death / sigkill / stream-crash /
                                # worker-death / scan-error (0 = any)
    save: int = 0               # ckpt-corrupt
    spill: int = 0              # spill-corrupt: 1-based run-file ordinal
    shard: int | None = None    # merge-crash (None = any shard)
    replica: int | None = None  # cluster kinds (None = any replica)
    worker: int | None = None   # worker-death (None = any worker)
    reducer: int | None = None  # reducer-death (None = any reducer)
    silent: int = 0             # scan-error: 1 = drop window, no raise
    req: int = 0                # serve kinds: 1-based data-request
                                # ordinal (0 never matches — admin ops)
    # chaos sampler bounds (chaos:seed=S:n=K clause only)
    seed: int = 0
    n: int = 0
    windows: int = 8
    workers: int = 4
    reducers: int = 4
    docs: int = 16
    reqs: int = 32
    kinds: tuple = CHAOS_KINDS


def _parse_int(kind: str, key: str, value: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise FaultSpecError(
            f"{kind}: {key}={value!r} is not an integer") from None


def _parse_clause(clause: str, kv_global: dict) -> _Rule | None:
    parts = [p for p in clause.strip().split(":") if p]
    if not parts:
        return None
    head = parts[0]
    if "=" in head:  # bare global assignment, e.g. seed=7
        k, v = head.split("=", 1)
        if k != "seed":
            raise FaultSpecError(f"unknown global fault key {k!r}")
        kv_global["seed"] = _parse_int("seed", "seed", v)
        if len(parts) > 1:
            raise FaultSpecError("seed=N must be a clause of its own")
        return None
    rule = _Rule(kind=head)
    if head not in (_READ_KINDS + _DEATH_KINDS + _SERVE_KINDS
                    + _SEGMENT_KINDS + _WAL_KINDS + _CLUSTER_KINDS):
        raise FaultSpecError(f"unknown fault kind {head!r}")
    saw_times = False
    for field in parts[1:]:
        if field == "all":
            rule.doc = None
            continue
        if "=" not in field:
            raise FaultSpecError(
                f"{head}: expected key=value, got {field!r}")
        k, v = field.split("=", 1)
        if k == "doc":
            rule.doc = _parse_int(head, k, v)
        elif k == "every":
            rule.every = _parse_int(head, k, v)
        elif k == "times":
            rule.times = _parse_int(head, k, v)
            saw_times = True
        elif k == "p":
            try:
                rule.p = float(v)
            except ValueError:
                raise FaultSpecError(
                    f"{head}: p={v!r} is not a float") from None
        elif k == "ms":
            rule.ms = float(_parse_int(head, k, v))
        elif k == "bytes":
            rule.bytes = _parse_int(head, k, v)
        elif k == "window":
            rule.window = _parse_int(head, k, v)
        elif k == "save":
            rule.save = _parse_int(head, k, v)
        elif k == "spill":
            rule.spill = _parse_int(head, k, v)
        elif k == "shard":
            rule.shard = _parse_int(head, k, v)
        elif k == "replica":
            rule.replica = _parse_int(head, k, v)
        elif k == "worker":
            rule.worker = _parse_int(head, k, v)
        elif k == "reducer":
            rule.reducer = _parse_int(head, k, v)
        elif k == "silent":
            rule.silent = _parse_int(head, k, v)
        elif k == "req":
            rule.req = _parse_int(head, k, v)
        elif k == "reqs" and head == "chaos":
            rule.reqs = _parse_int(head, k, v)
        elif k == "seed" and head == "chaos":
            rule.seed = _parse_int(head, k, v)
        elif k == "n" and head == "chaos":
            rule.n = _parse_int(head, k, v)
        elif k == "windows" and head == "chaos":
            rule.windows = _parse_int(head, k, v)
        elif k == "workers" and head == "chaos":
            rule.workers = _parse_int(head, k, v)
        elif k == "reducers" and head == "chaos":
            rule.reducers = _parse_int(head, k, v)
        elif k == "docs" and head == "chaos":
            rule.docs = _parse_int(head, k, v)
        elif k == "kinds" and head == "chaos":
            kinds = tuple(s for s in v.split(",") if s)
            samplable = (CHAOS_KINDS + SERVE_CHAOS_KINDS + SEGMENT_CHAOS_KINDS
                         + SPILL_CHAOS_KINDS + WAL_CHAOS_KINDS + CLUSTER_CHAOS_KINDS)
            bad = [s for s in kinds if s not in samplable]
            if bad:
                raise FaultSpecError(
                    f"chaos: kinds not samplable: {bad} (choose from {list(samplable)})")
            rule.kinds = kinds
        else:
            raise FaultSpecError(f"{head}: unknown key {k!r}")
    if rule.kind in ("reader-death", "sigkill", "stream-crash") \
            and rule.window < 1:
        raise FaultSpecError(f"{head} needs window=N (1-based)")
    if rule.kind == "ckpt-corrupt" and rule.save < 1:
        raise FaultSpecError("ckpt-corrupt needs save=N (1-based)")
    if rule.kind == "spill-corrupt" and rule.spill < 1:
        raise FaultSpecError("spill-corrupt needs spill=N (1-based)")
    if rule.kind == "scan-error" and rule.window < 1:
        raise FaultSpecError("scan-error needs window=N (1-based)")
    if rule.kind in ("client-disconnect", "slow-client", "handler-crash") \
            and rule.req < 1:
        raise FaultSpecError(f"{head} needs req=N (1-based)")
    if rule.kind == "slow-client" and rule.ms <= 0:
        rule.ms = 50.0
    if rule.kind == "shard-slow" and rule.ms <= 0:
        rule.ms = 20.0
    if rule.kind == "router-conn-reset" and rule.req < 1:
        raise FaultSpecError("router-conn-reset needs req=N (1-based)")
    if rule.kind == "shard-blackout" and not saw_times:
        # a blackout is an outage, not a blip: every send to the shard
        # dies until the rule is disarmed (override with times=N)
        rule.times = -1
    if rule.kind == "overload-storm":
        if rule.req < 1:
            rule.req = 1  # storm from the first data request
        if not saw_times:
            rule.times = 16  # a burst, not a single shed
    if rule.kind == "dispatcher-hang" and rule.ms <= 0:
        rule.ms = 500.0
    if rule.kind == "chaos":
        if rule.n < 1:
            raise FaultSpecError("chaos needs n=K (faults to sample)")
        if min(rule.windows, rule.workers, rule.reducers, rule.docs,
               rule.reqs) < 1 or not rule.kinds:
            raise FaultSpecError("chaos bounds must be >= 1")
    return rule


def _sample_chaos(rule: _Rule) -> list[_Rule]:
    """Expand one ``chaos:seed=S:n=K`` clause into K concrete rules.

    Deterministic in ``seed`` (the soak harness's repro contract).
    Every sampled rule keeps the default ``times=1`` budget, so a
    schedule is a finite set of one-shot faults — recovery always has
    a fixed point to converge to.  Permanent read-errors (the degraded
    exit-3 arm) are sampled with times=-1 occasionally.
    """
    rng = random.Random(rule.seed)
    out: list[_Rule] = []
    for _ in range(rule.n):
        kind = rng.choice(rule.kinds)
        if kind == "worker-death":
            # mostly any-worker (fires for whoever scans the window, so
            # the fault is guaranteed to land); occasionally pinned
            worker = rng.randrange(rule.workers) if rng.random() < 0.25 \
                else None
            out.append(_Rule(kind=kind, worker=worker,
                             window=rng.randint(1, rule.windows)))
        elif kind == "reducer-death":
            out.append(_Rule(kind=kind,
                             reducer=rng.randrange(rule.reducers)))
        elif kind == "scan-error":
            out.append(_Rule(kind=kind,
                             window=rng.randint(1, rule.windows)))
        elif kind == "reader-death":
            out.append(_Rule(kind=kind,
                             window=rng.randint(1, rule.windows)))
        elif kind == "read-error":
            out.append(_Rule(kind=kind, doc=rng.randrange(rule.docs),
                             times=rng.choice((1, 2, 2, -1))))
        elif kind == "slow-read":
            out.append(_Rule(kind="slow-read",
                             doc=rng.randrange(rule.docs),
                             ms=float(rng.choice((2, 5, 10)))))
        elif kind in ("client-disconnect", "handler-crash"):
            out.append(_Rule(kind=kind, req=rng.randint(1, rule.reqs)))
        elif kind == "slow-client":
            out.append(_Rule(kind=kind, req=rng.randint(1, rule.reqs),
                             ms=float(rng.choice((20, 50, 100)))))
        elif kind == "spill-corrupt":
            # early run ordinals: tiny-budget soaks write a handful of
            # runs per worker, so the Nth file must exist to be torn
            out.append(_Rule(kind=kind, spill=rng.randint(1, 3)))
        elif kind == "merge-crash":
            # any-shard: fires on whichever merger reaches it first,
            # so the takeover is guaranteed to be exercised
            out.append(_Rule(kind=kind))
        elif kind == "shard-dead":
            # any-shard: fires on whichever scatter send reaches it
            # first, so the failover is guaranteed to be exercised
            out.append(_Rule(kind=kind))
        elif kind == "shard-slow":
            out.append(_Rule(kind=kind,
                             ms=float(rng.choice((20, 50, 100)))))
        elif kind == "router-conn-reset":
            out.append(_Rule(kind=kind, req=rng.randint(1, rule.reqs)))
        elif kind == "shard-blackout":
            # pinned to one shard (soaks run small D): every replica
            # of that shard refuses until the soak's recovery phase
            out.append(_Rule(kind=kind, shard=rng.randrange(2),
                             times=-1))
        elif kind == "overload-storm":
            out.append(_Rule(kind=kind, req=rng.randint(1, rule.reqs),
                             times=rng.choice((8, 16, 32))))
        elif kind in _SEGMENT_KINDS + _WAL_KINDS:
            # no ordinal to pick: each fires once, on the next matching
            # segment mutation / fetch / lease check (times=1 default)
            out.append(_Rule(kind=kind))
        else:  # reload-corrupt
            out.append(_Rule(kind="reload-corrupt"))
    return out


class FaultInjector:
    """Parsed fault spec + per-rule firing state.  Thread-safe: the
    read hooks fire from reader threads concurrently with the main
    thread's checkpoint/window hooks."""

    def __init__(self, spec: str):
        self.spec = spec
        kv_global: dict = {}
        self.rules: list[_Rule] = []
        for clause in spec.split(";"):
            rule = _parse_clause(clause, kv_global)
            if rule is None:
                continue
            if rule.kind == "chaos":
                self.rules.extend(_sample_chaos(rule))
            else:
                self.rules.append(rule)
        if not self.rules and "seed" not in kv_global:
            raise FaultSpecError(f"empty fault spec {spec!r}")
        self._rng = random.Random(kv_global.get("seed", 0))
        self._lock = threading.Lock()
        self._fired: dict[tuple[int, int], int] = {}
        self._saves = 0
        self._spills = 0

    def _matches(self, rule: _Rule, index: int) -> bool:
        if rule.doc is not None and index != rule.doc:
            return False
        if rule.every is not None and index % rule.every != 0:
            return False
        if rule.p is not None and self._rng.random() >= rule.p:
            return False
        return True

    # -- hooks (each a no-op unless a matching rule is armed) ---------

    def on_read(self, index: int, path: str) -> int | None:
        """Per-attempt read hook.  May raise :class:`InjectedReadError`
        or sleep; returns a byte cap to truncate the document to, or
        None.  ``times=N`` counts *per document*, so a retrying caller
        sees N failures then success — the transient-fault contract."""
        cap = None
        delay = 0.0
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind not in _READ_KINDS \
                        or not self._matches(rule, index):
                    continue
                if rule.kind == "slow-read":
                    delay = max(delay, rule.ms / 1e3)
                elif rule.kind == "truncate":
                    cap = rule.bytes if cap is None \
                        else min(cap, rule.bytes)
                else:  # read-error
                    key = (ri, index)
                    n = self._fired.get(key, 0)
                    if rule.times < 0 or n < rule.times:
                        self._fired[key] = n + 1
                        raise InjectedReadError(
                            errno.EIO, "injected read failure "
                            f"(attempt {n + 1})", path)
        if delay:
            time.sleep(delay)
        return cap

    def on_reader_window(self, window: int) -> None:
        """Fires in the executor's reader thread before window
        ``window`` (1-based) is read; may raise ReaderThreadDeath.
        The firing budget is GLOBAL (``times=1`` by default) like the
        other death kinds: when the parallel host path requeues the
        dead reader's windows, the survivor that re-reads this window
        must not die of the same injection — recovery converges."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind == "reader-death" and rule.window == window:
                    if self._fire_once(ri, rule):
                        raise ReaderThreadDeath()

    def on_window_boundary(self, window: int) -> None:
        """Fires after window ``window`` completes — on the stream
        loop's main thread (post-checkpoint) and, for the pipelined cpu
        path, in each reader thread after the window is read and handed
        downstream (the window index is the GLOBAL plan index, so specs
        are worker-count-invariant); may SIGKILL."""
        for rule in self.rules:
            if rule.kind == "sigkill" and rule.window == window:
                log.warning("fault injection: SIGKILL at stream "
                            "window boundary %d", window)
                os.kill(os.getpid(), signal.SIGKILL)

    def on_stream_window(self, window: int) -> None:
        """Fires inside the device stream engine after it folds window
        ``window``; may raise (a worker crash mid-stream, as a
        first-class fault beside the MRI_TPU_STREAM_CRASH_AFTER_WINDOWS
        hook)."""
        for rule in self.rules:
            if rule.kind == "stream-crash" and rule.window == window:
                raise RuntimeError(
                    f"injected stream crash after window {window} "
                    "(fault spec)")

    def _fire_once(self, ri: int, rule: _Rule) -> bool:
        """Global once-per-rule firing budget (``times``), shared across
        workers: a requeued window rescanned by a survivor must NOT
        re-trigger the fault that killed the first worker, or recovery
        could never converge.  Caller holds ``self._lock``."""
        key = (ri, 0)
        n = self._fired.get(key, 0)
        if rule.times < 0 or n < rule.times:
            self._fired[key] = n + 1
            # fault firings are process-global obs counters (the obs
            # Counter has its own lock; safe under self._lock)
            reg = obs_metrics.default_registry()
            reg.counter("mri_faults_fired_total").inc()
            kind = rule.kind.replace("-", "_")
            reg.counter(f"mri_fault_{kind}_fired_total").inc()
            return True
        return False

    def on_worker_window(self, worker: int, window: int) -> None:
        """Fires in scan worker ``worker`` (0-based) as it picks up
        window ``window`` (1-based global plan index); may raise
        :class:`WorkerDeath` — the in-run worker-crash injection the
        lease/requeue recovery is proven against."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "worker-death":
                    continue
                if rule.window and rule.window != window:
                    continue
                if rule.worker is not None and rule.worker != worker:
                    continue
                if self._fire_once(ri, rule):
                    raise WorkerDeath(
                        f"injected worker death: worker {worker} at "
                        f"window {window} (fault spec)")

    def on_scan_window(self, window: int) -> bool:
        """Fires in the scan worker before window ``window`` is fed to
        the native scan.  May raise :class:`ScanError` (recoverable —
        the worker dies and the window is rescanned), or return True
        for ``silent=1`` rules: the caller drops the window without
        any error, the silent corruption ``--audit`` must catch."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "scan-error" or rule.window != window:
                    continue
                if not self._fire_once(ri, rule):
                    continue
                if rule.silent:
                    log.warning("fault injection: silently dropping "
                                "window %d from the scan", window)
                    return True
                raise ScanError(
                    f"injected native scan failure on window {window} "
                    "(fault spec)")
        return False

    def on_reducer(self, reducer: int) -> None:
        """Fires in reduce worker ``reducer`` (0-based) before it emits
        its letter range; may raise — the dead reducer whose range a
        surviving thread re-emits (takeover off the read-only merge)."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "reducer-death":
                    continue
                if rule.reducer is not None and rule.reducer != reducer:
                    continue
                if self._fire_once(ri, rule):
                    raise RuntimeError(
                        f"injected reducer death: reducer {reducer} "
                        "(fault spec)")

    def on_checkpoint_saved(self, path: str) -> None:
        """Fires after every atomic checkpoint save; the Nth save may
        be corrupted in place (truncated to a third), simulating the
        torn/bit-rotted file ``--resume=auto`` must survive."""
        with self._lock:
            self._saves += 1
            saves = self._saves
        for rule in self.rules:
            if rule.kind == "ckpt-corrupt" and rule.save == saves:
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(size // 3, 1))
                log.warning("fault injection: corrupted checkpoint "
                            "%s (save #%d)", path, saves)

    def on_spill_written(self, path: str) -> None:
        """Fires after every atomic spill-run write (build/spill.py);
        the Nth run file process-wide may have a byte flipped in place,
        simulating the torn run the reduce-side checksum walk must
        quarantine instead of merging."""
        with self._lock:
            self._spills += 1
            spills = self._spills
            for ri, rule in enumerate(self.rules):
                if rule.kind != "spill-corrupt" or rule.spill != spills:
                    continue
                if self._fire_once(ri, rule):
                    with open(path, "r+b") as f:
                        data = f.read()
                        at = max(len(data) // 2 - 1, 0)
                        f.seek(at)
                        f.write(bytes([data[at] ^ 0xFF]))
                    log.warning("fault injection: corrupted spill run "
                                "%s (run file #%d)", path, spills)

    def on_shard_merge(self, shard: int) -> None:
        """Fires in a reduce worker before it k-way-merges term-hash
        shard ``shard`` (0-based); may raise — the dead shard merger
        whose shards the main thread re-merges (the runs on disk are
        read-only inputs, so re-merge is idempotent)."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "merge-crash":
                    continue
                if rule.shard is not None and rule.shard != shard:
                    continue
                if self._fire_once(ri, rule):
                    raise RuntimeError(
                        f"injected shard-merge crash: shard {shard} "
                        "(fault spec)")

    def on_serve_request(self, req: int) -> None:
        """Fires in the serve daemon as data request ``req`` (1-based
        global ordinal) is handled; may raise :class:`HandlerCrash`.
        Admin ops pass req=0, which never matches an armed rule.  The
        firing budget is GLOBAL like the other death kinds: the daemon
        answers the crashed request with a counted ``internal`` error
        and the next request through the same code path survives."""
        if req < 1:
            return
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "handler-crash" or rule.req != req:
                    continue
                if self._fire_once(ri, rule):
                    raise HandlerCrash(
                        f"injected handler crash on request {req} "
                        "(fault spec)")

    def on_serve_response(self, req: int) -> bool:
        """Fires in the serve daemon's writer just before response
        ``req`` is sent.  ``slow-client`` sleeps here (outside the
        injector lock — a stalled peer must not serialize the whole
        daemon); ``client-disconnect`` returns True and the caller
        drops the connection as if the peer vanished mid-response."""
        if req < 1:
            return False
        delay = 0.0
        drop = False
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.req != req:
                    continue
                if rule.kind == "slow-client":
                    if self._fire_once(ri, rule):
                        delay = max(delay, rule.ms / 1e3)
                elif rule.kind == "client-disconnect":
                    if self._fire_once(ri, rule):
                        drop = True
        if delay:
            time.sleep(delay)
        return drop

    def on_serve_admit(self, req: int) -> bool:
        """Fires in the serve daemon as data request ``req`` (1-based
        ordinal) is admitted, before it is queued.  True means the
        daemon must shed it with a typed ``overloaded`` answer
        (``overload-storm`` rule: fires for every request from ordinal
        ``req=N`` on while its ``times`` budget lasts) — a synthetic
        sustained overload the admission-control and router-breaker
        soaks lean on without having to genuinely saturate the box.
        An ``every=K`` clause sheds only every Kth request: an
        INTERMITTENT overload, where the replica stays mostly healthy
        so breakers correctly hold closed and the retry budget is the
        only thing standing between a flaky shard and retry
        amplification."""
        if req < 1:
            return False
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "overload-storm" or req < rule.req:
                    continue
                if rule.every is not None and req % rule.every != 0:
                    continue
                if self._fire_once(ri, rule):
                    return True
        return False

    def on_router_send(self, shard: int, replica: int) -> None:
        """Fires in the cluster router as an RPC is handed to the
        connection for ``(shard, replica)``.  ``shard-dead`` (matching
        ``shard=K`` or any-shard) raises :class:`InjectedConnReset`,
        which the replica pool handles exactly like a real RST —
        condemn the connection, fail its pending RPCs, let the router
        fail over.  ``shard-slow`` sleeps ``ms`` here, outside the
        injector lock, stalling only this shard's sends (the hedging
        trigger)."""
        delay = 0.0
        dead = False
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.shard is not None and rule.shard != shard:
                    continue
                if rule.replica is not None and rule.replica != replica:
                    continue
                if rule.kind == "shard-dead":
                    if self._fire_once(ri, rule):
                        dead = True
                elif rule.kind == "shard-blackout":
                    # permanent by default (times=-1): EVERY send to
                    # the matched shard dies, all replicas — the
                    # replica-set-exhausted path partial results and
                    # breakers exist for
                    if self._fire_once(ri, rule):
                        dead = True
                elif rule.kind == "shard-slow":
                    if self._fire_once(ri, rule):
                        delay = max(delay, rule.ms / 1e3)
        if delay:
            time.sleep(delay)
        if dead:
            raise InjectedConnReset(
                f"injected shard-dead: shard {shard} replica {replica} "
                "(fault spec)")

    def on_router_client(self, req: int) -> bool:
        """Fires in the router as data request ``req`` (1-based global
        ordinal) is admitted; True means the client connection must be
        dropped as if the peer's NAT sent an RST (``router-conn-reset``
        rule).  The chaos soak uses it to prove a torn client sees
        either no answer or one answer — never two."""
        if req < 1:
            return False
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "router-conn-reset" or rule.req != req:
                    continue
                if self._fire_once(ri, rule):
                    return True
        return False

    def on_dispatch_batch(self) -> None:
        """Fires in the serve daemon's dispatcher thread as it picks up
        a batch.  An armed ``dispatcher-hang`` rule sleeps ``ms`` here
        — outside the injector lock, mirroring ``slow-client`` — so
        the single dispatch thread wedges with requests queued behind
        it while admin ops keep answering from the reader threads:
        exactly the failure shape the watchdog exists to detect.
        One-shot by default (``times=1``), like the other serve kinds."""
        delay = 0.0
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "dispatcher-hang":
                    continue
                if self._fire_once(ri, rule):
                    delay = max(delay, rule.ms / 1e3)
        if delay:
            time.sleep(delay)

    def on_segment_publish(self, op: str, tmp_path: str) -> None:
        """Fires in ``segments.manifest.save_manifest`` after the new
        manifest generation is staged, before the rename.  The
        ``append-torn-manifest`` rule truncates the STAGED file and
        raises :class:`InjectedPublishTear`, so the swap never happens
        and the previous generation keeps serving — the crash-
        mid-publish the stage+rename discipline exists to survive."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "append-torn-manifest" or op != "append":
                    continue
                if self._fire_once(ri, rule):
                    size = os.path.getsize(tmp_path)
                    with open(tmp_path, "r+b") as f:
                        f.truncate(max(size // 2, 1))
                    log.warning("fault injection: tore staged segment "
                                "manifest %s mid-publish", tmp_path)
                    raise InjectedPublishTear(
                        f"injected manifest tear publishing {op!r} "
                        "(fault spec)")

    def on_tombstone_write(self, tmp_path: str) -> None:
        """Fires in ``segments.tombstones.save`` after the bitmap is
        staged; the ``tombstone-corrupt`` rule flips a byte in place.
        Does not raise — the writer's read-back verification must be
        the thing that rejects the corrupted bytes before publish."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "tombstone-corrupt":
                    continue
                if self._fire_once(ri, rule):
                    with open(tmp_path, "r+b") as f:
                        data = f.read()
                        at = max(len(data) // 2 - 1, 0)
                        f.seek(at)
                        f.write(bytes([data[at] ^ 0xFF]))
                    log.warning("fault injection: corrupted staged "
                                "tombstone bitmap %s", tmp_path)

    def on_compact(self) -> None:
        """Fires in the compactor after the replacement segment is
        fully built, before the manifest swap; may raise
        :class:`InjectedCompactCrash` — the mid-compaction death that
        must leave the old generation serving (plus an orphan dir)."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "compact-crash":
                    continue
                if self._fire_once(ri, rule):
                    raise InjectedCompactCrash(
                        "injected compaction crash before publish "
                        "(fault spec)")

    def on_wal_append(self, path: str) -> None:
        """Fires in ``segments.wal.log_mutation`` after the record
        bytes are written, BEFORE the fsync.  The ``wal-torn-record``
        rule truncates the just-appended record mid-payload and raises
        :class:`InjectedWalTorn`: the mutation fails un-acked, and the
        next WAL read quarantines the torn tail — proving "acked means
        durable" covers the append syscall window itself."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "wal-torn-record":
                    continue
                if self._fire_once(ri, rule):
                    size = os.path.getsize(path)
                    with open(path, "r+b") as f:
                        f.truncate(max(size - 7, 1))
                    log.warning("fault injection: tore wal record in "
                                "%s before fsync", path)
                    raise InjectedWalTorn(
                        "injected wal record tear before fsync "
                        "(fault spec)")

    def on_fetch_payload(self, name: str, data: bytes) -> bytes:
        """Fires on the PRIMARY as a ``fetch_segment`` admin payload is
        about to ship; the ``fetch-partial`` rule truncates it to half.
        The replica's per-file adler32 verification must reject the
        short payload and retry — a partial ship may never be swapped
        into a manifest."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "fetch-partial":
                    continue
                if self._fire_once(ri, rule):
                    log.warning("fault injection: truncating fetch "
                                "payload for %s (%d -> %d bytes)",
                                name, len(data), max(len(data) // 2, 1))
                    return data[:max(len(data) // 2, 1)]
        return data

    def on_lease_check(self) -> bool:
        """Fires as a lease holder validates/renews its lease before a
        mutation.  The ``lease-steal`` rule returns True ONCE: the
        caller rewrites the lease to a foreign owner before its normal
        check runs, which must then reject the mutation with
        ``lease_lost`` while the old generation keeps serving reads."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "lease-steal":
                    continue
                if self._fire_once(ri, rule):
                    log.warning("fault injection: stealing the "
                                "mutation lease")
                    return True
        return False

    def on_reload(self) -> None:
        """Fires in the serve daemon's hot-reload path after the
        replacement artifact is opened but before the engine swap; may
        raise :class:`InjectedReloadCorrupt` — the verification
        failure a reload must survive by keeping the old artifact."""
        with self._lock:
            for ri, rule in enumerate(self.rules):
                if rule.kind != "reload-corrupt":
                    continue
                if self._fire_once(ri, rule):
                    raise InjectedReloadCorrupt(
                        "injected reload verification failure "
                        "(fault spec)")


# -- arming -----------------------------------------------------------

_UNSET = object()
_active: FaultInjector | None | object = _UNSET
_active_lock = threading.Lock()


def install(spec: str | None) -> FaultInjector | None:
    """Arm the injector from a spec string (None/empty disarms)."""
    global _active
    with _active_lock:
        _active = FaultInjector(spec) if spec else None
        return _active  # type: ignore[return-value]


def active() -> FaultInjector | None:
    """The armed injector, or None.  First call parses ``MRI_FAULTS``
    if :func:`install` was never called (subprocess arming)."""
    global _active
    if _active is _UNSET:
        with _active_lock:
            if _active is _UNSET:
                spec = envknobs.get(ENV_VAR)
                _active = FaultInjector(spec) if spec else None
    return _active  # type: ignore[return-value]


# -- retry policy -----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff and a per-document
    deadline.  ``max_attempts`` counts the first try: 3 attempts = up
    to 2 retries.  The deadline bounds the *total* time (including the
    upcoming sleep) one document may consume before its error is
    final — a pathological device can't stall the whole window."""

    max_attempts: int = 3
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    deadline_s: float = 1.0
    sleep: object = time.sleep  # injectable for tests

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Knobs: MRI_READ_RETRIES (attempts), MRI_READ_BACKOFF_MS,
        MRI_READ_DEADLINE_S.

        Invalid values raise a one-line KnobError naming the variable
        (the CLI maps it to exit 2) instead of surfacing a bare
        ``int()`` traceback three layers down a worker thread; the
        casts and bounds live with the declarations in
        :mod:`..utils.envknobs`.
        """
        return cls(
            max_attempts=envknobs.get("MRI_READ_RETRIES"),
            backoff_s=envknobs.get("MRI_READ_BACKOFF_MS") / 1e3,
            deadline_s=envknobs.get("MRI_READ_DEADLINE_S"),
        )

    def run(self, fn, *, doc_id: int | None = None, path: str = "",
            report: "DegradationReport | None" = None):
        """Call ``fn`` retrying OSError; the final error re-raises."""
        delay = self.backoff_s
        deadline = time.monotonic() + self.deadline_s
        attempt = 1
        while True:
            try:
                return fn()
            except OSError:
                if (attempt >= self.max_attempts
                        or time.monotonic() + delay > deadline):
                    raise
                if report is not None:
                    report.record_retry(doc_id=doc_id, path=path)
                self.sleep(delay)
                delay *= self.backoff_mult
                attempt += 1


def default_policy() -> RetryPolicy:
    """The pipeline-wide read policy (env-tunable, see
    :meth:`RetryPolicy.from_env`)."""
    return RetryPolicy.from_env()


# -- degradation report -----------------------------------------------

class DegradationReport:
    """Thread-safe tally of what failure handling did in one run."""

    def __init__(self):
        self._lock = threading.Lock()
        self.read_retries = 0  # guarded by: self._lock
        # {"doc_id", "path", "reason"}  # guarded by: self._lock
        self.skips: list[dict] = []
        # In-run fault-tolerance tallies (the host backend's parallel
        # path, not ported yet): a recovered worker death leaves the
        # output byte-identical, so these are the only observable
        # trace that recovery ran at all.
        self.worker_recoveries = 0   # guarded by: self._lock
        self.windows_requeued = 0    # guarded by: self._lock
        self.reducer_takeovers = 0   # guarded by: self._lock

    def record_retry(self, *, doc_id: int | None = None,
                     path: str = "") -> None:
        with self._lock:
            self.read_retries += 1

    def record_skip(self, *, doc_id: int, path: str,
                    reason: str) -> None:
        log.debug("skipping unreadable document %s (doc id %d): %s",
                  path, doc_id, reason)
        with self._lock:
            self.skips.append(
                {"doc_id": doc_id, "path": path, "reason": reason})

    def record_worker_recovery(self, *, windows_requeued: int = 0) -> None:
        """One scan worker died and its windows went back to the pool
        (survivors or a respawned replacement rescan them)."""
        with self._lock:
            self.worker_recoveries += 1
            self.windows_requeued += int(windows_requeued)

    def record_reducer_takeover(self) -> None:
        """One dead reducer's letter range was re-emitted by a
        surviving thread (atomic tmp+rename makes the re-emit safe)."""
        with self._lock:
            self.reducer_takeovers += 1

    def merge(self, other: "DegradationReport") -> None:
        """Fold ``other``'s tallies into this report (thread-safe on
        both sides).  The multi-worker host path gives each scan worker
        its own report — readers record without contending on the
        run-scoped lock — and merges them at the join barrier, so a
        degraded K-worker run still exits with the COMPLETE skipped-doc
        list no matter which worker hit the bad stripe."""
        if other is self:
            return
        with other._lock:
            retries = other.read_retries
            skips = list(other.skips)
            recoveries = other.worker_recoveries
            requeued = other.windows_requeued
            takeovers = other.reducer_takeovers
        with self._lock:
            self.read_retries += retries
            self.skips.extend(skips)
            self.worker_recoveries += recoveries
            self.windows_requeued += requeued
            self.reducer_takeovers += takeovers

    def clear(self) -> None:
        """Forget every tally: a plan restart re-reads the corpus and
        records its retries and skips anew."""
        with self._lock:
            self.read_retries = 0
            self.skips.clear()
            self.worker_recoveries = 0
            self.windows_requeued = 0
            self.reducer_takeovers = 0

    @property
    def degraded(self) -> bool:
        with self._lock:
            return bool(self.skips)

    def skipped_doc_ids(self) -> list[int]:
        with self._lock:
            return [s["doc_id"] for s in self.skips]

    def summary(self) -> dict:
        """The stats-dict form (bench JSON / ``--stats`` fields)."""
        with self._lock:
            return {
                "read_retries": self.read_retries,
                "skipped_docs": [s["doc_id"] for s in self.skips],
                "skip_reasons": {
                    str(s["doc_id"]): s["reason"] for s in self.skips},
                "worker_recoveries": self.worker_recoveries,
                "windows_requeued": self.windows_requeued,
                "reducer_takeovers": self.reducer_takeovers,
            }

    def log_summary(self, logger: logging.Logger = log) -> None:
        """ONE counted line for the whole run — per-document warnings
        are deduplicated here (each skip is DEBUG-logged at the site)."""
        with self._lock:
            recoveries = self.worker_recoveries
            requeued = self.windows_requeued
            takeovers = self.reducer_takeovers
        if recoveries or takeovers:
            logger.info(
                "fault tolerance: recovered %d worker death(s) "
                "(%d window(s) requeued), %d reducer takeover(s)",
                recoveries, requeued, takeovers)
        if not self.degraded:
            return
        with self._lock:
            ids = [s["doc_id"] for s in self.skips]
            first = self.skips[0]
            retries = self.read_retries
        logger.warning(
            "degraded run: skipped %d unreadable document(s) "
            "(doc ids %s) after %d retr%s; first reason: %s",
            len(ids), ids, retries,
            "y" if retries == 1 else "ies", first["reason"])


_report_lock = threading.Lock()
_current_report = DegradationReport()


def current_report() -> DegradationReport:
    """The run-scoped report the read paths record into by default."""
    with _report_lock:
        return _current_report


def begin_run() -> DegradationReport:
    """Start a fresh report (the model calls this at run() entry)."""
    global _current_report
    with _report_lock:
        _current_report = DegradationReport()
        return _current_report
