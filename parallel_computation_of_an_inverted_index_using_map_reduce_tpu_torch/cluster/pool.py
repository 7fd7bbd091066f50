"""Persistent pipelined replica connections + per-shard failover state.

One :class:`ReplicaConn` per (shard, replica) endpoint: a single
long-lived socket carrying many concurrent RPCs, correlated by ``id``
(the daemon echoes it).  RPC ids come from ONE process-global counter,
so the same encoded request line can be scattered verbatim to every
shard — the router JSON-encodes each client query once, not D times.

Threading: each live connection owns a reader thread (parse + resolve
callbacks) and a writer thread draining a deque with one batched
``sendall`` per wakeup — pipelined senders amortize syscalls exactly
like the daemon's writer.  Any socket error condemns the connection:
every pending callback is resolved with ``None`` (the
connection-death sentinel) and the owning :class:`ShardClient` marks
the replica down, which is what the router's failover keys off.

:class:`ShardClient` holds one shard's replica set: health state fed
by the router's healthz prober, the current primary, and a rolling
latency reservoir whose p95 drives adaptive hedging (hedge.py).
"""

from __future__ import annotations

import itertools
import json
import logging
import socket
import threading
import time
from collections import deque

from .. import faults

log = logging.getLogger("mri_torch.cluster")

#: Readiness reasons that must push traffic off a replica even
#: though its TCP endpoint still answers.
NOT_READY_REASONS = ("draining", "stalled", "overloaded",
                    "replica_lagging", "reloading")

_rpc_ids = itertools.count(1)


def next_rpc_id() -> int:
    """Process-global RPC id (``next`` on a count is atomic under the
    GIL) — unique across every replica connection, so one encoded
    request line is valid on all of them simultaneously."""
    return next(_rpc_ids)


class ConnDead(Exception):
    """The replica connection is gone (send refused or torn)."""


class ReplicaConn:
    """One pipelined JSON-lines connection to a shard replica."""

    def __init__(self, shard: int, replica: int, addr: tuple,
                 on_dead=None, connect_timeout: float = 5.0):
        self.shard = shard
        self.replica = replica
        self.addr = addr
        self._on_dead = on_dead
        self.sock = socket.create_connection(addr,
                                             timeout=connect_timeout)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self.sock.makefile("rb")
        self._pending: dict[int, object] = {}  # guarded by: self._lock
        self._lock = threading.Lock()
        self._outq: deque[bytes] = deque()  # guarded by: self._out_cv
        self._out_cv = threading.Condition()
        self.dead = False
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"mri-router-read-s{shard}r{replica}")
        self._writer = threading.Thread(
            target=self._write_loop, daemon=True,
            name=f"mri-router-write-s{shard}r{replica}")
        self._reader.start()
        self._writer.start()

    def send(self, rpc_id: int, data: bytes, cb) -> None:
        """Register ``cb(payload)`` for ``rpc_id`` and enqueue one
        encoded request line.  Raises :class:`ConnDead` when the
        connection is already condemned; a death AFTER enqueue resolves
        the callback with ``None`` instead."""
        inj = faults.active()
        if inj is not None:
            try:
                inj.on_router_send(self.shard, self.replica)
            except faults.InjectedConnReset:
                self._fail()
                raise ConnDead(
                    f"shard {self.shard} replica {self.replica}: "
                    "injected connection reset") from None
        with self._lock:
            if self.dead:
                raise ConnDead(
                    f"shard {self.shard} replica {self.replica} "
                    f"({self.addr[0]}:{self.addr[1]}): connection down")
            self._pending[rpc_id] = cb
        with self._out_cv:
            self._outq.append(data)
            self._out_cv.notify()

    def forget(self, rpc_id: int) -> None:
        """Drop the callback for an RPC the caller no longer wants
        (deadline passed, hedge already won).  A late response is then
        discarded by the reader."""
        with self._lock:
            self._pending.pop(rpc_id, None)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _write_loop(self) -> None:
        while True:
            with self._out_cv:
                while not self._outq and not self.dead:
                    self._out_cv.wait()
                if self.dead and not self._outq:
                    return
                chunk = b"".join(self._outq)
                self._outq.clear()
            try:
                self.sock.sendall(chunk)
            except OSError:
                self._fail()
                return

    def _read_loop(self) -> None:
        try:
            for raw in self._rfile:
                line = raw.strip()
                if not line:
                    continue
                try:
                    payload = json.loads(line)
                except ValueError:
                    log.warning("shard %d replica %d: undecodable "
                                "response line dropped", self.shard,
                                self.replica)
                    continue
                rid = payload.get("id") if isinstance(payload, dict) \
                    else None
                if rid is None:
                    continue  # unsolicited (id-less bad_request echo)
                with self._lock:
                    cb = self._pending.pop(rid, None)
                if cb is not None:
                    cb(payload)
        except OSError:
            pass
        self._fail()

    def _fail(self) -> None:
        """Condemn the connection once: close, fail every pending RPC
        with the ``None`` death sentinel, notify the owner."""
        with self._lock:
            if self.dead:
                return
            self.dead = True
            orphans = list(self._pending.values())
            self._pending.clear()
        with self._out_cv:
            self._out_cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        # the makefile handle holds the fd's last reference — close it
        # too or the socket outlives the condemned connection
        try:
            self._rfile.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._on_dead is not None:
            self._on_dead(self)
        for cb in orphans:
            try:
                cb(None)
            except Exception:
                log.exception("rpc callback failed on connection death")

    def close(self) -> None:
        self._fail()


class _P95Ring:
    """Fixed-size latency reservoir; p95 recomputed every few inserts
    (a 128-float sort is cheap, per-RPC would still be waste)."""

    def __init__(self, size: int = 128, refresh: int = 16):
        self._buf: list[float] = []
        self._size = size
        self._refresh = refresh
        self._i = 0
        self._n = 0
        self._p95: float | None = None
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            if len(self._buf) < self._size:
                self._buf.append(seconds)
            else:
                self._buf[self._i] = seconds
                self._i = (self._i + 1) % self._size
            self._n += 1
            if self._n % self._refresh == 0 or self._p95 is None:
                s = sorted(self._buf)
                self._p95 = s[min(len(s) - 1,
                                  int(0.95 * (len(s) - 1) + 0.5))]

    def p95(self) -> float | None:
        with self._lock:
            return self._p95


class Breaker:
    """Per-replica circuit breaker: closed → open → half-open.

    Failure evidence (error answers, RPC timeouts, connection deaths)
    lands in a ring of per-second ``(ok, err)`` buckets —
    ``obs/windows.py``'s stamped-bucket discipline shrunk to one
    counter pair — so verdicts follow a rolling ``WINDOW_S``-second
    window, not all-time totals.  The breaker opens when the window
    holds at least ``threshold`` failures and strictly more failures
    than successes; an open breaker rejects picks for ``cooldown_s``,
    then admits exactly ONE in-flight probe RPC (half-open) whose
    outcome closes or re-opens it.  A ready ``healthz`` verdict also
    closes it, so recovery is always probe-gated — by the router's own
    traffic or by the health prober, whichever speaks first.
    """

    WINDOW_S = 10

    CLOSED = "closed"
    HALF_OPEN = "half-open"
    OPEN = "open"

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._ok = [0] * self.WINDOW_S
        self._err = [0] * self.WINDOW_S
        self._stamp = [-1] * self.WINDOW_S  # second each bucket holds
        self.state = self.CLOSED
        self._opened_at = 0.0
        self._probing = False

    def _bucket(self, now: float) -> int:
        sec = int(now)
        i = sec % self.WINDOW_S
        if self._stamp[i] != sec:
            self._stamp[i] = sec
            self._ok[i] = 0
            self._err[i] = 0
        return i

    def _window(self, now: float) -> tuple:
        lo = int(now) - self.WINDOW_S + 1
        ok = err = 0
        for i in range(self.WINDOW_S):
            if self._stamp[i] >= lo:
                ok += self._ok[i]
                err += self._err[i]
        return ok, err

    def allow(self, now: float | None = None) -> bool:
        """May the caller send this replica an RPC right now?  Open
        says no until ``cooldown_s`` has passed, then one True answer
        claims the half-open probe slot — callers that get True MUST
        report the RPC's outcome or the slot stays claimed until the
        health prober speaks."""
        now = self._clock() if now is None else now
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if now - self._opened_at < self.cooldown_s:
                    return False
                self.state = self.HALF_OPEN
                self._probing = True
                return True
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        now = self._clock()
        with self._lock:
            if self.state != self.CLOSED:
                self._close_locked()
            self._ok[self._bucket(now)] += 1

    def record_failure(self) -> None:
        now = self._clock()
        with self._lock:
            self._err[self._bucket(now)] += 1
            if self.state == self.HALF_OPEN:
                self._open_locked(now)
            elif self.state == self.CLOSED:
                ok, err = self._window(now)
                if err >= self.threshold and err > ok:
                    self._open_locked(now)

    def note_ready(self) -> None:
        """A ready healthz verdict — probe-gated recovery through the
        prober's channel instead of a live data RPC."""
        with self._lock:
            if self.state != self.CLOSED:
                self._close_locked()

    def _open_locked(self, now: float) -> None:
        self.state = self.OPEN
        self._opened_at = now
        self._probing = False

    def _close_locked(self) -> None:
        self.state = self.CLOSED
        self._probing = False
        # fresh start: the failures that opened the breaker must not
        # re-open it on the first post-recovery error
        self._stamp = [-1] * self.WINDOW_S


class RetryBudget:
    """Token-bucket retry/hedge budget, a ratio of live traffic.

    Every FIRST attempt of a shard leg deposits ``ratio`` tokens;
    every retry or hedge spends one whole token.  Over any window the
    extra load a browning-out shard can attract is therefore capped
    near ``ratio`` × its live traffic plus the small constant ``cap``
    a cold router may bank — no retry storm compounds.  ``ratio`` 0
    disables retries and hedges outright.
    """

    def __init__(self, ratio: float, cap: float = 8.0):
        self.ratio = float(ratio)
        self._cap = max(1.0, float(cap))
        self._tokens = min(self._cap, 2.0) if self.ratio > 0 else 0.0
        self._lock = threading.Lock()
        self.denied = 0  # lifetime try_spend refusals (stats surface)

    def deposit(self) -> None:
        if self.ratio <= 0:
            return
        with self._lock:
            self._tokens = min(self._cap, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            self.denied += 1
            return False

    def tokens(self) -> float:
        with self._lock:
            return round(self._tokens, 3)


class Replica:
    """Health + connection state for one endpoint of one shard."""

    def __init__(self, shard: int, idx: int, addr: tuple):
        self.shard = shard
        self.idx = idx
        self.addr = addr
        self.conn: ReplicaConn | None = None  # guarded by: self.lock
        self.lock = threading.Lock()
        self.ready = False   # last healthz verdict
        self.reasons: list = ["unprobed"]
        self.generation = None  # serving generation from last healthz
        self.last_probe = 0.0
        self.breaker = Breaker()

    def describe(self) -> dict:
        return {"addr": f"{self.addr[0]}:{self.addr[1]}",
                "ready": self.ready,
                "reasons": list(self.reasons),
                "generation": self.generation,
                "breaker": self.breaker.state}


class ShardClient:
    """One doc-shard's replica set, as the router sees it."""

    def __init__(self, shard: int, addrs: list,
                 retry_budget_ratio: float = 0.1):
        self.shard = shard
        self.replicas = [Replica(shard, i, a)
                         for i, a in enumerate(addrs)]
        self.primary = 0  # guarded by: self._lock
        self._lock = threading.Lock()
        self.latency = _P95Ring()
        self.budget = RetryBudget(retry_budget_ratio)

    def conn(self, ri: int) -> ReplicaConn:
        """The live connection for replica ``ri``, dialing on demand.
        Raises :class:`ConnDead` when the endpoint refuses."""
        rep = self.replicas[ri]
        with rep.lock:
            c = rep.conn
            if c is not None and not c.dead:
                return c
            try:
                c = ReplicaConn(self.shard, ri, rep.addr,
                                on_dead=self._conn_died)
            except OSError as e:
                rep.breaker.record_failure()
                raise ConnDead(
                    f"shard {self.shard} replica {ri} "
                    f"({rep.addr[0]}:{rep.addr[1]}): {e}") from e
            rep.conn = c
            return c

    def _conn_died(self, conn: ReplicaConn) -> None:
        rep = self.replicas[conn.replica]
        rep.ready = False
        rep.reasons = ["connection_lost"]
        rep.breaker.record_failure()

    def pick(self, exclude: tuple = ()) -> int:
        """Replica to try next: the primary when it is ready and its
        breaker admits traffic, else the first such replica (and that
        becomes the new primary — a health-based failover the router
        counts), else any non-excluded endpoint whose breaker admits
        as a last resort (an open breaker whose cooldown just expired
        admits its single half-open probe here).  -1 when every
        replica is excluded or breaker-rejected — the signal the
        partial-result gather keys off."""
        with self._lock:
            p = self.primary
            rep = self.replicas[p]
            if p not in exclude and rep.ready and rep.breaker.allow():
                return p
            for r in self.replicas:
                if r.idx != p and r.idx not in exclude and r.ready \
                        and r.breaker.allow():
                    self.primary = r.idx
                    return r.idx
            for r in self.replicas:
                if r.idx not in exclude and not r.ready \
                        and r.breaker.allow():
                    return r.idx
        return -1

    def hedge_pick(self, primary_ri: int) -> int:
        """A DIFFERENT ready replica (breaker permitting) for the
        hedge RPC (-1 if none)."""
        for r in self.replicas:
            if r.idx != primary_ri and r.ready and r.breaker.allow():
                return r.idx
        return -1

    def breakers_open(self) -> int:
        """Replicas currently refusing traffic (open or half-open)."""
        return sum(1 for r in self.replicas
                   if r.breaker.state != Breaker.CLOSED)

    def ready_count(self) -> int:
        return sum(1 for r in self.replicas if r.ready)

    def describe(self) -> dict:
        with self._lock:
            primary = self.primary
        reps = []
        for r in self.replicas:
            d = r.describe()
            d["primary"] = r.idx == primary
            reps.append(d)
        p95 = self.latency.p95()
        return {"shard": self.shard,
                "p95_ms": round(p95 * 1e3, 3) if p95 is not None
                          else None,
                "breakers_open": self.breakers_open(),
                "retry_tokens": self.budget.tokens(),
                "retry_denied": self.budget.denied,
                "replicas": reps}

    def close(self) -> None:
        for r in self.replicas:
            with r.lock:
                c, r.conn = r.conn, None
            if c is not None:
                c.close()


class HealthProber:
    """One thread probing every replica of every shard with pipelined
    ``healthz`` RPCs at a fixed cadence, updating replica readiness
    from the daemon's ``ready``/``reasons`` verdict.  An unanswered probe
    (connection death, or no reply within two cadences) marks the
    replica down; the next cycle re-dials through ``ShardClient.conn``.
    """

    def __init__(self, shards: list, interval_s: float,
                 on_transition=None):
        self.shards = shards
        self.interval_s = interval_s
        self._on_transition = on_transition
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mri-router-health")

    def start(self) -> None:
        self._probe_all(first=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._probe_all()

    def _probe_all(self, first: bool = False) -> None:
        now = time.monotonic()
        for sc in self.shards:
            for rep in sc.replicas:
                self._probe(sc, rep, now, first)

    def _probe(self, sc: ShardClient, rep: Replica, now: float,
               first: bool) -> None:
        def _verdict(payload, rep=rep, sc=sc):
            was = rep.ready
            if payload is None:
                rep.ready = False
                rep.reasons = ["connection_lost"]
                rep.generation = None
            else:
                rep.ready = bool(payload.get("ready"))
                rep.reasons = list(payload.get("reasons") or ())
                gen = payload.get("generation")
                rep.generation = gen if isinstance(gen, int) \
                    and not isinstance(gen, bool) else None
                if rep.ready:
                    rep.breaker.note_ready()
            rep.last_probe = time.monotonic()
            if was != rep.ready and self._on_transition is not None:
                self._on_transition(sc, rep, was)

        # a probe two cadences old means the endpoint is wedged (alive
        # TCP, no answers): treat as down until it speaks again
        if rep.ready and rep.last_probe \
                and now - rep.last_probe > 3 * self.interval_s:
            was = rep.ready
            rep.ready = False
            rep.reasons = ["probe_timeout"]
            if was and self._on_transition is not None:
                self._on_transition(sc, rep, was)
        rid = next_rpc_id()
        line = (json.dumps({"id": rid, "op": "healthz"},
                           separators=(",", ":")) + "\n").encode()
        try:
            conn = sc.conn(rep.idx)
            conn.send(rid, line, _verdict)
        except ConnDead:
            _verdict(None)
            return
        if first:
            # synchronous first round so the router starts with real
            # readiness instead of an all-down fleet
            deadline = time.monotonic() + max(1.0, self.interval_s)
            while rep.last_probe == 0.0 \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
