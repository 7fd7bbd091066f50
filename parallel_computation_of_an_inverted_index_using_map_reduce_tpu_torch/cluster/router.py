"""``router`` — scatter-gather serving over doc-sharded daemons.

The router speaks the daemon's exact JSON-lines protocol on both
sides: clients connect to it as if it were one big ``serve`` (same
ops, same error kinds, same ``id``/``trace_id`` echo), and it fans
every data op out to D shard daemons over persistent pipelined
connections, then gathers with the same D-way merges
:class:`~..serve.multi_engine.MultiSegmentEngine` uses in-process —
the cluster is MultiSegmentEngine stretched over TCP.

Fan-out cost: each client query is JSON-encoded ONCE (RPC ids come
from a process-global counter, so one encoded line is valid on every
shard connection simultaneously) and its gather is resolved on
whichever shard connection answers last — no per-request threads, no
router-side queueing beyond the admission gate.

Correctness of the gather (why answers are byte-identical to a
monolithic build of the same corpus):

* shards answer in GLOBAL doc ids with GLOBAL BM25 stats injected at
  engine-open (cluster/shard.py), so ranked scores are bit-equal and
  per-shard ranked streams are disjoint — ``merge_ranked`` over
  ``(-score, gid)`` reproduces the monolith's exact tie order;
* AND/OR/postings streams are ascending and disjoint —
  ``merge_doc_ids`` is a pure ascending merge;
* ``df`` is an elementwise integer sum (each doc lives in exactly one
  shard);
* letter ``top_k`` runs threshold refinement: scatter a k2-deep local
  top, sum exact global dfs for the candidate union, and accept only
  when the kth candidate's global df strictly beats the sum of the
  per-shard k2-th dfs over non-exhausted shards — no unseen term can
  outrank an accepted one.

Tail tolerance: every shard RPC may be **hedged** (a duplicate to a
different ready replica after ``MRI_CLUSTER_HEDGE_MS`` or the shard's
rolling p95; first answer wins) and **fails over** on connection
death, not-ready health probes (readiness reasons: draining / stalled /
overloaded / replica_lagging), or retryable error answers.  A query is
acknowledged only after its merged response is written — a replica
killed mid-RPC loses zero acknowledged queries
(``mri_cluster_failovers_total`` counts the reroutes).
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import threading
import time

from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import tracing as obs_tracing
from ..obs import windows as obs_windows
from ..serve import result_cache as result_cache_mod
from ..serve.daemon import ADMIN_OPS, OUTBOUND_DEPTH
from ..serve.multi_engine import merge_doc_ids, merge_ranked
from ..utils import envknobs
from .. import faults
from . import hedge as hedge_mod
from . import pool as pool_mod

log = logging.getLogger("mri_torch.cluster")

HEDGE_ENV = "MRI_CLUSTER_HEDGE_MS"
HEALTH_ENV = "MRI_CLUSTER_HEALTH_MS"
INFLIGHT_ENV = "MRI_CLUSTER_INFLIGHT"
RPC_TIMEOUT_ENV = "MRI_CLUSTER_RPC_TIMEOUT_MS"
PARTIAL_ENV = "MRI_CLUSTER_PARTIAL"
RETRY_BUDGET_ENV = "MRI_CLUSTER_RETRY_BUDGET"

#: admission counters share the daemon's family names on purpose: the
#: router IS a serve-plane daemon, so the SLO tracker, the rolling
#: windows, and ``top`` price it with zero new math
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
    ("connections", "mri_serve_connections_total"),
    ("scatter_rpcs", "mri_router_scatter_rpcs_total"),
    ("hedges", "mri_cluster_hedges_total"),
    ("hedge_wins", "mri_cluster_hedge_wins_total"),
    ("failovers", "mri_cluster_failovers_total"),
    ("shard_errors", "mri_cluster_shard_errors_total"),
    ("shard_unavailable", "mri_cluster_shard_unavailable_total"),
    ("partial", "mri_cluster_partial_total"),
    ("retry_denied", "mri_cluster_retry_denied_total"),
)

#: shard error answers the router retries on another replica — the
#: shard refused to serve, it did not serve wrongly
_RETRYABLE = ("draining", "overloaded", "stale_generation")

#: admin ops the router answers itself (everything else is a
#: shard-local concern — mutations go to the shard primaries directly)
_ROUTER_ADMIN = ("stats", "healthz", "metrics", "slo")

_SENTINEL = object()


def parse_shard_arg(spec: str) -> list[list[tuple]]:
    """``--shards`` grammar: shards joined by ``,``, replicas of one
    shard joined by ``|`` — ``h:1|h:2,h:3`` is two shards, the first
    with two replicas.  Returns ``[[(host, port), ...], ...]``."""
    shards = []
    for si, part in enumerate(s for s in spec.split(",") if s.strip()):
        reps = []
        for ep in part.split("|"):
            host, _, port_s = ep.strip().rpartition(":")
            try:
                port = int(port_s)
                if not host or not (0 < port <= 65535):
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"shard {si}: bad endpoint {ep.strip()!r} "
                    "(want HOST:PORT)") from None
            reps.append((host, port))
        shards.append(reps)
    if not shards:
        raise ValueError("--shards lists no endpoints")
    return shards


def parse_partial_policy(spec) -> tuple:
    """``partial_policy`` grammar: ``fail`` (any unanswerable shard
    fails the whole request — the byte-compat default) or
    ``allow[:min_coverage=F]`` (answer from the shards that did
    answer, flagged with ``partial``+``coverage`` metadata, provided
    at least fraction F of the corpus answered; F defaults to 0).
    Returns ``(policy, min_coverage)``."""
    if not isinstance(spec, str):
        raise ValueError("partial_policy must be a string")
    s = spec.strip()
    if s == "fail":
        return ("fail", 1.0)
    if s == "allow":
        return ("allow", 0.0)
    if s.startswith("allow:"):
        key, _, val = s[len("allow:"):].partition("=")
        if key.strip() == "min_coverage":
            try:
                f = float(val)
            except ValueError:
                raise ValueError(
                    f"partial_policy: min_coverage {val!r} is not a "
                    "number") from None
            if 0.0 <= f <= 1.0:
                return ("allow", f)
            raise ValueError(
                "partial_policy: min_coverage must be in [0, 1]")
    raise ValueError(f"partial_policy {spec!r}: want 'fail' or "
                     "'allow[:min_coverage=F]'")


class _ClientConn:
    """One accepted client connection: reader thread (parse + admit),
    writer thread (sole socket writer) — the daemon's _Conn shape."""

    _ids = iter(range(1, 1 << 62))

    def __init__(self, router: "RouterDaemon", sock: socket.socket,
                 addr):
        self.router = router
        self.sock = sock
        self.addr = addr
        self.outbound: queue.Queue = queue.Queue(maxsize=OUTBOUND_DEPTH)
        self.dead = False
        self.reader_done = False
        self.writer_done = False
        cid = next(self._ids)
        self.reader = threading.Thread(
            target=router._reader_loop, args=(self,), daemon=True,
            name=f"mri-router-cread-{cid}")
        self.writer = threading.Thread(
            target=router._writer_loop, args=(self,), daemon=True,
            name=f"mri-router-cwrite-{cid}")

    def start(self) -> None:
        self.reader.start()
        self.writer.start()

    def enqueue(self, payload: dict) -> bool:
        data = (json.dumps(payload, separators=(",", ":"))
                + "\n").encode()
        try:
            self.outbound.put_nowait(data)
            return True
        except queue.Full:
            if not self.dead:
                self.router._count("slow_client_closes")
            self.kill()
            return False

    def enqueue_sentinel(self) -> None:
        try:
            self.outbound.put_nowait(_SENTINEL)
        except queue.Full:
            self.kill()

    def kill(self) -> None:
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


class _Scatter:
    """One admitted client data request fanned out to all shards."""

    __slots__ = ("conn", "rid", "op", "tid", "line", "rpc_id",
                 "t_admit", "explain", "k", "done", "lock", "parts",
                 "remaining", "calls", "deadline_timer",
                 "timeout_timer", "hedged", "failovers", "policy",
                 "min_cov", "missing", "ckey", "epoch")

    def __init__(self, conn, rid, op, tid, line, rpc_id, t_admit,
                 explain, k, nshards, policy="fail", min_cov=1.0,
                 ckey=None, epoch=None):
        self.conn = conn
        self.rid = rid
        self.op = op
        self.tid = tid
        self.line = line
        self.rpc_id = rpc_id
        self.t_admit = t_admit
        self.explain = explain
        self.k = k
        self.done = False  # guarded by: self.lock
        self.lock = threading.Lock()
        self.parts: list = [None] * nshards  # guarded by: self.lock
        self.remaining = nshards  # guarded by: self.lock
        self.calls: list = [None] * nshards
        self.deadline_timer = None
        self.timeout_timer = None  # one RPC-timeout timer for all legs
        self.hedged: list = []  # shard idx, for explain
        self.failovers = 0
        self.policy = policy  # partial_policy: "fail" | "allow"
        self.min_cov = min_cov  # docs_fraction floor under "allow"
        self.missing: list = []  # unanswerable shards  # guarded by: self.lock
        self.ckey = ckey   # result-cache key (None: not cacheable)
        self.epoch = epoch  # shard-generation vector at admission


class _ShardCall:
    """One shard's leg of a scatter: replica attempts + hedge timer."""

    __slots__ = ("tried", "conns", "hedge_timer",
                 "t0", "first_replica", "hedge_replica", "live",
                 "attempts", "done")

    def __init__(self):
        self.tried: set = set()  # guarded by: the scatter's lock
        self.conns: list = []  # guarded by: the scatter's lock
        self.hedge_timer = None
        self.t0 = 0.0
        self.first_replica = -1
        self.hedge_replica = -1
        self.live = 0  # in-flight attempts  # guarded by: the scatter's lock
        self.attempts = 0  # lifetime sends incl. hedges  # guarded by: the scatter's lock
        self.done = False  # guarded by: the scatter's lock


class RouterDaemon:
    """The scatter-gather front door.  ``start()`` connects the shard
    pool, probes health, and binds; ``drain()`` is the graceful exit.
    """

    def __init__(self, shard_addrs: list, host: str = "127.0.0.1",
                 port: int = 0, *, hedge_ms: float | None = None,
                 inflight: int | None = None,
                 rpc_timeout_ms: float | None = None,
                 health_ms: int | None = None,
                 drain_s: float = 5.0):
        if not shard_addrs:
            raise ValueError("router needs at least one shard")
        self._host = host
        self._port = port
        self.hedge_ms = hedge_ms if hedge_ms is not None \
            else envknobs.get(HEDGE_ENV)
        self.max_inflight = inflight if inflight is not None \
            else envknobs.get(INFLIGHT_ENV)
        self.rpc_timeout_s = (rpc_timeout_ms if rpc_timeout_ms
                              is not None
                              else envknobs.get(RPC_TIMEOUT_ENV)) / 1e3
        health_ms = health_ms if health_ms is not None \
            else envknobs.get(HEALTH_ENV)
        self.drain_s = drain_s
        self.partial_spec = envknobs.get(PARTIAL_ENV)
        self.partial_default = parse_partial_policy(self.partial_spec)
        self.retry_budget_ratio = envknobs.get(RETRY_BUDGET_ENV)

        self.shards = [pool_mod.ShardClient(
                           i, addrs,
                           retry_budget_ratio=self.retry_budget_ratio)
                       for i, addrs in enumerate(shard_addrs)]
        # per-shard corpus sizes (learned from the shard engines'
        # sidecar-fed describe()) back docs_fraction in coverage
        # metadata; None until the background learner hears back
        self._shard_docs: list = [None] * len(shard_addrs)
        self._total_docs: int | None = None
        self.registry = obs_metrics.Registry()
        self._counts = {key: self.registry.counter(name)
                        for key, name in _COUNTER_NAMES}
        self._g_shards = self.registry.gauge("mri_cluster_shards")
        self._g_shards.set(len(self.shards))
        self._g_ready = self.registry.gauge(
            "mri_cluster_replicas_ready")
        self._g_inflight = self.registry.gauge("mri_serve_inflight")
        self._g_draining = self.registry.gauge("mri_serve_draining")
        self._g_breakers = self.registry.gauge(
            "mri_cluster_breakers_open")
        self._h_request = self.registry.histogram(
            "mri_serve_request_seconds")
        self._rolling = obs_windows.RollingWindows(
            self.registry,
            counters=[name for _key, name in _COUNTER_NAMES],
            histograms=("mri_serve_request_seconds",))
        self._slo = obs_slo.SLOTracker(self._rolling)
        self._obs_enabled = obs_tracing.enabled()
        # whole-answer cache above the scatter, keyed on the vector of
        # per-shard generations learned from health probes — a hot
        # query at a fully-known, agreed epoch never fans out.  The
        # epoch lags a shard mutation by at most one health-probe
        # period (MRI_CLUSTER_HEALTH_MS); until the prober re-agrees,
        # the epoch is unknown and every query bypasses the cache.
        self._result_cache = result_cache_mod.ResultCache(
            registry=self.registry)

        self.clock = hedge_mod.Clock()
        self.prober = pool_mod.HealthProber(
            self.shards, health_ms / 1e3,
            on_transition=self._health_transition)
        self._count_lock = threading.Lock()
        self._inflight = 0  # guarded by: self._count_lock
        self._seq = 0  # data-request ordinal (faults)  # guarded by: self._count_lock
        self._conns: set = set()  # guarded by: self._conn_lock
        self._conn_lock = threading.Lock()
        self._draining = False
        self._drain_guard = threading.Lock()
        self._drain_started = False  # guarded by: self._drain_guard
        self._drained = threading.Event()
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self.final_stats: dict | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        self.prober.start()
        self._rolling.start()
        threading.Thread(target=self._learn_shard_docs, daemon=True,
                         name="mri-router-docs").start()
        self._listener = socket.create_server(
            (self._host, self._port))
        self._listener.listen(128)
        # periodic wake so drain()'s close is noticed even with no
        # incoming connection (same trick as the serve daemon)
        self._listener.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="mri-router-accept")
        self._accept_thread.start()

    @property
    def address(self) -> tuple:
        assert self._listener is not None
        return self._listener.getsockname()[:2]

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> int:
        with self._drain_guard:
            if self._drain_started:
                self._drained.wait()
                return 0
            self._drain_started = True
        self._draining = True
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        deadline = time.monotonic() + self.drain_s
        while time.monotonic() < deadline:
            with self._count_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.01)
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            c.enqueue_sentinel()
        for c in conns:
            c.writer.join(timeout=1.0)
            c.kill()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        self.prober.stop()
        self.clock.stop()
        for sc in self.shards:
            sc.close()
        self._rolling.stop()
        self.final_stats = self.stats()
        self._drained.set()
        return 0

    # -- health ---------------------------------------------------------

    def _health_transition(self, sc, rep, was_ready) -> None:
        if was_ready and not rep.ready:
            log.warning("shard %d replica %d (%s:%d) went not-ready: "
                        "%s", sc.shard, rep.idx, rep.addr[0],
                        rep.addr[1], rep.reasons)
            with sc._lock:
                if sc.primary == rep.idx:
                    pass  # pick() moves the primary on the next RPC
        self._g_ready.set(sum(s.ready_count() for s in self.shards))

    # -- result-cache epoch ---------------------------------------------

    def _current_epoch(self) -> tuple | None:
        """The per-shard serving-generation vector, or ``None`` while
        it is not fully known.  A shard's generation is known only when
        every READY replica reported the same one on its last healthz —
        a down shard, an unprobed replica, or a mid-catch-up replica
        set makes the epoch unknown and disables caching until the
        prober re-agrees (self-healing within one probe period)."""
        gens = []
        for sc in self.shards:
            seen = {rep.generation for rep in sc.replicas if rep.ready}
            if len(seen) != 1 or None in seen:
                return None
            gens.append(seen.pop())
        epoch = tuple(gens)
        # adopting a changed epoch drops every entry keyed under the
        # old one (they can never be probed again)
        self._result_cache.on_epoch(epoch)
        return epoch

    # -- coverage accounting --------------------------------------------

    def _learn_shard_docs(self) -> None:
        """Per-shard corpus sizes from the shard engines' describe()
        (fed by the cluster_shard.json sidecars) so partial answers
        report a docs_fraction, not just a shard count.  Best-effort:
        retries in the background until every shard has answered once;
        until then coverage falls back to the shard-count fraction."""
        while not self._draining:
            answers = self._rpc_all_blocking({"op": "stats"}, 2.0)
            for s, a in enumerate(answers):
                if not isinstance(a, dict):
                    continue
                eng = (a.get("stats") or {}).get("engine") or {}
                cl = eng.get("cluster") or {}
                ld, td = cl.get("local_docs"), cl.get("total_docs")
                if isinstance(ld, int):
                    self._shard_docs[s] = ld
                if isinstance(td, int):
                    self._total_docs = td
            if all(d is not None for d in self._shard_docs):
                return
            time.sleep(0.5)

    def _coverage(self, missing: list) -> dict:
        """The coverage block a degraded answer carries: how many
        shards answered, which are missing, and the fraction of the
        corpus' documents the answer covers (shard-count fraction when
        per-shard doc counts have not been learned yet)."""
        nd = len(self.shards)
        miss = sorted(set(missing))
        answered = nd - len(miss)
        cov = {"shards_answered": answered, "shards_total": nd,
               "missing": miss}
        docs, total = self._shard_docs, self._total_docs
        if total and all(d is not None for d in docs):
            have = sum(d for i, d in enumerate(docs) if i not in miss)
            frac = have / total
        else:
            frac = answered / nd if nd else 0.0
        cov["docs_fraction"] = round(frac, 6)
        return cov

    # -- client plumbing ------------------------------------------------

    def _count(self, key: str) -> None:
        self._counts[key].inc()

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._draining:
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed by drain()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _ClientConn(self, sock, addr)
            with self._conn_lock:
                self._conns.add(conn)
            self._count("connections")
            conn.start()

    def _reader_loop(self, conn: _ClientConn) -> None:
        try:
            with conn.sock.makefile("rb") as rfile:
                for raw in rfile:
                    self._handle_line(conn, raw)
                    if conn.dead:
                        break
        except OSError:
            pass
        finally:
            conn.reader_done = True
            conn.enqueue_sentinel()
            with self._conn_lock:
                self._conns.discard(conn)

    def _writer_loop(self, conn: _ClientConn) -> None:
        try:
            while True:
                data = conn.outbound.get()
                if data is _SENTINEL:
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

    # -- admission ------------------------------------------------------

    def _handle_line(self, conn: _ClientConn, raw: bytes) -> None:
        line = raw.strip()
        if not line:
            return
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            self._count("bad_request")
            conn.enqueue({"error": "bad_request", "detail": str(e)})
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
            self._reply_error(conn, rid, tid, "bad_request", err)
            return
        pp = req.get("partial_policy")
        if pp is None:
            policy, min_cov = self.partial_default
        else:
            try:
                policy, min_cov = parse_partial_policy(pp)
            except ValueError as e:
                self._count("bad_request")
                self._reply_error(conn, rid, tid, "bad_request",
                                  str(e))
                return
        if self._draining:
            self._count("draining_rejected")
            self._reply_error(conn, rid, tid, "draining",
                              "router is shutting down")
            return
        with self._count_lock:
            self._seq += 1
            seq = self._seq
        inj = faults.active()
        if inj is not None and inj.on_router_client(seq):
            # injected client reset: the peer vanishes before its
            # answer — the scatter never starts, nothing was acked.
            # Faults fire before the cache probe so chaos specs keyed
            # on request ordinal keep biting on hot queries.
            self._count("client_disconnects")
            conn.kill()
            return
        if tid is None and self._obs_enabled:
            tid = obs_tracing.gen_trace_id()
        ckey = epoch = None
        if req.get("partial_policy") is None \
                and req.get("min_generation") is None \
                and not req.get("explain"):
            ckey = result_cache_mod.key_for(
                op, req.get("terms"), req.get("letter"),
                int(req.get("k") or 0), req.get("score") or "df")
        if ckey is not None:
            t_admit = time.monotonic()
            epoch = self._current_epoch()
            hit = self._result_cache.lookup(ckey, epoch)
            if hit is not None:
                # answered above the scatter: a hot query at a known
                # epoch never fans out and never occupies an inflight
                # slot — it stays answerable even at the inflight cap
                self._count("requests")
                if rid is not None:
                    hit["id"] = rid
                if tid is not None:
                    hit.setdefault("trace_id", tid)
                self._h_request.observe(time.monotonic() - t_admit)
                conn.enqueue(hit)
                return
        with self._count_lock:
            if self._inflight >= self.max_inflight:
                self._count("shed")
                self._reply_error(conn, rid, tid, "overloaded",
                                  f"router at {self.max_inflight} "
                                  "inflight")
                return
            self._inflight += 1
        self._count("requests")
        if op == "top_k" and (req.get("score") or "df") == "df":
            # letter top_k needs multi-round refinement: run it on a
            # throwaway thread (rare op; the hot ops stay threadless)
            threading.Thread(
                target=self._letter_topk,
                args=(conn, req, tid, policy, min_cov, ckey, epoch),
                daemon=True, name="mri-router-letter").start()
            return
        self._start_scatter(conn, req, tid, policy, min_cov,
                            ckey=ckey, epoch=epoch)

    # the daemon's validation table, minus engine concerns
    @staticmethod
    def _validate(req: dict, op) -> str | None:
        from ..serve.daemon import ServeDaemon
        return ServeDaemon._validate(req, op)

    def _reply_error(self, conn, rid, tid, kind: str,
                     detail: str) -> None:
        payload = {"error": kind, "detail": detail}
        if rid is not None:
            payload["id"] = rid
        if tid is not None:
            payload["trace_id"] = tid
        conn.enqueue(payload)

    # -- scatter / gather -----------------------------------------------

    def _encode_shard_req(self, req: dict, rpc_id: int, tid,
                          **overrides) -> bytes:
        out = {"id": rpc_id, "op": req["op"]}
        for key in ("terms", "letter", "k", "score", "deadline_ms",
                    "explain", "tenant"):
            v = req.get(key)
            if v is not None:
                out[key] = v
        if tid is not None:
            out["trace_id"] = tid
        out.update(overrides)
        return (json.dumps(out, separators=(",", ":")) + "\n").encode()

    def _start_scatter(self, conn, req: dict, tid,
                       policy: str = "fail",
                       min_cov: float = 1.0,
                       ckey=None, epoch=None) -> None:
        rpc_id = pool_mod.next_rpc_id()
        line = self._encode_shard_req(req, rpc_id, tid)
        sc = _Scatter(conn, req.get("id"), req["op"], tid, line,
                      rpc_id, time.monotonic(),
                      bool(req.get("explain", False)),
                      int(req.get("k") or 0), len(self.shards),
                      policy=policy, min_cov=min_cov,
                      ckey=ckey, epoch=epoch)
        dl = req.get("deadline_ms")
        if dl is not None:
            sc.deadline_timer = self.clock.schedule(
                dl / 1e3, lambda: self._expire(sc))
        # one RPC-timeout timer covers every leg: with D shards a
        # per-leg timer would cost D schedules + D cancels per request
        # on the clock's shared lock, and all legs arm together anyway
        sc.timeout_timer = self.clock.schedule(
            self.rpc_timeout_s, lambda: self._rpc_timeout(sc))
        for shard in range(len(self.shards)):
            call = _ShardCall()
            sc.calls[shard] = call
            self._issue(sc, shard, call)

    def _attempt_cap(self, client) -> int:
        """Hard per-leg send bound: three passes over the replica set
        (the old exclusion-reset semantics), floor 4.  A persistently
        retryable replica — say stale_generation forever — must turn
        into a prompt typed failure, not spin until the deadline."""
        return max(4, 3 * len(client.replicas))

    def _issue(self, sc: _Scatter, shard: int, call: _ShardCall,
               charge_budget: bool = True) -> None:
        """Send (or resend) one shard leg on the best replica.  Never
        called (and never calls anything) while holding ``sc.lock``
        across a socket send — a send-side connection death resolves
        other scatters' callbacks synchronously.

        Every resend is bounded by the per-leg attempt cap; resends
        that answer a typed shed (``charge_budget``) additionally
        spend the shard's token-bucket retry budget, so a
        browning-out shard cannot attract a compounding retry storm.
        Failover after a connection death rides free
        (``charge_budget=False``): the replica is *gone*, not
        refusing, and re-homing its leg is the availability contract,
        not load amplification — a killed replica must not turn a
        burst of in-flight requests into typed failures because the
        bucket could not cover them all at once."""
        client = self.shards[shard]
        with sc.lock:
            if sc.done or call.done:
                return
            fail = None
            if call.attempts > 0:
                if call.attempts >= self._attempt_cap(client):
                    fail = (f"shard {shard}: attempt cap "
                            f"({self._attempt_cap(client)}) reached")
                elif charge_budget and not client.budget.try_spend():
                    self._count("retry_denied")
                    fail = f"shard {shard}: retry budget exhausted"
            ri = -1
            if fail is None:
                ri = client.pick(tuple(call.tried))
                if ri < 0 and call.tried:
                    # every replica tried this round, but a timed-out
                    # RPC or a dead pooled connection is not proof the
                    # replica itself is gone — clear the exclusion set
                    # and re-dial (the attempt cap bounds this)
                    call.tried.clear()
                    ri = client.pick(())
                if ri < 0:
                    fail = (f"shard {shard}: no replica admits "
                            "traffic (down or breaker-open)")
            if fail is None:
                if call.tried and ri not in call.tried:
                    self._count("failovers")
                    sc.failovers += 1
                call.tried.add(ri)
                call.live += 1
                call.attempts += 1
                if call.attempts == 1:
                    client.budget.deposit()
                if call.first_replica < 0:
                    call.first_replica = ri
            call.t0 = call.t0 or time.monotonic()
        if fail is not None:
            self._leg_unanswerable(sc, shard, call, fail)
            return
        # the hedge timer arms BEFORE the send: a stalled send (slow
        # shard, full kernel buffer) is exactly what hedges exist to
        # cover.  (The scatter-wide RPC-timeout timer armed even
        # earlier, in _start_scatter.)
        if call.hedge_timer is None:
            delay = hedge_mod.hedge_delay_s(self.hedge_ms,
                                            client.latency.p95())
            if delay is not None and len(client.replicas) > 1:
                call.hedge_timer = self.clock.schedule(
                    delay, lambda: self._fire_hedge(sc, shard, call))
        try:
            conn = client.conn(ri)
            conn.send(sc.rpc_id, sc.line,
                      lambda payload, s=shard, r=ri:
                      self._on_part(sc, s, r, payload))
        except pool_mod.ConnDead:
            self._count("shard_errors")
            with sc.lock:
                call.live = max(0, call.live - 1)
                retry = call.live == 0 and not (sc.done or call.done)
            if retry:
                self._issue(sc, shard, call, charge_budget=False)
            return
        with sc.lock:
            call.conns.append(conn)
        self._count("scatter_rpcs")

    def _fire_hedge(self, sc: _Scatter, shard: int,
                    call: _ShardCall) -> None:
        client = self.shards[shard]
        with sc.lock:
            if sc.done or call.done:
                return
            ri = client.hedge_pick(call.first_replica)
            if ri < 0 or ri in call.tried:
                return
            if not client.budget.try_spend():
                # hedges ride the same retry budget: a tail-latency
                # duplicate is exactly the load a brownout cannot absorb
                self._count("retry_denied")
                return
            call.tried.add(ri)
            call.live += 1
            call.attempts += 1
        try:
            conn = client.conn(ri)
            conn.send(sc.rpc_id, sc.line,
                      lambda payload, s=shard, r=ri:
                      self._on_part(sc, s, r, payload))
        except pool_mod.ConnDead:
            with sc.lock:
                call.live = max(0, call.live - 1)
            return
        with sc.lock:
            call.conns.append(conn)
            call.hedge_replica = ri
        self._count("scatter_rpcs")
        self._count("hedges")
        sc.hedged.append(shard)

    def _rpc_timeout(self, sc: _Scatter) -> None:
        """Condemn every leg still pending at the timeout and reissue
        each on a fresh replica.  Re-arms itself so the retries get a
        timeout window of their own."""
        stale = []
        with sc.lock:
            if sc.done:
                return
            for shard, call in enumerate(sc.calls):
                if call is None or call.done:
                    continue
                call.live = 0
                stale.append((shard, call, list(call.conns),
                              tuple(call.tried)))
            sc.timeout_timer = self.clock.schedule(
                self.rpc_timeout_s, lambda: self._rpc_timeout(sc))
        for shard, call, conns, tried in stale:
            self._count("shard_errors")
            for c in conns:
                c.forget(sc.rpc_id)
            # an unanswered window is failure evidence for every
            # replica that was in flight — this is what walks a
            # wedged-but-connected replica's breaker open.  The
            # reissue is budget-free like a connection death: a
            # wedged replica's burst of condemned in-flight legs is a
            # failover event, not retry amplification (the attempt
            # cap and the breaker bound it)
            for ri in tried:
                self.shards[shard].replicas[ri].breaker.record_failure()
            self._issue(sc, shard, call, charge_budget=False)

    def _expire(self, sc: _Scatter) -> None:
        salvage = False
        with sc.lock:
            if sc.done:
                return
            if sc.policy == "allow":
                # deadline with partials in hand: give up the pending
                # legs and answer from what arrived (the coverage
                # floor is still enforced in _complete)
                for shard, call in enumerate(sc.calls):
                    if call is None or not call.done:
                        if call is not None:
                            call.done = True
                        sc.missing.append(shard)
                        sc.remaining -= 1
                salvage = len(sc.missing) < len(sc.calls)
            sc.done = True
        if salvage:
            self._complete(sc)
            return
        self._count("deadline_expired")
        self._teardown_calls(sc)
        self._finish(sc, {"error": "deadline_expired",
                          "detail": "deadline passed before all "
                                    "shards answered"})

    def _teardown_calls(self, sc: _Scatter) -> None:
        if sc.timeout_timer is not None:
            self.clock.cancel(sc.timeout_timer)
        for call in sc.calls:
            if call is None:
                continue
            if call.hedge_timer is not None:
                self.clock.cancel(call.hedge_timer)
            for c in call.conns:
                c.forget(sc.rpc_id)

    def _shard_failed(self, sc: _Scatter, shard: int, detail: str,
                      kind: str = "internal") -> None:
        with sc.lock:
            if sc.done:
                return
            sc.done = True
        if kind == "internal":
            self._count("internal_errors")
        elif kind == "deadline_expired":
            self._count("deadline_expired")
        elif kind == "shard_unavailable":
            self._count("shard_unavailable")
        self._teardown_calls(sc)
        payload = {"error": kind, "detail": detail}
        if kind == "shard_unavailable":
            payload["shard"] = shard
        self._finish(sc, payload)

    def _leg_unanswerable(self, sc: _Scatter, shard: int,
                          call: _ShardCall, detail: str) -> None:
        """This shard's leg cannot be answered: replicas exhausted or
        breaker-rejected, attempt cap hit, or retry budget denied.
        Under partial_policy ``allow`` the scatter completes without
        it; under ``fail`` the whole request becomes a typed
        ``shard_unavailable`` error naming the shard."""
        if sc.policy != "allow":
            self._shard_failed(sc, shard, detail,
                               kind="shard_unavailable")
            return
        complete = False
        with sc.lock:
            if sc.done or call.done:
                return
            call.done = True
            sc.missing.append(shard)
            sc.remaining -= 1
            if sc.remaining == 0:
                sc.done = True
                complete = True
        if call.hedge_timer is not None:
            self.clock.cancel(call.hedge_timer)
        for c in call.conns:
            c.forget(sc.rpc_id)
        if complete:
            self._complete(sc)

    def _complete(self, sc: _Scatter) -> None:
        """Every leg settled (answered, or given up under ``allow``):
        cancel the timers, enforce the coverage floor, merge what
        arrived, and flag the answer when shards are missing."""
        for t in (sc.deadline_timer, sc.timeout_timer):
            if t is not None:
                self.clock.cancel(t)
        self._teardown_calls(sc)
        cov = self._coverage(sc.missing) if sc.missing else None
        if cov is not None and (
                cov["shards_answered"] == 0
                or cov["docs_fraction"] < sc.min_cov):
            self._count("shard_unavailable")
            payload = {
                "error": "shard_unavailable",
                "detail": (f"shards {cov['missing']} unanswerable; "
                           f"coverage {cov['docs_fraction']} below "
                           f"min_coverage {sc.min_cov}"
                           if cov["shards_answered"] else
                           "no shard answered"),
                "shard": cov["missing"][0],
                "coverage": cov,
            }
            self._finish(sc, payload)
            return
        try:
            out = self._merge(sc)
            if cov is not None:
                out["partial"] = True
                out["coverage"] = cov
                self._count("partial")
            elif sc.ckey is not None and sc.epoch is not None:
                # only full-coverage answers at the admission-time
                # epoch are cacheable: a partial answer depends on
                # which shards happened to be down, not on the epoch
                self._result_cache.fill(sc.ckey, sc.epoch, out)
            self._finish(sc, out)
        except Exception as e:
            log.exception("gather merge failed")
            self._count("internal_errors")
            self._finish(sc, {"error": "internal",
                              "detail": f"gather failed: {e}"})

    def _on_part(self, sc: _Scatter, shard: int, replica: int,
                 payload) -> None:
        call = sc.calls[shard]
        with sc.lock:
            if sc.done or call.done:
                return
        if payload is None or "error" in payload:
            kind = payload.get("error") if payload else None
            self._count("shard_errors")
            if payload is not None and kind in _RETRYABLE:
                # a refusing replica (overloaded / draining / stale)
                # is breaker pressure, not an invitation to hammer it
                client = self.shards[shard]
                if 0 <= replica < len(client.replicas):
                    client.replicas[replica].breaker.record_failure()
            if payload is not None and kind not in _RETRYABLE:
                detail = (f"shard {shard}: {kind}: "
                          f"{payload.get('detail', '')}")
                self._shard_failed(
                    sc, shard, detail,
                    kind="deadline_expired"
                    if kind == "deadline_expired" else "internal")
                return
            # connection death / refusing replica: another attempt for
            # this leg may still be in flight (a hedge) — only reissue
            # when this was the last one.  A typed shed spends retry
            # budget; a dead connection (payload None) fails over free
            with sc.lock:
                call.live = max(0, call.live - 1)
                retry = call.live == 0 and not (sc.done or call.done)
            if retry:
                self._issue(sc, shard, call,
                            charge_budget=payload is not None)
            return
        client = self.shards[shard]
        client.latency.record(time.monotonic() - call.t0)
        if 0 <= replica < len(client.replicas):
            client.replicas[replica].breaker.record_success()
        merged = None
        with sc.lock:
            if sc.done or call.done:
                return
            call.done = True
            sc.parts[shard] = payload
            sc.remaining -= 1
            if sc.remaining == 0:
                sc.done = True
                merged = True
        if replica == call.hedge_replica:
            self._count("hedge_wins")
        if call.hedge_timer is not None:
            self.clock.cancel(call.hedge_timer)
        for c in call.conns:
            c.forget(sc.rpc_id)
        if merged:
            self._complete(sc)

    def _merge(self, sc: _Scatter) -> dict:
        # a missing shard (partial_policy=allow) left its part None —
        # the merge over the remaining parts IS the monolith's answer
        # restricted to the covered shards (disjoint doc spaces,
        # global BM25 stats), which is the byte-parity contract the
        # chaos soak holds degraded answers to
        parts = [p for p in sc.parts if p is not None]
        if sc.op == "df":
            total = None
            for p in parts:
                row = p["df"]
                total = row if total is None else \
                    [a + b for a, b in zip(total, row)]
            out = {"ok": True, "df": total}
        elif sc.op == "postings":
            nterms = len(parts[0]["postings"])
            merged_posts = []
            for ti in range(nterms):
                cols = [p["postings"][ti] for p in parts
                        if p["postings"][ti] is not None]
                merged_posts.append(
                    merge_doc_ids(cols).tolist() if cols else None)
            out = {"ok": True, "postings": merged_posts}
        elif sc.op in ("and", "or"):
            out = {"ok": True,
                   "docs": merge_doc_ids(
                       [p["docs"] for p in parts]).tolist()}
        else:  # top_k score=bm25 (letter runs its own path)
            ranked = merge_ranked(
                [[(-s, d) for d, s in p["docs"]] for p in parts],
                sc.k)
            out = {"ok": True, "docs": [[d, s] for d, s in ranked]}
        if sc.explain:
            out["explain"] = {
                "router": {
                    "shards": len(self.shards),
                    "hedged_shards": sorted(set(sc.hedged)),
                    "failovers": sc.failovers,
                    "rpc_ms": {
                        str(i): round((time.monotonic()
                                       - sc.calls[i].t0) * 1e3, 3)
                        for i in range(len(sc.parts))
                        if sc.calls[i] is not None},
                },
                "per_shard": {str(i): p.get("explain")
                              for i, p in enumerate(sc.parts)
                              if p is not None},
            }
        return out

    def _finish(self, sc: _Scatter, payload: dict) -> None:
        if sc.rid is not None:
            payload["id"] = sc.rid
        if sc.tid is not None:
            payload.setdefault("trace_id", sc.tid)
        self._h_request.observe(time.monotonic() - sc.t_admit)
        with self._count_lock:
            self._inflight -= 1
        sc.conn.enqueue(payload)

    # -- letter top_k: threshold refinement over local tops -------------

    def _rpc_all_blocking(self, fields: dict,
                          timeout_s: float) -> list:
        """Scatter one op to every shard with per-shard failover,
        blocking until all answer (or raise).  Used by the refinement
        rounds and the metrics merge — rare, latency-tolerant ops."""
        rpc_id = pool_mod.next_rpc_id()
        line = (json.dumps({"id": rpc_id, **fields},
                           separators=(",", ":")) + "\n").encode()
        events = []
        results: list = [None] * len(self.shards)

        def _issue_one(shard: int, tried: set, ev: threading.Event):
            client = self.shards[shard]
            ri = client.pick(tuple(tried))
            if ri < 0:
                ev.set()
                return

            def _cb(payload, shard=shard, ri=ri, tried=tried, ev=ev):
                if payload is None or (isinstance(payload, dict)
                                       and payload.get("error")
                                       in _RETRYABLE):
                    self._count("shard_errors")
                    tried.add(ri)
                    if len(tried) < len(client.replicas):
                        self._count("failovers")
                        _issue_one(shard, tried, ev)
                    else:
                        ev.set()
                    return
                results[shard] = payload
                ev.set()

            tried.add(ri)
            try:
                client.conn(ri).send(rpc_id, line, _cb)
                self._count("scatter_rpcs")
            except pool_mod.ConnDead:
                self._count("shard_errors")
                if len(tried) < len(client.replicas):
                    self._count("failovers")
                    _issue_one(shard, tried, ev)
                else:
                    ev.set()

        for shard in range(len(self.shards)):
            ev = threading.Event()
            events.append(ev)
            _issue_one(shard, set(), ev)
        deadline = time.monotonic() + timeout_s
        for ev in events:
            ev.wait(max(0.0, deadline - time.monotonic()))
        return results

    def _letter_topk(self, conn, req: dict, tid,
                     policy: str = "fail",
                     min_cov: float = 1.0,
                     ckey=None, epoch=None) -> None:
        """Exact global letter top-k: rounds of (local k2-deep tops,
        exact global df sums) until the kth candidate provably beats
        every unseen term.  Termination is guaranteed — k2 doubles
        until every shard's letter range is exhausted.

        Under partial_policy ``allow`` a shard that stops answering
        mid-refinement is moved to the dead set and the refinement
        restricts itself to the survivors — the answer is then the
        restricted-corpus exact top-k, flagged with coverage."""
        k = int(req.get("k") or 0)
        letter = req["letter"]
        dl = req.get("deadline_ms")
        timeout_s = min(self.rpc_timeout_s,
                        dl / 1e3 if dl else self.rpc_timeout_s)
        t_admit = time.monotonic()
        dead: set = set()
        nd = len(self.shards)
        try:
            if k == 0:
                self._answer_letter(conn, req, tid, t_admit, [],
                                    dead, min_cov, ckey, epoch)
                return
            k2 = max(k, 4)
            while True:
                tops = self._rpc_all_blocking(
                    {"op": "top_k", "letter": letter, "k": k2},
                    timeout_s)
                miss = {i for i, t in enumerate(tops)
                        if t is None} | dead
                if miss and policy != "allow":
                    self._fail_letter(
                        conn, req, tid, t_admit,
                        f"shards {sorted(miss)} unanswerable",
                        kind="shard_unavailable", shard=min(miss))
                    return
                if len(miss) == nd:
                    self._fail_letter(
                        conn, req, tid, t_admit, "no shard answered",
                        kind="shard_unavailable",
                        shard=min(miss) if miss else 0)
                    return
                dead = miss
                live = [i for i in range(nd) if i not in dead]
                ltops = [tops[i] for i in live]
                exhausted = [len(t["top"]) < k2 for t in ltops]
                cands = sorted({term for t in ltops
                                for term, _df in t["top"]})
                if not cands:
                    self._answer_letter(conn, req, tid, t_admit, [],
                                        dead, min_cov)
                    return
                dfs = self._rpc_all_blocking(
                    {"op": "df", "terms": cands}, timeout_s)
                dmiss = {i for i in live if dfs[i] is None}
                if dmiss:
                    if policy != "allow":
                        self._fail_letter(
                            conn, req, tid, t_admit,
                            f"shards {sorted(dmiss)} unanswerable",
                            kind="shard_unavailable",
                            shard=min(dmiss))
                        return
                    dead |= dmiss
                    continue  # re-round over the shrunken live set
                gdf = [sum(dfs[i]["df"][j] for i in live)
                       for j in range(len(cands))]
                ranked = sorted(zip(cands, gdf),
                                key=lambda tg: (-tg[1], tg[0]))
                # an unseen term's global df is at most the sum of the
                # k2-th local dfs over shards that still have terms
                threshold = sum(t["top"][-1][1]
                                for t, ex in zip(ltops, exhausted)
                                if not ex and t["top"])
                if all(exhausted) or (
                        len(ranked) >= k
                        and ranked[k - 1][1] > threshold):
                    self._answer_letter(conn, req, tid, t_admit,
                                        ranked[:k], dead, min_cov,
                                        ckey, epoch)
                    return
                k2 *= 2
        except Exception as e:
            log.exception("letter top_k failed")
            self._fail_letter(conn, req, tid, t_admit, str(e))

    def _answer_letter(self, conn, req, tid, t_admit, ranked,
                       missing=(), min_cov: float = 0.0,
                       ckey=None, epoch=None) -> None:
        cov = self._coverage(sorted(missing)) if missing else None
        if cov is not None and cov["docs_fraction"] < min_cov:
            self._fail_letter(
                conn, req, tid, t_admit,
                f"shards {cov['missing']} unanswerable; coverage "
                f"{cov['docs_fraction']} below min_coverage {min_cov}",
                kind="shard_unavailable", shard=cov["missing"][0],
                coverage=cov)
            return
        payload = {"ok": True,
                   "top": [[term, int(df)] for term, df in ranked]}
        if cov is not None:
            payload["partial"] = True
            payload["coverage"] = cov
            self._count("partial")
        elif ckey is not None and epoch is not None:
            self._result_cache.fill(ckey, epoch, payload)
        rid = req.get("id")
        if rid is not None:
            payload["id"] = rid
        if tid is not None:
            payload["trace_id"] = tid
        self._h_request.observe(time.monotonic() - t_admit)
        with self._count_lock:
            self._inflight -= 1
        conn.enqueue(payload)

    def _fail_letter(self, conn, req, tid, t_admit, detail: str,
                     kind: str = "internal", shard: int | None = None,
                     coverage: dict | None = None) -> None:
        if kind == "shard_unavailable":
            self._count("shard_unavailable")
        else:
            self._count("internal_errors")
        self._h_request.observe(time.monotonic() - t_admit)
        with self._count_lock:
            self._inflight -= 1
        payload = {"error": kind, "detail": detail}
        if shard is not None:
            payload["shard"] = shard
        if coverage is not None:
            payload["coverage"] = coverage
        rid = req.get("id")
        if rid is not None:
            payload["id"] = rid
        if tid is not None:
            payload["trace_id"] = tid
        conn.enqueue(payload)

    # -- admin ----------------------------------------------------------

    def _handle_admin(self, conn, rid, op: str, req: dict) -> None:
        # read-only introspection, answered inline from published state
        if op not in _ROUTER_ADMIN:
            self._count("bad_request")
            payload = {"error": "bad_request",
                       "detail": f"op {op!r} is shard-local: send it "
                                 "to the shard primary, not the "
                                 "router"}
        elif op == "healthz":
            reasons = []
            if self._draining:
                reasons.append("draining")
            down = [s.shard for s in self.shards
                    if s.ready_count() == 0]
            if down:
                reasons.append("shard_unavailable")
            payload = {"ok": True, "live": True,
                       "ready": not reasons, "reasons": reasons,
                       "status": reasons[0] if reasons else "ok",
                       "queue_depth": 0,
                       "breakers_open": sum(s.breakers_open()
                                            for s in self.shards)}
            if down:
                payload["shards_down"] = down
        elif op == "slo":
            payload = {"ok": True, "slo": self._slo.report()}
        elif op == "stats":
            payload = {"ok": True, "stats": self.stats()}
        else:  # metrics
            payload = {"ok": True, "text": self.render_metrics()}
        if rid is not None:
            payload["id"] = rid
        tid = req.get("trace_id")
        if tid is not None:
            payload["trace_id"] = tid if isinstance(tid, str) \
                else str(tid)
        conn.enqueue(payload)

    def stats(self) -> dict:
        counters = {key: c.value for key, c in self._counts.items()}
        with self._count_lock:
            inflight = self._inflight
        with self._conn_lock:
            connections = len(self._conns)
        out = {
            "queue_depth": 0,
            "inflight": inflight,
            "draining": self._draining,
            "connections": connections,
            "counters": counters,
            "rolling": self._rolling_stats(),
            "slo": self._slo.report(),
            "result_cache": self._result_cache.stats(),
            "cluster": {
                "shards": [sc.describe() for sc in self.shards],
                "epoch": self._current_epoch(),
                "hedge_ms": self.hedge_ms,
                "rpc_timeout_ms": round(self.rpc_timeout_s * 1e3, 3),
                "partial_default": self.partial_spec,
                "retry_budget_ratio": self.retry_budget_ratio,
                "breakers_open": sum(s.breakers_open()
                                     for s in self.shards),
                "docs": {"per_shard": list(self._shard_docs),
                         "total": self._total_docs},
            },
            "config": {
                "max_inflight": self.max_inflight,
                "drain_s": self.drain_s,
            },
        }
        return out

    def _rolling_stats(self) -> dict:
        out = {}
        roll = self._rolling
        for label, span in obs_windows.WINDOWS:
            p50 = roll.quantile("mri_serve_request_seconds", span,
                                50.0)
            p99 = roll.quantile("mri_serve_request_seconds", span,
                                99.0)
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

    def render_metrics(self) -> str:
        """Router registry + every shard primary's scrape, merged with
        ``{shard=,replica=}`` labels injected so the families never
        collide — one exposition prices the whole fleet."""
        with self._count_lock:
            self._g_inflight.set(self._inflight)
        self._g_draining.set(1 if self._draining else 0)
        self._g_ready.set(sum(s.ready_count() for s in self.shards))
        state_code = {pool_mod.Breaker.CLOSED: 0,
                      pool_mod.Breaker.HALF_OPEN: 1,
                      pool_mod.Breaker.OPEN: 2}
        open_n = 0
        for s in self.shards:
            for r in s.replicas:
                st = r.breaker.state
                if st != pool_mod.Breaker.CLOSED:
                    open_n += 1
                self.registry.gauge(
                    f"mri_cluster_breaker_state_s{s.shard}_r{r.idx}"
                ).set(state_code[st])
        self._g_breakers.set(open_n)
        self._slo.set_gauges(self.registry)
        parts = [self.registry.render_text()]
        labels: list = [None]
        answers = self._rpc_all_blocking({"op": "metrics"}, 1.0)
        for shard, ans in enumerate(answers):
            if ans is None or "text" not in ans:
                continue
            with self.shards[shard]._lock:
                primary = self.shards[shard].primary
            parts.append(ans["text"])
            labels.append({"shard": str(shard),
                           "replica": str(primary)})
        parts.append(obs_metrics.default_registry().render_text())
        labels.append(None)
        return obs_metrics.merge_expositions(parts, labels=labels)
