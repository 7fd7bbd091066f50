"""The port's cluster router under faults and brownouts, the twins of the
JAX suite's failure envelope (``tests/test_cluster.py``) and brownout
cases (``tests/test_brownout.py``), on the CPU.

* degradation primitives — ``parse_partial_policy``, the per-replica
  ``Breaker`` (rolling window, cooldown, one half-open probe,
  probe-gated recovery) and the ``RetryBudget`` token bucket under fake
  clocks, each also driven side by side with the JAX one on a seeded
  event sequence (same states, same answers);
* failure envelope — an injected ``shard-dead`` fails over (counted), a
  replica killed mid-burst loses no acknowledged query, hedges fire on a
  slowed shard, a ``router-conn-reset`` tears one client only, a
  deadline expires typed and the router drains;
* brownout — a blacked-out shard is a typed ``shard_unavailable`` naming
  it at every data op under ``fail``; under ``allow`` every answer is
  ``partial`` with coverage and equals ``ShardRestrictedOracle`` over
  the live shards (BM25 floats included) at D in {2, 4}; the
  ``min_coverage`` floor, a bad policy, the environment's default;
  retries stay bounded when every replica refuses; breakers open under a
  blackout and close again through the health prober.
"""

import random
import time

import pytest

from test_torch_cluster import (
    DOCS,
    Client,
    build_mono,
    cluster_up,
    write_list,
)

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cluster import (
    pool as jpool,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cluster.router import (
    parse_partial_policy as jparse_policy,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    faults as tfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster import (
    hedge as hedge_mod,
    partition as tpart,
    pool as pool_mod,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cluster.router import (
    parse_partial_policy,
    parse_shard_arg,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    Engine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.multi_engine import (
    ShardRestrictedOracle,
)

pytestmark = [pytest.mark.cluster, pytest.mark.serve, pytest.mark.faults]

daemonized = pytest.mark.daemon


@pytest.fixture(autouse=True)
def _disarm():
    tfaults.install(None)
    yield
    tfaults.install(None)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The corpus's monolith, its terms, and the port's cluster
    directories at D in {2, 4}."""
    root = tmp_path_factory.mktemp("tcluster_faults")
    src = write_list(root, DOCS)
    dirs = {}
    for d in (2, 4):
        tpart.partition(src, d, root / f"d{d}")
        dirs[d] = root / f"d{d}"
    words = sorted({w.decode() for doc in DOCS for w in doc.split()})
    return build_mono(root, src), words, dirs


def _wait_docs_learned(router, deadline_s: float = 5.0) -> None:
    """Block until the router has each shard's doc count (so coverage
    reports a docs_fraction, not a shard count)."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        docs = router.stats()["cluster"]["docs"]
        if docs["total"] and all(d is not None for d in docs["per_shard"]):
            return
        time.sleep(0.02)
    raise AssertionError("router never learned per-shard doc counts")


def _ranked(pairs):
    return [[d, s] for d, s in pairs]


# -- grammar and the degradation primitives ----------------------------------


def test_parse_arguments_match_jax():
    assert parse_shard_arg("a:1|b:2,c:3") == [[("a", 1), ("b", 2)], [("c", 3)]]
    for bad in ("", "h:0", "h", "h:1|,h:2", "h:99999"):
        with pytest.raises(ValueError):
            parse_shard_arg(bad)
    for spec in ("fail", "allow", "allow:min_coverage=0.5", " allow:min_coverage=1 "):
        assert parse_partial_policy(spec) == jparse_policy(spec)
    for bad in ("", "maybe", "allow:min_coverage=nope", "allow:min_coverage=1.5",
                "allow:max_coverage=0.5", 3, None, ["allow"]):
        with pytest.raises(ValueError) as te:
            parse_partial_policy(bad)
        with pytest.raises(ValueError) as je:
            jparse_policy(bad)
        assert str(te.value) == str(je.value)
    assert hedge_mod.hedge_delay_s(0, 0.5) is None
    assert hedge_mod.hedge_delay_s(25.0, None) == 0.025
    assert hedge_mod.hedge_delay_s(-1.0, None) is None
    assert hedge_mod.hedge_delay_s(-1.0, 0.010) == 0.010
    assert hedge_mod.hedge_delay_s(-1.0, 1e-9) == hedge_mod.MIN_HEDGE_S


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_breaker_state_machine():
    clk = FakeClock()
    b = pool_mod.Breaker(threshold=5, cooldown_s=1.0, clock=clk)
    for _ in range(4):
        b.record_failure()
    assert b.state == b.CLOSED and b.allow()
    b.record_failure()
    assert b.state == b.OPEN and not b.allow()
    # more failures than successes are needed
    b = pool_mod.Breaker(threshold=5, cooldown_s=1.0, clock=clk)
    for _ in range(6):
        b.record_success()
    for _ in range(6):
        b.record_failure()
    assert b.state == b.CLOSED
    b.record_failure()
    assert b.state == b.OPEN
    # old evidence ages out of the window
    b = pool_mod.Breaker(threshold=3, cooldown_s=1.0, clock=clk)
    b.record_failure()
    b.record_failure()
    clk.t += pool_mod.Breaker.WINDOW_S + 1
    b.record_failure()
    assert b.state == b.CLOSED
    # one half-open probe after the cooldown; it re-opens or closes
    b = pool_mod.Breaker(threshold=2, cooldown_s=1.0, clock=clk)
    b.record_failure()
    b.record_failure()
    clk.t += 1.5
    assert b.allow() and b.state == b.HALF_OPEN and not b.allow()
    b.record_failure()
    assert b.state == b.OPEN and not b.allow()
    clk.t += 1.5
    assert b.allow()
    b.record_success()
    assert b.state == b.CLOSED and b.allow()
    b.record_failure()  # recovery reset the window
    assert b.state == b.CLOSED
    # a ready healthz verdict closes it
    b.record_failure()
    b.record_failure()
    assert b.state == b.OPEN
    b.note_ready()
    assert b.state == b.CLOSED and b.allow()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_breaker_and_budget_follow_jax_on_seeded_events(seed):
    """A seeded stream of successes, failures, picks, health verdicts
    and clock steps through the port's and the JAX ``Breaker`` and
    ``RetryBudget`` side by side: the same states and answers."""
    rng = random.Random(seed)
    tclk, jclk = FakeClock(), FakeClock()
    tb = pool_mod.Breaker(threshold=3, cooldown_s=0.5, clock=tclk)
    jb = jpool.Breaker(threshold=3, cooldown_s=0.5, clock=jclk)
    tr, jr = pool_mod.RetryBudget(0.25, cap=4.0), jpool.RetryBudget(0.25, cap=4.0)
    for _ in range(400):
        ev = rng.choice(("ok", "err", "err", "allow", "ready", "tick", "deposit", "spend"))
        if ev == "ok":
            tb.record_success(), jb.record_success()
        elif ev == "err":
            tb.record_failure(), jb.record_failure()
        elif ev == "allow":
            assert tb.allow() == jb.allow()
        elif ev == "ready":
            tb.note_ready(), jb.note_ready()
        elif ev == "tick":
            step = rng.choice((0.1, 0.3, 0.7, 2.0, 11.0))
            tclk.t += step
            jclk.t += step
        elif ev == "deposit":
            tr.deposit(), jr.deposit()
        else:
            assert tr.try_spend() == jr.try_spend()
        assert tb.state == jb.state
        assert (tr.tokens(), tr.denied) == (jr.tokens(), jr.denied)


def test_retry_budget_token_bucket():
    bud = pool_mod.RetryBudget(0.25, cap=8.0)
    assert bud.tokens() == 2.0
    assert bud.try_spend() and bud.try_spend() and not bud.try_spend()
    assert bud.denied == 1
    for _ in range(4):
        bud.deposit()
    assert bud.try_spend() and not bud.try_spend()
    for _ in range(100):
        bud.deposit()
    assert bud.tokens() == 8.0
    off = pool_mod.RetryBudget(0.0)
    off.deposit()
    assert off.tokens() == 0.0 and not off.try_spend()


def test_clock_fires_in_order_and_cancels():
    clock = hedge_mod.Clock(name="mri-test-clock")
    fired = []
    try:
        clock.schedule(0.03, lambda: fired.append("late"))
        tok = clock.schedule(0.01, lambda: fired.append("cancelled"))
        clock.schedule(0.0, lambda: fired.append("now"))
        clock.schedule(0.0, lambda: 1 / 0)  # a raising callback is logged, not fatal
        clock.cancel(tok)
        deadline = time.monotonic() + 5
        while len(fired) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        clock.stop()
    assert fired == ["now", "late"]


# -- failure envelope ---------------------------------------------------------


@daemonized
def test_injected_shard_dead_fails_over(built):
    mono, words, dirs = built
    with cluster_up(dirs[2], 2, replicas=2) as (router, _):
        tfaults.install("shard-dead:shard=0")
        with Client(router) as c:
            r = c.rpc(id=1, op="df", terms=words[:3])
        with Engine(mono) as eng:
            assert r["ok"] and r["df"] == eng.df(eng.encode_batch(words[:3])).tolist()
        st = router.stats()["counters"]
        assert st["failovers"] >= 1 and st["shard_errors"] >= 1


@daemonized
def test_replica_kill_loses_no_acked_queries(built):
    """Shard 0's primary stops listening and drops its connections mid
    burst: each of the 200 pipelined queries gets one answer, all ok and
    all equal to the monolith's."""
    mono, words, dirs = built
    terms = words[:2]
    with Engine(mono) as eng:
        want = _ranked(eng.top_k_scored(eng.encode_batch(terms), 5))
    with cluster_up(dirs[2], 2, replicas=2) as (router, daemons):
        victim = daemons[0]
        got = []
        with Client(router) as c:
            n = 200
            for i in range(n):
                c.send(id=i, op="top_k", terms=terms, k=5, score="bm25")
                if i == 20:
                    victim._listener.close()
                    with victim._conn_lock:
                        conns = list(victim._conns)
                    for conn in conns:
                        conn.kill()
                if i % 50 == 49:
                    got.extend(c.recv() for _ in range(50))
        assert sorted(r["id"] for r in got) == list(range(n))
        assert [r for r in got if not r.get("ok")] == []
        assert all(r["docs"] == want for r in got)


@daemonized
def test_hedges_fire_on_slowed_shard(built):
    mono, words, dirs = built
    with Engine(mono) as eng:
        want = eng.df(eng.encode_batch(words[:2])).tolist()
    with cluster_up(dirs[2], 2, replicas=2, hedge_ms=5.0) as (router, _):
        tfaults.install("shard-slow:shard=0:ms=40:times=3")
        with Client(router) as c:
            for i in range(3):
                r = c.rpc(id=i, op="df", terms=words[:2])
                assert r["ok"] and r["df"] == want
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            st = router.stats()["counters"]
            if st["hedges"] >= 1:
                break
            time.sleep(0.01)
        assert st["hedges"] >= 1


@daemonized
def test_router_conn_reset_tears_one_client_only(built):
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        tfaults.install("router-conn-reset:req=2")
        with Client(router) as c:
            assert c.rpc(id=1, op="df", terms=words[:1])["ok"]
            c.send(id=2, op="df", terms=words[:1])
            assert c.f.readline() == b""
        with Client(router) as c2:
            assert c2.rpc(id=3, op="df", terms=words[:1])["ok"]
        assert router.stats()["counters"]["client_disconnects"] >= 1


@daemonized
def test_router_deadline_and_drain(built):
    """A client deadline shorter than a slowed shard: typed
    ``deadline_expired``; the drained router keeps its counters and its
    port refuses new clients."""
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        addr = router.address
        tfaults.install("shard-slow:shard=0:ms=300")
        with Client(router) as c:
            r = c.rpc(id=1, op="top_k", terms=words[:1], k=3, score="bm25", deadline_ms=30)
            assert r["error"] == "deadline_expired"
    assert router.final_stats["counters"]["deadline_expired"] >= 1
    with pytest.raises(OSError):
        Client(addr, timeout=2.0)


# -- brownout: blackout x policy x op -------------------------------------------


def _ops(words):
    return [dict(op="df", terms=words), dict(op="postings", terms=words),
            dict(op="and", terms=words), dict(op="or", terms=words),
            dict(op="top_k", terms=words, k=7, score="bm25"),
            dict(op="top_k", letter="c", k=4)]


@daemonized
def test_blackout_fail_policy_types_every_op(built):
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        _wait_docs_learned(router)
        tfaults.install("shard-blackout:shard=0")
        with Client(router) as c:
            for i, req in enumerate(_ops(words[:2])):
                r = c.rpc(id=i, **req)
                assert r["error"] == "shard_unavailable" and r["shard"] == 0, r
        st = router.stats()
        assert st["counters"]["shard_unavailable"] >= 6
        assert st["counters"]["partial"] == 0


def _oracle_answer(eng, oracle, req):
    if req.get("letter") is not None:
        return [[t.decode("ascii"), int(df)] for t, df in oracle.top_k(req["letter"], req["k"])]
    batch = eng.encode_batch(req["terms"])
    op = req["op"]
    if op == "df":
        return oracle.df(batch).tolist()
    if op == "postings":
        return [None if p is None else p.tolist() for p in oracle.postings(batch)]
    if op == "and":
        return oracle.query_and(batch).tolist()
    if op == "or":
        return oracle.query_or(batch).tolist()
    return _ranked(oracle.top_k_scored(batch, req["k"]))


@daemonized
@pytest.mark.parametrize("d", [2, 4])
def test_blackout_allow_policy_partial_parity(built, d):
    """One shard blacked out under ``allow``: every op's answer is
    ``partial``, its coverage names the shard with the live docs'
    fraction, and it equals ``ShardRestrictedOracle`` over the live
    shards — BM25 floats exact — on a seeded fuzz."""
    mono, words, dirs = built
    rng = random.Random(500 + d)
    dead = rng.randrange(d)
    with Engine(mono) as eng, cluster_up(dirs[d], d) as (router, _):
        oracle = ShardRestrictedOracle.round_robin(eng, d, covered=set(range(d)) - {dead})
        _wait_docs_learned(router)
        tfaults.install(f"shard-blackout:shard={dead}")
        with Client(router) as c:
            for i in range(8):
                for req in _ops(rng.sample(words, rng.randint(1, 4))):
                    r = c.rpc(id=i, partial_policy="allow", **req)
                    assert r["ok"] and r["partial"] is True, r
                    assert r["coverage"] == {
                        "shards_answered": d - 1, "shards_total": d, "missing": [dead],
                        "docs_fraction": round(1 - (len(range(dead + 1, len(DOCS) + 1, d))
                                                    / len(DOCS)), 6)}
                    key = "top" if req.get("letter") else next(
                        k for k in ("df", "postings", "docs") if k in r)
                    assert r[key] == _oracle_answer(eng, oracle, req), req
        st = router.stats()
        assert st["counters"]["partial"] >= 48 and st["counters"]["shard_unavailable"] == 0


@daemonized
def test_min_coverage_bad_policy_and_env_default(built, monkeypatch):
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        _wait_docs_learned(router)
        tfaults.install("shard-blackout:shard=0")
        with Client(router) as c:
            r = c.rpc(id=1, op="df", terms=words[:1], partial_policy="allow:min_coverage=0.9")
            assert r["error"] == "shard_unavailable" and r["shard"] == 0
            assert r["coverage"]["docs_fraction"] == 0.5
            r = c.rpc(id=2, op="df", terms=words[:1], partial_policy="allow:min_coverage=0.5")
            assert r["ok"] and r["partial"] is True
            r = c.rpc(id=3, op="df", terms=words[:1], partial_policy="sometimes")
            assert r["error"] == "bad_request" and "partial_policy" in r["detail"]
    monkeypatch.setenv("MRI_CLUSTER_PARTIAL", "allow")
    tfaults.install(None)
    with cluster_up(dirs[2], 2) as (router, _):
        assert router.partial_default == ("allow", 0.0)
        _wait_docs_learned(router)
        tfaults.install("shard-blackout:shard=1")
        with Client(router) as c:
            r = c.rpc(id=1, op="df", terms=words[:1])
            assert r["ok"] and r["partial"] is True and r["coverage"]["missing"] == [1]


@daemonized
def test_retries_bounded_when_every_replica_refuses(built):
    _, words, dirs = built
    with cluster_up(dirs[2], 2, replicas=2) as (router, _):
        base = router.stats()["counters"]["scatter_rpcs"]
        tfaults.install("overload-storm:req=1:times=-1")
        with Client(router) as c:
            t0 = time.monotonic()
            r = c.rpc(id=1, op="df", terms=words[:1])
            elapsed = time.monotonic() - t0
        assert r["error"] == "shard_unavailable" and elapsed < 5.0
        st = router.stats()["counters"]
        assert st["scatter_rpcs"] - base <= 2 * 6 + 4
        assert st["retry_denied"] >= 1


@daemonized
def test_breaker_opens_under_blackout_and_recovers(built):
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        _wait_docs_learned(router)
        tfaults.install("shard-blackout:shard=0")
        with Client(router) as c:
            for i in range(12):
                assert c.rpc(id=i, op="df", terms=words[:1], partial_policy="allow")["ok"]
            deadline = time.monotonic() + 5.0
            opened = 0
            while time.monotonic() < deadline:
                opened = router.stats()["cluster"]["breakers_open"]
                if opened:
                    break
                c.rpc(id=99, op="df", terms=words[:1], partial_policy="allow")
            assert opened >= 1
            assert c.rpc(id=100, op="healthz")["breakers_open"] >= 1
            text = c.rpc(id=101, op="metrics")["text"]
            assert "mri_cluster_breakers_open 1" in text
            assert "mri_cluster_breaker_state_s0_r0 " in text
            tfaults.install(None)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if router.stats()["cluster"]["breakers_open"] == 0:
                    break
                time.sleep(0.05)
            assert router.stats()["cluster"]["breakers_open"] == 0
            r = c.rpc(id=102, op="df", terms=words[:1])
            assert r["ok"] and "partial" not in r


@daemonized
def test_overload_storm_feeds_router_breakers(built):
    _, words, dirs = built
    with cluster_up(dirs[2], 2) as (router, _):
        _wait_docs_learned(router)
        tfaults.install("overload-storm:req=1:times=-1")
        with Client(router) as c:
            r = c.rpc(id=1, op="df", terms=words[:1], partial_policy="allow")
            assert r["error"] == "shard_unavailable"
        st = router.stats()["counters"]
        assert st["shard_errors"] >= 2 and st["retry_denied"] >= 1
