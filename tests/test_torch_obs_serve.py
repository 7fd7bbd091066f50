"""The port's obs layers against the JAX package's, fed the same
observations: histogram quantiles, snapshots and exemplars;
``Registry.render_text`` and ``merge_expositions`` text; ``OpTimer``
stats; the rolling windows and the SLO burn math on one stepped
clock; the watchdog's stall episodes; the structured-log funnel (both
formats, the rate limit, the two packages' separate logger trees); the
trace ring and the flight recorder; the result cache; the daemon's
environment knobs (defaults and refusals).  Last, an exact module-name
check that no module of the port (nor ``chip_smoke.py``) imports JAX or
the JAX package."""

import ast
import io
import json
import logging
import random
from pathlib import Path

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    attribution as jattrib,
    logging as jlog,
    metrics as jmetrics,
    slo as jslo,
    timing as jtiming,
    tracing as jtracing,
    watchdog as jwatchdog,
    windows as jwindows,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    result_cache as jrc,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    envknobs as jknobs,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    attribution as tattrib,
    logging as tlog,
    metrics as tmetrics,
    slo as tslo,
    timing as ttiming,
    tracing as ttracing,
    watchdog as twatchdog,
    windows as twindows,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    result_cache as trc,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    envknobs as tknobs,
)

pytestmark = [pytest.mark.obs, pytest.mark.attrib]

ROOT = Path(__file__).resolve().parent.parent
PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
JAX_PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu"


def _samples(seed: int, n: int = 500) -> list[float]:
    rng = random.Random(seed)
    return [rng.lognormvariate(-7, 2) for _ in range(n)] + [0.0, 1e-9, 100.0]


@pytest.mark.parametrize("seed", range(4))
def test_histogram_matches_jax(seed):
    hj, ht = jmetrics.Histogram("h"), tmetrics.Histogram("h")
    for i, v in enumerate(_samples(seed)):
        ex = f"t{i}" if i % 7 == 0 else None
        hj.observe(v, exemplar=ex)
        ht.observe(v, exemplar=ex)
    assert ht.cumulative_counts() == hj.cumulative_counts()
    assert ht.bounds == hj.bounds and ht.count == hj.count and ht.sum == hj.sum
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert ht.quantile(p) == hj.quantile(p)
    assert ht.snapshot() == hj.snapshot() and ht.exact and hj.exact
    assert [e and e[:2] for e in ht.exemplars()] == [e and e[:2] for e in hj.exemplars()]


def _feed(mod, seed: int):
    reg = mod.Registry()
    rng = random.Random(seed)
    names = ["mri_serve_requests_total", "mri_serve_shed_total", "mri_engine_vocab_terms",
             "mri_custom_total", "mri_serve_request_seconds", "mri_engine_op_df_seconds"]
    for i in range(60):
        name = names[rng.randrange(len(names))]
        if name.endswith("_seconds"):
            reg.histogram(name).observe(rng.random() / 100, exemplar=f"id{i}")
        elif name.endswith("_total"):
            reg.counter(name).inc(rng.randrange(1, 5))
        else:
            reg.gauge(name).set(rng.random() * 1000)
    return reg


@pytest.mark.parametrize("exemplars", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_render_text_and_merge_match_jax(seed, exemplars, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)  # exemplar stamps
    rj, rt = _feed(jmetrics, seed), _feed(tmetrics, seed)
    tj, tt = rj.render_text(exemplars=exemplars), rt.render_text(exemplars=exemplars)
    assert tt == tj and "# TYPE mri_serve_request_seconds histogram" in tt
    assert rt.as_dict() == rj.as_dict()
    other = [_feed(m, seed + 10).render_text() for m in (jmetrics, tmetrics)]
    assert tmetrics.merge_expositions([tt, other[1]]) == jmetrics.merge_expositions([tj, other[0]])
    labels = [{"shard": "0"}, {"shard": "1", "replica": "0"}]
    assert tmetrics.merge_expositions([tt, other[1]], labels) == \
        jmetrics.merge_expositions([tj, other[0]], labels)


def test_known_metrics_and_optimer_match_jax():
    assert tmetrics.KNOWN_METRICS == jmetrics.KNOWN_METRICS
    oj, ot = jtiming.OpTimer(), ttiming.OpTimer()
    for v in _samples(9, 50):
        oj.histogram("df").observe(v)
        ot.histogram("df").observe(v)
    assert ot.stats() == oj.stats()


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _windows(mod, smod, seed):
    """A stepped run: per tick, counter and histogram feeds, then one
    sample; returns every window read and the SLO report."""
    metrics_mod = jmetrics if mod is jwindows else tmetrics
    reg = metrics_mod.Registry()
    clock = Clock()
    names = ["mri_serve_requests_total", "mri_serve_shed_total",
             "mri_serve_internal_errors_total", "mri_serve_draining_rejected_total",
             "mri_serve_deadline_expired_total"]
    win = mod.RollingWindows(reg, counters=names, histograms=("mri_serve_request_seconds",),
                             period_s=1.0, clock=clock)
    slo = smod.SLOTracker(win, slos=(smod.SLO("availability", 0.99),
                                     smod.SLO("latency", 0.99, threshold_ms=5.0)))
    rng = random.Random(seed)
    reads = []
    for tick in range(40):
        clock.t += 1.0
        for _ in range(rng.randrange(0, 30)):
            reg.counter(names[0]).inc()
            reg.histogram("mri_serve_request_seconds").observe(rng.lognormvariate(-6, 1.5))
        if rng.random() < 0.3:
            reg.counter(names[rng.randrange(1, 5)]).inc(rng.randrange(1, 4))
        if tick == 20:
            win.track(counters=("mri_serve_tenant_a_requests_total",))
        win.sample()
        for span in (10.0, 60.0, 300.0):
            reads.append((win.counts(span), win.rate(names[0], span),
                          win.quantile("mri_serve_request_seconds", span, 95.0),
                          win.good_fraction("mri_serve_request_seconds", span, 0.004),
                          win.hist_count("mri_serve_request_seconds", span)))
    slo.set_gauges(reg)
    return reads, slo.report(), reg.render_text()


@pytest.mark.parametrize("seed", range(3))
def test_rolling_windows_and_slo_match_jax(seed):
    assert twindows.WINDOWS == jwindows.WINDOWS
    assert _windows(twindows, tslo, seed) == _windows(jwindows, jslo, seed)


def test_default_slos_read_the_knobs(monkeypatch):
    monkeypatch.setenv("MRI_OBS_SLO_TARGET", "0.95")
    monkeypatch.setenv("MRI_OBS_SLO_LATENCY_MS", "12.5")
    assert [(s.name, s.target, s.threshold_ms) for s in tslo.default_slos()] == \
        [(s.name, s.target, s.threshold_ms) for s in jslo.default_slos()]


def _watch(mod, metrics_mod):
    clock = Clock()
    reg = metrics_mod.Registry()
    events = []
    w = mod.Watchdog(100.0, on_stall=lambda n, a: events.append(("stall", n, round(a, 3))),
                     on_recover=lambda n: events.append(("recover", n)), registry=reg,
                     clock=clock)
    w.register("dispatcher")
    w.register("accept")
    seen = []
    for step in range(12):
        clock.t += 0.06
        if step % 5 != 4:
            w.beat("accept")
        if step in (0, 1, 8, 9, 10, 11):
            w.beat("dispatcher")
        seen.append((w.check(), round(w.max_age_s(), 6)))
    return seen, events, reg.counter(mod.STALLS_TOTAL).value, w.enabled


def test_watchdog_matches_jax():
    got = _watch(twatchdog, tmetrics)
    assert got == _watch(jwatchdog, jmetrics)
    assert got[2] > 0 and any(s for s, _ in got[0])
    assert not twatchdog.Watchdog(0.0).enabled


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_logging_funnel_matches_jax(fmt, monkeypatch):
    import time

    monkeypatch.setenv("MRI_OBS_LOG_FORMAT", fmt)
    monkeypatch.setenv("MRI_OBS_LOG_RATE_LIMIT", "3")
    # the limiter counts per whole second of the monotonic clock: one
    # fixed second, a second no other test of this file uses
    monkeypatch.setattr(time, "monotonic", lambda: 7000.5 + (fmt == "json"))
    out = {}
    try:
        for name, mod, metrics_mod in (("jax", jlog, jmetrics), ("port", tlog, tmetrics)):
            stream = io.StringIO()
            mod.configure(stream)
            dropped = metrics_mod.default_registry().counter("mri_obs_log_dropped_total")
            d0 = dropped.value
            logger = logging.getLogger(mod.ROOT_LOGGER + ".obs")
            for i in range(5):
                mod.emit(logger, "slow_query", level=logging.WARNING, n=i, when=object)
            mod.emit(logger, "other", k="v")
            lines = stream.getvalue().splitlines()
            out[name] = (lines, dropped.value - d0)
    finally:
        jlog.reset()
        tlog.reset()
    (jl, jd), (tl, td) = out["jax"], out["port"]
    assert td == jd == 2 and len(tl) == len(jl) == 4
    if fmt == "json":
        strip = [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in tl]
        want = [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in jl]
        assert [dict(r, logger=r["logger"].replace("mri_torch", "mri_tpu")) for r in strip] == want
    else:
        assert [x.replace("mri_torch", "mri_tpu") for x in tl] == jl
    assert tlog.ROOT_LOGGER == "mri_torch"


def test_logging_trees_stay_apart():
    """Configuring the port's tree leaves the JAX package's loggers
    alone (and the reverse)."""
    try:
        tlog.configure(io.StringIO())
        assert not any(getattr(h, "_mri_obs_handler", False)
                       for h in logging.getLogger("mri_tpu").handlers)
        assert logging.getLogger("mri_tpu").propagate
        assert not logging.getLogger("mri_torch").propagate
    finally:
        tlog.reset()
    assert logging.getLogger("mri_torch").propagate


def test_trace_ring_and_slow_log(caplog, monkeypatch):
    monkeypatch.setenv("MRI_OBS_TRACE_RING", "3")
    monkeypatch.setenv("MRI_OBS_SLOW_MS", "2.5")
    assert ttracing.slow_ms() == jtracing.slow_ms() == 2.5 and ttracing.enabled()
    rj, rt = jtracing.TraceRing(), ttracing.TraceRing()
    for i in range(5):
        rj.push({"i": i})
        rt.push({"i": i})
    assert rt.snapshot() == rj.snapshot() == [{"i": 4}, {"i": 3}, {"i": 2}]
    assert rt.snapshot(2) == rj.snapshot(2) and len(rt) == 3
    tid = ttracing.gen_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0
    with caplog.at_level(logging.WARNING, logger="mri_torch.obs"):
        ttracing.emit_slow({"trace_id": tid, "dur_ms": 9.0})
    rec = [r for r in caplog.records if r.name == "mri_torch.obs"]
    assert json.loads(rec[-1].getMessage()) == {"event": "slow_query", "trace_id": tid,
                                                "dur_ms": 9.0}


def test_flight_recorder_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_OBS_FLIGHT_RING", "4")
    monkeypatch.setenv("MRI_OBS_EXEMPLARS", "0")
    assert tattrib.flight_ring_capacity() == jattrib.flight_ring_capacity() == 4
    assert tattrib.exemplars_enabled() is jattrib.exemplars_enabled() is False
    fj, ft = jattrib.FlightRecorder(slow_threshold_ms=5.0), tattrib.FlightRecorder(
        slow_threshold_ms=5.0)
    for i in range(7):
        trace = {"id": i, "dur_ms": float(i * 2)}
        fj.record(trace, {"op": "df"} if i % 2 else None)
        ft.record(trace, {"op": "df"} if i % 2 else None)
    dj, dt = fj.dump("admin"), ft.dump("admin")
    for d in (dj, dt):
        d.pop("ts")
    assert dt == dj and len(ft) == 4
    path = ft.dump_to_file(str(tmp_path), "sig quit")
    assert Path(path).name.endswith("-sig-quit.json")
    assert json.loads(Path(path).read_text())["requests"] == dt["requests"]
    assert tattrib.FlightRecorder(capacity=0).dump_to_file(str(tmp_path), "x") is None


def test_result_cache_matches_jax():
    cases = [("df", ["b", "a", "a"], None, 0, "df"), ("and", ["b", "a", "a"], None, 0, "df"),
             ("top_k", ["b", "a", "a"], None, 5, "bm25"), ("top_k", None, "q", 3, "df"),
             ("postings", [], None, 0, ""), ("stats", ["a"], None, 0, ""),
             ("df", None, "q", 0, "")]
    for c in cases:
        if c[0] == "top_k" and c[1]:
            # ranked: the port keeps the term order (BM25 sums in it);
            # the JAX key sorts the terms (ROADMAP §C)
            assert trc.key_for(*c) == ("top_k", ("b", "a", "a"), 5, "bm25")
            assert jrc.key_for(*c) == ("top_k", ("a", "a", "b"), 5, "bm25")
            continue
        assert trc.key_for(*c) == jrc.key_for(*c)
    out = []
    for metrics_mod, mod in ((jmetrics, jrc), (tmetrics, trc)):
        reg = metrics_mod.Registry()
        cache = mod.ResultCache(registry=reg, enabled=True, entries=3, max_bytes=60)
        log = []
        for i in range(8):
            key = mod.key_for("df", [f"w{i % 4}"], None, 0, "df")
            hit = cache.lookup(key, 0)
            log.append(hit)
            if hit is None:
                cache.fill(key, 0, {"ok": True, "df": [i] * (i % 3 + 1)})
            if i == 5:
                cache.on_epoch(1)
        cache.purge()
        out.append((log, cache.stats(), reg.render_text()))
    assert out[1] == out[0]


#: every knob the daemon and the obs layers read, and a value each
#: package refuses
DAEMON_KNOBS = {
    "MRI_SERVE_COALESCE_US": "-1", "MRI_SERVE_QUEUE_DEPTH": "0", "MRI_SERVE_MAX_BATCH": "x",
    "MRI_SERVE_DRAIN_S": "0", "MRI_SERVE_CODEL_TARGET_MS": "-2",
    "MRI_SERVE_CODEL_INTERVAL_MS": "0.5", "MRI_SERVE_RESULT_CACHE": "2",
    "MRI_SERVE_RESULT_CACHE_ENTRIES": "0", "MRI_SERVE_RESULT_CACHE_BYTES": "-1",
    "MRI_SERVE_TENANT_WEIGHTS": None, "MRI_SERVE_TENANT_RATE": None,
    "MRI_SERVE_TENANT_MAX": "0", "MRI_SERVE_GC_FREEZE": "3",
    "MRI_SERVE_TENANT_QUEUE_DEPTH": "-1",
    "MRI_OBS_ENABLE": "2", "MRI_OBS_TRACE_RING": "0", "MRI_OBS_SLOW_MS": "fast",
    "MRI_OBS_FLIGHT_RING": "-1", "MRI_OBS_EXEMPLARS": "yes", "MRI_OBS_SAMPLE_MS": "5",
    "MRI_OBS_SLO_LATENCY_MS": "0", "MRI_OBS_SLO_TARGET": "-0.1", "MRI_OBS_STALL_MS": "-1",
    "MRI_OBS_OVERLOAD_SHED_RATE": "-1", "MRI_OBS_LOG_FORMAT": "xml",
    "MRI_OBS_LOG_RATE_LIMIT": "-1", "MRI_SERVE_SHARDS": "two",
}


@pytest.mark.parametrize("name", sorted(DAEMON_KNOBS))
def test_daemon_knobs_match_jax(name, monkeypatch):
    monkeypatch.delenv(name, raising=False)
    assert tknobs.get(name) == jknobs.get(name)
    bad = DAEMON_KNOBS[name]
    if bad is None:  # free-form strings, parsed by the daemon
        return
    monkeypatch.setenv(name, bad)
    with pytest.raises(ValueError) as te:
        tknobs.get(name)
    with pytest.raises(ValueError) as je:
        jknobs.get(name)
    assert str(te.value) == str(je.value) and name in str(te.value)


def _imports(path: Path) -> set[str]:
    """Every module name a file imports (absolute names only; a relative
    import inside the port stays inside it)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == JAX_PKG


PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / PORT).rglob("*.py")) + [
    "chip_smoke.py"]


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_nothing_of_jax(rel):
    bad = sorted(n for n in _imports(ROOT / rel) if _forbidden(n))
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_match_is_by_whole_name():
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".serve") and _forbidden("jax.numpy")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".serve") and not _forbidden("jaxtyping")
