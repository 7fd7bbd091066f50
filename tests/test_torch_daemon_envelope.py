"""The port daemon's robustness envelope against the JAX daemon's: each
case drives one JAX daemon (host engine) and one port daemon (the
``DeviceEngine`` on the CPU) through the same requests under the same
fault spec — each package's injector armed on its own — and compares
the answer kinds and the daemons' counters, which must be equal:
admission shedding (``overloaded``), ``deadline_expired``, a drain with
stragglers (``draining``), hot reload ok and rejected
(``reload-corrupt``), ``handler-crash``, ``client-disconnect``,
``slow-client``, and a ``dispatcher-hang`` that flips healthz readiness
to ``stalled`` and back."""

import threading
import time

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve.daemon import (
    ServeDaemon as JDaemon,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import (
    faults as tfaults,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve.daemon import (
    ServeDaemon as TDaemon,
)

from test_torch_daemon import Client, built, serving  # noqa: F401  (the module fixture)

pytestmark = [pytest.mark.daemon, pytest.mark.faults, pytest.mark.qos, pytest.mark.serve]

#: (daemon class, its package's injector, constructor arguments)
SIDES = {"jax": (JDaemon, jfaults, {"engine": "host"}),
         "port": (TDaemon, tfaults, {"engine": "device", "device": "cpu"})}


@pytest.fixture(autouse=True)
def _disarm():
    jfaults.install(None)
    tfaults.install(None)
    yield
    jfaults.install(None)
    tfaults.install(None)


def wait_for(cond, timeout=10.0):
    """Poll ``cond`` until true (a counter or a flag, never a sleep)."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def park_dispatcher(d):
    d._dispatch_stop.set()
    d._dispatcher.join(timeout=5.0)


def resume_dispatcher(d):
    d._dispatch_stop.clear()
    d._dispatcher = threading.Thread(target=d._dispatch_loop, name="mri-serve-dispatch",
                                     daemon=True)
    d._dispatcher.start()


def case_overloaded(d, c):
    park_dispatcher(d)
    for i in range(10):
        c.send(id=i, op="df", terms=["cat"])
    wait_for(lambda: d.stats()["counters"]["requests"] == 10)
    resume_dispatcher(d)
    return [c.recv() for _ in range(10)]


def case_deadline(d, c):
    with d._engine_lock:  # stall execution past the deadline
        c.send(id=1, op="df", terms=["cat"], deadline_ms=1)
        wait_for(lambda: d.stats()["counters"]["requests"] == 1)
        time.sleep(0.01)
    return [c.recv(), c.rpc(id=2, op="df", terms=["cat"])]


def case_drain(d, c):
    park_dispatcher(d)
    for i in range(6):
        c.send(id=i, op="df", terms=["dog"])
    wait_for(lambda: d.stats()["counters"]["requests"] == 6)
    assert d.drain() == 0
    return [c.recv() for _ in range(6)]


def case_reload(d, c, inj):
    got = [c.rpc(id=1, op="reload")]
    inj.install("reload-corrupt")
    got += [c.rpc(id=2, op="reload"), c.rpc(id=3, op="df", terms=["cat"]),
            c.rpc(id=4, op="reload")]
    return got


def case_handler_crash(d, c, inj):
    inj.install("handler-crash:req=2")
    return [c.rpc(id=i, op="df", terms=["cat"]) for i in (1, 2, 3)]


def case_client_disconnect(d, c, inj):
    inj.install("client-disconnect:req=1")
    victim = Client(d)
    try:
        victim.send(id=1, op="df", terms=["cat"])
        try:
            line = victim.f.readline()
        except OSError:
            line = b""
        assert line == b""
    finally:
        victim.close()
    wait_for(lambda: d.stats()["counters"]["client_disconnects"] == 1)
    return [c.rpc(id=2, op="df", terms=["cat"])]


def case_slow_client(d, c, inj):
    inj.install("slow-client:req=1:ms=150")
    with Client(d) as slow:  # a writer reads the injector as it starts
        t0 = time.monotonic()
        got = slow.rpc(id=1, op="df", terms=["dog"])
        assert time.monotonic() - t0 >= 0.12  # the injected stall happened
    return [got]


def case_dispatcher_hang(d, c, inj):
    inj.install("dispatcher-hang:ms=1200")
    c.send(id=1, op="df", terms=["cat"])
    with Client(d) as probe:
        # healthz answers from the reader thread while the dispatcher
        # is wedged: readiness flips to stalled, liveness stays
        wait_for(lambda: "stalled" in probe.rpc(op="healthz")["reasons"])
        h = probe.rpc(op="healthz")
        answer = c.recv()
        wait_for(lambda: probe.rpc(op="healthz")["ready"])
    assert h["ok"] and not h["ready"] and h["status"] == "stalled"
    # at least the dispatcher's episode (a loaded host may add one of its own)
    return [answer, {"stalled": d.registry.counter("mri_watchdog_stalls_total").value >= 1}]


CASES = {"overloaded": (case_overloaded, {"queue_depth": 4, "max_batch": 1, "coalesce_us": 0}),
         "deadline": (case_deadline, {"max_batch": 8, "coalesce_us": 0}),
         "drain": (case_drain, {"coalesce_us": 0, "drain_s": 0.2}),
         "reload": (case_reload, {}),
         "handler_crash": (case_handler_crash, {"coalesce_us": 0, "max_batch": 1}),
         "client_disconnect": (case_client_disconnect, {"coalesce_us": 0}),
         "slow_client": (case_slow_client, {"coalesce_us": 0}),
         "dispatcher_hang": (case_dispatcher_hang, {})}


def run_case(name, side, out, monkeypatch):
    fn, kw = CASES[name]
    cls, inj, engine_kw = SIDES[side]
    if name == "dispatcher_hang":
        monkeypatch.setenv("MRI_OBS_STALL_MS", "400")  # accept beats every 200 ms
    with serving(cls, out, **engine_kw, **kw) as d:
        with Client(d) as c:
            args = (d, c) if name in ("overloaded", "deadline", "drain") else (d, c, inj)
            got = fn(*args)
        inj.install(None)
    # after the drain: every writer has counted its responses
    counters = d.final_stats["counters"]
    kinds = [r.get("error", "ok" if r.get("ok") else r) for r in got]
    answers = [r.get("df") for r in got]
    return kinds, answers, counters


@pytest.mark.parametrize("name", sorted(CASES))
def test_envelope_counters_match_jax(built, name, monkeypatch):
    jdir, tdir, naive = built
    want = run_case(name, "jax", jdir, monkeypatch)
    got = run_case(name, "port", tdir, monkeypatch)
    kinds, answers, counters = got
    assert kinds == want[0]
    assert answers == want[1]
    # responses and connections count what the client side did, which
    # is the same — but for the healthz polls of the hang case, as many
    # as its flip took; every other counter too
    if name == "dispatcher_hang":
        counters, want = dict(counters), (want[0], want[1], dict(want[2]))
        del counters["responses"], want[2]["responses"]
    assert counters == want[2]
    expect = {"overloaded": ("shed", 6), "deadline": ("deadline_expired", 1),
              "drain": ("draining_rejected", 6), "reload": ("reload_rejected", 1),
              "handler_crash": ("internal_errors", 1),
              "client_disconnect": ("client_disconnects", 1),
              "slow_client": ("requests", 1), "dispatcher_hang": ("requests", 1)}[name]
    assert counters[expect[0]] == expect[1]
    for a in answers:
        assert a is None or a in ([len(naive["cat"])], [len(naive["dog"])])
