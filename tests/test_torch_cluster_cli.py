"""The port's cluster subcommands against the JAX CLI's, on the CPU:
``shard``'s exit-2 contract and JSON event lines; ``router``'s argument
errors (one line, exit 2); ``serve`` on a shard directory (the shard
engine by default, the JAX message under ``--engine device``); a
``router`` child over two ``serve`` children that prints its
``listening`` line, answers as the monolith, shows its fleet through
``top ROUTER --once`` and drains on SIGTERM; and ``top``'s fleet rows
equal to the JAX ``_top_render`` on the JAX suite's samples."""

import json
import signal

import pytest

from test_torch_cluster import DOCS, build_mono, write_list
from test_torch_serve_daemon_cli import _child, _rpc

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    logging as jlogging,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    logging as tlogging,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    Engine,
)

pytestmark = [pytest.mark.cluster, pytest.mark.serve]

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("tcluster_cli")
    src = write_list(root, DOCS)
    assert tcli.main(["shard", str(src), "--shards", "2", "--out", str(root / "cl")]) == 0
    return src, build_mono(root, src), root / "cl"


@pytest.fixture(autouse=True)
def _no_log_handlers():
    """``router`` attaches each package's stderr log handler; detached
    after every test so later stderr comparisons see no log lines."""
    yield
    jlogging.reset()
    tlogging.reset()


def _both(capsys, argv):
    """``(rc, stdout, stderr)`` of the JAX CLI and the port's on ``argv``."""
    got = []
    for main in (jcli.main, tcli.main):
        try:
            rc = main(list(argv))
        except SystemExit as e:  # argparse's own refusals
            rc = e.code
        o, e = capsys.readouterr()
        got.append((rc, o, e.replace("mri-tpu", "PROG").replace("mri-torch", "PROG")))
    return got


@pytest.mark.parametrize("case", ["missing_list", "zero_shards", "too_many_shards",
                                  "bad_mode", "no_cluster_json"])
def test_shard_exit_2_contract_matches_jax(built, tmp_path, capsys, case):
    src, _, _ = built
    argv = {
        "missing_list": ["shard", str(tmp_path / "nope.list"), "--shards", "2",
                         "--out", str(tmp_path / "a")],
        "zero_shards": ["shard", str(src), "--shards", "0", "--out", str(tmp_path / "a")],
        "too_many_shards": ["shard", str(src), "--shards", str(len(DOCS) + 1),
                            "--out", str(tmp_path / "a")],
        "bad_mode": ["shard", str(src), "--shards", "2", "--out", str(tmp_path / "a"),
                     "--mode", "random"],
        "no_cluster_json": ["shard", str(src), "--shards", "2", "--out",
                            str(tmp_path / "empty"), "--verify-only"],
    }[case]
    jax, port = _both(capsys, argv)
    assert port[0] == jax[0] == 2 and port[1] == jax[1] == ""
    if case == "bad_mode":
        # argparse: a usage block wrapped to the prog's width, then the error
        assert port[2].splitlines()[-1] == jax[2].splitlines()[-1]
    else:
        assert port[2] == jax[2]
        assert port[2].startswith("error: ") and port[2].count("\n") == 1


@pytest.mark.parametrize("case", ["bad_endpoint", "no_endpoints", "bad_listen",
                                  "bad_hedge_knob", "bad_fault_spec"])
def test_router_argument_errors_exit_2_one_line(capsys, monkeypatch, case):
    argv, env = {
        "bad_endpoint": (["router", "--shards", "h:1,h"], None),
        "no_endpoints": (["router", "--shards", ","], None),
        "bad_listen": (["router", "--shards", "127.0.0.1:9", "--listen", "nowhere"], None),
        "bad_hedge_knob": (["router", "--shards", "127.0.0.1:9"],
                           {"MRI_CLUSTER_HEDGE_MS": "-5"}),
        "bad_fault_spec": (["router", "--shards", "127.0.0.1:9", "--fault-spec",
                            "shard-dead:bogus=1"], None),
    }[case]
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    jax, port = _both(capsys, argv)
    assert port[0] == jax[0] == 2 and port[1] == jax[1] == ""
    lines = port[2].splitlines()
    assert len(lines) == 1 and lines[0].startswith("error: "), port
    if case != "bad_hedge_knob":  # the knob messages are each package's own words
        assert port[2] == jax[2]
    else:
        assert "MRI_CLUSTER_HEDGE_MS" in port[2] and "-1.0" in port[2]


def test_serve_on_a_shard_dir_refuses_a_named_device(built, capsys):
    _, _, cl = built
    shard = str(cl / "shard-0")
    jax, port = _both(capsys, ["serve", shard, "--engine", "device"])
    assert port[0] == jax[0] == 2
    assert port[2] == jax[2] == (f"error: {shard} is a cluster shard (cluster_shard.json "
                                 "present): the device engine serves plain artifacts only "
                                 "(use host or auto, which route to the shard engine)\n")


def test_router_child_serves_drains_and_shows_its_fleet(built, capsys):
    """Two ``serve`` children over the shard directories (no engine
    named: the shard engine, no card needed) and a ``router`` child
    over them: the ``listening`` line, answers equal to the monolith,
    ``top ROUTER --once --json`` and its frame with fleet rows, and a
    SIGTERM drain to exit 0 with the ``drained`` line."""
    _, mono, cl = built
    procs = [_child("serve", str(cl / f"shard-{s}"), "--listen", "127.0.0.1:0")
             for s in range(2)]
    try:
        ready = [json.loads(p.stdout.readline()) for p in procs]
        assert [r["engine"] for r in ready] == ["shard", "shard"]
        spec = ",".join(f"{r['host']}:{r['port']}" for r in ready)
        router = _child("router", "--shards", spec, "--listen", "127.0.0.1:0",
                        "--hedge-ms", "0")
        procs.append(router)
        line = json.loads(router.stdout.readline())
        assert line["event"] == "listening" and line["pid"] == router.pid
        assert line["shards"] == 2 and line["replicas"] == [1, 1]
        addr = (line["host"], line["port"])
        terms = sorted({w.decode() for w in DOCS[0].split()})[:3]
        with Engine(mono) as eng:
            b = eng.encode_batch(terms)
            want_df = eng.df(b).tolist()
            want_top = [[d, s] for d, s in eng.top_k_scored(b, 6)]
        assert _rpc(addr, id=1, op="df", terms=terms)["df"] == want_df
        assert _rpc(addr, id=2, op="top_k", terms=terms, k=6, score="bm25")["docs"] == want_top
        target = f"{line['host']}:{line['port']}"
        assert tcli.main(["top", target, "--once", "--json"]) == 0
        sample = json.loads(capsys.readouterr().out)
        fleet = sample["stats"]["cluster"]["shards"]
        assert [len(sh["replicas"]) for sh in fleet] == [1, 1]
        assert all(sh["replicas"][0]["ready"] for sh in fleet)
        assert tcli.main(["top", target, "--once"]) == 0
        frame = capsys.readouterr().out
        assert "coverage: 2/2 shards answerable" in frame and "ready*" in frame
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=60) == 0
        drained = json.loads(router.stdout.readline())
        assert drained["event"] == "drained" and drained["counters"]["requests"] == 2
        for p in procs[:2]:
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=60) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
            p.stderr.close()


#: the JAX suite's fleet samples (tests/test_cluster.py and
#: tests/test_brownout.py), one healthy pair of replicas and one
#: degraded fleet
SAMPLES = {
    "healthy": {
        "healthz": {"ready": True, "status": "ok", "reasons": []},
        "stats": {
            "queue_depth": 0, "inflight": 0, "connections": 1,
            "counters": {"requests": 5}, "rolling": {},
            "cluster": {"shards": [
                {"shard": 0, "p95_ms": 1.25, "replicas": [
                    {"addr": "h:1", "ready": True, "reasons": [], "primary": True},
                    {"addr": "h:2", "ready": False, "reasons": ["connection_lost"],
                     "primary": False}]}]},
        },
        "slo": {},
    },
    "degraded": {
        "healthz": {"ready": True, "status": "ok", "reasons": []},
        "stats": {
            "queue_depth": 0, "inflight": 0, "connections": 1, "counters": {}, "rolling": {},
            "cluster": {
                "partial_default": "allow", "breakers_open": 1,
                "shards": [
                    {"shard": 0, "p95_ms": 1.0, "replicas": [
                        {"addr": "h:1", "ready": False, "reasons": ["connection_lost"],
                         "primary": True, "breaker": "open"}]},
                    {"shard": 1, "p95_ms": 1.0, "replicas": [
                        {"addr": "h:2", "ready": True, "reasons": [], "primary": True,
                         "breaker": "closed"}]}]},
        },
        "slo": {},
    },
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_top_fleet_rows_equal_jax(name):
    frame = tcli._top_render("h:9", SAMPLES[name])
    assert frame == jcli._top_render("h:9", SAMPLES[name])
    if name == "healthy":
        assert "ready*" in frame and "DOWN" in frame and "connection_lost" in frame
        assert "coverage: 1/1 shards answerable" in frame
    else:
        assert "coverage: 1/2 shards answerable  [DEGRADED]" in frame
        assert "breakers_open=1" in frame and "partial_default=allow" in frame
