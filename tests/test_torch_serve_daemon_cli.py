"""The port's ``serve`` CLI and its operator clients, with four child
processes at most (each imports torch): ``serve --device cpu`` prints
its ``listening`` line, answers, serves HTTP ``/metrics``, reloads on
SIGHUP, dumps the flight recorder on SIGQUIT and drains to exit 0 with
the ``drained`` line on SIGTERM; ``metrics``, ``flightdump`` and ``top
--once --json`` run against it in this process.  A missing artifact, a
bad knob and ``--replica-of`` each exit 2 with one line; the segment
subcommands exit 2 naming ROADMAP A15b; ``metrics``/``top`` on a
directory need the card unless ``--device cpu``; ``query --explain``
prints the JAX CLI's report."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from conftest import REPO_ROOT

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)

pytestmark = [pytest.mark.daemon, pytest.mark.serve]

PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
DOCS = [b"the cat sat on the mat", b"the dog ran far", b"cat and dog nap",
        b"a quiet zebra naps", b"dog dog dog barks the most"]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve_cli")
    tman.write_manifest(root / "list.txt", tsyn.write_corpus(root / "docs", DOCS))
    assert tcli.main(["1", "1", str(root / "list.txt"), "--device", "cpu", "--artifact",
                      "--output-dir", str(root / "out")]) == 0
    return root / "out"


def _child(*args, env_extra=None, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    env.pop("MRI_FAULTS", None)
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-m", PORT, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, env=env, cwd=str(REPO_ROOT), text=True,
                            **kw)


def _rpc(addr, **obj):
    import socket

    with socket.create_connection(addr, timeout=15) as s, s.makefile("rb") as f:
        s.sendall((json.dumps(obj) + "\n").encode())
        return json.loads(f.readline())


def _poll(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


def test_serve_cli_lifecycle_and_clients(out, capsys, tmp_path):
    proc = _child("serve", str(out), "--device", "cpu", "--listen", "127.0.0.1:0",
                  "--listen-metrics", "0")
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["event"] == "listening" and ready["engine"] == "device"
        assert ready["pid"] == proc.pid and ready["metrics_port"] > 0
        addr = (ready["host"], ready["port"])
        target = f"{ready['host']}:{ready['port']}"
        assert _rpc(addr, id=1, op="df", terms=["cat", "dog"])["df"] == [2, 3]
        r = _rpc(addr, id=2, op="top_k", score="bm25", k=2, terms=["dog"], explain=True)
        assert r["explain"]["terms"][0]["path"] == "device"
        with urllib.request.urlopen(f"http://127.0.0.1:{ready['metrics_port']}/metrics",
                                    timeout=15) as resp:
            scrape = resp.read().decode()
        assert "# TYPE mri_serve_requests_total counter" in scrape

        assert tcli.main(["metrics", target]) == 0
        text = capsys.readouterr().out
        assert "mri_serve_requests_total 2" in text and "mri_engine_vocab_terms" in text
        # a request enters the flight ring just after its answer is queued
        _poll(lambda: len(_rpc(addr, op="flightdump")["flight"]["requests"]) == 2)
        dump = tmp_path / "flight.json"
        assert tcli.main(["flightdump", target, "--out", str(dump)]) == 0
        flight = json.loads(capsys.readouterr().out)
        assert flight["event"] == "flight_dump" and len(flight["requests"]) == 2
        assert json.loads(dump.read_text()) == flight
        assert tcli.main(["top", target, "--once", "--json"]) == 0
        sample = json.loads(capsys.readouterr().out)
        assert sample["healthz"]["ready"] and sample["stats"]["counters"]["requests"] == 2
        assert set(sample["slo"]) == {"availability", "latency"}
        assert tcli.main(["top", target, "--once"]) == 0
        assert "mri top — " + target in capsys.readouterr().out

        proc.send_signal(signal.SIGHUP)
        _poll(lambda: _rpc(addr, op="stats")["stats"]["counters"]["reload_ok"] == 1)
        proc.send_signal(signal.SIGQUIT)
        sigquit = out / f"flight-{proc.pid}-sigquit.json"
        _poll(sigquit.exists)
        assert json.loads(sigquit.read_text())["reason"] == "sigquit"
        assert _rpc(addr, id=3, op="df", terms=["zebra"])["df"] == [1]  # still serving

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        drained = json.loads(proc.stdout.readline())
        assert drained["event"] == "drained"
        assert drained["counters"]["requests"] == 3 and drained["counters"]["reload_ok"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("case", ["missing", "bad_knob", "replica_of"])
def test_serve_cli_refusals_exit_2(out, tmp_path, case):
    args, env, want = {
        "missing": (["serve", str(tmp_path / "nowhere"), "--device", "cpu"], None,
                    "cannot open"),
        "bad_knob": (["serve", str(out), "--device", "cpu"],
                     {"MRI_SERVE_CODEL_TARGET_MS": "nope"}, "MRI_SERVE_CODEL_TARGET_MS"),
        "replica_of": (["serve", str(out), "--device", "cpu", "--replica-of", "h:1"], None,
                       "A15b")}[case]
    proc = _child(*args, env_extra=env)
    stdout, stderr = proc.communicate(timeout=120)
    assert proc.returncode == 2 and stdout == ""
    lines = stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("error: ") and want in lines[0]


def test_static_clients_and_segment_subcommands(out, capsys):
    for sub in ("shard", "router", "append", "delete", "compact", "recover", "replicate"):
        assert tcli.main([sub, str(out)]) == 2
        assert "ROADMAP A15b" in capsys.readouterr().err
    if not torch.cuda.is_available():  # the default is the card, never a quiet CPU
        for sub in ("metrics", "top"):
            assert tcli.main([sub, str(out)]) == 2
            assert "torch sees no CUDA device" in capsys.readouterr().err
    assert tcli.main(["metrics", str(out), "--device", "cpu"]) == 0
    assert "# TYPE mri_engine_vocab_terms gauge" in capsys.readouterr().out
    assert tcli.main(["top", str(out), "--json", "--device", "cpu"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["engine"]["engine"] == "device" and "mri_engine_artifact_bytes" in \
        snap["metrics_text"]


@pytest.mark.parametrize("args", [["cat", "dog"], ["--op", "and", "cat", "dog"],
                                  ["--top-k", "2", "--score", "bm25", "dog", "cat", "dog"]])
def test_query_explain_prints_the_jax_report(out, capsys, args, monkeypatch):
    monkeypatch.setenv("MRI_SERVE_PLANNER", "bmw")
    assert jcli.main(["query", str(out), *args, "--engine", "device", "--explain"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert tcli.main(["query", str(out), *args, "--device", "cpu", "--explain"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1]
    report = json.loads(got[-1])["explain"]
    assert report == json.loads(want[-1])["explain"]
    assert {t["path"] for t in report["terms"]} == {"device"}


def test_flightdump_needs_an_address(capsys):
    assert tcli.main(["flightdump", "not-an-address"]) == 2
    assert "HOST:PORT" in capsys.readouterr().err
