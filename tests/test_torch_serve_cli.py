"""The port's ``query`` CLI on the CPU against the JAX CLI's ``--engine
device`` on the same artifacts (v1, v2, v2.1): stdout equal for lookups,
``--op and|or`` and ``--top-k --letter``; BM25 lines equal in docs and
within rel 1e-4 in score; and the CLI's exit-code contract."""

import contextlib
import io
import json

import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import cli as jcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import serve as tserve

from test_torch_serve_device import FORMATS, zipf  # noqa: F401  (zipf: fixture)

pytestmark = pytest.mark.serve


def _run(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("fmt", FORMATS)
def test_query_cli_stdout_equals_jax(zipf, fmt):
    trios, naive = zipf
    out = str(trios[fmt].out)
    vocab = sorted(naive)
    words = [vocab[3], "Zebra", "nope", vocab[-1], "x1y2", vocab[40], vocab[3]]
    for extra in ([], ["--op", "and"], ["--op", "or"], ["--top-k", "5", "--letter", "b"],
                  ["--top-k", "3", "--letter", "q"]):
        rt = _run(tcli, ["query", out, "--device", "cpu", *words, *extra])
        rj = _run(jcli, ["query", out, "--engine", "device", *words, *extra])
        assert rt == rj, extra
    args = ["zebra", "apple", vocab[1], "--top-k", "10", "--score", "bm25"]
    rt = _run(tcli, ["query", out, "--device", "cpu", *args])
    rj = _run(jcli, ["query", out, "--engine", "device", *args])
    assert rt[0] == rj[0] == 0
    lt, lj = json.loads(rt[1]), json.loads(rj[1])
    assert [d["doc"] for d in lt["docs"]] == [d["doc"] for d in lj["docs"]]
    for a, b in zip(lt["docs"], lj["docs"]):
        assert a["score"] == pytest.approx(b["score"], rel=1e-4)


def test_query_cli_contract(zipf, tmp_path, capsys):
    out = str(zipf[0]["2"].out)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    assert tcli.main(["query", out, "--device", "cpu", "--batch-file", str(empty)]) == 0
    assert capsys.readouterr().out == ""
    assert tcli.main(["query", out, "--device", "cpu"]) == 2
    assert "no query terms" in capsys.readouterr().err
    assert tcli.main(["query", out, "--device", "cpu", "--top-k", "3"]) == 2
    assert "--top-k needs --letter" in capsys.readouterr().err
    assert tcli.main(["query", out, "--device", "cpu", "--top-k", "3",
                      "--score", "bm25"]) == 2
    assert tcli.main(["query", str(tmp_path), "--device", "cpu", "word"]) == 2
    assert "cannot open artifact" in capsys.readouterr().err
    batch = tmp_path / "batch.txt"
    batch.write_text("zebra\n\napple\n")
    assert tcli.main(["query", out, "--device", "cpu", "--batch-file", str(batch),
                      "--stats"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["term"] for x in lines[:2]] == ["zebra", "apple"]
    stats = json.loads(lines[-1])
    assert stats["engine"] == "device" and stats["ops"]["postings"]["calls"] == 1
    if not torch.cuda.is_available():
        assert tcli.main(["query", out, "zebra"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("fmt", FORMATS)
def test_query_cli_engines_print_the_same(zipf, fmt, monkeypatch):
    """``--engine host|device|auto`` (device on the CPU): byte-identical
    stdout on the df/postings, AND/OR and top-k legs, equal to the JAX
    CLI's host engine."""
    monkeypatch.delenv("MRI_SERVE_ENGINE", raising=False)
    trios, naive = zipf
    out = str(trios[fmt].out)
    vocab = sorted(naive)
    words = [vocab[3], "Zebra", "nope", vocab[-1], "x1y2", vocab[40], vocab[3], vocab[7]]
    for extra in ([], ["--op", "and"], ["--op", "or"], ["--top-k", "5", "--letter", "b"]):
        got = {e: _run(tcli, ["query", out, "--engine", e, "--device", "cpu", *words, *extra])
               for e in ("host", "device", "auto")}
        assert got["host"][0] == 0 and got["host"][1]
        assert got["host"] == got["device"] == got["auto"], extra
        assert got["host"] == _run(jcli, ["query", out, "--engine", "host", *words, *extra])
    args = ["zebra", "apple", vocab[1], "--top-k", "10", "--score", "bm25"]
    assert _run(tcli, ["query", out, "--engine", "host", *args]) == \
        _run(tcli, ["query", out, "--engine", "auto", "--device", "cpu", *args]) == \
        _run(jcli, ["query", out, "--engine", "host", *args])


def test_query_cli_engine_env_and_stats(zipf, monkeypatch, capsys):
    out = str(zipf[0]["3"].out)
    monkeypatch.setenv("MRI_SERVE_ENGINE", "host")
    assert tcli.main(["query", out, "zebra", "apple", "--stats"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["engine"] == "host"
    assert set(stats["native"]) == {"mode", "active", "error", "ops", "fallbacks"}
    # the flag beats the env; auto carries the native and auto blocks
    assert tcli.main(["query", out, "zebra", "--engine", "auto", "--device", "cpu",
                      "--stats"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["engine"] == "auto" and "native" in stats
    assert stats["auto"] == {"crossover": None, "probe": None, "device_ready": False}
    monkeypatch.setenv("MRI_SERVE_ENGINE", "device")
    assert tcli.main(["query", out, "zebra", "--device", "cpu", "--stats"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["engine"] == "device" and stats["device"]["platform"] == "cpu"


def test_query_cli_bad_knobs_exit_2(zipf, monkeypatch, capsys):
    out = str(zipf[0]["3"].out)
    monkeypatch.setenv("MRI_SERVE_NATIVE", "sometimes")
    assert tcli.main(["query", out, "zebra", "--engine", "host"]) == 2
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "MRI_SERVE_NATIVE" in err
    monkeypatch.delenv("MRI_SERVE_NATIVE")
    monkeypatch.setenv("MRI_SERVE_ENGINE", "tpu")
    assert tcli.main(["query", out, "zebra"]) == 2
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "unknown engine 'tpu'" in err
    monkeypatch.delenv("MRI_SERVE_ENGINE")
    monkeypatch.setenv("MRI_SERVE_CROSSOVER", "-1")
    assert tcli.main(["query", out, "zebra", "--engine", "auto", "--device", "cpu"]) == 2
    assert "MRI_SERVE_CROSSOVER" in capsys.readouterr().err
    monkeypatch.delenv("MRI_SERVE_CROSSOVER")
    if not torch.cuda.is_available():
        assert tcli.main(["query", out, "zebra", "--engine", "auto"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


def test_query_cli_native_required_exits_2_other_errors_raise(zipf, monkeypatch, capsys):
    """``MRI_SERVE_NATIVE=1`` on a v1 artifact (numpy only) is a one-line
    exit 2; any other error while the engine is built keeps its
    traceback instead of passing for a usage error."""
    out = str(zipf[0]["1"].out)
    monkeypatch.setenv("MRI_SERVE_NATIVE", "1")
    assert tcli.main(["query", out, "zebra", "--engine", "host"]) == 2
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "MRI_SERVE_NATIVE=1" in err
    monkeypatch.delenv("MRI_SERVE_NATIVE")

    def broken(*args, **kwargs):
        raise RuntimeError("engine construction bug")

    monkeypatch.setattr(tserve, "create_engine", broken)
    with pytest.raises(RuntimeError, match="engine construction bug"):
        tcli.main(["query", out, "zebra", "--engine", "host"])
