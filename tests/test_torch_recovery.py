"""The port's in-run fault tolerance on the host backend, against the
JAX package's under the same fault specs: leased re-execution of a dead
scan worker's windows, reducer takeover, the respawn budget, the lease
watchdog, and the integrity audit (``WindowLedger``, ``check_merge``,
``--audit``/``--verify``).

A worker or reducer death inside a run is invisible in the output: the
letter files equal the oracle's.  Only an exhausted respawn budget with
no survivors degrades the run (exit 3), naming the documents lost.  The
audit makes the opposite fault, a silently dropped window, fail loudly."""

import json
import time

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import audit as jaudit
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cli import main as jmain
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import audit, faults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.io import (
    plan_byte_windows,
)

from conftest import read_letter_files
from test_torch_cpu_backend import _disarm, corpus_pair  # noqa: F401

pytestmark = [pytest.mark.faults, pytest.mark.parallel_host]

WINDOW_BYTES = 512  # ~16 windows over the 29-document corpus


@pytest.fixture(autouse=True)
def _tiny_windows(monkeypatch):
    monkeypatch.setenv("MRI_CPU_WINDOW_BYTES", str(WINDOW_BYTES))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("recovery")
    tm, jm, lst = corpus_pair(root)
    tpkg.oracle_index(tm, str(root / "golden"))
    return tm, jm, lst, read_letter_files(root / "golden")


def _build(tm, out, K, M, spec=None, audit=False, pkg=tpkg, mod=faults):
    mod.install(spec)
    mod.begin_run()
    try:
        return pkg.build_index(tm, pkg.IndexConfig(backend="cpu", num_mappers=K,
                                                   num_reducers=M, io_prefetch=2,
                                                   audit=audit),
                               output_dir=str(out))
    finally:
        mod.install(None)


def _jax():
    import parallel_computation_of_an_inverted_index_using_map_reduce_tpu as jpkg

    return dict(pkg=jpkg, mod=jfaults)


# -- worker death -------------------------------------------------------------


@pytest.mark.parametrize("mappers", [2, 4])
@pytest.mark.parametrize("reducers", [1, 3, 26])
@pytest.mark.parametrize("position", ["early", "middle", "last"])
def test_worker_death_byte_identical(mappers, reducers, position, corpus, tmp_path):
    tm, _, _, golden = corpus
    n = len(plan_byte_windows(tm, WINDOW_BYTES))
    window = {"early": 1, "middle": n // 2, "last": n}[position]
    d = _build(tm, tmp_path / "out", mappers, reducers,
               spec=f"worker-death:window={window}")["degradation"]
    assert d["worker_recoveries"] >= 1 and d["windows_requeued"] >= 1
    assert d["skipped_docs"] == []  # recovery is not degradation
    assert read_letter_files(tmp_path / "out") == golden


#: fault spec, (K, M), the recoveries both packages must count
RECOVERIES = {
    "two_deaths": ("worker-death:worker=1:window=0;worker-death:worker=2:window=0", (4, 3), 2),
    "all_die_respawn": ("worker-death:worker=0:window=0;worker-death:worker=1:window=0",
                        (2, 2), 2),
    "single_mapper": ("worker-death:worker=0:window=2", (1, 2), 1),
    "scan_error": ("scan-error:window=3", (2, 3), None),
    "reader_death": ("reader-death:window=2", (2, 2), None),
}


@pytest.mark.parametrize("case", sorted(RECOVERIES))
def test_recovery_equals_jax(case, corpus, tmp_path):
    """The same spec in both packages: oracle bytes and no skips; where
    the spec names the dying workers, the same recovery count."""
    tm, jm, _, golden = corpus
    spec, (K, M), count = RECOVERIES[case]
    d = _build(tm, tmp_path / "port", K, M, spec=spec)["degradation"]
    jd = _build(jm, tmp_path / "jax", K, M, spec=spec, **_jax())["degradation"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == golden
    assert d["skipped_docs"] == jd["skipped_docs"] == []
    if count is not None:
        assert d["worker_recoveries"] == jd["worker_recoveries"] == count
    else:
        assert d["worker_recoveries"] >= 1 and jd["worker_recoveries"] >= 1


def test_respawn_budget_exhausted_degrades_as_jax(corpus, tmp_path, monkeypatch):
    monkeypatch.setenv("MRI_WORKER_RESPAWNS", "0")
    tm, jm, _, golden = corpus
    spec = "worker-death:worker=0:window=0;worker-death:worker=1:window=0"
    d = _build(tm, tmp_path / "port", 2, 2, spec=spec)["degradation"]
    jd = _build(jm, tmp_path / "jax", 2, 2, spec=spec, **_jax())["degradation"]
    # which windows a dying worker had leased depends on its reader's
    # timing, so the requeue count and the skip order may differ
    for key in ("worker_recoveries", "reducer_takeovers", "read_retries"):
        assert d[key] == jd[key]
    assert d["worker_recoveries"] == 2
    assert sorted(d["skipped_docs"]) == sorted(jd["skipped_docs"]) == list(range(1, len(tm) + 1))
    assert all((tmp_path / "port" / f"{chr(97 + i)}.txt").exists() for i in range(26))
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") != golden


def test_budget_exhausted_is_cli_exit_3_as_jax(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MRI_WORKER_RESPAWNS", "0")
    _, _, lst, _ = corpus
    spec = "worker-death:worker=0:window=0;worker-death:worker=1:window=0"
    lines = []
    for name, fn in (("port", main), ("jax", jmain)):
        rc = fn(["2", "2", lst, "--backend", "cpu", "--output-dir", str(tmp_path / name),
                 "--fault-spec", spec])
        assert rc == faults.EXIT_DEGRADED
        lines.append([ln for ln in capsys.readouterr().err.splitlines() if "DEGRADED" in ln])
    assert lines[0] == lines[1] and len(lines[0]) == 1


def test_lease_deadline_watchdog_never_hangs(corpus, tmp_path, monkeypatch):
    """A worker wedged in a slow read past MRI_WINDOW_DEADLINE_S is
    retired in absentia: the run ends quickly with the oracle's bytes."""
    monkeypatch.setenv("MRI_WINDOW_DEADLINE_S", "0.25")
    tm, _, _, golden = corpus
    t0 = time.monotonic()
    d = _build(tm, tmp_path / "out", 2, 2, spec="slow-read:doc=5:ms=900")["degradation"]
    assert time.monotonic() - t0 < 30
    assert d["skipped_docs"] == [] and d["worker_recoveries"] in (0, 1)
    assert read_letter_files(tmp_path / "out") == golden


# -- reducer takeover --------------------------------------------------------


@pytest.mark.parametrize("reducers,dead", [(1, 0), (3, 0), (3, 1), (3, 2), (26, 0),
                                           (26, 12), (26, 25)])
def test_reducer_death_range_reemitted(reducers, dead, corpus, tmp_path):
    tm, _, _, golden = corpus
    d = _build(tm, tmp_path / "out", 2, reducers,
               spec=f"reducer-death:reducer={dead}")["degradation"]
    assert d["reducer_takeovers"] == 1 and d["skipped_docs"] == []
    assert read_letter_files(tmp_path / "out") == golden


def test_worker_and_reducer_death_same_run(corpus, tmp_path):
    tm, _, _, golden = corpus
    d = _build(tm, tmp_path / "out", 4, 3,
               spec="worker-death:window=2;reducer-death:reducer=1", audit=True)["degradation"]
    assert d["worker_recoveries"] >= 1 and d["reducer_takeovers"] == 1
    assert read_letter_files(tmp_path / "out") == golden


# -- the integrity audit -------------------------------------------------------


def _ledger_story(mod):
    """One sequence of feeds, a death and a rescan; the errors it meets."""
    out = []
    led = mod.WindowLedger()
    for wi in (1, 3):
        led.record(wi, worker=0, docs=2, nbytes=10, checksum=wi)
    for call in (lambda: led.check_complete(3),
                 lambda: led.discard_worker(0),
                 lambda: led.record(1, worker=2, docs=2, nbytes=10, checksum=7),
                 lambda: led.record(3, worker=0, docs=1, nbytes=5, checksum=9),  # zombie
                 lambda: led.check_complete(3, missing_ok=[2, 3]),
                 lambda: led.record(3, worker=1, docs=1, nbytes=5, checksum=9),
                 lambda: led.record(3, worker=2, docs=1, nbytes=5, checksum=9),  # double feed
                 lambda: led.check_complete(3, missing_ok=[2]),
                 led.summary):
        try:
            out.append(call())
        except mod.AuditError as e:
            out.append(str(e))
    return out


def test_window_ledger_equals_jax():
    got = _ledger_story(audit)
    assert got == _ledger_story(jaudit)
    assert "window 2" in got[0] and got[1] == 2 and "more than once" in got[7]
    assert got[8] == {"windows": 2, "docs": 3, "bytes": 15}


def test_window_checksum_equals_jax():
    import numpy as np

    buf = np.frombuffer(b"alpha beta gamma", dtype=np.uint8)
    ends = np.array([5, 10, 16], dtype=np.int64)
    ids = np.array([1, 2, 3], dtype=np.int32)
    assert audit.window_checksum(buf, ends, ids) == jaudit.window_checksum(buf, ends, ids)


def test_check_spill_equals_jax():
    for args in ((5, 5, 9, 4), (5, 4, 9, 4), (5, 5, 3, 4)):
        msgs = []
        for mod in (audit, jaudit):
            try:
                mod.check_spill(*args)
                msgs.append(None)
            except mod.AuditError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("spec", [None, "worker-death:window=2"])
def test_audit_passes_on_clean_and_recovered_runs(spec, corpus, tmp_path):
    tm, _, _, golden = corpus
    stats = _build(tm, tmp_path / "out", 2, 3, spec=spec, audit=True)
    assert stats["audit_ms"] > 0
    assert read_letter_files(tmp_path / "out") == golden
    doc = json.loads((tmp_path / "out" / audit.MANIFEST_NAME).read_text())
    assert len(doc["files"]) == 26
    assert audit.verify_output_dir(tmp_path / "out") == (True, [])


def test_audit_catches_a_silently_dropped_window(corpus, tmp_path):
    tm, jm, _, golden = corpus
    spec = "scan-error:window=2:silent=1"
    with pytest.raises(audit.AuditError, match="window 2") as e:
        _build(tm, tmp_path / "a", 2, 2, spec=spec, audit=True)
    with pytest.raises(jaudit.AuditError) as je:
        _build(jm, tmp_path / "b", 2, 2, spec=spec, audit=True, **_jax())
    assert str(e.value) == str(je.value)
    # the control: without --audit the same fault corrupts the output
    _build(tm, tmp_path / "c", 2, 2, spec=spec)
    assert read_letter_files(tmp_path / "c") != golden


def test_cli_audit_and_verify_exit_codes_equal_jax(corpus, tmp_path, capsys):
    _, _, lst, _ = corpus
    for name, fn in (("port", main), ("jax", jmain)):
        out = tmp_path / name
        assert fn(["2", "2", lst, "--backend", "cpu", "--output-dir", str(out),
                   "--audit"]) == 0
        assert fn(["--verify", str(out)]) == 0
        (out / "b.txt").write_bytes(b"x:[2]\n")
        assert fn(["--verify", str(out)]) == 2
        assert "b.txt" in capsys.readouterr().err
    assert ((tmp_path / "port" / audit.MANIFEST_NAME).read_text().replace("b.txt", "")
            == (tmp_path / "jax" / audit.MANIFEST_NAME).read_text().replace("b.txt", ""))
