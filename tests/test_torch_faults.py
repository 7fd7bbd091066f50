"""The port's fault injector, read retries and degradation report
(``faults.py``, ``corpus/manifest.py``) against the JAX package's.

The spec grammar parses to the same rules in both packages, the retry
policy and its knobs behave alike, and one spec string drives both
builds to the same letter files, the same ``degradation`` block and the
same CLI exit code on every single-device plan.  Each package is armed
with its own ``install()``; ``MRI_FAULTS`` would arm both.
"""

import dataclasses
import json

import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cli import main as jmain
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.models import (
    inverted_index as JMI,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.obs import (
    metrics as jmetrics,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.obs import (
    metrics as tmetrics,
)

from conftest import read_letter_files

pytestmark = pytest.mark.faults


@pytest.fixture(autouse=True)
def _disarm():
    """No injector armed and a fresh report in either package, before
    and after each test (both are process-global by design)."""
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()
    yield
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()


def _small(tmp_path, texts=("alpha beta", "beta gamma", "delta alpha")):
    paths = tsyn.write_corpus(tmp_path / "small", [t.encode() for t in texts])
    tman.write_manifest(tmp_path / "small.txt", paths)
    return tman.read_manifest(tmp_path / "small.txt")


def _rules(inj):
    return [dataclasses.asdict(r) for r in inj.rules]


# -- spec grammar -------------------------------------------------------

# one clause per kind the JAX parser knows, with the fields each needs
EVERY_KIND = (
    "read-error:doc=2:times=2", "read-error:all:times=-1", "read-error:every=3:times=1",
    "read-error:all:p=0.5:times=1", "slow-read:doc=1:ms=50", "truncate:doc=4:bytes=10",
    "reader-death:window=1", "sigkill:window=2", "stream-crash:window=2",
    "ckpt-corrupt:save=1", "worker-death:worker=1:window=2", "worker-death:window=2",
    "reducer-death:reducer=0", "scan-error:window=3", "scan-error:window=3:silent=1",
    "spill-corrupt:spill=2", "merge-crash:shard=1", "handler-crash:req=3",
    "client-disconnect:req=2", "slow-client:req=1:ms=200", "reload-corrupt",
    "dispatcher-hang:ms=500", "append-torn-manifest", "compact-crash", "tombstone-corrupt",
    "wal-torn-record", "fetch-partial", "lease-steal", "shard-dead:shard=1",
    "shard-slow:shard=2:ms=50", "shard-slow:shard=2:replica=1", "router-conn-reset:req=3",
    "shard-blackout:shard=0", "overload-storm:every=2", "chaos:seed=5:n=3",
    "chaos:seed=9:n=6:kinds=shard-dead,slow-client,spill-corrupt", "seed=7",
)


@pytest.mark.parametrize("clause", EVERY_KIND)
def test_every_kind_parses_to_the_jax_rules(clause):
    spec = clause if clause != "seed=7" else "read-error:doc=0;seed=7"
    assert _rules(faults.FaultInjector(spec)) == _rules(jfaults.FaultInjector(spec))


def test_multi_clause_schedule_matches_jax():
    spec = "; ".join(EVERY_KIND)
    got = faults.FaultInjector(spec)
    assert _rules(got) == _rules(jfaults.FaultInjector(spec))
    assert len(got.rules) > len(EVERY_KIND)  # chaos clauses expanded


@pytest.mark.parametrize("bad", [
    "", "bogus:doc=1", "read-error:doc=x", "read-error:nope=1",
    "reader-death", "sigkill:window=0", "ckpt-corrupt",
    "seed=7:doc=1", "speed=9", "read-error:p=half", "scan-error",
    "handler-crash", "chaos:seed=1", "chaos:n=2:kinds=bogus",
    "router-conn-reset", "spill-corrupt", "read-error:window",
])
def test_spec_rejects_malformed_with_the_jax_message(bad):
    with pytest.raises(faults.FaultSpecError) as got:
        faults.FaultInjector(bad)
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.FaultInjector(bad)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_install_and_env_arming(monkeypatch):
    assert faults.install("read-error:doc=0").spec == "read-error:doc=0"
    assert faults.active() is not None
    assert faults.install(None) is None and faults.active() is None
    # env arming happens on the first active() after an unset state
    monkeypatch.setenv(faults.ENV_VAR, "slow-read:all:ms=1")
    monkeypatch.setattr(faults, "_active", faults._UNSET)
    inj = faults.active()
    assert inj is not None and inj.rules[0].kind == "slow-read"
    assert faults.ENV_VAR == jfaults.ENV_VAR == "MRI_FAULTS"
    assert faults.EXIT_DEGRADED == jfaults.EXIT_DEGRADED == 3


def test_bad_env_spec_is_a_fault_spec_error(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "warp-core-breach")
    monkeypatch.setattr(faults, "_active", faults._UNSET)
    with pytest.raises(faults.FaultSpecError, match="unknown fault kind"):
        faults.active()


def test_firings_count_in_the_default_registry():
    reg = tmetrics.default_registry()
    assert reg is tmetrics.default_registry()
    before = reg.counter("mri_faults_fired_total").value
    inj = faults.FaultInjector("reducer-death:reducer=1; reducer-death")
    with pytest.raises(RuntimeError, match="reducer 0"):
        inj.on_reducer(0)  # the second rule fires for any reducer
    with pytest.raises(RuntimeError, match="reducer 1"):
        inj.on_reducer(1)
    inj.on_reducer(1)  # both budgets spent
    assert reg.counter("mri_faults_fired_total").value - before == 2
    assert reg.counter("mri_fault_reducer_death_fired_total").value >= 2
    assert jmetrics.default_registry() is not reg


def test_death_hook_budget_is_global_like_jax():
    """``times`` of a death kind is one global budget: a requeued window
    rescanned by a survivor must not re-fire (both packages)."""
    for mod in (faults, jfaults):
        inj = mod.FaultInjector("worker-death:window=2:times=2; scan-error:window=3:silent=1")
        fired = 0
        for worker in (0, 1, 2):
            try:
                inj.on_worker_window(worker, 2)
            except mod.WorkerDeath:
                fired += 1
        assert fired == 2
        assert inj.on_scan_window(3) is True and inj.on_scan_window(3) is False


def test_serve_and_cluster_hooks_match_jax():
    """The hooks whose call sites come with the serving stack behave as
    the JAX ones do, call by call."""
    spec = ("handler-crash:req=2; client-disconnect:req=3; overload-storm:req=4:times=2; "
            "router-conn-reset:req=5; lease-steal; fetch-partial; shard-dead:shard=1")

    def trace(mod):
        inj = mod.FaultInjector(spec)
        out = []
        for req in range(1, 7):
            try:
                inj.on_serve_request(req)
                out.append("ok")
            except RuntimeError as e:
                out.append(type(e).__name__)
            out += [inj.on_serve_response(req), inj.on_serve_admit(req),
                    inj.on_router_client(req)]
        out += [inj.on_lease_check(), inj.on_lease_check(),
                inj.on_fetch_payload("seg", b"0123456789")]
        for shard in (0, 1, 1):
            try:
                inj.on_router_send(shard, 0)
                out.append("sent")
            except ConnectionError as e:
                out.append(type(e).__name__)
        return out

    assert trace(faults) == trace(jfaults)


def test_checkpoint_corrupt_hook_truncates_the_nth_save(tmp_path):
    p = tmp_path / "c.npz"
    inj = faults.FaultInjector("ckpt-corrupt:save=2")
    p.write_bytes(b"x" * 300)
    inj.on_checkpoint_saved(str(p))
    assert p.stat().st_size == 300
    inj.on_checkpoint_saved(str(p))
    assert p.stat().st_size == 100


def test_stream_and_window_hooks_fire_only_at_their_window():
    inj = faults.FaultInjector("stream-crash:window=2")
    inj.on_stream_window(1)
    inj.on_window_boundary(2)  # no sigkill rule: a no-op
    with pytest.raises(RuntimeError, match="injected stream crash after window 2"):
        inj.on_stream_window(2)


# -- RetryPolicy --------------------------------------------------------


def test_retry_policy_transient_then_success():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    report = faults.DegradationReport()
    policy = faults.RetryPolicy(max_attempts=3, backoff_s=0.0, sleep=lambda s: None)
    assert policy.run(flaky, doc_id=1, report=report) == "ok"
    assert calls["n"] == 3 and report.read_retries == 2


def test_retry_policy_exhausts_attempts():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("always")

    policy = faults.RetryPolicy(max_attempts=2, backoff_s=0.0, sleep=lambda s: None)
    with pytest.raises(OSError):
        policy.run(always)
    assert calls["n"] == 2


def test_retry_policy_deadline_cuts_retries():
    # backoff so large the first retry would already pass the deadline
    policy = faults.RetryPolicy(max_attempts=10, backoff_s=99.0, deadline_s=0.01,
                                sleep=lambda s: None)
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("down")

    with pytest.raises(OSError):
        policy.run(always)
    assert calls["n"] == 1


def test_retry_policy_backoff_doubles():
    slept = []
    policy = faults.RetryPolicy(max_attempts=4, backoff_s=0.001, deadline_s=60.0,
                                sleep=slept.append)
    with pytest.raises(OSError):
        policy.run(lambda: (_ for _ in ()).throw(OSError("down")))
    assert slept == [0.001, 0.002, 0.004]


def test_retry_policy_from_env_reads_knobs(monkeypatch):
    monkeypatch.setenv("MRI_READ_RETRIES", "5")
    monkeypatch.setenv("MRI_READ_BACKOFF_MS", "12.5")
    monkeypatch.setenv("MRI_READ_DEADLINE_S", "7")
    policy = faults.RetryPolicy.from_env()
    assert _policy_fields(policy) == _policy_fields(jfaults.RetryPolicy.from_env())
    assert policy.max_attempts == 5
    assert policy.backoff_s == pytest.approx(0.0125)
    assert policy.deadline_s == pytest.approx(7.0)
    assert faults.default_policy() == policy


def _policy_fields(policy) -> tuple:
    return (policy.max_attempts, policy.backoff_s, policy.backoff_mult, policy.deadline_s)


def test_retry_policy_defaults_match_jax():
    assert _policy_fields(faults.RetryPolicy.from_env()) == (3, 0.005, 2.0, 1.0)
    assert (_policy_fields(faults.RetryPolicy())
            == _policy_fields(jfaults.RetryPolicy.from_env())
            == _policy_fields(jfaults.RetryPolicy()))


@pytest.mark.parametrize("var,bad", [
    ("MRI_READ_RETRIES", "zero"),
    ("MRI_READ_RETRIES", "0"),
    ("MRI_READ_RETRIES", "-1"),
    ("MRI_READ_RETRIES", "2.5"),
    ("MRI_READ_BACKOFF_MS", "fast"),
    ("MRI_READ_BACKOFF_MS", "-10"),
    ("MRI_READ_DEADLINE_S", "0"),
    ("MRI_READ_DEADLINE_S", "nope"),
])
def test_retry_policy_from_env_rejects_bad_values(monkeypatch, var, bad):
    """A typo'd knob is a one-line ValueError naming the variable, with
    the JAX package's words."""
    monkeypatch.setenv(var, bad)
    with pytest.raises(ValueError, match=var) as got:
        faults.RetryPolicy.from_env()
    with pytest.raises(ValueError) as want:
        jfaults.RetryPolicy.from_env()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("plan", [[], ["--pipeline-chunk-docs", "0"],
                                  ["--device-tokenize"]])
def test_retry_policy_bad_env_is_cli_exit_2(tmp_path, monkeypatch, capsys, plan):
    _small(tmp_path)
    monkeypatch.setenv("MRI_READ_RETRIES", "lots")
    rc = main(["1", "1", str(tmp_path / "small.txt"), "--device", "cpu",
               "--output-dir", str(tmp_path / "out"), *plan])
    assert rc == 2
    err = capsys.readouterr().err
    assert "MRI_READ_RETRIES" in err and err.count("\n") == 1


# -- the read path: retry, skip, truncate, slow, probabilistic ----------


def _both_ranges(m, spec, ranges, policy_kw=None):
    """iter_document_ranges of both packages under the same spec, each
    with its own report; returns ``[(items, summary), ...]``."""
    out = []
    for mod, man in ((faults, tman), (jfaults, jman)):
        mod.install(spec)
        report = mod.DegradationReport()
        policy = mod.RetryPolicy(**{"backoff_s": 0.0, "sleep": lambda s: None,
                                    **(policy_kw or {})})
        mm = man.Manifest(paths=m.paths, sizes=m.sizes)
        items = list(man.iter_document_ranges(mm, ranges, policy=policy, report=report))
        out.append((items, report.summary()))
        mod.install(None)
    return out


def test_iter_document_ranges_resilience(tmp_path):
    m = _small(tmp_path)
    (items, summary), want = _both_ranges(
        m, "read-error:doc=0:times=1; read-error:doc=2:times=-1", [(0, len(m))])
    assert (items, summary) == want
    (contents, doc_ids), = items
    assert doc_ids == [1, 2]  # doc id 3 (index 2) gone
    assert summary["skipped_docs"] == [3]
    # doc 0's one transient and the 2 retries doc 2 spent before its
    # error became final (3 attempts = 2 recorded retries)
    assert summary["read_retries"] == 3


def test_transient_faults_on_every_doc_leave_no_skip(tmp_path):
    m = _small(tmp_path)
    (items, summary), want = _both_ranges(m, "read-error:all:times=2", [(0, 2), (2, 3)])
    assert (items, summary) == want
    assert [c for c, _ in items] == [[b"alpha beta", b"beta gamma"], [b"delta alpha"]]
    assert summary["read_retries"] == 2 * len(m) and summary["skipped_docs"] == []


def test_truncate_fault_shortens_document(tmp_path):
    m = _small(tmp_path, texts=("alpha beta", "gamma"))
    (items, _), want = _both_ranges(m, "truncate:doc=0:bytes=5", [(0, 2)])
    assert items == want[0]
    assert items[0][0] == [b"alpha", b"gamma"]


def test_slow_read_fault_still_succeeds(tmp_path):
    m = _small(tmp_path, texts=("alpha",))
    faults.install("slow-read:doc=0:ms=3")
    contents, ids = tman.load_documents(m, faults.DegradationReport())
    assert contents == [b"alpha"] and ids == [1]


def test_probabilistic_faults_follow_the_seed_like_jax(tmp_path):
    m = _small(tmp_path, texts=tuple(f"w{i} x" for i in range(24)))
    spec = "read-error:all:p=0.5:times=-1; seed=11"
    (items, summary), want = _both_ranges(m, spec, [(0, 12), (12, 24)])
    assert (items, summary) == want
    assert summary["read_retries"] > 0 and summary["skipped_docs"]  # the seed bites
    (_, other), _ = _both_ranges(m, "read-error:all:p=0.5:times=-1; seed=12",
                                 [(0, 12), (12, 24)])
    assert other != summary


def test_deadline_turns_a_slow_retry_into_a_skip(tmp_path):
    m = _small(tmp_path)
    (items, summary), want = _both_ranges(
        m, "read-error:doc=1:times=1", [(0, 3)],
        policy_kw={"backoff_s": 5.0, "deadline_s": 0.5})
    assert (items, summary) == want
    assert summary["skipped_docs"] == [2] and summary["read_retries"] == 0


def test_prefetch_reads_through_the_retry_policy(tmp_path):
    m = _small(tmp_path)
    faults.install("read-error:doc=1:times=2")
    report = faults.DegradationReport()
    got = list(tman.prefetch_document_ranges(m, [(0, 2), (2, 3)], report))
    assert [i for _, i in got] == [[1, 2], [3]]
    assert report.read_retries == 2 and not report.degraded


def test_report_merge_clear_and_log(caplog):
    a, b = faults.DegradationReport(), faults.DegradationReport()
    a.record_retry()
    b.record_skip(doc_id=4, path="p", reason="gone")
    b.record_worker_recovery(windows_requeued=2)
    b.record_reducer_takeover()
    a.merge(b)
    a.merge(a)
    assert a.summary() == {"read_retries": 1, "skipped_docs": [4],
                           "skip_reasons": {"4": "gone"}, "worker_recoveries": 1,
                           "windows_requeued": 2, "reducer_takeovers": 1}
    assert a.degraded and a.skipped_doc_ids() == [4]
    with caplog.at_level("INFO"):
        a.log_summary()
    assert "skipped 1 unreadable document(s) (doc ids [4]) after 1 retry" in caplog.text
    a.clear()
    assert a.summary() == faults.DegradationReport().summary()
    assert faults.current_report() is faults.current_report()
    assert faults.begin_run() is faults.current_report()


# -- whole builds, both packages ----------------------------------------

PLANS = {
    "pipelined": [],
    "one_shot": ["--pipeline-chunk-docs", "0"],
    "streaming": ["--stream-chunk-docs", "7"],
    "all_device": ["--device-tokenize"],
    "stream_all_device": ["--device-tokenize", "--stream-chunk-docs", "5"],
}


@pytest.fixture(scope="module")
def zipf_list(tmp_path_factory):
    root = tmp_path_factory.mktemp("zipf")
    docs = tsyn.zipf_corpus(num_docs=40, vocab_size=300, tokens_per_doc=40, seed=5)
    paths = tsyn.write_corpus(root / "docs", docs)
    tman.write_manifest(root / "list.txt", paths)
    return root / "list.txt"


def _fresh_pack(orig):
    """The JAX streaming loop's pack ring without reuse: on JAX's CPU
    backend a reused buffer can be refilled while a queued program still
    reads it (ROADMAP §C), so the JAX side gets a fresh array per window."""
    def pack(contents, ids, shard_len, docs_cap, arena=None):
        return orig(contents, ids, shard_len, docs_cap)
    return pack


def _cli_both(list_path, out, plan, spec, capsys, monkeypatch):
    """One CLI build per package under the same fault spec; returns
    ``(port_rc, port_stats, jax_rc, jax_stats)``."""
    monkeypatch.setattr(JMI, "_pack_window", _fresh_pack(JMI._pack_window))
    base = ["1", "1", str(list_path), "--stats", "--pad-multiple", "256", *PLANS[plan]]
    fault = ["--fault-spec", spec] if spec else []
    capsys.readouterr()
    rc = main([*base, "--device", "cpu", "--output-dir", str(out / "port"), *fault])
    port_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jrc = jmain([*base, "--backend", "tpu", "--device-shards", "1",
                 "--output-dir", str(out / "jax"), *fault])
    jax_stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, port_stats, jrc, jax_stats


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_degradation_block_matches_jax_without_faults(plan, zipf_list, tmp_path, capsys,
                                                      monkeypatch):
    """With no fault armed the port's ``--stats`` degradation block has
    exactly the JAX block's six keys and values, on every single-device
    plan."""
    rc, st, jrc, jst = _cli_both(zipf_list, tmp_path, plan, None, capsys, monkeypatch)
    assert rc == jrc == 0
    assert st["degradation"] == jst["degradation"]
    assert sorted(st["degradation"]) == ["read_retries", "reducer_takeovers", "skip_reasons",
                                         "skipped_docs", "windows_requeued",
                                         "worker_recoveries"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax")


SPECS = (
    "read-error:every=3:times=2",
    "read-error:doc=4:times=-1",
    "read-error:all:p=0.4:times=-1; seed=11",
    "truncate:doc=2:bytes=7; slow-read:doc=5:ms=2",
    "read-error:doc=1:times=1; read-error:every=9:times=-1",
)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fault_matrix_matches_jax(plan, spec, zipf_list, tmp_path, capsys, monkeypatch):
    """One spec string, both packages, one plan: the same letter files,
    the same degradation block and the same exit code (0 or 3)."""
    monkeypatch.setenv("MRI_READ_BACKOFF_MS", "0")
    rc, st, jrc, jst = _cli_both(zipf_list, tmp_path, plan, spec, capsys, monkeypatch)
    assert rc == jrc
    assert rc == (3 if jst["degradation"]["skipped_docs"] else 0)
    assert st["degradation"] == jst["degradation"]
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax")


def test_cli_degraded_exit_with_exact_doc_ids(tmp_path, capsys):
    _small(tmp_path)
    out = tmp_path / "out"
    rc = main(["1", "1", str(tmp_path / "small.txt"), "--device", "cpu",
               "--output-dir", str(out), "--stats",
               "--fault-spec", "read-error:doc=1:times=-1"])
    assert rc == faults.EXIT_DEGRADED == 3
    captured = capsys.readouterr()
    assert "DEGRADED" in captured.err and "[2]" in captured.err
    stats = json.loads(captured.out.strip())
    assert stats["degradation"]["skipped_docs"] == [2]
    assert stats["degradation"]["read_retries"] == 2
    assert b"alpha:[1 3]\n" in read_letter_files(out)


def test_bad_fault_spec_is_cli_usage_error(tmp_path, capsys):
    _small(tmp_path)
    rc = main(["1", "1", str(tmp_path / "small.txt"), "--device", "cpu",
               "--output-dir", str(tmp_path / "out"), "--fault-spec", "warp-core-breach"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "unknown fault kind" in err and err.count("\n") == 1


def test_oracle_backend_retries_and_reports(tmp_path):
    m = _small(tmp_path)
    tpkg.oracle_index(m, tmp_path / "clean")
    faults.install("read-error:all:times=2")
    stats = tpkg.build_index(m, tpkg.IndexConfig(backend="oracle"),
                             output_dir=tmp_path / "faulted")
    assert read_letter_files(tmp_path / "faulted") == read_letter_files(tmp_path / "clean")
    assert stats["degradation"]["read_retries"] == 2 * len(m)
    assert stats["degradation"]["skipped_docs"] == []


@pytest.mark.parametrize("restart", ["width", "key_overflow"])
def test_plan_restart_clears_the_whole_report(restart, tmp_path, monkeypatch):
    """A plan restart rereads the corpus, so the report starts over:
    its retries and skips are the second read's alone (ROADMAP §C: the
    JAX package keeps the first read's too)."""
    m = _small(tmp_path, texts=("alpha beta", "beta gamma", "delta alpha", "zeta"))
    monkeypatch.setenv("MRI_READ_BACKOFF_MS", "0")
    if restart == "width":
        kw = dict(device_tokenize=True, device_tokenize_width=4)
    else:
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import native
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
            inverted_index as TMI,
        )

        def overflow(self, manifest, out_dir, timer, report, device):
            list(tman.iter_document_ranges(manifest, [(0, len(manifest))], report))
            raise native.KeyOverflow("forced")

        monkeypatch.setattr(TMI.InvertedIndexModel, "_run_pipelined", overflow)
        kw = {}
    faults.install("read-error:doc=0:times=1; read-error:doc=2:times=-1")
    stats = tpkg.build_index(m, tpkg.IndexConfig(device="cpu", pad_multiple=256, **kw),
                             output_dir=tmp_path / "out")
    assert ("device_tokenize_fallback" in stats) == (restart == "width")
    # the first read spent doc 0's one transient; the second read's only
    # retries are doc 2's two before its skip
    assert stats["degradation"]["skipped_docs"] == [3]
    assert stats["degradation"]["read_retries"] == 2
