"""The port's host backend (``backend="cpu"``) against the JAX package's
on the same inputs: letter files, ``index.mri`` bytes, ``--stats``,
exit codes and degradation blocks, through each of its routes — the
pipelined ingest (one scan worker), the parallel map/reduce (K scan
workers on a steal queue, M letter reducers), the one-shot native call
(``--io-prefetch 0``), the out-of-core spill and ``--artifact``.

The host backend's v2/v2.1 artifacts carry real term frequencies and
doc lengths in tokens, so they differ from the device build's (as they
do in the JAX package); they are held byte-equal to JAX
``backend="cpu"``, not to the device build.  The helpers here are
shared with the other host-backend suites.
"""

import json
import os

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import (
    IndexConfig as JConfig,
    build_index as jbuild,
    read_manifest as jread_manifest,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu import faults as jfaults
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.cli import main as jmain
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.serve import (
    artifact as jart,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import faults, native
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.cli import main
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
    artifact as tart,
)

from conftest import read_letter_files

pytestmark = pytest.mark.parallel_host

#: route name -> (IndexConfig kwargs, environment)
ROUTES = {
    "pipelined": (dict(host_threads=1), {"MRI_CPU_WINDOW_BYTES": "512"}),
    "parallel": (dict(num_mappers=4, num_reducers=3), {"MRI_CPU_WINDOW_BYTES": "512"}),
    "one_shot": (dict(io_prefetch=0), {}),
    "spill": (dict(num_mappers=3, num_reducers=4),
              {"MRI_CPU_WINDOW_BYTES": "512", "MRI_BUILD_SPILL_BYTES": "4096",
               "MRI_BUILD_SHARDS": "8"}),
    "artifact": (dict(num_mappers=2, num_reducers=2, artifact=True),
                 {"MRI_CPU_WINDOW_BYTES": "512"}),
}

#: CLI flags of each route
ROUTE_ARGV = {
    "pipelined": ["1", "1", "--host-threads", "1"],
    "parallel": ["4", "3"],
    "one_shot": ["1", "1", "--io-prefetch", "0"],
    "spill": ["3", "4"],
    "artifact": ["2", "2", "--artifact"],
}


@pytest.fixture(autouse=True)
def _disarm():
    """No injector armed and a fresh report in either package."""
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()
    yield
    for mod in (faults, jfaults):
        mod.install(None)
        mod.begin_run()


def corpus_pair(tmp_path, docs=None, *, name="docs", **zipf):
    """Write ``docs`` (default: a small Zipf corpus) and its list file;
    the port's and the JAX package's manifests of it, and the list path."""
    if docs is None:
        kw = dict(num_docs=29, vocab_size=500, tokens_per_doc=60, seed=13)
        kw.update(zipf)
        docs = tsyn.zipf_corpus(**kw)
    paths = tsyn.write_corpus(tmp_path / name, docs)
    lst = tmp_path / f"{name}.txt"
    tman.write_manifest(lst, paths)
    return tpkg.read_manifest(lst), jread_manifest(lst), str(lst)


def build_both(tm, jm, out, env=None, **cfg):
    """One build of each package under ``env``; ``(port stats, JAX
    stats)`` with the letter files under ``out/port`` and ``out/jax``."""
    env = env or {}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ts = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", **cfg),
                              output_dir=str(out / "port"))
        js = jbuild(jm, JConfig(backend="cpu", **cfg), output_dir=str(out / "jax"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert "cpu_fallback" not in ts
    return ts, js


#: ``--stats`` keys the port adds to the JAX package's: the CLI's
#: manifest and build times, and the host's wait on the card
PORT_ONLY_STATS = ("manifest_ms", "build_ms", "card_wait_ms")


def stable(stats: dict) -> dict:
    """The part of a ``--stats`` block that is the same on every run:
    times become their shape (a list's length), the spill block its
    keys; everything else stays, but the port's own keys."""
    out = {}
    for k, v in stats.items():
        if k in PORT_ONLY_STATS:
            continue
        if k == "phases_ms" or k == "spill":
            out[k] = sorted(v)
        elif "_ms" in k:
            out[k] = len(v) if isinstance(v, list) else "t"
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_smoke_golden_equals_jax(route, smoke_fixture, tmp_path):
    cfg, env = ROUTES[route]
    tm = tpkg.read_manifest(smoke_fixture / "manifest.txt", base_dir=smoke_fixture)
    jm = jread_manifest(smoke_fixture / "manifest.txt", base_dir=smoke_fixture)
    ts, js = build_both(tm, jm, tmp_path, env=env, **cfg)
    golden = read_letter_files(smoke_fixture / "golden")
    assert read_letter_files(tmp_path / "port") == golden
    assert read_letter_files(tmp_path / "jax") == golden
    if route != "spill":  # spill runs depend on which worker took which window
        assert stable(ts) == stable(js)
    if cfg.get("artifact"):
        assert ((tmp_path / "port" / "index.mri").read_bytes()
                == (tmp_path / "jax" / "index.mri").read_bytes())


def test_reference_small_golden(reference_dir, tmp_path):
    """The committed reference-binary goldens of ``test_small.txt`` (the
    corpus lives outside the repo, so this skips where it is absent)."""
    from pathlib import Path

    tm = tpkg.read_manifest(reference_dir / "test_small.txt", base_dir=reference_dir)
    jm = jread_manifest(reference_dir / "test_small.txt", base_dir=reference_dir)
    build_both(tm, jm, tmp_path, num_mappers=3, num_reducers=2)
    golden = read_letter_files(Path(__file__).parent / "fixtures" / "golden_ref_small")
    assert read_letter_files(tmp_path / "port") == golden
    assert read_letter_files(tmp_path / "jax") == golden


#: punctuation, uppercase, UTF-8, NUL and 0xff bytes, a 300-byte word,
#: an empty document; the list adds a duplicated path and a missing file
EDGE_DOCS = [
    b"Don't STOP; caf\xc3\xa9 x1y2z3 -- the END.",
    b"nul\x00byte \xffhigh\xfe zz\x00zz apple",
    b"w" * 300 + b" short " + b"Q" * 299,
    b"",
    b"\t\n  apple APPLE apple  \r\n",
    b"123 456 !!!",
    b"zebra yak xylophone Walrus vole",
]


def _edge_list(tmp_path):
    paths = tsyn.write_corpus(tmp_path / "edge", EDGE_DOCS)
    listed = paths + [paths[1], str(tmp_path / "edge" / "missing.txt")]
    lst = tmp_path / "edge.txt"
    lst.write_text(f"{len(listed)}\n" + "\n".join(listed) + "\n")
    return str(lst)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_edge_corpus_cli_equals_jax(route, tmp_path, monkeypatch, capsys):
    """The same argv through both CLIs: exit 3 (the missing file), the
    same letter files, degradation block and skip line, and the same
    ``--stats`` but for the times."""
    lst = _edge_list(tmp_path)
    _, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    runs = {}
    for name, fn in (("port", main), ("jax", jmain)):
        out = tmp_path / name
        rc = fn([*ROUTE_ARGV[route][:2], lst, "--backend", "cpu", "--output-dir", str(out),
                 "--stats", *ROUTE_ARGV[route][2:]])
        cap = capsys.readouterr()
        runs[name] = (rc, json.loads(cap.out.strip().splitlines()[-1]),
                      [ln for ln in cap.err.splitlines() if "DEGRADED" in ln],
                      read_letter_files(out))
    (prc, pstats, perr, pletters), (jrc, jstats, jerr, jletters) = runs["port"], runs["jax"]
    assert prc == jrc == faults.EXIT_DEGRADED
    assert pletters == jletters and b"apple:[" in pletters
    assert pstats["degradation"] == jstats["degradation"]
    assert pstats["degradation"]["skipped_docs"] == [len(EDGE_DOCS) + 2]
    assert perr == jerr and len(perr) == 1
    if route != "spill":
        assert stable(pstats) == stable(jstats)
    else:
        assert sorted(set(pstats) - set(PORT_ONLY_STATS)) == sorted(jstats)
    if route == "artifact":
        assert ((tmp_path / "port" / "index.mri").read_bytes()
                == (tmp_path / "jax" / "index.mri").read_bytes())


def test_random_corpus_equals_oracle_and_jax(tmp_path):
    tm, jm, _ = corpus_pair(tmp_path, num_docs=37, vocab_size=900, tokens_per_doc=70, seed=5)
    tpkg.oracle_index(tm, str(tmp_path / "oracle"))
    build_both(tm, jm, tmp_path)
    golden = read_letter_files(tmp_path / "oracle")
    assert read_letter_files(tmp_path / "port") == golden
    assert read_letter_files(tmp_path / "jax") == golden


def test_empty_corpus(tmp_path):
    tm, jm, _ = corpus_pair(tmp_path, [b"123 456\n", b""])
    ts, js = build_both(tm, jm, tmp_path)
    assert read_letter_files(tmp_path / "port") == read_letter_files(tmp_path / "jax") == b""
    assert sorted(p.name for p in (tmp_path / "port").glob("*.txt")) == [
        f"{chr(97 + i)}.txt" for i in range(26)]
    assert stable(ts) == stable(js)


def test_falls_back_to_oracle_without_native(smoke_fixture, tmp_path, monkeypatch):
    """The JAX fallback, kept: with no native library (or use_native
    off) the backend runs the oracle and says so."""
    m = tpkg.read_manifest(smoke_fixture / "manifest.txt", base_dir=smoke_fixture)
    golden = read_letter_files(smoke_fixture / "golden")
    r = tpkg.build_index(m, tpkg.IndexConfig(backend="cpu", use_native=False),
                         output_dir=str(tmp_path / "off"))
    assert r["cpu_fallback"] == "oracle" and read_letter_files(tmp_path / "off") == golden
    monkeypatch.setattr(native, "available", lambda: False)
    r = tpkg.build_index(m, tpkg.IndexConfig(backend="cpu"), output_dir=str(tmp_path / "nolib"))
    assert r["cpu_fallback"] == "oracle" and read_letter_files(tmp_path / "nolib") == golden


@pytest.mark.parametrize("mappers", [1, 4])
def test_mapper_threads_output_invariant(mappers, smoke_fixture, tmp_path):
    """num_mappers drives the scan workers; the output does not move,
    and ``host_threads`` follows the documented rule (one mapper means
    the default thread count, not one thread)."""
    m = tpkg.read_manifest(smoke_fixture / "manifest.txt", base_dir=smoke_fixture)
    cfg = tpkg.IndexConfig(backend="cpu", num_mappers=mappers, num_reducers=2)
    r = tpkg.InvertedIndexModel(cfg).run(m, output_dir=str(tmp_path))
    assert (r["num_mappers"], r["num_reducers"]) == (mappers, 2)
    assert r["host_threads"] == cfg.resolved_host_threads()
    assert r["host_threads"] == (mappers if mappers > 1 else native.default_threads())
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


@pytest.mark.parametrize("trial", [0, 1])
def test_engine_matrix_cpu_row(trial, tmp_path):
    """A small twin of the JAX engine matrix's ``backend="cpu"`` row:
    port cpu, port cuda on the CPU device and JAX cpu, equal bytes."""
    rng = np.random.default_rng(1000 + trial)
    tm, jm, _ = corpus_pair(tmp_path, num_docs=int(rng.integers(5, 50)),
                            vocab_size=int(rng.integers(80, 1000)),
                            tokens_per_doc=int(rng.integers(8, 100)), seed=2000 + trial)
    build_both(tm, jm, tmp_path)
    tpkg.build_index(tm, tpkg.IndexConfig(device="cpu", pad_multiple=64),
                     output_dir=str(tmp_path / "cuda"))
    got = read_letter_files(tmp_path / "port")
    assert got == read_letter_files(tmp_path / "jax") == read_letter_files(tmp_path / "cuda")


@pytest.mark.parametrize("fmt", ["1", "2", "3"])
def test_artifact_bytes_equal_jax_cpu(fmt, tmp_path, monkeypatch):
    """``--artifact`` packs ``index.mri`` off the merge state: byte-equal
    to JAX ``backend="cpu"`` at every format.  At v1 it also equals the
    device build's; v2/v2.1 carry the host build's tf and token doc
    lengths, which the device build does not write."""
    monkeypatch.setenv("MRI_SERVE_FORMAT", fmt)
    tm, jm, _ = corpus_pair(tmp_path, num_docs=40, vocab_size=300, tokens_per_doc=50, seed=5)
    ts, _ = build_both(tm, jm, tmp_path, num_mappers=3, num_reducers=2, artifact=True)
    port = (tmp_path / "port" / "index.mri").read_bytes()
    assert port == (tmp_path / "jax" / "index.mri").read_bytes()
    assert ts["artifact_bytes"] == len(port)
    tpkg.build_index(tm, tpkg.IndexConfig(device="cpu", artifact=True),
                     output_dir=str(tmp_path / "dev"))
    device = (tmp_path / "dev" / "index.mri").read_bytes()
    assert (port == device) is (fmt == "1")
    art = tart.load_artifact(tmp_path / "port" / "index.mri")
    assert art.version == int(fmt)
    if fmt != "1":
        # doc lengths in tokens: every document has 50
        assert set(tart.bm25_corpus(art)[0][1:].tolist()) == {50}


def test_build_from_export_equals_build_from_merge(tmp_path, monkeypatch):
    """The two-step pack (export the merge's columns, then pack them) and
    the one-pass native pack write the same v1 file, in both packages
    (the export carries no tf, so only v1 can agree)."""
    monkeypatch.setenv("MRI_SERVE_FORMAT", "1")
    tm, _, _ = corpus_pair(tmp_path, num_docs=23, vocab_size=400, tokens_per_doc=40, seed=4)
    contents, ids = tman.load_documents(tm)
    streams = [native.HostIndexStream() for _ in range(2)]
    try:
        for k, s in enumerate(streams):
            s.feed(contents[k::2], ids[k::2])
            s.partial()
        with native.HostIndexMerge(streams) as merge:
            n1 = tart.build_from_merge(tmp_path / "a.mri", merge)
            n2 = tart.build_from_export(tmp_path / "b.mri", merge.export_arrays())
            jart.build_from_export(tmp_path / "c.mri", merge.export_arrays())
    finally:
        for s in streams:
            s.close()
    a = (tmp_path / "a.mri").read_bytes()
    assert n1 == n2 == len(a)
    assert a == (tmp_path / "b.mri").read_bytes() == (tmp_path / "c.mri").read_bytes()


@pytest.mark.parametrize("width", [0, 1, 5, 17, 32])
def test_pack_bits_equals_jax(width):
    rng = np.random.default_rng(width)
    vals = rng.integers(0, 1 << min(width, 31), size=37).astype(np.uint32) if width else \
        np.zeros(37, dtype=np.uint32)
    np.testing.assert_array_equal(tart._pack_bits(vals, width), jart._pack_bits(vals, width))


@pytest.mark.parametrize("flag", ["stream_chunk_docs", "checkpoint_path", "profile_dir",
                                  "pipeline_chunk_docs", "device_tokenize",
                                  "collect_skew_stats", "overlap_tail_fraction"])
def test_device_options_refuse_cpu_as_jax_does(flag):
    value = {"stream_chunk_docs": 2, "checkpoint_path": "x", "profile_dir": "x",
             "pipeline_chunk_docs": 3, "device_tokenize": True,
             "collect_skew_stats": True, "overlap_tail_fraction": 0.5}[flag]
    with pytest.raises(ValueError) as te:
        tpkg.IndexConfig(backend="cpu", **{flag: value})
    with pytest.raises(ValueError) as je:
        JConfig(backend="cpu", **{flag: value})
    assert str(te.value) == str(je.value).replace("'tpu'", "'cuda'")


@pytest.mark.parametrize("knob,value", [
    ("MRI_CPU_WINDOW_BYTES", "big"), ("MRI_BUILD_SHARDS", "0"),
    ("MRI_BUILD_SPILL_BYTES", "0"), ("MRI_SPILL_KILL_AFTER", "x"),
    ("MRI_STEAL_SHUFFLE_SEED", "1.5"), ("MRI_WINDOW_DEADLINE_S", "soon"),
    ("MRI_WORKER_RESPAWNS", "many"),
])
def test_bad_knob_exits_2_naming_it(knob, value, tmp_path, monkeypatch, capsys):
    _, _, lst = corpus_pair(tmp_path, num_docs=4)
    monkeypatch.setenv(knob, value)
    if knob in ("MRI_BUILD_SHARDS", "MRI_SPILL_KILL_AFTER"):  # read by the spill route
        monkeypatch.setenv("MRI_BUILD_SPILL_BYTES", "4096")
        monkeypatch.setenv("MRI_CPU_WINDOW_BYTES", "512")
    argv = ["2", "2", lst, "--backend", "cpu", "--output-dir", str(tmp_path / "o")]
    assert main(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and knob in err[0]
    jrc = jmain(argv)
    jerr = [ln for ln in capsys.readouterr().err.strip().splitlines() if ln.startswith("error")]
    if knob == "MRI_SPILL_KILL_AFTER":
        # the JAX package reads this crash hook in the scan workers only,
        # so a bad value kills every worker and the run ends degraded
        # with every document lost (exit 3); the port refuses it up
        # front (ROADMAP §C)
        assert jrc == faults.EXIT_DEGRADED
    else:
        assert jrc == 2 and jerr == err


@pytest.mark.parametrize("route", ["pipelined", "parallel", "spill", "artifact"])
def test_trace_out_spans_equal_jax(route, tmp_path, monkeypatch):
    """``--trace-out`` records the host pipeline's spans (reader windows,
    scans, merge, reducer emits, spill flushes, shard merges, the
    artifact pack) under the JAX package's span and thread names."""
    cfg, env = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tm, jm, _ = corpus_pair(tmp_path)
    ts = tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu",
                                               trace_out=str(tmp_path / "p.json"), **cfg),
                          output_dir=str(tmp_path / "port"))
    jbuild(jm, JConfig(backend="cpu", trace_out=str(tmp_path / "j.json"), **cfg),
           output_dir=str(tmp_path / "jax"))
    names = []
    for name in ("p.json", "j.json"):
        events = json.loads((tmp_path / name).read_text())["traceEvents"]
        names.append(({e["name"] for e in events if e.get("ph") == "X"},
                      {e["args"]["name"] for e in events if e.get("ph") == "M"}))
    # the port adds a span per phase
    assert names[0] == (names[1][0] | set(ts["phases_ms"]), names[1][1])
    assert {"read", "scan"} <= names[0][0]


#: index.mri bytes of zipf_corpus(300 docs, 2,000 words, 200 tokens, seed 5):
#: (host backend at K = 4, M = 3; the device build), by MRI_SERVE_FORMAT
ARTIFACT_SIZES = {"1": (155_424, 155_424), "2": (82_960, 77_696), "3": (86_832, 81_568)}


@pytest.mark.parametrize("fmt", sorted(ARTIFACT_SIZES))
def test_host_and_device_artifacts_differ_in_the_tf_columns(fmt, tmp_path, monkeypatch):
    """The host backend's v2/v2.1 ``index.mri`` carries real term
    frequencies (``tf_words``) and doc lengths in tokens; the device
    build's carries tf 1 and doc lengths in distinct terms.  So the same
    corpus gives the same df and postings but other BM25 scores — the
    JAX package's behaviour, kept as it is (ROADMAP §C)."""
    monkeypatch.setenv("MRI_SERVE_FORMAT", fmt)
    tm, jm, _ = corpus_pair(tmp_path, num_docs=300, vocab_size=2000, tokens_per_doc=200, seed=5)
    build_both(tm, jm, tmp_path, num_mappers=4, num_reducers=3, artifact=True)
    tpkg.build_index(tm, tpkg.IndexConfig(device="cpu", artifact=True),
                     output_dir=str(tmp_path / "dev"))
    host = (tmp_path / "port" / "index.mri").read_bytes()
    device = (tmp_path / "dev" / "index.mri").read_bytes()
    assert host == (tmp_path / "jax" / "index.mri").read_bytes()
    assert (len(host), len(device)) == ARTIFACT_SIZES[fmt]
    a, d = (tart.load_artifact(tmp_path / p / "index.mri") for p in ("port", "dev"))
    np.testing.assert_array_equal(a.df, d.df)
    if fmt == "1":
        assert host == device
    else:
        assert len(a.tf_words) == 1314 and len(d.tf_words) == 0
        assert set(a.doc_lens[1:].tolist()) == {200}
        assert (int(d.doc_lens[1:].min()), int(d.doc_lens[1:].max())) == (68, 99)


def test_host_artifact_served_by_the_device_engine(tmp_path):
    """Path M4's checks at a small size: the host build's v2.1 on the
    port's ``DeviceEngine`` (CPU device) answers df, postings, AND and OR
    as the device build's artifact does, and BM25 as the host ``Engine``
    on the same file (rel 1e-4; the float32 engine may order documents
    whose float64 scores tie within that in another order)."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.serve import (
        DeviceEngine, Engine)

    tm, _, _ = corpus_pair(tmp_path, num_docs=300, vocab_size=2000, tokens_per_doc=100, seed=9)
    tpkg.build_index(tm, tpkg.IndexConfig(backend="cpu", num_mappers=3, num_reducers=2,
                                          artifact=True), output_dir=str(tmp_path / "host"))
    tpkg.build_index(tm, tpkg.IndexConfig(device="cpu", artifact=True),
                     output_dir=str(tmp_path / "dev"))
    art = tart.load_artifact(tmp_path / "host" / "index.mri")
    ranked = [art.term(int(i)) for i in np.argsort(-art.df.astype(np.int64), kind="stable")]
    words = ranked[:40] + ranked[-20:] + ["absent", "x1"]
    served = DeviceEngine(tmp_path / "host" / "index.mri", device="cpu")
    ref = DeviceEngine(tmp_path / "dev" / "index.mri", device="cpu")
    host = Engine(tmp_path / "host" / "index.mri")
    try:
        b = served.encode_batch(words)
        assert served.df(b).tolist() == ref.df(b).tolist()
        for x, y in zip(served.postings(b), ref.postings(b)):
            assert (x is None and y is None) or np.array_equal(x, y)
        rng = np.random.default_rng(9)
        for arity in (2, 3, 5):
            for _ in range(6):
                q = [ranked[int(i)] for i in rng.choice(60, arity, replace=False)]
                qb = served.encode_batch(q)
                assert np.array_equal(served.query_and(qb), ref.query_and(qb))
                assert np.array_equal(served.query_or(qb), ref.query_or(qb))
                got = served.top_k_scored(qb, 10)
                want = host.top_k_scored(host.encode_batch(q), 10)
                assert len(got) == len(want)
                for (_, g), (_, w) in zip(got, want):
                    assert abs(g - w) <= 1e-4 * abs(w)
                mine = dict(got)
                for d, w in want:
                    assert (abs(mine[d] - w) <= 1e-4 * abs(w) if d in mine
                            else w <= want[-1][1] * (1 + 1e-4))
    finally:
        served.close()
        ref.close()
        host.close()
