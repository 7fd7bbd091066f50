"""The port's streaming all-device plan (``device_tokenize`` with
``stream_chunk_docs``) end to end on the CPU: whole builds byte-equal to
``oracle_index`` and the smoke golden at any window size, with
accumulator growth, empty windows and corpora, and the ``WidthOverflow``
restart on the streaming plan; resumable stream checkpoints (kill and
resume at any crash point and cadence, empty windows, changed configs
rejected, corrupt files under both trust policies, the snapshot-tax
budget, the growth curve across a resume); and the checkpoint format,
which loads in both packages.  The builds are held against the oracle,
not against the JAX streaming build: on JAX's CPU backend that plan's
window ring can refill a buffer a queued program still reads."""

import json

import numpy as np
import pytest

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.corpus import (
    manifest as jman,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.ops import (
    device_streaming as JDS,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.utils import (
    checkpoint as jckpt,
)
import parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch as tpkg
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli as tcli
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
    manifest as tman,
    synthetic as tsyn,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.models import (
    inverted_index as TMI,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
    device_streaming as TDS,
    device_tokenizer as TDT,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.utils import (
    checkpoint as tckpt,
)

from conftest import read_letter_files

STREAM_PHASES = {"stream_feed", "device_index", "fetch", "host_views", "emit"}
CRASH = "MRI_TPU_STREAM_CRASH_AFTER_WINDOWS"


def _cfg(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("device_tokenize", True)
    kw.setdefault("stream_chunk_docs", 7)
    kw.setdefault("pad_multiple", 256)
    return tpkg.IndexConfig(**kw)


def _corpus(tmp_path, docs):
    paths = tsyn.write_corpus(tmp_path / "docs", docs)
    tman.write_manifest(tmp_path / "list.txt", paths)
    m = tpkg.read_manifest(tmp_path / "list.txt")
    tpkg.oracle_index(m, tmp_path / "oracle")
    return m, read_letter_files(tmp_path / "oracle")


def _zipf(tmp_path, **kw):
    return _corpus(tmp_path, tsyn.zipf_corpus(**kw))


def _build(m, tmp_path, name="out", **kw):
    stats = tpkg.build_index(m, _cfg(**kw), output_dir=str(tmp_path / name))
    return stats, read_letter_files(tmp_path / name)


def _crash_then_resume(m, tmp_path, monkeypatch, crash_at, **kw):
    monkeypatch.setenv(CRASH, str(crash_at))
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, _cfg(**kw), output_dir=str(tmp_path / "out"))
    monkeypatch.delenv(CRASH)
    return _build(m, tmp_path, **kw)


# -- whole builds ----------------------------------------------------------


def test_matches_the_smoke_golden(smoke_fixture, tmp_path, monkeypatch):
    monkeypatch.chdir(smoke_fixture)
    stats = tpkg.build_index(tpkg.read_manifest("manifest.txt"), _cfg(stream_chunk_docs=2),
                             output_dir=str(tmp_path))
    assert stats["stream_windows"] >= 2 and "sort_cols" in stats
    assert set(stats["phases_ms"]) == STREAM_PHASES
    assert read_letter_files(tmp_path) == read_letter_files(smoke_fixture / "golden")


@pytest.mark.parametrize("chunk", [1, 5, 1000])
def test_any_window_size_matches_the_oracle(chunk, tmp_path):
    m, want = _zipf(tmp_path, num_docs=33, vocab_size=700, tokens_per_doc=55, seed=5)
    stats, got = _build(m, tmp_path, stream_chunk_docs=chunk)
    assert got == want
    assert stats["stream_windows"] == -(-33 // chunk)
    assert stats["documents"] == 33 and stats["tokens"] == 33 * 55
    curve = stats.get("unique_rows_curve", [])
    assert len(curve) == max(stats["stream_windows"] - 2, 0) and curve == sorted(curve)
    # the CPU merges with the kernel's plain version; windows of distinct
    # documents share no row
    assert stats["stream_merge_kernel_launches"] == 0
    # and tokenizes with the tokenize kernel's plain version
    assert stats["stream_tokenize_kernel_launches"] == 0
    assert stats["stream_merge_dup_rows"] == 0


class _Tiny(TDS.DeviceStreamEngine):
    def __init__(self, **kw):
        super().__init__(**{**kw, "initial_capacity": 256, "window_pad": 256})


def test_a_small_initial_capacity_grows_and_stays_exact(tmp_path, monkeypatch):
    m, want = _zipf(tmp_path, num_docs=25, vocab_size=900, tokens_per_doc=70, seed=3)
    monkeypatch.setattr(TMI, "DeviceStreamEngine", _Tiny)
    stats, got = _build(m, tmp_path, stream_chunk_docs=3)
    assert stats["accumulator_capacity"] > 256
    assert got == want


def test_capacity_tracks_unique_rows_not_the_stream_length(tmp_path, monkeypatch):
    rng = np.random.default_rng(12)
    vocab = [b"w" + bytes([97 + i // 26, 97 + i % 26]) for i in range(50)]
    m, want = _corpus(tmp_path, [b" ".join(rng.choice(vocab, 200)) for _ in range(40)])
    monkeypatch.setattr(TMI, "DeviceStreamEngine", _Tiny)
    stats, got = _build(m, tmp_path, stream_chunk_docs=2)
    # unique pairs <= 50 words x 40 docs = 2000, against 8000 tokens fed
    assert stats["accumulator_capacity"] <= 4096
    assert got == want


@pytest.mark.parametrize("docs", [[b"", b"   ", b"123 456", b"--- !!!"], [b"42 7", b"3.14"]])
def test_empty_and_numbers_only_corpora(docs, tmp_path):
    m, _ = _corpus(tmp_path, docs)
    stats, got = _build(m, tmp_path, stream_chunk_docs=2)
    assert got == b""
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        f"{chr(97 + i)}.txt" for i in range(26)]
    # numbers are tokens without letters: their windows are fed, and the
    # finalize finds no pairs, so nothing is fetched
    assert {"stream_feed", "emit"} <= set(stats["phases_ms"])
    assert "fetch" not in stats["phases_ms"] and stats.get("unique_pairs", 0) == 0


def test_width_overflow_restarts_on_the_streaming_plan_exactly(tmp_path):
    """A too-wide token in a later window aborts the whole stream to the
    host streaming plan, byte-equal to the oracle."""
    m, want = _corpus(tmp_path, [b"early window words"] * 6 + [b"a" * 30 + b" tail", b"end"])
    stats, got = _build(m, tmp_path, stream_chunk_docs=3, device_tokenize_width=16)
    assert got == want
    assert stats["device_tokenize_fallback"].startswith("cleaned token of 30 letters")
    assert {"aborted_device_tokenize", "stream"} <= set(stats["phases_ms"])
    assert stats["stream_windows"] == 3


def test_cli_streaming_all_device_plan(tmp_path, capsys):
    m, want = _zipf(tmp_path, num_docs=9, vocab_size=200, tokens_per_doc=30, seed=4)
    assert tcli.main(["2", "2", str(tmp_path / "list.txt"), "--device", "cpu", "--stats",
                      "--device-tokenize", "--stream-chunk-docs", "4",
                      "--output-dir", str(tmp_path / "cli")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["stream_windows"] == 3 and set(stats["phases_ms"]) == STREAM_PHASES
    assert read_letter_files(tmp_path / "cli") == want


def test_a_skipped_file_is_reported_with_exit_3(tmp_path, capsys):
    paths = tsyn.write_corpus(tmp_path / "docs", [b"alpha beta", b"beta gamma", b"delta"])
    tman.write_manifest(tmp_path / "list.txt",
                        [paths[0], str(tmp_path / "gone.txt"), *paths[1:]])
    rc = tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu", "--stats",
                    "--device-tokenize", "--stream-chunk-docs", "2",
                    "--output-dir", str(tmp_path / "out")])
    assert rc == 3
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["degradation"]["skipped_docs"] == [2]
    assert (tmp_path / "out" / "b.txt").read_bytes() == b"beta:[1 3]\n"


# -- resumable stream checkpoints ------------------------------------------


def test_kill_and_resume(tmp_path, monkeypatch):
    m, want = _zipf(tmp_path, num_docs=40, vocab_size=120, tokens_per_doc=12, seed=9)
    ckpt = tmp_path / "stream.ckpt.npz"
    kw = dict(stream_chunk_docs=5, stream_checkpoint=str(ckpt), stream_checkpoint_every=2)
    monkeypatch.setenv(CRASH, "5")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, _cfg(**kw), output_dir=str(tmp_path / "out"))
    assert ckpt.exists()
    monkeypatch.delenv(CRASH)
    stats, got = _build(m, tmp_path, **kw)
    assert stats["resumed_from_window"] == 4 and stats["stream_windows"] == 8
    assert not ckpt.exists()
    assert got == want
    # an uninterrupted checkpointed run: the same bytes, two saves
    stats2, got2 = _build(m, tmp_path, "out2", **kw)
    assert "resumed_from_window" not in stats2 and got2 == want
    assert stats2["checkpoint_saves"] == 3 and len(stats2["checkpoint_ms_per_save"]) == 3


@pytest.mark.parametrize("crash_at,every", [(2, 1), (3, 2), (7, 3)])
def test_resume_at_any_crash_point(crash_at, every, tmp_path, monkeypatch):
    m, want = _zipf(tmp_path, num_docs=32, vocab_size=90, tokens_per_doc=9, seed=21)
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(tmp_path / "s.npz"),
              stream_checkpoint_every=every)
    stats, got = _crash_then_resume(m, tmp_path, monkeypatch, crash_at, **kw)
    # the last save at or before the crash, on the cadence (a save at an
    # aligned window runs before the crash hook)
    assert stats["resumed_from_window"] == (crash_at // every) * every
    assert stats["stream_windows"] == 8
    assert got == want


def test_resume_with_empty_windows(tmp_path, monkeypatch):
    """Whitespace-only windows are not fed, so the engine's window count
    lags the loop position; the checkpoint stores the loop position."""
    m, want = _corpus(tmp_path, [b"alpha beta", b"   \n  ", b" \t ", b"gamma delta",
                                 b"epsilon zeta", b"beta alpha", b"eta theta", b"iota kappa"])
    kw = dict(stream_chunk_docs=1, stream_checkpoint=str(tmp_path / "s.npz"),
              stream_checkpoint_every=2)
    stats, got = _crash_then_resume(m, tmp_path, monkeypatch, 5, **kw)
    assert stats["resumed_from_window"] == 4
    assert stats["stream_windows"] == 6
    assert got == want


@pytest.mark.parametrize("change", [{"stream_chunk_docs": 6}, {"device_tokenize_width": 64},
                                    {"pad_multiple": 512}])
def test_a_changed_stream_config_is_rejected(change, tmp_path, monkeypatch):
    m, _ = _zipf(tmp_path, num_docs=20, vocab_size=60, tokens_per_doc=10, seed=3)
    ckpt = tmp_path / "stream.ckpt.npz"
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(ckpt), stream_checkpoint_every=1)
    monkeypatch.setenv(CRASH, "3")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, _cfg(**kw), output_dir=str(tmp_path / "out"))
    monkeypatch.delenv(CRASH)
    with pytest.raises(ValueError, match="different manifest or stream config"):
        tpkg.build_index(m, _cfg(**{**kw, **change}), output_dir=str(tmp_path / "out"))
    assert ckpt.exists()


def test_a_changed_manifest_is_rejected(tmp_path, monkeypatch):
    m, _ = _zipf(tmp_path, num_docs=12, vocab_size=60, tokens_per_doc=10, seed=3)
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(tmp_path / "s.npz"),
              stream_checkpoint_every=1)
    monkeypatch.setenv(CRASH, "2")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, _cfg(**kw), output_dir=str(tmp_path / "out"))
    monkeypatch.delenv(CRASH)
    shorter = tpkg.Manifest(paths=m.paths[:-1], sizes=m.sizes[:-1])
    with pytest.raises(ValueError, match="different manifest"):
        tpkg.build_index(shorter, _cfg(**kw), output_dir=str(tmp_path / "out"))


@pytest.mark.parametrize("resume", ["strict", "auto"])
def test_a_corrupt_checkpoint(resume, tmp_path, capsys):
    m, want = _zipf(tmp_path, num_docs=12, vocab_size=60, tokens_per_doc=10, seed=7)
    ckpt = tmp_path / "s.npz"
    ckpt.write_bytes(b"PK\x03\x04 torn write")
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(ckpt), resume=resume)
    if resume == "strict":
        with pytest.raises(tckpt.CheckpointCorrupt, match="corrupt or truncated"):
            _build(m, tmp_path, **kw)
        assert ckpt.exists()
        rc = tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
                        "--device-tokenize", "--stream-chunk-docs", "4",
                        "--stream-checkpoint", str(ckpt), "--output-dir", str(tmp_path / "cli")])
        assert rc == 2 and "corrupt or truncated" in capsys.readouterr().err
        return
    stats, got = _build(m, tmp_path, **kw)
    assert stats["quarantined_checkpoint"] == str(ckpt) + ".corrupt"
    assert (tmp_path / "s.npz.corrupt").read_bytes() == b"PK\x03\x04 torn write"
    assert "resumed_from_window" not in stats and not ckpt.exists()
    assert got == want


def test_the_budget_stretches_the_cadence(tmp_path, monkeypatch):
    """An over-budget save is skipped at most MRI_TPU_CKPT_STRETCH times
    in a row, then one is forced; the bytes never change."""
    m, want = _zipf(tmp_path, num_docs=24, vocab_size=80, tokens_per_doc=10, seed=6)
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(tmp_path / "s.npz"),
              stream_checkpoint_every=1)
    # zero budget, stretch 4: cadence points are windows 1-5 (6 is the
    # last): four skips, then a forced save at window 5
    monkeypatch.setenv("MRI_TPU_CKPT_BUDGET_S", "0")
    stats, got = _build(m, tmp_path, **kw)
    assert stats["checkpoint_skips"] == 4 and len(stats["checkpoint_skipped_projection_s"]) == 4
    assert stats["checkpoint_saves"] == 1 and stats["checkpoint_budget_s"] == 0.0
    assert got == want and not (tmp_path / "s.npz").exists()
    monkeypatch.setenv("MRI_TPU_CKPT_STRETCH", "0")
    stats0, _ = _build(m, tmp_path, "out0", **kw)
    assert stats0["checkpoint_saves"] == 5 and "checkpoint_skips" not in stats0
    monkeypatch.delenv("MRI_TPU_CKPT_STRETCH")
    monkeypatch.setenv("MRI_TPU_CKPT_BUDGET_S", "3600")
    stats2, got2 = _build(m, tmp_path, "out2", **kw)
    assert stats2["checkpoint_saves"] == 5 and len(stats2["checkpoint_ms_per_save"]) == 5
    assert "checkpoint_skips" not in stats2 and got2 == want


@pytest.mark.parametrize("name,value", [("MRI_TPU_CKPT_BUDGET_S", "soon"),
                                        ("MRI_TPU_CKPT_STRETCH", "1.5"),
                                        ("MRI_TPU_STREAM_CRASH_AFTER_WINDOWS", "x")])
def test_a_malformed_knob_exits_2_naming_it(name, value, tmp_path, monkeypatch, capsys):
    _zipf(tmp_path, num_docs=4, vocab_size=20, tokens_per_doc=5, seed=1)
    monkeypatch.setenv(name, value)
    rc = tcli.main(["1", "1", str(tmp_path / "list.txt"), "--device", "cpu",
                    "--device-tokenize", "--stream-chunk-docs", "2",
                    "--stream-checkpoint", str(tmp_path / "s.npz"),
                    "--output-dir", str(tmp_path / "out")])
    assert rc == 2 and name in capsys.readouterr().err


def test_the_rows_curve_survives_a_resume(tmp_path, monkeypatch):
    m, _ = _zipf(tmp_path, num_docs=32, vocab_size=90, tokens_per_doc=9, seed=2)
    kw = dict(stream_chunk_docs=4, stream_checkpoint=str(tmp_path / "s.npz"),
              stream_checkpoint_every=2)
    resumed, _ = _crash_then_resume(m, tmp_path, monkeypatch, 5, **kw)
    whole, _ = _build(m, tmp_path, "whole", stream_chunk_docs=4)
    rc, wc = resumed["unique_rows_curve"], whole["unique_rows_curve"]
    # the window-4 save drained every merge in flight: the resumed curve
    # starts with the uninterrupted run's first four counts
    assert rc[:4] == wc[:4]
    assert rc == sorted(rc) and len(rc) >= len(wc)
    assert rc[-1] <= resumed["unique_pairs"]


def test_width_overflow_clears_the_checkpoint(tmp_path):
    m, want = _corpus(tmp_path, [b"short words here", b"also small ones",
                                 b"x" * 60 + b" overflowing token window"])
    ckpt = tmp_path / "stream.ckpt.npz"
    stats, got = _build(m, tmp_path, stream_chunk_docs=1, device_tokenize_width=48,
                        stream_checkpoint=str(ckpt), stream_checkpoint_every=1)
    assert "device_tokenize_fallback" in stats and "stream" in stats["phases_ms"]
    assert not ckpt.exists()
    assert got == want


# -- the checkpoint format, in both packages --------------------------------


def _fingerprints(tmp_path, **kw):
    t_fp = tckpt.stream_fingerprint(tpkg.read_manifest(tmp_path / "list.txt"), **kw)
    j_fp = jckpt.stream_fingerprint(jman.read_manifest(tmp_path / "list.txt"), **kw)
    return t_fp, j_fp


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path, monkeypatch):
    m, _ = _zipf(tmp_path, num_docs=20, vocab_size=90, tokens_per_doc=9, seed=8)
    ckpt = tmp_path / "s.npz"
    monkeypatch.setenv(CRASH, "3")
    with pytest.raises(RuntimeError, match="injected stream crash"):
        tpkg.build_index(m, _cfg(stream_chunk_docs=4, stream_checkpoint=str(ckpt),
                                 stream_checkpoint_every=2), output_dir=str(tmp_path / "out"))
    t_fp, j_fp = _fingerprints(tmp_path, width=48, chunk_docs=4, pad_multiple=256)
    assert t_fp == j_fp
    got, want = jckpt.load_stream_state(ckpt, j_fp), tckpt.load_stream_state(ckpt, t_fp)
    assert got["window_pos"] == want["window_pos"] == 2 and got["windows_fed"] == 2
    for k in want:
        if k != "columns":
            assert got[k] == want[k], k
    for a, b in zip(got["columns"], want["columns"], strict=True):
        np.testing.assert_array_equal(a, b)
    # the JAX engine takes it and finalizes what the port's engine does
    j_eng = JDS.DeviceStreamEngine(width=48)
    j_eng.restore(got)
    t_eng = TDS.DeviceStreamEngine(width=48, device="cpu")
    t_eng.restore(want)
    j_out, t_out = j_eng.finalize(), t_eng.finalize()
    for k in ("counts", "df", "postings"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]), err_msg=k)


def test_a_jax_checkpoint_resumes_a_port_build(tmp_path):
    """The JAX engine folds the first two windows, the JAX package saves
    the checkpoint, and the port's build resumes from it to the oracle's
    bytes."""
    m, want = _zipf(tmp_path, num_docs=20, vocab_size=90, tokens_per_doc=9, seed=8)
    j_eng = JDS.DeviceStreamEngine(width=48)
    fed = 0
    chunks = tman.iter_document_chunks(m, 4)
    for _ in range(2):
        contents, ids = next(chunks)
        total = sum(len(c) for c in contents)
        buf, ends, idv = TMI._pack_window(contents, ids, -(-total // 256) * 256)
        count, max_len = TDT.host_token_stats(buf, ends)
        j_eng.feed(buf.copy(), ends.copy(), idv.copy(), tok_count=count, max_len=max_len)
        fed += count
    ckpt = tmp_path / "s.npz"
    _, j_fp = _fingerprints(tmp_path, width=48, chunk_docs=4, pad_multiple=256)
    snap = j_eng.snapshot()
    jckpt.save_stream_state(ckpt, {**snap, "columns": [np.asarray(c) for c in snap["columns"]]},
                            fed, 2, j_fp)
    stats, got = _build(m, tmp_path, stream_chunk_docs=4, stream_checkpoint=str(ckpt))
    assert stats["resumed_from_window"] == 2 and stats["stream_windows"] == 5
    assert stats["tokens"] == 20 * 9
    assert got == want and not ckpt.exists()
