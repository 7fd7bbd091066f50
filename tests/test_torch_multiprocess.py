"""The port's multi-process mesh on the CPU: 2 OS processes joined in a
gloo group by ``parallel/distributed.initialize``, each holding 2 of a
mesh's 4 positions (``parallel/mesh.py``).

Here: the backend rule as a pure function and the placement rule; the
collectives of the 2-process mesh against the single-process mesh's on
seeded inputs; the overflow retry forced in both processes; and the
refusals of a global assembly on a mesh that is not all local, with the
JAX package's message.  The twins of the JAX package's four 2-process
tests (``tests/test_distributed.py``) are in
``test_torch_multiprocess_twins*.py`` and use this file's launcher and
worker sources.
"""

import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from parallel_computation_of_an_inverted_index_using_map_reduce_tpu.parallel import (
    dist_engine as jdist_engine,
)
from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.parallel import (
    dist_engine as tdist_engine,
    distributed as tdistributed,
    mesh as M,
)

from conftest import REPO_ROOT

CHILD_TIMEOUT_S = 120
TPKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"


def jax_global_refusal() -> str:
    """The JAX package's global-assembly refusal, raised by its
    ``assemble_postings`` on an array with a shard this process cannot
    see."""
    partial = types.SimpleNamespace(addressable_shards=[],
                                    sharding=types.SimpleNamespace(num_devices=2))
    with pytest.raises(RuntimeError) as err:
        jdist_engine.assemble_postings(partial, 1, 1, np.zeros(1, np.int64), 0)
    return str(err.value)


def free_port() -> int:
    """The JAX tests' pattern: a port the kernel just handed out."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_pair(tmp_path: Path, name: str, src: str, *args: str, env_extra=None):
    """Start 2 processes of ``src`` (argv: repo, process id, coordinator
    address, then ``args``); returns the started processes."""
    worker = tmp_path / f"{name}.py"
    worker.write_text(src)
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "2", **(env_extra or {})}
    return [subprocess.Popen([sys.executable, str(worker), str(REPO_ROOT), str(pid), coord,
                              *map(str, args)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in (0, 1)]


def finish(procs) -> list[tuple[str, str]]:
    """Wait for every process (each killed past CHILD_TIMEOUT_S) and
    assert each exited 0; returns their (stdout, stderr)."""
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:  # no orphan holds the coordinator's port
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    return outs


def jax_pair(tmp_path: Path, name: str, src: str, *args: str):
    """The JAX package's 2-process workers, as its own tests start them
    (2 virtual CPU devices each)."""
    return start_pair(tmp_path, name, src, *args, env_extra={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2", "JAX_PLATFORMS": "cpu"})


PRELUDE = textwrap.dedent(f"""
    import sys
    repo, pid, coord = sys.argv[1:4]
    args = sys.argv[4:]
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from {TPKG}.parallel import distributed
    distributed.initialize(coordinator_address=coord, num_processes=2,
                           process_id=int(pid))
""")

# -- the port's twins of the JAX package's four 2-process workers ---------

WORKER = PRELUDE + textwrap.dedent(f"""
    corpus_dir, out_dir = args
    from {TPKG}.corpus.manifest import load_documents, manifest_from_dir
    from {TPKG}.corpus.scheduler import plan_letter_ranges
    from {TPKG}.ops import engine, keys as K
    from {TPKG}.parallel import dist_engine
    from {TPKG}.parallel.mesh import make_mesh, shard
    from {TPKG}.text import formatter
    from {TPKG}.text.tokenizer import tokenize_documents

    info = distributed.runtime_info()
    assert info["process_count"] == 2 and info["backend"] == "gloo", info

    # every process tokenizes the same corpus; each uploads only its
    # own positions' slices
    m = manifest_from_dir(corpus_dir)
    contents, ids = load_documents(m)
    corpus = tokenize_documents(contents, ids)
    stride = len(m) + 2
    keys = np.unique(corpus.term_ids.astype(np.int64) * stride + corpus.doc_ids)
    df = np.bincount((keys // stride).astype(np.int64),
                     minlength=corpus.vocab_size).astype(np.int64)
    order, _ = engine.host_order_offsets(corpus.letter_of_term, df)

    n = 4
    padded = -(-keys.size // n) * n
    buf = np.full(padded, K.INT32_MAX, dtype=np.int32)
    buf[: keys.size] = keys
    mesh = make_mesh(n, "cpu")

    ranges = plan_letter_ranges(n)
    owner_of_letter = np.zeros(26, dtype=np.int32)
    for o, (lo, hi) in enumerate(ranges):
        owner_of_letter[lo:hi] = o
    owner_of_term = owner_of_letter[np.asarray(corpus.letter_of_term)]

    rows = dist_engine.dist_letter_windows([shard(buf, mesh)], owner_of_term,
                                           stride=stride, mesh=mesh)
    local_owner_ids = sorted(rows)
    assert local_owner_ids == list(mesh.local_positions), local_owner_ids
    for o, row in sorted(rows.items()):
        df_o = np.where(owner_of_term == o, df, 0)
        offsets_local = np.cumsum(df_o) - df_o
        postings_o = dist_engine.merge_owner_runs([row], stride, offsets_local,
                                                  int(df_o.sum()))
        formatter.emit_index(
            out_dir, vocab=corpus.vocab, letter_of_term=corpus.letter_of_term, order=order,
            df=df, offsets=offsets_local, postings=postings_o, max_doc_id=len(m),
            letter_range=ranges[o])
    print(f"proc {{pid}} emitted owners {{local_owner_ids}}", flush=True)
""")

DEVTOK_WORKER = PRELUDE + textwrap.dedent(f"""
    corpus_dir, out_dir = args
    import pathlib
    from {TPKG}.corpus.manifest import iter_document_ranges, manifest_from_dir
    from {TPKG}.corpus.scheduler import plan_contiguous_windows
    from {TPKG}.ops import device_tokenizer as DT
    from {TPKG}.parallel import dist_device_tokenizer as DDT
    from {TPKG}.parallel.mesh import make_mesh

    n = 4
    mesh = make_mesh(n, "cpu")
    width = 48
    m = manifest_from_dir(corpus_dir)
    shards = list(iter_document_ranges(m, plan_contiguous_windows(m, n)))
    shard_len = max(max(sum(len(b) for b in c) for c, _ in shards), 1)
    shard_len = -(-shard_len // 256) * 256
    docs_cap = max(max(len(c) for c, _ in shards), 1)
    bufs, ends_l, ids_l = [], [], []
    tok_count = host_max_len = 0
    for contents, ids in shards:
        buf = np.full(shard_len, 0x20, np.uint8)
        nb = 0
        ends = np.full(docs_cap, shard_len, np.int64)
        idv = np.full(docs_cap, 1, np.int32)
        for j, (c, i) in enumerate(zip(contents, ids)):
            buf[nb:nb + len(c)] = np.frombuffer(c, np.uint8)
            nb += len(c)
            ends[j] = nb
            idv[j] = i
        cnt, ml = DT.host_token_stats(buf, ends)
        tok_count = max(tok_count, cnt)
        host_max_len = max(host_max_len, ml)
        bufs.append(buf)
        ends_l.append(ends.astype(np.int32))
        ids_l.append(idv)
    tok_cap = -(-(tok_count + 1) // (1 << 14)) * (1 << 14)
    sort_cols = -(-max(host_max_len, 1) // 4)

    owners, (max_len, retries) = DDT.index_bytes_dist(
        bufs, ends_l, ids_l, width=width, tok_cap=tok_cap, mesh=mesh,
        sort_cols=sort_cols, max_doc_id=len(m))
    assert max_len == host_max_len, (max_len, host_max_len)
    got = sorted(owners)
    assert got == sorted(DDT._local_mesh_positions(mesh)), got
    for o, ow in owners.items():
        words = DT.decode_word_groups(ow["unique_groups"], width)
        np.savez(pathlib.Path(out_dir) / f"owner{{o}}.npz",
                 words=words, df=ow["df"], postings=ow["postings"])
    print(f"proc {{pid}} fetched owners {{got}}", flush=True)
""")

DEVTOK_LETTER_WORKER = PRELUDE + textwrap.dedent(f"""
    corpus_dir, out_dir = args
    from {TPKG} import IndexConfig, InvertedIndexModel
    from {TPKG}.corpus.manifest import manifest_from_dir

    m = manifest_from_dir(corpus_dir)
    report = InvertedIndexModel(IndexConfig(
        device="cpu", device_tokenize=True, device_shards=4,
        emit_ownership="letter", pad_multiple=256,
        output_dir=out_dir)).run(m)
    print(f"proc {{pid}} letter_owners={{report['letter_owners']}} "
          f"lines={{report['lines_written']}}", flush=True)
    print(f"proc {{pid}} dist_sent_bytes={{report['dist_sent_bytes']}}", flush=True)
""")

DEVSTREAM_WORKER = PRELUDE + textwrap.dedent(f"""
    corpus_dir, out_dir = args
    import pathlib
    from {TPKG}.corpus.manifest import iter_document_chunks, manifest_from_dir
    from {TPKG}.corpus.scheduler import plan_contiguous_ranges
    from {TPKG}.ops import device_tokenizer as DT
    from {TPKG}.parallel import dist_device_streaming as DDS, dist_device_tokenizer as DDT
    from {TPKG}.parallel.mesh import make_mesh

    n = 4
    mesh = make_mesh(n, "cpu")
    width = 48
    # a tiny initial capacity forces regrows across the processes' accumulators
    m = manifest_from_dir(corpus_dir)
    eng = DDS.DistDeviceStreamEngine(width=width, mesh=mesh, window_pad=1 << 10,
                                     initial_capacity=32)
    for contents, ids in iter_document_chunks(m, 8):
        ranges_c = plan_contiguous_ranges([len(c) for c in contents], n)
        parts = [(contents[lo:hi], ids[lo:hi]) for lo, hi in ranges_c]
        shard_len = max(max((sum(len(c) for c in cs) for cs, _ in parts), default=1), 1)
        shard_len = -(-shard_len // 256) * 256
        docs_cap = max(max(len(c) for c, _ in parts), 1)
        bufs, ends_l, ids_l = [], [], []
        tok_count = max_len = 0
        for contents_s, ids_s in parts:
            buf = np.full(shard_len, 0x20, np.uint8)
            nb = 0
            ends = np.full(docs_cap, shard_len, np.int32)
            idv = np.full(docs_cap, 1, np.int32)
            for j, (c, i) in enumerate(zip(contents_s, ids_s)):
                buf[nb:nb + len(c)] = np.frombuffer(c, np.uint8)
                nb += len(c)
                ends[j] = nb
                idv[j] = i
            cnt, ml = DT.host_token_stats(buf, ends)
            tok_count = max(tok_count, cnt)
            max_len = max(max_len, ml)
            bufs.append(buf)
            ends_l.append(ends)
            ids_l.append(idv)
        assert max_len <= width
        eng.feed(bufs, ends_l, ids_l, tok_count=tok_count, max_len=max_len)

    sort_cols = -(-max(eng.max_word_len, 1) // 4)
    owners = eng.finalize(sort_cols=sort_cols, max_doc_id=len(m))
    got = sorted(owners)
    assert got == sorted(DDT._local_mesh_positions(mesh)), got
    for o, ow in owners.items():
        words = DT.decode_word_groups(ow["unique_groups"], width)
        np.savez(pathlib.Path(out_dir) / f"owner{{o}}.npz",
                 words=words, df=ow["df"], postings=ow["postings"])
    print(f"proc {{pid}} stream owners {{got}} windows {{eng.windows_fed}} "
          f"cap {{eng.capacity}}", flush=True)
""")


def same_owner_blocks(a: Path, b: Path) -> None:
    """Every owner*.npz of ``a`` and ``b``, array for array."""
    names = sorted(p.name for p in a.glob("owner*.npz"))
    assert names == sorted(p.name for p in b.glob("owner*.npz")) and names
    for name in names:
        x, y = np.load(a / name), np.load(b / name)
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (name, k)


# -- the backend and placement rules ---------------------------------------


@pytest.mark.parametrize("procs,cards,want", [
    (2, 1, "gloo"), (1, 1, "nccl"), (1, 0, "gloo"), (2, 0, "gloo"), (4, 4, "nccl"),
    (4, 2, "gloo"), (1, 8, "nccl"), (2, 8, "nccl")])
def test_backend_rule(procs, cards, want):
    assert tdistributed.choose_backend(procs, cards) == want


@pytest.mark.parametrize("local_rank,local_count,cards,want", [
    (0, 1, 4, [0, 1, 2, 3]), (0, 2, 1, [0]), (1, 2, 1, [0]), (0, 2, 2, [0]), (1, 2, 2, [1]),
    (1, 2, 4, [2, 3]), (2, 3, 2, [0])])
def test_card_block(local_rank, local_count, cards, want):
    assert tdistributed.card_block(local_rank, local_count, cards) == want


def _joined(monkeypatch, rank, world, local_rank, local_count, backend, cards):
    topo = tdistributed.Topology(rank, world, local_rank, local_count, backend)
    monkeypatch.setattr(tdistributed, "topology", lambda: topo)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)


def test_placement_in_a_group(monkeypatch):
    """Process p holds positions [p*n/P, (p+1)*n/P); two processes share
    a card only when there are more processes than cards."""
    _joined(monkeypatch, 1, 2, 1, 2, "gloo", 1)
    mesh = M.make_mesh(4, "cuda")
    assert (mesh.size, mesh.first, list(mesh.local_positions)) == (4, 2, [2, 3])
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:0"] and not mesh.all_local
    _joined(monkeypatch, 1, 2, 1, 2, "nccl", 2)
    assert [str(d) for d in M.make_mesh(4, "cuda").devices] == ["cuda:1", "cuda:1"]
    _joined(monkeypatch, 0, 1, 0, 1, "nccl", 1)
    mesh = M.make_mesh(4, "cuda")
    assert mesh.all_local and mesh.backend == "nccl" and len(mesh.devices) == 4
    _joined(monkeypatch, 0, 2, 0, 2, "gloo", 1)
    with pytest.raises(ValueError, match="cannot be split over 2 processes"):
        M.make_mesh(3, "cuda")
    # the serving engine's batch mesh stays in this process
    assert M.local_mesh(4, "cuda").all_local


def test_no_group_mesh_is_unchanged():
    mesh = M.make_mesh(4, "cpu")
    assert (mesh.size, mesh.first, mesh.backend, mesh.all_local) == (4, 0, None, True)
    assert tdistributed.topology() is None


@pytest.mark.parametrize("backend,want", [("nccl", "cpu:gloo,cuda:nccl"), ("gloo", "gloo")])
def test_group_backend(backend, want):
    assert tdistributed.group_backend(backend) == want


def test_nccl_group_runs_a_host_mesh_through_gloo(monkeypatch):
    """A group whose rule picks NCCL (one process, one card) is created
    with gloo beside NCCL, so a mesh on the CPU in that group runs its
    collectives.  The card is faked and only the group's host half is
    created (this torch has no NCCL)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda card: None)
    monkeypatch.setattr(tdistributed, "_topology", None)
    made = {}
    real_init = dist.init_process_group

    def init(backend, **kwargs):
        made.update(backend=backend, device_id=kwargs.pop("device_id", None))
        real_init(",".join(b for b in backend.split(",") if b.startswith("cpu:")), **kwargs)

    monkeypatch.setattr(dist, "init_process_group", init)
    tdistributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert made == {"backend": "cpu:gloo,cuda:nccl", "device_id": torch.device("cuda", 0)}
        assert tdistributed.runtime_info()["backend"] == "nccl"
        mesh = M.make_mesh(2, "cpu")
        assert mesh.backend == "nccl" and mesh.all_local
        rng = np.random.default_rng(23)
        host = [rng.integers(-50, 50, (3, 5)) for _ in range(2)]
        parts = [torch.from_numpy(h) for h in host]
        np.testing.assert_array_equal(M.psum(parts, mesh).numpy(), host[0] + host[1])
        np.testing.assert_array_equal(M.pmax(parts, mesh).numpy(), np.maximum(*host))
        np.testing.assert_array_equal(M.gather_host(parts, mesh), np.stack(host))
        assert M.agree_max([3, 9], mesh) == [3, 9]
    finally:
        dist.destroy_process_group()


def test_global_assembly_refusal_is_the_jax_message(monkeypatch):
    _joined(monkeypatch, 0, 2, 0, 2, "gloo", 1)
    mesh = M.make_mesh(4, "cpu")
    want = jax_global_refusal()
    with pytest.raises(RuntimeError) as err:
        tdist_engine.require_all_local(mesh, "global")
    assert str(err.value) == want
    with pytest.raises(RuntimeError) as err:
        tdist_engine.require_all_local(mesh, "merged")
    assert str(err.value) == want.replace("global", "merged", 1)


# -- the collectives and the engines in 2 processes --------------------------

COLLECTIVES_WORKER = PRELUDE + textwrap.dedent(f"""
    out_dir, corpus_dir = args
    import json, pathlib
    from {TPKG}.ops import keys as K
    from {TPKG}.parallel import dist_engine
    from {TPKG}.parallel import mesh as M

    n = 4
    mesh = M.make_mesh(n, "cpu")
    mine = list(mesh.local_positions)
    rng = np.random.default_rng(2024)
    sends = [rng.integers(-2**31, 2**31 - 1, size=(n, 6), dtype=np.int32) for _ in range(n)]
    wide = [rng.integers(0, 255, size=(n, 3, 5), dtype=np.uint8) for _ in range(n)]
    parts = [rng.integers(-1000, 1000, size=7, dtype=np.int32) for _ in range(n)]
    out = {{}}
    got = M.all_to_all([torch.from_numpy(sends[i]) for i in mine], mesh)
    got_wide = M.all_to_all([torch.from_numpy(wide[i]) for i in mine], mesh)
    for j, i in enumerate(mine):
        out[f"a2a_{{i}}"] = got[j].numpy()
        out[f"a2a_wide_{{i}}"] = got_wide[j].numpy()
    tp = [torch.from_numpy(parts[i]) for i in mine]
    out["psum"] = M.psum(tp, mesh).numpy()
    out["pmax"] = M.pmax(tp, mesh).numpy()
    out["gather"] = M.gather_host(tp, mesh)

    # a letter exchange on skewed keys at capacity factor 0.25: the
    # overflow flag is reduced over both processes, so both retry
    keys = np.sort(rng.choice(60 * 200, size=1500, replace=False)).astype(np.int32)
    owner_of_term = (np.arange(60) * 7 // 60).astype(np.int32) % n
    owner_of_term[:40] = 0  # most terms on owner 0: its buckets overflow
    padded = -(-keys.size // n) * n
    buf = np.full(padded, K.INT32_MAX, np.int32)
    buf[: keys.size] = keys
    stats = {{}}
    rows = dist_engine.dist_letter_windows([M.shard(buf, mesh)], owner_of_term, stride=200,
                                           mesh=mesh, capacity_factor=0.25, stats=stats)
    for o, r in rows.items():
        out[f"rows_{{o}}"] = r
    np.savez(pathlib.Path(out_dir) / f"proc{{pid}}.npz", **out)

    # the global assemblies refuse, with the JAX text
    refusals = []
    try:
        dist_engine.dist_index([M.shard(buf, mesh)], torch.zeros(60, dtype=torch.int32),
                               vocab_size=60, max_doc_id=198, mesh=mesh)
    except RuntimeError as e:
        refusals.append(str(e))
    from {TPKG} import IndexConfig, InvertedIndexModel
    from {TPKG}.corpus.manifest import manifest_from_dir
    # every merged mesh plan: pipelined, streaming, all-device, both
    for plan in ({{}}, {{"stream_chunk_docs": 5}}, {{"device_tokenize": True}},
                 {{"device_tokenize": True, "stream_chunk_docs": 5}}):
        try:
            InvertedIndexModel(IndexConfig(device="cpu", device_shards=4, output_dir=out_dir,
                                           **plan)).run(manifest_from_dir(corpus_dir))
        except RuntimeError as e:
            refusals.append(str(e))
    print(json.dumps({{"owners": sorted(rows), "stats": stats, "refusals": refusals,
                      "sent_bytes": mesh.sent_bytes, "info": distributed.runtime_info()}}),
          flush=True)
""")


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """One 2-process run of COLLECTIVES_WORKER and the single-process
    mesh's answers on the same seeded inputs."""
    import json

    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
        synthetic as tsyn,
    )

    tmp = tmp_path_factory.mktemp("collectives")
    tsyn.write_corpus(tmp / "docs", tsyn.zipf_corpus(num_docs=12, vocab_size=80,
                                                   tokens_per_doc=20, seed=5))
    outs = finish(start_pair(tmp, "collectives", COLLECTIVES_WORKER, tmp, tmp / "docs"))
    reports = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    got = [dict(np.load(tmp / f"proc{p}.npz")) for p in (0, 1)]
    return reports, got


def _single_process():
    """The same seeded inputs through the mesh of one process."""
    from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
        keys as K,
    )

    n = 4
    mesh = M.make_mesh(n, "cpu")
    rng = np.random.default_rng(2024)
    sends = [rng.integers(-2**31, 2**31 - 1, size=(n, 6), dtype=np.int32) for _ in range(n)]
    wide = [rng.integers(0, 255, size=(n, 3, 5), dtype=np.uint8) for _ in range(n)]
    parts = [rng.integers(-1000, 1000, size=7, dtype=np.int32) for _ in range(n)]
    tp = [torch.from_numpy(p) for p in parts]
    want = {f"a2a_{i}": t.numpy() for i, t in
            enumerate(M.all_to_all([torch.from_numpy(s) for s in sends], mesh))}
    want.update({f"a2a_wide_{i}": t.numpy() for i, t in
                 enumerate(M.all_to_all([torch.from_numpy(s) for s in wide], mesh))})
    want.update(psum=M.psum(tp, mesh).numpy(), pmax=M.pmax(tp, mesh).numpy(),
                gather=M.gather_host(tp, mesh))
    keys = np.sort(rng.choice(60 * 200, size=1500, replace=False)).astype(np.int32)
    owner_of_term = (np.arange(60) * 7 // 60).astype(np.int32) % n
    owner_of_term[:40] = 0
    padded = -(-keys.size // n) * n
    buf = np.full(padded, K.INT32_MAX, np.int32)
    buf[: keys.size] = keys
    stats = {}
    rows = tdist_engine.dist_letter_windows([M.shard(buf, mesh)], owner_of_term, stride=200,
                                            mesh=mesh, capacity_factor=0.25, stats=stats)
    want.update({f"rows_{o}": r for o, r in rows.items()})
    # the most keys one source sends one owner, against the capacity at 0.25
    sources = buf.reshape(n, -1)
    most = max(int(np.sum(owner_of_term[src[src < K.INT32_MAX] // 200] == o))
               for src in sources for o in range(n))
    stats["most_in_a_bucket"] = most
    stats["capacity"] = tdist_engine.default_capacity(padded // n, n, 0.25)
    stats["sent_bytes"] = mesh.sent_bytes
    return want, stats


def test_collectives_equal_the_single_process_mesh(collectives):
    reports, got = collectives
    want, _ = _single_process()
    for p, proc in enumerate(got):
        mine = (2 * p, 2 * p + 1)
        for i in mine:
            np.testing.assert_array_equal(proc[f"a2a_{i}"], want[f"a2a_{i}"])
            np.testing.assert_array_equal(proc[f"a2a_wide_{i}"], want[f"a2a_wide_{i}"])
        for k in ("psum", "pmax", "gather"):  # the same array in every process
            np.testing.assert_array_equal(proc[k], want[k])
    assert [r["info"]["backend"] for r in reports] == ["gloo", "gloo"]
    assert [r["info"]["process_index"] for r in reports] == [0, 1]


def test_overflow_retry_finishes_in_both_processes(collectives):
    reports, got = collectives
    want, stats = _single_process()
    assert stats["most_in_a_bucket"] > stats["capacity"]  # the first exchange overflows
    assert [r["owners"] for r in reports] == [[0, 1], [2, 3]]
    for p, proc in enumerate(got):
        for o in (2 * p, 2 * p + 1):
            np.testing.assert_array_equal(proc[f"rows_{o}"], want[f"rows_{o}"])
    # the local counts of both processes add up to the one process's
    assert sum(r["stats"]["dist_valid_pairs"] for r in reports) == stats["dist_valid_pairs"]
    assert all(r["sent_bytes"] > 0 for r in reports)
    assert stats["sent_bytes"] == 0  # no group: nothing crosses a process


def test_global_assemblies_refuse_in_two_processes(collectives):
    reports, _ = collectives
    want = jax_global_refusal()
    merged = want.replace("global", "merged", 1)
    for r in reports:
        assert r["refusals"] == [want, merged, merged, merged, merged]
