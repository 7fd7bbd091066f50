#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (exit 1, no result line):

1. The card (``nvidia-smi`` name and power limit) and the kernels' build
   from ``csrc/`` with nvcc (time and ptxas report).
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, exact equality, at the main path's shapes, ragged sizes,
   all-padding and dense runs; then CUDA-event times of the kernel, the
   plain version and (histogram only) ``torch.bincount``, beside the
   least time the card could take (bytes over 3.35 TB/s, or operations
   over 67 T/s, whichever is larger).  Each time is the median of five
   CUDA-event means, printed with its min and max, each taken after a
   device spin so that the host's enqueue is not what is timed.
   ``bucket_histogram`` is checked on misaligned views, ``n % 4`` in
   {1, 2, 3} and 1 to 128 buckets, and timed at both of Path B's launches
   (26 letters, 2 hash buckets) and on one-hot ids (a contention probe).
   Then the warm device time of the engine program each path runs
   (index_u16, index_packed) at that path's shape.
3. Path A — the reference envelope, u16 engine: a 355-doc,
   33,000-word-vocab Zipf corpus (~1.03 M tokens) through the CLI
   (``4 26 list.txt --stats``); letter-file md5 equal to the oracle's.
4. Path B — the packed engine at BASELINE.json config 4's vocabulary
   (100,000 words) with 20,000 docs (20 M tokens), ``--skew``; md5 equal
   to the same build with ``--device cpu``.  The card's run is recorded by
   torch.profiler (device activity only), which gives the device-busy
   time and the idle share of the run's wall time.

Both paths go through ``cli.main``, the function behind
``python -m parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch``,
in this process, so the kernels' launch counts are read around each
run.  The last lines are the card, one ``{"kernels": [...]}`` JSON line,
and ``{"ok": true, "device": {...}}``.  Exits non-zero without those on
a machine with no CUDA device, or when the package is not beside this
script.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
JAX_KERNELS = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu/ops/pallas/kernels.py"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12     # 32-bit ops on the CUDA cores (fp32 non-tensor peak)
INT32_MAX = 2**31 - 1


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


HOLD_CYCLES = 100_000_000  # ~50 ms of device spin at the H100's clocks


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3, repeats: int = 5
            ) -> tuple[float, float, float]:
    """Device time of one ``fn`` call in ms, by CUDA events: the mean over
    ``iters`` calls, taken ``repeats`` times; returns (median, min, max).
    The device spins first, so the host has queued every call before the
    first starts and the time is the device's, not the enqueue's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    runs.sort()
    return runs[len(runs) // 2], runs[0], runs[-1]


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zipf_ids(torch, n: int, vocab: int, gen, alpha: float = 1.2):
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device="cuda")
    cdf = torch.cumsum(ranks ** (-alpha), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device="cuda", generator=gen)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1).to(torch.int32)


def sorted_keys(torch, n: int, n_valid: int, vocab: int, max_doc: int, gen):
    """Ascending packed keys as the engine sorts them: Zipf terms,
    uniform docs, INT32_MAX padding."""
    term = zipf_ids(torch, n_valid, vocab, gen)
    doc = torch.randint(1, max_doc + 1, (n_valid,), device="cuda", generator=gen,
                        dtype=torch.int32)
    keys = torch.full((n,), INT32_MAX, dtype=torch.int32, device="cuda")
    keys[:n_valid] = term * (max_doc + 2) + doc
    return torch.sort(keys).values


def phase_kernels(torch, K, shapes) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []

    # -- unique_mask_count -------------------------------------------------
    err = 0

    def cmp_unique(keys, limit, label):
        nonlocal err
        mask, count = K.unique_mask_count(keys, limit)
        pmask, pcount = K.unique_mask_count_plain(keys, limit)
        torch.cuda.synchronize()
        bad = int((mask != pmask).sum()) + abs(int(count) - int(pcount))
        err = max(err, bad)
        check(bad == 0, f"unique_mask_count != plain on {label}: {bad} differences")

    a_n, a_valid, a_vocab, a_docs = shapes["A"]
    b_n, b_valid, b_vocab, b_docs = shapes["B"]
    keys_a = sorted_keys(torch, a_n, a_valid, a_vocab, a_docs, gen)
    keys_b = sorted_keys(torch, b_n, b_valid, b_vocab, b_docs, gen)
    limit_a = a_vocab * (a_docs + 2)
    limit_b = b_vocab * (b_docs + 2)
    cmp_unique(keys_a, limit_a, f"path A shape n={a_n}")
    cmp_unique(keys_b, limit_b, f"path B shape n={b_n}")
    for n in (1, 8191, 1_000_003):
        cmp_unique(sorted_keys(torch, n, n - n // 7, 5000, 355, gen), 5000 * 357, f"ragged n={n}")
    cmp_unique(torch.full((8192,), INT32_MAX, dtype=torch.int32, device="cuda"), 100,
               "all padding")
    dense = torch.repeat_interleave(
        torch.arange(64, dtype=torch.int32, device="cuda") * 7, 3 * 8192 // 64)
    cmp_unique(dense, 1 << 30, "dense runs")
    mask, count = K.unique_mask_count(torch.empty(0, dtype=torch.int32, device="cuda"), 5)
    check(mask.numel() == 0 and int(count) == 0, "unique_mask_count n=0 not (empty, 0)")

    ms, lo, hi = cuda_ms(torch, lambda: K.unique_mask_count(keys_b, limit_b))
    plain_ms = cuda_ms(torch, lambda: K.unique_mask_count_plain(keys_b, limit_b))[0]
    b_ms, b_by = bound(5 * b_n + 4, 4 * b_n)
    results.append({
        "name": "unique_mask_count", "route": "cuda",
        "source": f"{PKG}/csrc/unique_mask_count.cu",
        "replaces": f"{JAX_KERNELS}:124", "n": b_n,
        "max_abs_err": err, "parity": err == 0, "ms": ms, "kernel_ms": ms,
        "ms_min": lo, "ms_max": hi,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })

    # -- bucket_histogram --------------------------------------------------
    err = 0

    def cmp_hist(values, nb, label):
        nonlocal err
        got = K.bucket_histogram(values, nb)
        want = K.bucket_histogram_plain(values, nb)
        torch.cuda.synchronize()
        bad = int((got - want).abs().max())
        err = max(err, bad)
        check(bad == 0, f"bucket_histogram != plain on {label}: max err {bad}")

    terms = zipf_ids(torch, b_valid, b_vocab, gen)
    letter_of_term = torch.randint(0, 26, (b_vocab,), device="cuda", generator=gen,
                                   dtype=torch.int32)
    letters = letter_of_term[terms.long()]
    buckets = terms % 2
    one_hot = torch.full((b_valid,), 5, dtype=torch.int32, device="cuda")
    cmp_hist(letters, 26, f"path B letters n={b_valid}")
    cmp_hist(buckets, 2, f"path B hash buckets n={b_valid}")
    cmp_hist(one_hot, 26, f"one hot n={b_valid}")
    mixed = torch.randint(-3, 128 + 3, (1_000_003,), device="cuda", generator=gen,
                          dtype=torch.int32)
    for nb in (1, 2, 8, 26, 32, 33, 127, 128):
        cmp_hist(mixed % (nb + 6) - 3, nb, f"out-of-range mix nb={nb}")
    for offset in (1, 2, 3):  # views that start 4, 8, 12 bytes past a 16-byte boundary
        cmp_hist(letters[offset:], 26, f"letters[{offset}:]")
        cmp_hist(mixed[offset:offset + 4097], 33, f"mixed[{offset}:{offset + 4097}] nb=33")
    for n in (1, 2, 3, 5, 6, 7, 8191, 8193, 8194, 8195):  # n % 4 in {1, 2, 3}
        cmp_hist(torch.randint(-2, 28, (n,), device="cuda", generator=gen,
                               dtype=torch.int32), 26, f"ragged n={n}")
    cmp_hist(letters[::3], 26, "strided letters[::3]")
    cmp_hist(torch.full((8192,), 26, dtype=torch.int32, device="cuda"), 26, "all padding")
    cmp_hist(torch.full((3 * 8192,), 5, dtype=torch.int32, device="cuda"), 26, "one hot bucket")

    # Path B's two launches (letters, hash buckets), then one-hot ids as a
    # contention probe; each beside its plain version and torch.bincount.
    hist_shapes = []
    for label, values, nb in (("letters", letters, 26), ("hash_buckets", buckets, 2),
                              ("one_hot", one_hot, 26)):
        ms, lo, hi = cuda_ms(torch, lambda: K.bucket_histogram(values, nb))
        shape = {"label": label, "n": b_valid, "num_buckets": nb, "ms": ms,
                 "ms_min": lo, "ms_max": hi}
        shape["plain_ms"] = cuda_ms(torch, lambda: K.bucket_histogram_plain(values, nb))[0]
        shape["library_ms"] = cuda_ms(torch, lambda: torch.bincount(values, minlength=nb))[0]
        shape["bound_ms"], shape["bound_by"] = bound(4 * b_valid + 4 * nb, 2 * b_valid)
        hist_shapes.append(shape)
    main_shape = hist_shapes[0]
    results.append({
        "name": "bucket_histogram", "route": "cuda",
        "source": f"{PKG}/csrc/bucket_histogram.cu",
        "replaces": f"{JAX_KERNELS}:183", "n": b_valid, "num_buckets": 26,
        "max_abs_err": err, "parity": err == 0,
        "ms": main_shape["ms"], "kernel_ms": main_shape["ms"],
        "ms_min": main_shape["ms_min"], "ms_max": main_shape["ms_max"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": main_shape["library_ms"],
        "shapes": hist_shapes,
    })
    return results


def phase_engine(torch, E, shapes) -> dict:
    """Warm device time of the engine program each path runs, at its
    shape: index_u16 at Path A's, index_packed at Path B's."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    a_n, a_valid, a_vocab, a_docs = shapes["A"]
    pad = torch.full((a_n - a_valid,), 0xFFFF, dtype=torch.int32, device="cuda")
    terms = torch.cat([zipf_ids(torch, a_valid, a_vocab, gen), pad])
    docs = torch.cat([torch.randint(1, a_docs + 1, (a_valid,), device="cuda", generator=gen,
                                    dtype=torch.int32), pad])
    feed = torch.cat([terms, docs]).to(torch.int16)  # the uint16 feed's bits
    u16 = cuda_ms(torch, lambda: E.index_u16(feed, vocab_size=a_vocab, max_doc_id=a_docs),
                  iters=10)
    b_n, b_valid, b_vocab, b_docs = shapes["B"]
    keys = sorted_keys(torch, b_n, b_valid, b_vocab, b_docs, gen)
    keys = keys[torch.randperm(b_n, device="cuda", generator=gen)]
    letters = torch.randint(0, 26, (b_vocab,), device="cuda", generator=gen, dtype=torch.int32)
    packed = cuda_ms(torch, lambda: E.index_packed(keys, letters, vocab_size=b_vocab,
                                                   max_doc_id=b_docs), iters=10)
    return {"index_u16_ms": u16, "index_packed_ms": packed}


def device_busy_ms(trace_path: Path) -> float | None:
    """Summed duration of the kernels, copies and fills in a
    torch.profiler Chrome trace (None when the trace holds none)."""
    events = json.loads(trace_path.read_text()).get("traceEvents", [])
    durs = [e.get("dur", 0) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sum(durs) / 1e3 if durs else None


def run_cli(cli, argv: list[str]) -> tuple[int, dict | None]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


def write_corpus_dir(synthetic, manifest_mod, root: Path, docs) -> Path:
    paths = synthetic.write_corpus(root / "docs", docs)
    list_path = root / "list.txt"
    manifest_mod.write_manifest(list_path, paths)
    return list_path


def drive_path(torch, K, cli, formatter, list_path: Path, out_dir: Path, extra: list[str],
               label: str, trace: Path | None = None) -> tuple[dict, dict]:
    """One counted run of the main path: counts set to 0 just before,
    read just after.  With ``trace``, the run is recorded by
    torch.profiler (device activity only) and its device-busy time
    summed from the trace."""
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    profiler = None
    t0 = time.perf_counter()
    if trace is not None:
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        profiler.start()
    t1 = time.perf_counter()
    rc, stats = run_cli(cli, ["4", "26", str(list_path), "--stats",
                              "--output-dir", str(out_dir), *extra])
    t2 = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    t3 = time.perf_counter()
    launches = {"unique_mask_count": K.unique_mask_count.launches,
                "bucket_histogram": K.bucket_histogram.launches}
    check(rc == 0 and stats is not None, f"{label}: CLI exit {rc}")
    stats["md5"] = formatter.letters_md5(out_dir)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    stats["wall_ms"] = (t2 - t1) * 1e3
    if profiler is not None:
        stats["profiler_start_stop_ms"] = ((t1 - t0) + (t3 - t2)) * 1e3
        profiler.export_chrome_trace(str(trace))
        stats["device_busy_ms"] = device_busy_ms(trace)
    return stats, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch import cli
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.corpus import (
            manifest as manifest_mod, synthetic)
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.ops import (
            engine as E, kernels as K)
        from parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch.text import (
            formatter)
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f"phase card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
              f"| {kind}", flush=True)
        built = K.build()
        print(f"phase build: {built['seconds']:.1f} s", flush=True)
        for stem, log in built["ptxas"].items():
            for line in log.splitlines():
                if "registers" in line or "error" in line.lower():
                    print(f"  ptxas {stem}: {line.strip()}")

        # main-path shapes: (padded n, valid tokens, vocab, docs)
        shapes = {"A": (1 << 20, 355 * 2900, 33_000, 355),
                  "B": (20_054_016, 20_000 * 1000, 100_000, 20_000)}
        kernels = phase_kernels(torch, K, shapes)
        for k in kernels:
            print(f"phase kernels: {k['name']} exact={k['parity']} ms={k['ms']:.4f} "
                  f"(min {k['ms_min']:.4f} max {k['ms_max']:.4f}) "
                  f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
                  f"library_ms={k['library_ms']}", flush=True)
            for shape in k.get("shapes", []):
                print(f"  {k['name']} {json.dumps(shape)}", flush=True)
        eng = phase_engine(torch, E, shapes)
        print("phase engine: " + " ".join(
            f"{name}={t[0]:.4f} (min {t[1]:.4f} max {t[2]:.4f})" for name, t in eng.items()),
            flush=True)

        with tempfile.TemporaryDirectory(prefix="mri_chip_smoke_") as tmp:
            tmp = Path(tmp)
            list_a = write_corpus_dir(synthetic, manifest_mod, tmp / "A", synthetic.zipf_corpus(
                num_docs=355, vocab_size=33_000, tokens_per_doc=2900, seed=7))
            stats_a, launches_a = drive_path(torch, K, cli, formatter, list_a, tmp / "A_out",
                                             [], "path A")
            check(stats_a["engine"] == "u16", f"path A took engine {stats_a['engine']}")
            check(launches_a["unique_mask_count"] > 0, "path A launched no unique_mask_count")
            rc, _ = run_cli(cli, ["4", "26", str(list_a), "--backend", "oracle",
                                  "--output-dir", str(tmp / "A_oracle")])
            check(rc == 0, f"path A oracle: exit {rc}")
            md5_oracle = formatter.letters_md5(tmp / "A_oracle")
            check(stats_a["md5"] == md5_oracle,
                  f"path A md5 {stats_a['md5']} != oracle {md5_oracle}")
            print(f"phase path_a: tokens={stats_a['tokens']} engine={stats_a['engine']} "
                  f"wall_ms={stats_a['wall_ms']:.3f} total_ms={stats_a['total_ms']} "
                  f"md5={stats_a['md5']} oracle_md5={md5_oracle} launches={launches_a} "
                  f"phases_ms={json.dumps(stats_a['phases_ms'])} "
                  f"max_memory_allocated={stats_a['max_memory_allocated']}", flush=True)

            list_b = write_corpus_dir(synthetic, manifest_mod, tmp / "B", synthetic.zipf_corpus(
                num_docs=20_000, vocab_size=100_000, tokens_per_doc=1000, seed=11))
            stats_b, launches_b = drive_path(torch, K, cli, formatter, list_b, tmp / "B_out",
                                             ["--skew"], "path B", trace=tmp / "B_trace.json")
            check(stats_b["engine"] == "packed", f"path B took engine {stats_b['engine']}")
            for name, n in launches_b.items():
                check(n > 0, f"path B launched no {name}")
            rc, stats_cpu = run_cli(cli, ["4", "26", str(list_b), "--device", "cpu",
                                          "--output-dir", str(tmp / "B_cpu"), "--stats"])
            check(rc == 0, f"path B --device cpu: exit {rc}")
            md5_cpu = formatter.letters_md5(tmp / "B_cpu")
            check(stats_b["md5"] == md5_cpu, f"path B md5 {stats_b['md5']} != cpu {md5_cpu}")
            print(f"phase path_b: tokens={stats_b['tokens']} engine={stats_b['engine']} "
                  f"unique_pairs={stats_b['unique_pairs']} md5={stats_b['md5']} "
                  f"cpu_md5={md5_cpu} launches={launches_b} "
                  f"letter_imbalance={stats_b['letter_imbalance']} "
                  f"bucket_imbalance={stats_b['bucket_imbalance']} "
                  f"phases_ms={json.dumps(stats_b['phases_ms'])} "
                  f"cpu_phases_ms={json.dumps(stats_cpu['phases_ms'])} "
                  f"max_memory_allocated={stats_b['max_memory_allocated']}", flush=True)
            busy = stats_b["device_busy_ms"]
            print(f"phase path_b_device: wall_ms={stats_b['wall_ms']:.3f} "
                  f"total_ms={stats_b['total_ms']} "
                  f"profiler_start_stop_ms={stats_b['profiler_start_stop_ms']:.3f} device_busy_ms="
                  + (f"{busy:.3f} idle_share={1 - busy / stats_b['wall_ms']:.6f}"
                     if busy is not None else "not measured (no device events in the trace)"),
                  flush=True)
    except (SmokeFailure, OSError, RuntimeError, ValueError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    for k in kernels:
        k["launches"] = launches_b[k["name"]]
    print(f"phase done: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
