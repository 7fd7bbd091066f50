"""Program spans of a build, read back from the port's ``--trace-out``
file, and the card's idle gaps named after them.

The port writes ``--trace-out`` on the clock of the profiler's trace
(``baseTimeNanoseconds`` plus ``ts`` in µs is Unix time in both files),
so the card's idle time can be named after the program spans: each idle
gap is cut at every span's start and end, and each piece is named after
the innermost span that covers its midpoint: ``<parent>/<span>``
(``stream_feed/read``, ``feed/card_wait``, ``build/emit``), a top-level
span's own time ``<span>/unphased`` where other spans nest in it
(``build/unphased``: set-up and teardown outside every phase) and
``<span>`` where none do (``manifest``).  Time that no span covers keeps
the label the entry's phase labeller gives it.

    python3 portbench/spans.py --workload CELL --seed N --seconds S

runs one traced run of a build cell as ``run.py --trace 1`` does, with
each build handed ``--trace-out <run dir>/spans.<i>.json``: it prints, per
build, the wall time less ``build_ms`` and ``manifest_ms`` (the CLI's
remainder), then one JSON line with ``correct``, the cell's per-layer
metrics, the ``breakdown`` with span labels, all of the idle time by
label (``idle_gaps_all``), the share of the idle time inside builds that
a span names (``span_labelled_share``, %) and the spans' wall and CPU ms
per build of the window by label (``span_ms_per_build``).  It wraps the entry's build
call and its idle-gap labelling in this process only; the cell's own
runs are left as they are.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import bench  # noqa: E402

#: the label the build entry gives idle time between builds
BETWEEN_BUILDS = "harness:"


def read(path: Path) -> list[dict]:
    """The complete spans of a ``--trace-out`` file, each ``{"name",
    "parent", "start", "end", "cpu_ms"}`` (Unix seconds; the thread's CPU
    ms where the span carries it, else None); none from a file without
    ``baseTimeNanoseconds`` (a trace rebased to start near 0 has no place
    on the clock)."""
    doc = bench.read_json(path)
    if "baseTimeNanoseconds" not in doc:
        return []
    base = doc["baseTimeNanoseconds"] / 1e9
    out = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "X":
            start, args = base + e["ts"] / 1e6, e.get("args") or {}
            out.append({"name": e["name"], "parent": args.get("parent"), "start": start,
                        "end": start + e["dur"] / 1e6, "cpu_ms": args.get("cpu_ms")})
    return out


def span_label(span: dict, parents: set) -> str:
    """``<parent>/<name>``; at the top ``<name>/unphased`` where ``name``
    is in ``parents`` (its own time), else ``<name>``."""
    if span["parent"]:
        return f"{span['parent']}/{span['name']}"
    return f"{span['name']}/unphased" if span["name"] in parents else span["name"]


def split_idle_gaps(intervals: list, t0: float, t1: float, spans: list[dict], label) -> list:
    """``bench.idle_gaps`` with every gap cut at each span's start and end
    (an empty interval there adds no busy time), so a gap that runs
    through several spans is shared among them."""
    cuts = [(t, t) for s in spans for t in (s["start"], s["end"]) if t0 < t < t1]
    return bench.idle_gaps(sorted(intervals + cuts), t0, t1, label)


def labeller(spans: list[dict], fallback, fell_back: set | None = None):
    """``label(t)``: the label of the innermost span covering ``t`` (the
    shortest, as spans nest), else ``fallback(t)``, whose labels are
    added to ``fell_back`` when given."""
    parents = {s["parent"] for s in spans if s["parent"]}
    shortest_first = sorted(spans, key=lambda s: s["end"] - s["start"])

    def label(t: float) -> str:
        for s in shortest_first:
            if s["start"] <= t < s["end"]:
                return span_label(s, parents)
        name = fallback(t)
        if fell_back is not None:
            fell_back.add(name)
        return name

    return label


def span_labelled_share(gaps: list, fell_back: set) -> float | None:
    """% of the idle time inside builds (every gap but the ones between
    builds) whose label a program span gave."""
    inside = [(n, s) for n, s in gaps if not n.startswith(BETWEEN_BUILDS)]
    total = sum(s for _, s in inside)
    if not total:
        return None
    return 100.0 * sum(s for n, s in inside if n not in fell_back) / total


def traced(mod) -> dict:
    """Wrap a loaded build entry ``mod`` (``entries/build.py``): each build
    writes its spans next to its output directory, and the idle gaps are
    labelled by them.  Returns what the wrappers collect: ``spans``, the
    same per build in call order (``builds``, the warm-up first),
    ``fell_back`` (labels from the phase labeller) and ``gaps`` (all of
    them, largest first)."""
    got: dict = {"spans": [], "builds": [], "fell_back": set(), "gaps": []}
    plain_build = mod._build
    numbers = itertools.count()

    def build(cli, argv):
        path = Path(argv[argv.index("--output-dir") + 1]).parent / f"spans.{next(numbers)}.json"
        t0 = time.time()
        rc, stats = plain_build(cli, [*argv, "--trace-out", str(path)])
        wall_ms = (time.time() - t0) * 1e3
        if path.exists():
            got["builds"].append(read(path))
            got["spans"] += got["builds"][-1]
            path.unlink()
        if stats is not None:
            build_ms, manifest_ms = stats.get("build_ms"), stats.get("manifest_ms")
            rest = (f"{wall_ms - build_ms - manifest_ms:.3f}"
                    if build_ms is not None and manifest_ms is not None else "not reported")
            print(f"portbench: build wall {wall_ms:.3f} ms, build_ms {build_ms}, "
                  f"manifest_ms {manifest_ms}, total_ms {stats.get('total_ms')}, "
                  f"wall - build_ms - manifest_ms {rest}", file=sys.stderr)
        return rc, stats

    def idle_gaps(intervals, t0, t1, label):
        gaps = split_idle_gaps(intervals, t0, t1, got["spans"],
                               labeller(got["spans"], label, got["fell_back"]))
        got["gaps"] = gaps
        return gaps

    mod._build = build
    mod.bench = types.SimpleNamespace(**{**vars(bench), "idle_gaps": idle_gaps})
    return got


def span_ms_per_build(builds: list[list[dict]]) -> dict:
    """The spans' whole time by ``<parent>/<name>`` (``<name>`` at the
    top), ms per build over ``builds``: ``[wall, cpu]``, the thread's CPU
    ms None where the spans carry none."""
    total: dict = {}
    for spans in builds:
        for s in spans:
            name = f"{s['parent']}/{s['name']}" if s["parent"] else s["name"]
            wall, cpu = total.get(name, (0.0, None))
            if s["cpu_ms"] is not None:
                cpu = (cpu or 0.0) + s["cpu_ms"]
            total[name] = (wall + (s["end"] - s["start"]) * 1e3, cpu)
    return {k: [w / len(builds), None if c is None else c / len(builds)]
            for k, (w, c) in sorted(total.items())}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    c = bench.cell(args.workload)
    os.environ.update(bench.cache_env())
    import torch

    if not torch.cuda.is_available():
        print(f"portbench: {args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    mod = bench.entry(c["entry"]["kind"])
    got = traced(mod)
    out = mod.run(c, seed=args.seed, seconds=args.seconds, trace=True, device="cuda", t0=T0)
    correct, comp = bench.compared(out["numbers"], c["limits"])
    metrics = {m["name"]: bench.read_metric(m["name"], out["record"]) for m in c["per_layer"]}
    line = {"correct": correct, "metrics": metrics, "breakdown": out.get("breakdown"),
            "idle_gaps_all": got["gaps"],
            "span_labelled_share": span_labelled_share(got["gaps"], got["fell_back"]),
            "span_ms_per_build": span_ms_per_build(got["builds"][1:]),
            "device": bench.device_info(torch, "cuda", c["chips"])}
    bench.print_compared(comp)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
