"""What every cell shares: finding its files by name, the device's
busy time from a profiler trace, the result line and its checks.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``.  Its own file,
``workloads/<cell>.json``, names the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``),
the entry that drives the port (``entries/<kind>.py``) and the limits of
the numbers that decide ``correct``.  Each per-layer metric is
``metrics/<metric>.py``.  A later cell or metric is a new file; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "parallel_computation_of_an_inverted_index_using_map_reduce_tpu_torch"
#: top-level module names that no run may load (compared whole: the
#: port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "parallel_computation_of_an_inverted_index_using_map_reduce_tpu")


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """A cell's file, with its configuration, its traffic mix and the
    metrics of ``BENCHMARK.json`` that it reports (a cell that
    ``BENCHMARK.json`` does not list reports ``setup_s`` alone)."""
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no workload {name!r} (no {path})")
    c = read_json(path)
    c["config_params"] = read_json(HERE / "configs" / f"{c['config']}.json")
    c["mix"] = read_json(HERE / "traffic" / f"{c['traffic']}.json")
    spec = benchmark()
    c["end_to_end"] = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    c["per_layer"] = [m for m in spec["per_layer"] if name in m.get("workloads", [])]
    return c


def load_module(path: Path):
    """A module of this folder by file path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(kind: str):
    return load_module(HERE / "entries" / f"{kind}.py")


def read_metric(name: str, record: dict):
    """The per-layer metric ``name`` read from a traced run's record, or
    None where its reader finds nothing to read."""
    value = load_module(HERE / "metrics" / f"{name}.py").read(record)
    return None if value is None else float(value)


def forbidden_loaded(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: every
    module loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cache_env() -> dict:
    """Fixed cache directories inside the checkout for anything that
    builds or compiles kernels (the port's own builds already go to its
    ``csrc/_build`` and ``native/_build``)."""
    base = ROOT / ".portbench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton")}


# -- the device's busy time (the arithmetic of chip_smoke.py) -----------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_trace(trace_path: Path) -> dict:
    """From a torch.profiler Chrome trace: ``busy_s`` (summed duration of
    the kernels, copies and fills; None without any), ``ops`` (seconds
    summed by full name, largest first) and ``intervals`` (wall-clock
    ``(start, end)`` s of each device event, sorted)."""
    doc = read_json(trace_path)
    base = doc.get("baseTimeNanoseconds", 0) / 1e9
    by_name: dict = {}
    intervals = []
    for e in doc.get("traceEvents", []):
        if e.get("cat") in DEVICE_CATS:
            dur = e.get("dur", 0) / 1e6
            by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0.0) + dur
            start = base + e["ts"] / 1e6
            intervals.append((start, start + dur))
    intervals.sort()
    busy = sum(by_name.values())
    return {"busy_s": busy if intervals else None,
            "ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "intervals": intervals}


def idle_gaps(intervals: list, t0: float, t1: float, label) -> list:
    """Idle time of the device inside ``[t0, t1]`` summed by what
    ``label(midpoint)`` says the host was doing, largest first."""
    by_label: dict = {}
    cursor = t0
    for a, b in intervals + [(t1, t1)]:
        if a > cursor:
            lo, hi = cursor, min(a, t1)
            if hi > lo:
                name = label((lo + hi) / 2)
                by_label[name] = by_label.get(name, 0.0) + (hi - lo)
        cursor = max(cursor, b)
        if cursor >= t1:
            break
    return sorted(by_label.items(), key=lambda kv: -kv[1])


class Profile:
    """torch.profiler over the card's activity only, around a window."""

    def __init__(self, torch, run_dir: Path):
        self.torch = torch
        self.path = run_dir / "device_trace.json"
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.stop()

    def read(self) -> dict:
        self.prof.export_chrome_trace(str(self.path))
        out = device_trace(self.path)
        self.path.unlink()
        return out


def breakdown(trace: dict, gaps: list) -> dict:
    return {"device_ops": [[n[:120], s] for n, s in trace["ops"][:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


# -- the result line -----------------------------------------------------------

def compared(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none is over it."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def device_info(torch, device: str, chips: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def print_compared(comp: dict) -> None:
    for k, v in comp.items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)


def bytes_under(path: Path) -> int:
    """Bytes of the files under ``path`` (what a run wrote there)."""
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def run_dir(cell_name: str) -> Path:
    """This run's scratch directory under the temp root: ``TMPDIR`` as it
    is now (``tempfile.gettempdir`` keeps the first one it saw)."""
    d = Path(os.environ.get("TMPDIR") or tempfile.gettempdir()) / "portbench" / cell_name
    if d.exists():
        shutil.rmtree(d)
    d.mkdir(parents=True)
    return d
