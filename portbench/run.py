"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  It loads, warms up and measures the cell
for ``S`` seconds, holds what the window produced against the plain
reference, and prints one JSON object as the last line of standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown`` of device time and idle
time, and last ``compared``, each number that decides ``correct`` beside
its limit (also the last lines of standard error).  Without a CUDA card,
or with fewer cards than the cell asks for, it exits 2 and prints no
result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import bench  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None, cell: dict | None = None) -> dict:
    """One run of a cell: the result line as a dict.  ``device="cpu"`` and
    a ``cell`` with smaller sizes are for the tests."""
    import torch

    c = cell or bench.cell(name)
    out = bench.entry(c["entry"]["kind"]).run(
        c, seed=seed, seconds=seconds, trace=trace, device=device,
        t0=T0 if t0 is None else t0)
    correct, comp = bench.compared(out["numbers"], c["limits"])
    if trace:
        metrics = {}
        for m in c["per_layer"]:
            v = bench.read_metric(m["name"], out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {}
        for m in c["end_to_end"]:
            v = out["e2e"][m["name"]]
            if v is None and device == "cuda":
                raise SystemExit(f"portbench: the run measured no {m['name']}")
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = bench.device_info(torch, device, c["chips"])
    dev["memory_peak_bytes"] = out["memory_peak"]
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.get("busy_s", 0.0)
        dev["window_s"] = out["window_s"]
        if "breakdown" in out:
            line["breakdown"] = out["breakdown"]
    if "compile_s" in out:
        print(f"portbench: setup_s {out['setup_s']:.3f} of which compile_s "
              f"{out['compile_s']:.3f}", file=sys.stderr)
    line["compared"] = comp
    return line


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    c = bench.cell(args.workload)
    os.environ.update(bench.cache_env())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"portbench: {args.workload} needs {c['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=c)
    loaded = bench.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(f"portbench: the run took {time.monotonic() - T0:.3f} s", file=sys.stderr)
    bench.print_compared(line["compared"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
