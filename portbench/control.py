"""The controls of ``correct``, read on the chip at each cell's own size.

    python3 portbench/control.py --cells CELL [CELL ...] --seeds 1,2,3 --out control.json

For each cell and seed, the plain reference put in the program's place
with a guarantee of the configuration broken (see each entry's
``control``) is judged by the cell's own comparison; each reading must
fail one of the cell's limits.  The benchmark's runs never run this.
Without a CUDA card it exits 2: the readings are the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import bench  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    os.environ.update(bench.cache_env())
    import torch

    if not torch.cuda.is_available():
        print("portbench: the controls are read on a CUDA card; torch sees none",
              file=sys.stderr)
        return 2
    seconds = bench.benchmark()["run_seconds"]
    out = {}
    for name in args.cells:
        c = bench.cell(name)
        rows = []
        for seed in (int(s) for s in args.seeds.split(",")):
            numbers = bench.entry(c["entry"]["kind"]).control(
                c, seed=seed, seconds=seconds, device="cuda")
            ok, comp = bench.compared(numbers, c["limits"])
            rows.append({"seed": seed, "passes": ok, "compared": comp})
            print(f"control {name} seed {seed}: {json.dumps(comp)} passes={ok}", flush=True)
        out[name] = rows
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0 if not any(r["passes"] for rows in out.values() for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
