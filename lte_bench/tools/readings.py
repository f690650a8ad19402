#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from, for one cell in
one process: the numbers compared for each seed, with the program, or with
the control (the reference at the configuration's lower precision) in its
place:

    python3 lte_bench/tools/readings.py --workload <cell> --seconds 2 \\
        [--control] 11 12 13 ...

Prints one JSON line per seed.  Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args()

    import torch

    from lte_bench import catalog, control, run

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    _w, cfg, _mix = catalog.cell(ROOT, args.workload)
    entry = control.entry(cfg["control"]) if args.control else None
    for seed in args.seeds:
        result, lines = run.run_cell(args.workload, seed, args.seconds, False, entry=entry)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cfg["control"] if args.control else None,
                          "correct": result["correct"], "checks": result["checks"],
                          "note": lines[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
