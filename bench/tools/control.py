"""Readings for a cell's limits: the program's check on many seeds and the
control's on some, in one process (set-up paid once a seed, the kernels
built once).

    python3 bench/tools/control.py --cell command-r-35b.decode --seconds 30 \\
        --seeds 101 102 103 --control 101 102 103 --out results/bench/ctl.jsonl

For each seed the cell runs as ``bench/run.py`` runs it (same window,
same check), and with ``--control`` the reference computed with float8
products stands in the program's place over the same prompts and tokens:
its numbers are the ones the check would read from it, judged by the
cell's limits as the program's are. One JSON line a seed: the program's
readings and verdict, the control's readings and verdict, and the
end-to-end metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[],
                    help="seeds that also read the control")
    ap.add_argument("--precision", default="fp8")
    ap.add_argument("--fault", default=None, help="a fault of bench/tools/faults.py, "
                    "planted in the program for every seed")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from bench.lib import harness
    from bench.tools.faults import FAULTS
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            res = harness.execute(args.cell, seed=seed, seconds=args.seconds, trace=False,
                                  t0=t0,
                                  control=args.precision if seed in args.control else None)
        rec = {"cell": args.cell, "seed": seed, "fault": args.fault,
               "wall_s": time.perf_counter() - t0,
               "correct": res["correct"],
               "program": {k: c["value"] for k, c in res["checks"].items()},
               "control": ({k: c["value"] for k, c in res["control"]["checks"].items()}
                           if "control" in res else None),
               "control_correct": res["control"]["correct"] if "control" in res else None,
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "peak_gb": res["device"]["memory_peak_bytes"] / 1e9, "notes": res["notes"]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("seed", "fault", "wall_s", "correct", "program",
                                             "control", "control_correct", "metrics",
                                             "peak_gb")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
