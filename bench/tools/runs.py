"""Run cells of the benchmark one after another, each a fresh process, and
keep what each printed.

    python3 bench/tools/runs.py --out results/bench/set1 --seconds 10 \\
        command-r-35b.decode:1001:0 command-r-35b.decode:1002:1

Each argument is ``cell:seed:trace``. Every run's standard output and
error go to ``<out>/<n>.<cell>.<seed>.{out,err}``; one line a run (its exit
code, wall seconds, and its result line) goes to ``<out>/runs.jsonl`` and is
printed, shortened. With ``--spread`` the end-to-end metrics' quartile
spreads (``bench.lib.stats.spread``) are printed per cell at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench.lib.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("runs", nargs="+", help="cell:seed:trace")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", smi.stdout.strip(), flush=True)
    by_cell = defaultdict(lambda: defaultdict(list))
    for n, spec in enumerate(args.runs):
        cell, seed, trace = spec.rsplit(":", 2)
        base = os.path.join(args.out, f"{n:02d}.{cell}.{seed}")
        cmd = [sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload", cell,
               "--seed", seed, "--seconds", str(args.seconds), "--trace", trace]
        t0 = time.perf_counter()
        with open(base + ".out", "w") as fo, open(base + ".err", "w") as fe:
            rc = subprocess.run(cmd, stdout=fo, stderr=fe, cwd=ROOT).returncode
        wall = time.perf_counter() - t0
        with open(base + ".out") as f:
            lines = f.read().strip().splitlines()
        result = None
        if rc == 0 and lines:
            result = json.loads(lines[-1])
        rec = {"n": n, "cell": cell, "seed": int(seed), "trace": int(trace), "rc": rc,
               "wall_s": wall, "result": result}
        with open(os.path.join(args.out, "runs.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        if result is None:
            with open(base + ".err") as f:
                tail = f.read()[-3000:]
            print(f"[{n}] {cell} seed {seed} trace {trace}: rc {rc} in {wall:.1f}s\n{tail}",
                  flush=True)
            continue
        short = {k: round(v["value"], 6) for k, v in result["metrics"].items()}
        checks = {k: v["value"] for k, v in result["checks"].items()}
        print(f"[{n}] {cell} seed {seed} trace {trace}: rc {rc} in {wall:.1f}s correct "
              f"{result['correct']} {short} checks {checks} peak "
              f"{result['device']['memory_peak_bytes'] / 1e9:.2f} GB notes "
              f"{json.dumps(result.get('notes'))[:300]}", flush=True)
        if int(trace) == 0:
            for k, v in result["metrics"].items():
                by_cell[cell][k].append(v["value"])
        else:
            print("    device:", json.dumps(result["device"]), flush=True)
            print("    breakdown:", json.dumps(result.get("breakdown"))[:1500], flush=True)
    if args.spread:
        for cell, metrics in by_cell.items():
            for k, xs in metrics.items():
                if len(xs) >= 4:
                    print(f"spread {cell} {k}: {spread(xs):.5f} over {len(xs)} runs; "
                          f"median {sorted(xs)[len(xs) // 2]:.6f}; values {xs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
