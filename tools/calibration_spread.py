#!/usr/bin/env python3
"""Spread of the analytic model's calibration against the threaded engine.

    python3 tools/calibration_spread.py [--runs 6] [--devices cuda,cpu]

Runs ``repro_torch.model.run_calibration`` at ``chip_smoke.py``'s
calibration point (the reference suite's: 4 clients, 2 donors, 1 worker,
paced 1-page writes at 500 ops/s a client, 48 a client) ``--runs`` times on
each device, in turns (cuda, cpu, cpu, cuda, ...), then the real time of
one engine write from each device. Prints the card's name and power limit
(when a GPU is used), one line a run, then one JSON line: per device the
runs, their minimum, median and maximum of each ratio, and how many held
the ±0.35 band with no saturation and no admission shrink.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (  # noqa: E402
    CALIBRATION_BAND,
    CALIBRATION_OPS,
    CALIBRATION_SPEC,
    CALIBRATION_WORKLOAD,
    one_write_us,
)
from repro_torch import box  # noqa: E402
from repro_torch.model import ModelWorkload, run_calibration  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--devices", default="cuda,cpu")
    args = ap.parse_args()
    devices = args.devices.split(",")
    if "cuda" in devices:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    spec = box.ClusterSpec(**CALIBRATION_SPEC)
    wl = ModelWorkload(**CALIBRATION_WORKLOAD)
    runs = {d: [] for d in devices}
    for k in range(args.runs):
        order = devices if k % 2 == 0 else devices[::-1]
        for device in order:
            r = run_calibration(spec, wl, ops_per_client=CALIBRATION_OPS, device=device)
            ok = (r.within(CALIBRATION_BAND) and not r.model_saturated
                  and r.measured_shrinks == 0)
            print(f"{device} run {k}: {r.agreement()} p99 {r.measured_p99_us:.1f} us "
                  f"{'holds' if ok else 'MISSES'}", flush=True)
            runs[device].append({"throughput_ratio": r.throughput_ratio,
                                 "latency_ratio": r.latency_ratio,
                                 "measured_mean_us": r.measured_mean_us,
                                 "measured_p99_us": r.measured_p99_us,
                                 "model_p99_us": r.model_p99_us,
                                 "shrinks": r.measured_shrinks, "holds": ok})
    summary = {}
    for device, rows in runs.items():
        summary[device] = {"holds": sum(r["holds"] for r in rows), "runs": len(rows),
                           "one_write_real_us": one_write_us(device)}
        for key in ("throughput_ratio", "latency_ratio", "measured_p99_us"):
            vals = [r[key] for r in rows]
            summary[device][key] = [min(vals), statistics.median(vals), max(vals)]
    print(json.dumps({"band": CALIBRATION_BAND, "summary": summary, "runs": runs}))


if __name__ == "__main__":
    main()
