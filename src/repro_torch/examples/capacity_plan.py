"""Capacity planning with the analytic model backend, in ~40 lines.

Load a ClusterSpec from JSON (or fall back to an inline one), sweep
donor/worker variants through ``box.open(spec, backend="model")`` —
milliseconds per topology, zero simulator threads — and print the
cheapest topology whose premium-tenant p99 estimate meets its target.

  PYTHONPATH=src python -m repro_torch.examples.capacity_plan [spec.json]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch import box

P99_TARGET_US = 60.0                    # the premium latency contract


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description="capacity plan")
    ap.add_argument("spec", nargs="?", help="a saved ClusterSpec (JSON)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the model computes on the "
                         "host, box.open only checks the device")
    args = ap.parse_args(argv)

    spec = box.ClusterSpec(
        num_clients=500, donor_pages=1 << 16, replication=1, sla="premium",
        service="slo", nic_cost={"num_pus": 8, "wqe_proc_us": 10.0,
                                 "wire_us_per_page": 2.0})
    if args.spec:                       # a saved spec overrides the inline one
        with open(args.spec) as f:
            spec = box.ClusterSpec.from_json(f.read())

    # every client offers 8k ops/s; donors cost 4 units each, workers 1
    workload = box.ModelWorkload(client_ops_per_s=8_000.0, read_fraction=0.7)
    grid = [{"num_donors": d, "serve_workers": w}
            for d in (16, 32, 64) for w in (1, 2, 4, 8)]

    with box.open(spec, backend="model", workload=workload,
                  device=args.device) as session:
        rows = session.sweep(grid)
    plans = []
    for variant, row in zip(grid, rows):
        p99 = max(c["p99_us"] for c in row["classes"].values())
        cost = 4 * variant["num_donors"] + variant["serve_workers"]
        ok = not row["saturated"] and p99 <= P99_TARGET_US
        plans.append((ok, cost, variant, p99, row["bottleneck"]))
        mark = "meets " if ok else "misses"
        print(f"{mark} donors={variant['num_donors']:3d} "
              f"workers={variant['serve_workers']} cost={cost:4d} "
              f"p99={p99:8.1f}us bottleneck={row['bottleneck']}")

    feasible = sorted(p for p in plans if p[0])
    if not feasible:
        sys.exit(f"no topology in the grid meets p99 <= {P99_TARGET_US}us")
    _, cost, best, p99, _ = feasible[0]
    print(f"\ncheapest plan meeting the premium p99 target: "
          f"{best['num_donors']} donors x {best['serve_workers']} workers "
          f"(cost {cost}, predicted p99 {p99:.1f}us <= {P99_TARGET_US}us)")
    return {"best": best, "cost": cost, "p99_us": p99, "rows": rows}


if __name__ == "__main__":
    main()
