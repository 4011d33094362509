#!/usr/bin/env python3
"""Each perf knob of ``repro_torch.configs.optimized`` on the dry run, one at a
time against ``base``: the table that decides the port's ``DEFAULT_ON``.

    PYTHONPATH=src python3 tools/knob_table.py [--mesh single] [--jobs 6] \
        [--out results/knob_table.json]

For every knob and every full-size cell it touches (an arch whose config the
knob changes, each shape of ``SHAPES`` the registry runs), and for every
cell's ``base``, it runs ``launch.dryrun.run_cell`` on the production mesh
(16×16 by default; meta tensors, the fake process group, the H100 constants
of ``roofline.analysis``), a fresh process a cell. It prints one markdown table
row a (knob, arch, shape): each term of ``base`` and of the knob in ms
(compute, unfused memory, minimum memory, collective) and the knob's change
of each, then a verdict a knob: on by default only where it lowers the
largest of the compute, minimum-memory and collective terms of at least one
cell and raises no term of any cell by more than 1 %; a knob that changes
no count in any cell stays off. The rows go to ``--out`` as JSON.

Counts, not times: the terms are one device's counts over the H100's peak
rates. It allocates nothing (meta tensors), but traces every full-size
config: run it on a machine with the cores to spare.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

TERMS = ("compute_s", "memory_s", "min_memory_s", "collective_s")
DECIDING = ("compute_s", "min_memory_s", "collective_s")   # the "largest term"
RAISE_LIMIT = 0.01


def touched(knob: str, arch: str) -> bool:
    """Whether ``knob`` changes ``arch``'s config."""
    from repro_torch.configs import get_config
    from repro_torch.configs.optimized import optimize
    cfg = get_config(arch)
    return optimize(cfg, only={knob}) != cfg


def cell(job: tuple) -> dict:
    """One dry-run row: (arch, shape, mesh, knob or "base")."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch import dryrun
    arch, shape, mesh, knob = job
    row = dryrun.run_cell(arch, shape, mesh, RunConfig(remat="full"),
                          knobs=None if knob == "base" else {knob})
    row["knob"] = knob
    row.pop("memory_stats", None)
    row.pop("traceback", None)
    return row


def verdicts(rows: list) -> dict:
    """knob → (on by default?, why), from the rows' terms (module docstring)."""
    from repro_torch.configs.optimized import KNOBS
    base = {(r["arch"], r["shape"]): r for r in rows if r["knob"] == "base"}
    out = {}
    for knob in KNOBS:
        lowers, raises, changes = [], [], False
        for r in rows:
            if r["knob"] != knob or r["status"] != "ok":
                continue
            b = base[(r["arch"], r["shape"])]
            if any(r[k] != b[k] for k in TERMS) or r["hlo_flops"] != b["hlo_flops"]:
                changes = True
            largest = max(DECIDING, key=lambda k: b[k])
            if r[largest] < b[largest]:
                lowers.append(f"{r['arch']} {r['shape']} ({largest[:-2]})")
            raises += [f"{r['arch']} {r['shape']} ({k[:-2]} +{r[k] / b[k] - 1:.2%})"
                       for k in TERMS if b[k] > 0 and r[k] > b[k] * (1 + RAISE_LIMIT)]
        if not changes:
            out[knob] = (False, "changes no count")
        elif not lowers:
            out[knob] = (False, "lowers no cell's largest term; raises " + (
                ", ".join(raises) or "nothing"))
        elif raises:
            out[knob] = (False, "raises " + ", ".join(raises))
        else:
            out[knob] = (True, "lowers " + ", ".join(lowers))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--out", default="results/knob_table.json")
    args = ap.parse_args(argv)
    from repro_torch.configs import SHAPES
    from repro_torch.configs.optimized import KNOBS
    from repro_torch.launch.dryrun import DRYRUN_ARCHS
    jobs = [(a, s, args.mesh, "base") for a in DRYRUN_ARCHS for s in SHAPES]
    jobs += [(a, s, args.mesh, k) for k in KNOBS for a in DRYRUN_ARCHS if touched(k, a)
             for s in SHAPES]
    # a fresh process a cell: the unfused byte count of a cell depends on what
    # its process ran before (DTensor's sharding propagation runs some ops on
    # meta tensors on a cache miss, and those are counted), e.g. hymba-1.5b
    # train_4k by 1.3 %; FLOPs and collectives do not
    with ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        rows = list(pool.map(cell, jobs))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    errors = [r for r in rows if r["status"] == "error"]
    base = {(r["arch"], r["shape"]): r for r in rows if r["knob"] == "base"}
    print("| knob | arch | shape | base: compute / memory / min memory / collective (ms) "
          "| knob: the same (ms) | change |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        if r["knob"] == "base" or r["status"] != "ok":
            continue
        b = base[(r["arch"], r["shape"])]
        change = " / ".join(f"{r[k] / b[k] - 1:+.2%}" if b[k] else "—" for k in TERMS)
        print(f"| {r['knob']} | {r['arch']} | {r['shape']} | "
              + " / ".join(f"{b[k] * 1e3:,.3f}" for k in TERMS) + " | "
              + " / ".join(f"{r[k] * 1e3:,.3f}" for k in TERMS) + f" | {change} |")
    for knob, (on, why) in verdicts(rows).items():
        print(f"{knob}: {'ON' if on else 'off'} — {why}")
    for r in errors:
        print(f"ERROR {r['arch']} {r['shape']} {r['knob']}: {r['error']}")
    print(json.dumps({"cells": len(rows), "errors": len(errors),
                      "skipped": sum(r["status"] == "skipped" for r in rows)}))
    if errors:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
