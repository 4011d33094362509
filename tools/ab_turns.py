#!/usr/bin/env python3
"""Time some of ``chip_smoke.py``'s serving phases on two trees in turns on
one card: the older tree, this one, this one, the older tree (each run
``tools/chip_phases.py --rounds N`` in its own process), then the decode
rate of every served arch and each phase's seconds, run by run.

    python3 tools/ab_turns.py --parent DIR [--rounds 2] serve serve_archs hybrid_decode

``DIR`` is an unpacked older commit (``git archive <commit> | tar -x -C DIR``);
this script copies ``tools/chip_phases.py`` into it when it has none. Each
run's whole output goes to ``chiprun_out/ab_<n>_<tree>.log``; the table
is printed at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(tree: Path, label: str, n: int, rounds: int, phases: list) -> dict:
    """One process of ``chip_phases.py`` in ``tree``: {metric: [values]}."""
    log = ROOT / "chiprun_out" / f"ab_{n}_{label}.log"
    log.parent.mkdir(exist_ok=True)
    out = subprocess.run([sys.executable, "tools/chip_phases.py", "--rounds", str(rounds),
                          *phases], cwd=tree, capture_output=True, text=True)
    log.write_text(out.stdout + out.stderr)
    if out.returncode:
        raise SystemExit(f"{label} run {n} failed ({out.returncode}); see {log}")
    got: dict = {}
    for line in out.stdout.splitlines():
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if "decode_tok_s" in row and "arch" in row:
            got.setdefault(f"{row['phase']} {row['arch']} tok/s", []).append(row["decode_tok_s"])
        if "phase_seconds" in row:
            for phase, secs in row["phase_seconds"].items():
                if phase != "build":
                    got[f"{phase} s"] = secs
    return got


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    parent = args.parent.resolve()
    if not (parent / "tools" / "chip_phases.py").exists():
        (parent / "tools").mkdir(exist_ok=True)
        shutil.copy(ROOT / "tools" / "chip_phases.py", parent / "tools" / "chip_phases.py")
    order = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    runs = [(label, run(tree, label, n, args.rounds, args.phases))
            for n, (label, tree) in enumerate(order, 1)]
    metrics = sorted({k for _, got in runs for k in got})
    print("| metric | " + " | ".join(f"{n} {label}" for n, (label, _) in
                                      enumerate(runs, 1)) + " |")
    print("|---" * (len(runs) + 1) + "|")
    for k in metrics:
        cells = [", ".join(f"{v:.4f}" for v in got.get(k, [])) for _, got in runs]
        print(f"| {k} | " + " | ".join(cells) + " |")
    print(json.dumps({"ab": [{"tree": label, **got} for label, got in runs]}))


if __name__ == "__main__":
    main()
