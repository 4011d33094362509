"""Render the dry run's tables from results/dryrun_torch.json.

Twin of ``repro/roofline/report.py``: plain Python over the dry run's rows
(``launch.dryrun``). ``bytes/dev`` is the argument bytes of one device's
step (its parameters, moments, cache and data shards); the port counts no
temporaries.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def load(path: str = "results/dryrun_torch.json") -> Dict:
    rows = json.loads(Path(path).read_text())
    return {tuple(r["key"]): r for r in rows}


def fmt_ms(s: float) -> str:
    return f"{s*1e3:,.1f}"


def dryrun_table(rows: Dict, mesh: str, variant: str = "base") -> str:
    out = ["| arch | shape | status | bytes/dev (GB) | compile (s) |",
           "|---|---|---|---:|---:|"]
    for key in sorted(rows):
        r = rows[key]
        if key[2] != mesh or (len(key) > 3 and key[3] != variant):
            continue
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP (documented) | — | — |")
            continue
        ms = r.get("memory_stats") or {}
        gb = (ms.get("argument_bytes", 0) + ms.get("temp_bytes", 0)) / 1e9
        out.append(f"| {r['arch']} | {r['shape']} | {r['status']} | "
                   f"{gb:.2f} | {r.get('compile_seconds', 0):.0f} |")
    return "\n".join(out)


def roofline_table(rows: Dict, variant: str = "base", mesh: str = "single") -> str:
    """The three terms of every ok cell on ``mesh``, with the minimum-bytes
    term (``min memory``) beside the unfused one."""
    out = ["| arch | shape | compute (ms) | memory (ms) | min memory (ms) "
           "| collective (ms) | dominant | useful-FLOPs | roofline frac |",
           "|---|---|---:|---:|---:|---:|---|---:|---:|"]
    for key in sorted(rows):
        r = rows[key]
        if key[2] != mesh or key[3] != variant or r["status"] != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['compute_s'])} | "
            f"{fmt_ms(r['memory_s'])} | {fmt_ms(r['min_memory_s'])} | "
            f"{fmt_ms(r['collective_s'])} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.3f} | "
            f"{r['roofline_fraction']:.4f} |")
    return "\n".join(out)


def meshes_table(rows: Dict, variant: str = "base") -> str:
    """One row per (arch, shape): each mesh's compute, unfused memory,
    minimum-bytes memory and collective terms (ms), side by side; skipped
    cells are left out."""
    meshes = ("single", "multi")
    out = ["| arch | shape | " + " | ".join(
        f"{m}: compute / memory / min memory / collective (ms)" for m in meshes) + " |",
           "|---|---|" + "---:|" * len(meshes)]
    cells = sorted({(k[0], k[1]) for k in rows if len(k) < 4 or k[3] == variant})
    for arch, shape in cells:
        terms = []
        for m in meshes:
            r = rows.get((arch, shape, m, variant))
            if not r or r["status"] != "ok":
                terms.append("—" if not r or r["status"] == "skipped" else r["status"])
                continue
            terms.append(" / ".join(fmt_ms(r[k]) for k in ("compute_s", "memory_s",
                                                           "min_memory_s", "collective_s")))
        if any(t != "—" for t in terms):
            out.append(f"| {arch} | {shape} | " + " | ".join(terms) + " |")
    return "\n".join(out)


def variant_compare(rows: Dict, arch: str, shape: str,
                    variants: List[str]) -> str:
    out = ["| variant | compute (ms) | memory (ms) | collective (ms) | "
           "dominant | frac |", "|---|---:|---:|---:|---|---:|"]
    for v in variants:
        for mesh in ("single",):
            r = rows.get((arch, shape, mesh, v))
            if not r or r["status"] != "ok":
                continue
            out.append(f"| {v} | {fmt_ms(r['compute_s'])} | "
                       f"{fmt_ms(r['memory_s'])} | "
                       f"{fmt_ms(r['collective_s'])} | {r['dominant']} | "
                       f"{r['roofline_fraction']:.4f} |")
    return "\n".join(out)
