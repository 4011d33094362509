"""Dry run: run every (arch × shape) on the production meshes on the meta
device and record one device's counts and roofline terms.

Twin of ``repro/launch/dryrun.py``. Where the reference lowers and compiles
each cell on 512 host devices and reads the compiled HLO, this runs the
step (``launch.steps.build_step``) on meta DTensors over the production mesh
(``launch.mesh.make_production_mesh``, the fake process group) under
``roofline.count``: nothing is allocated, so the 32–35B archs count without
their weights. Every count is this device's (rank 0's) program. The terms use
the H100's constants (``roofline.analysis``). ``train_4k`` runs forward,
backward and AdamW, so the two backward kernels count through their meta
paths.

``--opt`` applies the port's ``configs.optimized.DEFAULT_ON`` and
``--knobs a,b`` the knobs named (``configs.optimized.KNOBS``), as the
reference's do; their rows carry the variant "opt" in the key (or
``--variant``'s label), beside the "base" rows of a run without knobs, and
``roofline.report.variant_compare`` prints them side by side. Not ported:
``--hlo-dir`` (there is no HLO).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch.json
  python -m repro_torch.launch.dryrun --arch deepseek-v2-lite-16b --knobs moe --variant moe
  python -m repro_torch.launch.dryrun --all --opt
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Optional

from repro_torch.configs import (ARCH_IDS, SHAPES, ModelConfig, RunConfig, ShapeConfig,
                                 cell_supported, get_config)
from repro_torch.launch.mesh import close_mesh, make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.transformer import cache_tensors
from repro_torch.roofline.analysis import RooflineReport, analyze, model_flops_for
from repro_torch.roofline.count import count

DRYRUN_ARCHS = [a for a in ARCH_IDS if a != "rdmabox-paper-100m"]


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        t = t.to_local() if hasattr(t, "to_local") else t
        total += t.numel() * t.element_size()
    return total


def _min_bytes(shape: ShapeConfig, args: tuple, out: Any) -> tuple[int, int]:
    """(the bytes the step must move at least, the bytes of its arguments),
    this device's: parameters read once; a train step's moments read and
    written and its parameters written; a prefill's cache written, a
    decode's cache read; the data in and the logits out."""
    params = _local_bytes(args[0].parameters())
    if shape.kind == "train":
        opt = args[1]
        moments = _local_bytes([*opt.m.values(), *opt.v.values(),
                                *((opt.err or {}).values())])
        data = _local_bytes(args[2].values())
        return 2 * (params + moments) + data, params + moments + data
    if shape.kind == "prefill":
        logits, cache = out
        data = _local_bytes(args[1].values())
        cache_b = _local_bytes(cache_tensors(cache).values())
        return params + data + cache_b + _local_bytes([logits]), params + data
    logits, cache = out
    cache_b = _local_bytes(cache_tensors(cache).values())
    token = _local_bytes([args[2]])
    return params + cache_b + token + _local_bytes([logits]), params + cache_b + token


def roofline_of(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig, mesh=None, *,
                mesh_name: str = "one", arch: Optional[str] = None) -> RooflineReport:
    """One device's roofline of ``shape``'s step on ``mesh`` (None: one
    device, plain meta tensors), counted on meta."""
    t0 = time.perf_counter()
    step, args = build_step(cfg, shape, run, mesh)
    counts, out = count(step, *args)
    least, arg_bytes = _min_bytes(shape, args, out)
    return analyze(counts, arch=arch or cfg.name, shape_name=shape.name, mesh_name=mesh_name,
                   chips=1 if mesh is None else mesh.size(),
                   model_flops=model_flops_for(cfg, shape), min_bytes=least,
                   memory_stats={"argument_bytes": arg_bytes, "kernels": counts.kernels,
                                 "comm_calls": counts.comm_calls, "ops": counts.ops,
                                 "flops_by_op": counts.flops_by_op},
                   compile_seconds=time.perf_counter() - t0)


def run_cell(arch: str, shape_name: str, mesh_kind: str, run: RunConfig,
             knobs=None) -> dict:
    """One cell's row; ``knobs`` a set of ``configs.optimized.KNOBS`` (an empty
    set: ``DEFAULT_ON``, as ``--opt``), None for the config as it is."""
    cfg = get_config(arch)
    if knobs is not None:
        from repro_torch.configs.optimized import optimize
        cfg = optimize(cfg, only=knobs if knobs else None)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        rep = roofline_of(cfg, shape, run, mesh, mesh_name=mesh_kind, arch=arch)
        out = rep.to_dict()
        out["status"] = "ok"
        return out
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the port's DEFAULT_ON knobs (configs.optimized)")
    ap.add_argument("--knobs", default=None,
                    help="comma list of individual knobs (see optimized.KNOBS)")
    ap.add_argument("--variant", default=None, help="label for this run's result keys")
    args = ap.parse_args(argv)

    archs = DRYRUN_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    run = RunConfig(remat=args.remat)
    knobs = None
    if args.opt:
        knobs = set()
    if args.knobs is not None:
        knobs = set(k for k in args.knobs.split(",") if k)
    variant = args.variant or ("opt" if knobs is not None else "base")

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = {}
    if out_path.exists():
        results = {tuple(r["key"]): r for r in json.loads(out_path.read_text())}

    t_all = time.perf_counter()
    try:
        for mesh_kind in meshes:
            for arch in archs:
                for shape_name in shapes:
                    key = (arch, shape_name, mesh_kind, variant)
                    if args.skip_existing and key in results and \
                            results[key].get("status") in ("ok", "skipped"):
                        continue
                    r = run_cell(arch, shape_name, mesh_kind, run, knobs=knobs)
                    r["key"] = list(key)
                    r["variant"] = variant
                    r["remat"] = args.remat
                    results[key] = r
                    status = r["status"]
                    extra = ""
                    if status == "ok":
                        extra = (f"compute={r['compute_s']*1e3:.2f}ms "
                                 f"memory={r['memory_s']*1e3:.2f}ms "
                                 f"min_memory={r['min_memory_s']*1e3:.2f}ms "
                                 f"coll={r['collective_s']*1e3:.2f}ms "
                                 f"dom={r['dominant']} "
                                 f"frac={r['roofline_fraction']:.2f} "
                                 f"[{r['compile_seconds']:.0f}s]")
                    elif status == "error":
                        extra = r["error"][:160]
                    print(f"[{mesh_kind}] {arch} × {shape_name}: {status} {extra}", flush=True)
                    out_path.write_text(json.dumps(list(results.values()), indent=1))
    finally:
        close_mesh()

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\nDONE: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors "
          f"in {time.perf_counter() - t_all:.0f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
