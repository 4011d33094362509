"""What the benchmark's ``deepseek-v2-lite-16b.decode`` cell does not print:
how its decode steps ran, what its routing counters read, and how often the
program's bf16 router picks other experts than the plain f32 reference's.

    python3 tools/moe_cell_probe.py --seed 3100000101 --seconds 45 \\
        --out results/moe_probe.json

1. The cell once (``bench.lib.harness.execute``, untraced), with
   ``Transformer.decode_step`` wrapped to keep each step's
   ``decode_graphs(cache).snapshot()`` and the MoE layers' routing counters
   (``MoE.routed``): the window's steps replayed and run eagerly, and the
   pairs routed and dropped over the run (prefill and every decode step).
2. Router agreement: the program (bf16, through its ``_route``) and the
   reference (f32, through its ``moe``) over the same ``--tokens`` seeded
   tokens of two sequences, each MoE layer's top-k sets compared token by
   token: the share of (token, layer) whose sets differ, and of tokens with
   any layer differing. The reference sees its own hidden states, so a
   difference in one layer carries into the next.

Needs a CUDA device (``--small`` runs the CPU tests' small sizes on the
CPU instead); one JSON object on the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

CELL = "deepseek-v2-lite-16b.decode"


def _small():
    from bench.tests.cells_more import SMALL, SMALL_LIMITS
    model, traffic = SMALL[CELL]
    return dict(device="cpu", model=model, traffic=traffic, limits=SMALL_LIMITS[CELL])


def run_cell(seed: int, seconds: float, small: bool) -> dict:
    from bench.lib import harness
    from repro_torch.models import transformer
    steps, routed = [], []
    orig = transformer.Transformer.decode_step

    def wrapped(self, cache, *a, **k):
        out = orig(self, cache, *a, **k)
        steps.append(self.decode_graphs(cache).snapshot())
        if not routed:
            routed.extend(blk.moe.routed for blk in self.blocks if blk.moe is not None)
        return out

    transformer.Transformer.decode_step = wrapped
    try:
        res = harness.execute(CELL, seed=seed, seconds=seconds, trace=False,
                              t0=time.perf_counter(), **(_small() if small else {}))
    finally:
        transformer.Transformer.decode_step = orig
    window = int(res["notes"]["window_steps"])
    first, last = steps[-window - 1], steps[-1]
    per = [r[:-1].cpu() for r in routed]
    return {"correct": res["correct"], "checks": res["checks"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "peak_gb": res["device"]["memory_peak_bytes"] / 1e9, "notes": res["notes"],
            "steps": len(steps), "window_steps": window,
            "window_replays": last["replays"] - first["replays"],
            "window_eager": {k: v - first["eager"].get(k, 0) for k, v in last["eager"].items()
                             if v - first["eager"].get(k, 0)},
            "graphs": last,
            "routing": {"moe_layers": len(per), "pairs": sum(int(p.sum()) for p in per),
                        "dropped": sum(int(r[-1]) for r in routed),
                        "most_an_expert": max(int(p.max()) for p in per),
                        "least_an_expert": min(int(p.min()) for p in per)}}


def route_agreement(seed: int, tokens: int, small: bool) -> dict:
    import numpy as np
    import torch

    from bench.lib import program, spec
    from bench.lib.harness import release
    from bench.lib.weights import Weights
    from repro_torch.models import moe as moe_mod
    cell = spec.Cell(CELL)
    ref = cell.reference()
    m = {**cell.config["model"], **(_small()["model"] if small else {})}
    dev = torch.device("cpu" if small else "cuda")
    w = Weights(ref.groups(m), ref.full_name, seed, dev)

    class R:                  # what ``program.build`` reads of a run
        model, device = m, dev
    _, model = program.build(R, w)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, m["vocab_size"], (2, tokens)))
    mine, theirs = [], []
    route = moe_mod._route

    def keep_route(xt, p, cfg, *rest):
        out = route(xt, p, cfg, *rest)
        mine.append(out[1].sort(-1).values.cpu())
        return out
    moe_mod._route = keep_route
    try:
        with torch.no_grad():
            model(toks.to(dev))
    finally:
        moe_mod._route = route
    del model
    release(dev)
    ref_moe = ref.moe

    def keep_moe(p, f, mm_, quant):
        probs = torch.softmax(ref.mm(f, p["moe.router"], quant), dim=-1)
        theirs.append(torch.topk(probs, mm_["top_k"], -1).indices.sort(-1).values.cpu())
        return ref_moe(p, f, mm_, quant)
    ref.moe = keep_moe
    try:
        ref.logits_at(w.group, m, toks.to(dev), [[tokens - 1]] * 2)
    finally:
        ref.moe = ref_moe
    differ = torch.stack([(a != b).any(-1) for a, b in zip(mine, theirs)])   # (layers, tokens)
    return {"tokens": 2 * tokens, "moe_layers": len(mine),
            "token_layers_differing": float(differ.float().mean()),
            "tokens_any_layer_differing": float(differ.any(0).float().mean()),
            "by_layer": [round(float(x), 5) for x in differ.float().mean(1)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--tokens", type=int, default=2048)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = {"cell": CELL, "seed": args.seed, "run": run_cell(args.seed, args.seconds, args.small)}
    print(json.dumps(out), flush=True)
    out["routers"] = route_agreement(args.seed, args.tokens, args.small)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
