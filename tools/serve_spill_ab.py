#!/usr/bin/env python3
"""Decode tok/s of the qwen1.5-0.5b serving path with and without --spill.

    python3 tools/serve_spill_ab.py

On one GPU, in one process, after one warm-up run, in the order plain,
idle, spill, spill, idle, plain: serving without the remote-KV tier
("plain"); the same while a session of the ``--spill`` spec, its kv_store
built, stays open and idle ("idle": its NIC, poller and delay-line threads
alive, nothing appended); and with the tier (``--spill --donors 3
--replication 2 --clients 2``, "spill"). Then the host time of one step's
row copy and four appends alone. Prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import serve  # noqa: E402

BASE = ["--arch", "qwen1.5-0.5b", "--batch", "4", "--prompt-len", "64",
        "--page-tokens", "16"]
SPILL = ["--spill", "--donors", "3", "--replication", "2", "--clients", "2"]
GEN = 32


def decode_tok_s(args) -> float:
    res = serve.main(BASE + ["--gen", str(GEN)] + args)
    torch.cuda.empty_cache()
    return GEN * 4 / res.decode_s


def spill_session():
    """A session and kv_store as ``serve --spill`` builds them (same spec
    and pool), for the idle arm and the append timing."""
    args = serve._parser().parse_args(BASE + SPILL)
    return serve._open_kv_store(args, None, torch.device("cuda"))


def idle_tok_s() -> float:
    session, _ = spill_session()
    try:
        return decode_tok_s([])
    finally:
        session.close()


def append_ms_per_step() -> float:
    """One decode step's kv_store work alone: a row a sequence from pinned
    memory, four appends; host clock over 32 steps ending in a sync."""
    session, kv = spill_session()
    try:
        rng = np.random.default_rng(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GEN):
            rows = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
            rows = rows.pin_memory().to("cuda", non_blocking=True)
            for b in range(4):
                kv.append_tokens(b, rows[b:b + 1])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / GEN * 1e3
    finally:
        session.close()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serve_spill_ab: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    serve.main(BASE + ["--gen", "2"])          # cuBLAS and allocator warm-up
    torch.cuda.empty_cache()
    arms = {"plain": lambda: decode_tok_s([]), "idle": idle_tok_s,
            "spill": lambda: decode_tok_s(SPILL)}
    order = ["plain", "idle", "spill"]
    out = {name: [] for name in order}
    for name in order + order[::-1]:
        out[name].append(arms[name]())
    out["append_ms_per_step"] = append_ms_per_step()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
