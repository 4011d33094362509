#!/usr/bin/env python3
"""Where the engine's real time goes on a 1-page move, card against host.

    python3 tools/engine_move_costs.py

On one GPU, in one process:

1. the host time of one 4 KB engine-shaped write, the way the engine moves
   it (``core/buffers.py``: a ready event at submit unless the stream is
   idle, the NIC worker's host wait on it, ``copy_parts`` on the worker's
   stream, the interpreter lock held throughout) and the way the same move goes through torch calls
   (``torch.cuda.Event``, ``Stream.wait_event``, ``copy_``,
   ``synchronize``, each of which lets the lock go), from a buffer on the
   card and from one on the host; alone, and with 4 threads moving at once
   (median and p99 a move);
2. two calibration runs per device (``chip_smoke.py``'s point) with the
   host time of every byte move (the NIC worker's whole copy scope) and
   every submit-side ready event recorded.

Prints the card's name and power limit, one line per measurement, then one
JSON line.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (  # noqa: E402
    CALIBRATION_OPS,
    CALIBRATION_SPEC,
    CALIBRATION_WORKLOAD,
)
from repro_torch import box  # noqa: E402
from repro_torch.core.buffers import copy_parts, ready_event, worker_stream  # noqa: E402
from repro_torch.model import ModelWorkload, run_calibration  # noqa: E402

PAGE = 4096


def engine_move(device: str):
    """One 1-page write the way the engine moves it."""
    dst = torch.empty(PAGE, dtype=torch.uint8, pin_memory=device == "cuda")
    src = torch.zeros(PAGE, dtype=torch.uint8, device=device)
    if device == "cpu":
        return lambda: copy_parts([(dst, src)])

    def move():
        ev = ready_event([src])
        if ev is not None:
            ev.synchronize()
        with torch.cuda.stream(worker_stream(src.device)):
            copy_parts([(dst, src)])
    return move


def torch_move(device: str):
    """The same write through torch's calls, each letting the lock go."""
    dst = torch.empty(PAGE, dtype=torch.uint8, pin_memory=device == "cuda")
    src = torch.zeros(PAGE, dtype=torch.uint8, device=device)
    if device == "cpu":
        return lambda: dst.copy_(src)

    def move():
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(src.device))
        stream = worker_stream(src.device)
        stream.wait_event(ev)
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
        stream.synchronize()
    return move


def alone_us(fn, n: int = 2000) -> float:
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def threaded_us(factory, threads: int = 4, n: int = 500) -> list:
    """Per-move host µs [median, p99] with ``threads`` threads moving at once."""
    times: list = []
    lock = threading.Lock()

    def run():
        fn = factory()
        local = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            local.append((time.perf_counter() - t0) * 1e6)
        with lock:
            times.extend(local)
    ts = [threading.Thread(target=run) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    times.sort()
    return [statistics.median(times), times[int(0.99 * len(times))]]


def pct(v: list) -> list:
    """[count, median, p99, max, sum] of host µs samples."""
    if not v:
        return [0, 0.0, 0.0, 0.0, 0.0]
    v = sorted(v)
    return [len(v), statistics.median(v), v[int(0.99 * len(v))], v[-1], sum(v)]


def timed_calibration(device: str) -> dict:
    """One calibration run with the host time of every byte move (the NIC
    worker's whole copy scope) and every submit-side ready event kept."""
    from repro_torch.core import nic as nic_mod
    from repro_torch.core import rdmabox as rdmabox_mod
    moves, readies = [], []
    scope, ready = nic_mod.SimulatedNIC._copy_scope, rdmabox_mod.ready_event

    @contextlib.contextmanager
    def timed_scope(nic, requests):
        t0 = time.perf_counter()
        with scope(nic, requests):
            yield
        moves.append((time.perf_counter() - t0) * 1e6)

    def timed_ready(payloads):
        t0 = time.perf_counter()
        ev = ready(payloads)
        readies.append((time.perf_counter() - t0) * 1e6)
        return ev

    nic_mod.SimulatedNIC._copy_scope = timed_scope
    rdmabox_mod.ready_event = timed_ready
    try:
        r = run_calibration(box.ClusterSpec(**CALIBRATION_SPEC),
                            ModelWorkload(**CALIBRATION_WORKLOAD),
                            ops_per_client=CALIBRATION_OPS, device=device)
    finally:
        nic_mod.SimulatedNIC._copy_scope = scope
        rdmabox_mod.ready_event = ready
    return {"latency_ratio": r.latency_ratio, "measured_mean_us": r.measured_mean_us,
            "move_us": pct(moves), "ready_event_us": pct(readies)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("engine_move_costs: torch sees no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    moves = {}
    for way, factory in (("engine", engine_move), ("torch", torch_move)):
        for device in ("cuda", "cpu"):
            key = f"{way} {device}"
            moves[key] = {"alone_us": alone_us(factory(device)),
                          "four_threads_us": threaded_us(lambda d=device: factory(d))}
            print(f"{key}: alone {moves[key]['alone_us']:.2f} us a move; 4 threads "
                  f"median {moves[key]['four_threads_us'][0]:.1f} us, "
                  f"p99 {moves[key]['four_threads_us'][1]:.1f} us", flush=True)
    timed = {d: [timed_calibration(d) for _ in range(2)] for d in ("cuda", "cpu")}
    for d, rows in timed.items():
        for row in rows:
            print(f"timed calibration on {d}: latency ratio {row['latency_ratio']:.3f}, "
                  f"moves [n, median, p99, max, sum] us {row['move_us']}, "
                  f"ready events {row['ready_event_us']}", flush=True)
    print(json.dumps({"moves": moves, "timed_calibration": timed}))


if __name__ == "__main__":
    main()
