"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; what it runs
is found by name under ``bench/`` (see ``bench/lib/spec.py``). The run
builds the program's model from the seed's weights, warms up, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and ``breakdown`` when traced), then ``checks``: each number compared
with its limit, which are also the last lines of standard error.

It needs as many CUDA devices as the cell asks for, and fails (exit 2,
no result) without them. It fails (exit 3, no result) if JAX, Flax or the
JAX package were loaded by the time the window closed.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (Linux /proc)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# every cache stays inside the checkout, at fixed paths
_CACHE = os.path.join(ROOT, "bench", ".cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ.setdefault(_var, os.path.join(_CACHE, _sub))
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench.lib import harness
    from bench.lib.spec import Cell

    chips = Cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {chips} CUDA device(s); torch sees {seen}",
              file=sys.stderr)
        return 2
    result = harness.execute(args.workload, seed=args.seed, seconds=args.seconds,
                             trace=bool(args.trace), device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: modules loaded that must not be: {bad}", file=sys.stderr)
        return 3
    print(f"card: {_card()}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
