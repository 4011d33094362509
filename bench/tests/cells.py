"""Small sizes of the benchmark's cells for the CPU tests: the same widths'
kinds at a few hundred thousand parameters, traffic a few dozen tokens
long, through the kernels' plain versions."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DENSE = dict(num_layers=2, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
             head_dim=32, d_ff=256)
HYBRID = dict(num_layers=2, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2,
              head_dim=32, window=64, d_ff=256, ssm_state=8, ssm_heads=4, ssm_head_dim=32,
              ssm_chunk=32)
SMALL = {
    "command-r-35b.decode": (DENSE, dict(
        sessions=4, history=dict(median=40, sigma=0.5, range=[48, 64]), prefill_tokens=64,
        turn_tokens=dict(median=16, sigma=0.8, range=[16, 32]), capacity=96, warmup_steps=2,
        trace_steps=2, trace_host_steps=1, check_turns=4)),
    "hymba-1.5b.decode": (HYBRID, dict(sessions=3, history=64, prefill_tokens=64,
                                       warmup_steps=2, trace_steps=2, trace_host_steps=1,
                                       check_turns=3)),
    "command-r-35b.prefill": (DENSE, dict(
        lengths=dict(median=48, sigma=0.8, range=[32, 64], multiple=16), block=8,
        max_requests=4000, trace_requests=2, trace_host_requests=1)),
    "hymba-1.5b.train": (HYBRID, dict(batch=2, seq=64, trace_steps=1, trace_host_steps=1)),
}
# Limits at these sizes where a cell's own do not fit them. A decode cell
# here serves a few dozen to a few hundred tokens of a 2-layer model, as many
# as a 0.15-0.5 s window's steps allow: on the control test's seeds the
# control's widest gap reads 0.17-0.86, the program's 0-0.057 (0.79 and 1.76
# for the control at the cells' sizes, which their limits of 0.3 and 0.75
# are set against).
SMALL_LIMITS = {"command-r-35b.decode": {"served_gap": 0.1},
                "hymba-1.5b.decode": {"served_gap": 0.1}}
SECONDS = 0.5
SEED = 2**31 + 12345          # larger than 32 signed bits hold


def run_small(cell: str, *, trace: bool = False, seed: int = SEED, control=None) -> dict:
    from bench.lib import harness
    model, traffic = SMALL[cell]
    return harness.execute(cell, seed=seed, seconds=SECONDS, trace=trace, device="cpu",
                           model=model, traffic=traffic, limits=SMALL_LIMITS.get(cell),
                           control=control)
