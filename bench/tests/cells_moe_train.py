"""The small size of ``deepseek-v2-lite-5l.train``: ``cells_more.MLA_MOE``'s
two layers (one dense, one MoE of 8 experts, top-2, one shared, gates
unnormalised, dropless, MLA at R 32 with YaRN) with the sequence-wise
balance loss on, trained on 2 × 64 tokens through the kernels' plain
versions on the CPU."""

from bench.tests.cells_more import MLA_MOE, SEED  # noqa: F401  (sets sys.path)

CELL = "deepseek-v2-lite-5l.train"
MODEL = dict(MLA_MOE, moe_seq_aux=True)
TRAFFIC = dict(batch=2, seq=64, trace_steps=1, trace_host_steps=1)
# Limits at this size: on eight seeds from SEED the program's change_gap read
# 0.0023-0.0058 and the control's 0.0111-0.0143, the program's grad_gap
# 0.0006-0.0052 and the control's 0.0093-0.0224 (a 2-layer model at d 128
# rounds more, relative to its gradients, than the cell's published widths,
# whose own limits are set from chip readings: PERF.md §6).
SMALL_LIMITS = {"grad_gap": 0.008, "change_gap": 0.009}
SECONDS = 0.5


def run_small(*, trace: bool = False, seed: int = SEED, control=None) -> dict:
    from bench.lib import harness
    return harness.execute(CELL, seed=seed, seconds=SECONDS, trace=trace, device="cpu",
                           model=MODEL, traffic=TRAFFIC, limits=SMALL_LIMITS, control=control)
