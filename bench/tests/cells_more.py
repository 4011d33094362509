"""Small sizes of the cells that ``bench/tests/cells.py`` does not size: the
same kinds of width at a few hundred thousand parameters, traffic a few
dozen tokens long, through the kernels' plain versions on the CPU.

``MLA_MOE`` is a DeepSeek-V2 decoder of two layers, one dense and one MoE
(8 experts, top-2, one shared, gates unnormalised, dropless), MLA at R 32
with YaRN's rope and score scale on."""

from bench.tests.cells import HYBRID, SEED  # noqa: F401  (sets sys.path)

MLA_MOE = dict(num_layers=2, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=4,
               head_dim=48, kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
               d_ff=256, num_experts=8, num_shared_experts=1, top_k=2, moe_d_ff=64)
SMALL = {
    "deepseek-v2-lite-16b.decode": (MLA_MOE, dict(
        sessions=4, history=dict(median=40, sigma=0.5, range=[48, 64]), prefill_tokens=64,
        turn_tokens=dict(median=16, sigma=0.8, range=[16, 32]), capacity=96, warmup_steps=2,
        trace_steps=2, trace_host_steps=1, check_turns=4)),
    "hymba-1.5b.prefill": (HYBRID, dict(
        lengths=dict(median=96, sigma=0.5, range=[64, 128], multiple=32), block=8,
        max_requests=4000, trace_requests=2, trace_host_requests=1, check_requests=3)),
}
# Limits at these sizes, as cells.py's SMALL_LIMITS: a small decode cell
# serves a few dozen tokens of a 2-layer model, the program's widest gap
# reading 0-0.022 and the control's 0.17-0.29 on the tests' first seeds (and
# 0.083-0.135 where a window ends after 13 steps); a small prefill's
# logit_err reads 0.008-0.011 for the program, 0.067-0.153 for the control
# (bench/tests/test_bench_more_cells.py holds both sides).
SMALL_LIMITS = {"deepseek-v2-lite-16b.decode": {"served_gap": 0.1},
                "hymba-1.5b.prefill": {"logit_err": 0.04}}
# The window: long enough that a loaded CPU still ends some turns and checks
# a few dozen tokens, on which the control's gap reads above the limit (the
# check samples what the window served, so a shorter window reads less).
SECONDS = 1.0


def run_small(cell: str, *, trace: bool = False, seed: int = SEED, control=None) -> dict:
    from bench.lib import harness
    model, traffic = SMALL[cell]
    return harness.execute(cell, seed=seed, seconds=SECONDS, trace=trace, device="cpu",
                           model=model, traffic=traffic, limits=SMALL_LIMITS.get(cell),
                           control=control)
