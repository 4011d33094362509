"""The latent attention kernel's yardstick (``latent_attn_roofline.decode``):
its byte count at one small shape, worked by hand, and a reading from a
traced segment that has the kernel, and none from one that has not."""

from types import SimpleNamespace

import pytest

from bench.lib import roofline as rf
from bench.lib.spec import Cell
from bench.lib.trace import Segment

MODEL = {"num_heads": 4, "num_layers": 2, "kv_lora_rank": 32, "qk_rope_dim": 16}


def reader():
    return Cell("deepseek-v2-lite-16b.decode").reader("latent_attn_roofline.decode")


def test_bytes_count_the_live_latent_once():
    # 2 layers, B 3 at lengths 5, 1, 10: 16 live tokens of 32 + 16 bf16 values,
    # q_lat and o_lat (3 x 4 x 32 f32 each), q_pe (3 x 4 x 16 bf16)
    flops, f32, nbytes = reader().step_work(MODEL, [5, 1, 10])
    assert nbytes == 2 * (16 * 48 * 2 + 2 * 3 * 4 * 32 * 4 + 3 * 4 * 16 * 2) == 9_984
    assert flops == 2 * 2 * 4 * (2 * 32 + 16) * 16 == 20_480 and f32 == 0.0
    _, _, longer = reader().step_work(MODEL, [6, 1, 10])
    assert longer - nbytes == 2 * 48 * 2                # one more token, every layer


def test_reads_the_kernels_device_time_and_nothing_without_them():
    lengths = [5, 1, 10]
    least = rf.least_s(reader().step_work(MODEL, lengths))
    kernels = [("void (anonymous namespace)::latent_attention_kernel<32, 16, 16, 32, 2>",
                0.0, 4 * least),
               ("void (anonymous namespace)::latent_attention_combine", 5.0, 5.0 + 4 * least),
               ("sm80_xmma_gemm_f32f32_f32f32_f32_nn", 6.0, 7.0)]
    run = SimpleNamespace(model=MODEL, segment=Segment(kernels, units=[lengths, lengths]))
    assert reader().read(run) == pytest.approx(100.0 * 2 * least / (8 * least))
    run.segment = Segment(kernels[2:], units=[lengths])
    assert reader().read(run) is None                   # the parent: no such kernel
    assert reader().read(SimpleNamespace(model={"num_heads": 4}, segment=None)) is None
