"""The yardstick's counts, against hand-worked shapes from PERF.md's kernel
table, and shares that cannot pass 100 %."""

import pytest

from bench.lib import roofline as rf


def test_ssd_scan_count_matches_kernel_3():
    # mamba2-780m's serving shape: x (4, 512, 48, 64), N 128, chunk 256
    _, flops, nbytes = rf.ssd_fwd(4, 512, 48, 64, 128, 256)
    assert flops / 1e9 == pytest.approx(4.906, abs=5e-4)
    assert nbytes / 1e6 == pytest.approx(59.1, abs=0.05)


def test_ssd_training_counts_match_table():
    _, flops, nbytes = rf.ssd_fwd(8, 512, 48, 64, 128, 256, states=True)
    assert flops / 1e9 == pytest.approx(9.81, abs=5e-3)
    _, flops, nbytes = rf.ssd_bwd(8, 512, 48, 64, 128, 256)
    assert flops / 1e9 == pytest.approx(23.03, abs=5e-3)
    assert nbytes / 1e6 == pytest.approx(186, abs=0.5)


def test_flash_backward_count_matches_kernel_2b():
    # B 8, S 512, H 12, Kh 4, D 64, bf16, causal
    flops, _, nbytes = rf.flash_bwd(8, 512, 12, 4, 64, None)
    assert nbytes == 33_947_648                     # "34.0 MB"
    assert flops / 1e9 == pytest.approx(8.07, abs=5e-3)
    assert rf.least_s((flops, 0.0, nbytes)) * 1e3 == pytest.approx(0.010134, abs=1e-6)


def test_windowed_pairs_count_only_inside_the_window():
    assert rf.attended_pairs(4, 4, True, None) == 10
    assert rf.attended_pairs(4, 4, True, 2) == 7
    S, W = 2048, 1024
    assert rf.attended_pairs(S, S, True, W) == W * (W + 1) // 2 + (S - W) * W


def test_paged_counts_live_tokens_only():
    a = rf.paged_decode(1000, 4, 64, 8, 128)
    b = rf.paged_decode(2000, 4, 64, 8, 128)
    assert b[0] == 2 * a[0]
    assert b[2] - a[2] == 1000 * 2 * 8 * 128 * 2


def test_least_time_is_the_larger_term():
    assert rf.least_s((989e12, 0.0, 0.0)) == pytest.approx(1.0)
    assert rf.least_s((0.0, 495e12, 0.0)) == pytest.approx(1.0)
    assert rf.least_s((0.0, 0.0, 3.35e12)) == pytest.approx(1.0)
    assert rf.least_s((989e12, 0.0, 6.7e12)) == pytest.approx(2.0)


def test_step_counts_scale_as_the_work():
    m = dict(num_layers=2, d_model=64, vocab_size=100, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128)
    one = rf.decode_step(m, [10])
    two = rf.decode_step(m, [10, 10])
    assert two[0] == pytest.approx(2 * one[0])
    assert two[2] > one[2]
    assert rf.prefill(m, 64)[0] > rf.prefill(m, 32)[0]
    assert rf.train_step(m, 2, 64)[0] > 3 * rf.forward_flops(m, 2, 64)[0]
