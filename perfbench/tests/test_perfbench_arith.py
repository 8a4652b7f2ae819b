"""Rates and tails over every sample, and the yardstick's byte, FLOP and
MAC counts on shapes known by hand."""
import pytest

from perfbench.harness import costs, peaks, stats
from perfbench.harness import core


def test_percentile_over_all_samples():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    # a tail is of all samples, not of chunk medians
    assert stats.percentile([1] * 90 + [100] * 10, 95) == 100
    assert stats.median([3, 1, 2]) == 2


def test_k1_launch_cost():
    nbytes, ops = costs.k1_launch(1, 10, 32, 5)
    assert nbytes == 2 * 10 * 32 + 4 * (5 * 32 + 10)
    assert ops == 10 * 32 * 5
    assert costs.bound_s(3.35e12, 0, 1) == pytest.approx(1.0)
    assert costs.bound_s(0, 67e12, peaks.ALU_OPS_PER_S) == pytest.approx(1.0)


CNN = core.load_json(core.BENCH_DIR / "configs" / "resnet50.json")


def test_resnet50_sites_at_224():
    sites = costs.cnn_sites(CNN, 1)
    assert len(sites) == 54
    assert sites[0] == ("stem", 112 * 112, 147, 64)
    assert sites[-1] == ("fc", 1, 2048, 1000)
    macs = sum(M * K * N for _, M, K, N in sites)
    assert macs == pytest.approx(4.09e9, rel=0.01)
    assert costs.cnn_flops(CNN, 256) == pytest.approx(2 * 256 * macs)
    # operand words an image: 21.8M bf16 (the issue's CPU trace)
    words = sum(M * K + K * N / 256 for _, M, K, N in
                costs.cnn_sites(CNN, 256)) / 256
    assert words == pytest.approx(21.8e6, rel=0.01)


def test_cnn_k1_rows_of_the_menu():
    cfg = dict(CNN, resolution=16)
    nbytes, ops = costs.cnn_k1_call(cfg, 1)
    by_hand_b = by_hand_o = 0.0
    for _, M, K, N in costs.cnn_sites(cfg, 1):
        for L, r in ((-(-M // 16) * 16, 10), (-(-N // 16) * 16, 9)):
            by_hand_b += 2 * K * L + 4 * (r * L + K)
            by_hand_o += K * L * r
    assert (nbytes, ops) == (by_hand_b, by_hand_o)


def test_minicpm3_counts():
    cfg = core.load_json(core.BENCH_DIR / "configs" / "minicpm3-4b.json")
    assert costs.k2_launches(cfg) == 62 * 7 + 1 == 435
    layers = costs.lm_matmul_params(cfg) - 2560 * 73448
    assert layers == pytest.approx(3.89e9, rel=0.005)
    nbytes, flops = costs.k2_step(cfg, 128)
    weights = sum(K * N for K, N in costs.lm_weights(cfg))
    assert nbytes > 2 * weights and flops == 2 * 128 * weights
    b3, o3 = costs.k3_call(128, 2560, 6400)
    assert b3 == (2 * 128 * 1024 + 2 * 1024 * 256
                  + 4 * (128 * 256 + 128 * 6 * 16 + 128 * 1024 + 5 * 256
                         + 1024))
    b1, _ = costs.k1_admission(cfg, 4096)
    assert b1 == 2 * ((2 * 1024 * 256 + 4 * (6 * 256 + 1024))
                      + (2 * 1024 * 256 + 4 * (5 * 256 + 1024)))
