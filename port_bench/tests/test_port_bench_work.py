"""The yardstick's arithmetic pinned to cases worked by hand."""

import pytest

from port_bench import spec
from port_bench.metrics import _work


def test_spmm_flops_and_bytes():
    # 10 edges, 4 x 6 matrix, K = 8.
    assert _work.spmm_flops(10, 8) == 160.0
    # valued: 10*(4+4) + 5*4 + 6*8*4 + 4*8*4 = 80 + 20 + 192 + 128
    assert _work.spmm_bytes(10, 4, 6, 8, True) == 420.0
    # no values: 10*4 + 20 + 192 + 128
    assert _work.spmm_bytes(10, 4, 6, 8, False) == 380.0


def test_spmm_min_seconds_takes_the_larger_bound():
    # Products-sized: 107M edges, 2,449,029 rows, K = 256, valued.
    t, by = _work.spmm_min_seconds(107_000_000, 2_449_029, 2_449_029, 256,
                                   True)
    flops_s = 2 * 107e6 * 256 / 67e12
    bytes_s = (107e6 * 8 + 2_449_030 * 4 + 2 * 2_449_029 * 256 * 4) / 3.35e12
    assert by == "bytes" and t == pytest.approx(bytes_s)
    assert bytes_s > flops_s
    # A dense-ish case: 1,000 rows, 1,000,000 edges, K = 4096: flops.
    t, by = _work.spmm_min_seconds(10**6, 1000, 1000, 4096, True)
    assert by == "flops" and t == pytest.approx(2e6 * 4096 / 67e12)


def test_dense_layer_flops():
    assert _work.dense_layer_flops(10, 3, 5, False) == (300.0, 300.0)
    assert _work.dense_layer_flops(10, 3, 5, True) == (300.0, 600.0)


def test_share_pct():
    assert _work.share_pct([1.0, 1.0], [4.0, 4.0]) == 25.0
    assert _work.share_pct([1.0], [0.0]) is None


def _cfg(model):
    return {"in_channels": 3, "hidden_channels": 4, "out_channels": 2,
            "num_layers": 2, "model": model}


def test_gcn_epoch_flops_by_hand():
    gcn = spec.load_module("models", "gcn")
    # M = 10, nnz = 20; dims 3 -> 4 -> 2.
    # forward: dense 2*10*3*4 + 2*10*4*2 = 240 + 160; SpMM 2*20*4 + 2*20*2
    fwd = 240 + 160 + 160 + 80
    # backward: weight grads 240 + 160, input grad of layer 2 only 160,
    # every SpMM's transpose 160 + 80.
    bwd = 240 + 160 + 160 + 160 + 80
    assert gcn.epoch_flops(_cfg("gcn"), 10, 20) == 2 * fwd + bwd


def test_sage_epoch_flops_by_hand():
    sage = spec.load_module("models", "sage")
    # layer 1 (3 -> 4): two products 2*2*10*3*4 = 480, SpMM at K=3: 120;
    # layer 2 (4 -> 2): 2*2*10*4*2 = 320, SpMM at K=4: 160.
    fwd = 480 + 120 + 320 + 160
    # backward: layer 1 weight grads only (480); layer 2 weight and input
    # grads (640) and its SpMM's transpose (160).
    bwd = 480 + 640 + 160
    assert sage.epoch_flops(_cfg("sage"), 10, 20) == 2 * fwd + bwd


def test_spmm_calls_follow_the_models():
    gcn = spec.load_module("models", "gcn")
    sage = spec.load_module("models", "sage")
    cfg = _cfg("gcn")
    assert [(c["K"], c["backward"]) for c in gcn.spmm_calls(cfg)] == [
        (4, True), (2, True)]
    assert [(c["K"], c["backward"]) for c in sage.spmm_calls(cfg)] == [
        (3, False), (4, True)]
