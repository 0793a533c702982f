"""Each cell's whole run at a tiny size on the CPU (the kernels' plain
versions), held to the reference by the cell's own limits, and the
run's result line."""

import time

import pytest
import torch

from port_bench import run
from port_bench.tests._tiny import CELLS, tiny_cell

ROUTES = {"gcn-products.clustered": "HybridFormat",
          "sage-products.shuffled": "csr"}


def _run(workload, traced, device="cpu", seed=2**31 + 11):
    return run.run_cell(tiny_cell(workload), seed, 0.3, traced,
                        torch.device(device), time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct_and_reports_the_cells_metrics(workload):
    res = _run(workload, traced=False)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"epoch_ms", "epoch_ms_p90", "setup_s"}
    assert list(res)[-1] == "checks"
    for name, v in res["checks"].items():
        assert v["value"] <= v["limit"], name


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_tiny_run_reads_the_route_and_the_spans(workload,
                                                         capsys):
    res = _run(workload, traced=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["build_s"]["value"] > 0 and m["route_build_s"]["value"] > 0
    assert 0 < m["epoch_mfu_pct"]["value"] < 100
    if ROUTES[workload] == "csr":
        assert m["block_edge_pct"]["value"] == 0
    else:
        assert 0 < m["block_edge_pct"]["value"] <= 100
    assert "breakdown" in res and res["device"]["window_s"] > 0
    assert f'"view": "{ROUTES[workload]}"' in capsys.readouterr().err


def test_the_same_seed_gives_the_same_first_epochs():
    a = _run("sage-products.shuffled", traced=False, seed=123)
    b = _run("sage-products.shuffled", traced=False, seed=123)
    assert a["checks"] == b["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _run(workload, traced=True, device="cuda")
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
