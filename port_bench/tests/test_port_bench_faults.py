"""The check fails what it must: the control (the reference in TF32, the
nearest precision below the configuration's float32, put in the
program's place) and each fault a training cell can have, planted under
a whole run with the harness's look for a card skipped.  The faults: a
step that leaves the state unchanged; the loss taken over half of the
training nodes; an answer (one node's prediction) altered where it is
produced.  One chip, so no exchange between chips to leave out."""

import time

import pytest
import torch

import pytorch_sparse_tpu_torch.models as ptm
from port_bench import check, control, run
from port_bench.tests._tiny import CELLS, tiny_cell

DEV = torch.device("cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_and_the_planted_faults_are_not_correct(workload):
    recs = control.readings(tiny_cell(workload), 2**33 + 7, DEV)
    by = {r["variant"]: r for r in recs}
    assert set(by) == {"sound_reference", *control.VARIANTS}
    for v in control.VARIANTS:
        assert not by[v]["correct"], (v, by[v]["numbers"])


class _Frozen(torch.optim.Adam):
    def step(self, closure=None):
        return None


def _half_loss(orig):
    def loss(self, adj, x, labels, mask=None, *args, **kwargs):
        idx = torch.nonzero(mask)[:, 0]
        half = torch.zeros_like(mask)
        half[idx[: idx.shape[0] // 2]] = 1
        return orig(self, adj, x, labels, half, *args, **kwargs)
    return loss


def _altered_preds(orig):
    def preds_of(logits):
        pred = orig(logits).clone()
        pred[0] = (int(pred[0]) + 1) % logits.shape[-1]
        return pred
    return preds_of


def _plant(monkeypatch, fault):
    if fault == "frozen":
        monkeypatch.setattr(run, "make_optimizer", lambda model, cfg:
                            _Frozen(model.parameters(), lr=cfg["lr"]))
    elif fault == "half":
        for cls in (ptm.GCN, ptm.GraphSAGE):
            monkeypatch.setattr(cls, "loss", _half_loss(cls.loss))
    elif fault == "answer":
        monkeypatch.setattr(check, "preds_of",
                            _altered_preds(check.preds_of))


@pytest.mark.parametrize("fault", ["frozen", "half", "answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_run_with_the_timed_path_broken_is_not_correct(workload, fault,
                                                         monkeypatch):
    _plant(monkeypatch, fault)
    res = run.run_cell(tiny_cell(workload), 2**32 + 3, 0.2, False, DEV,
                       time.perf_counter())
    assert not res["correct"], res["checks"]
    failed = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    expect = {"frozen": {"change_gap", "change_median_gap"},
              "half": {"loss_gap"}, "answer": {"pred_gap"}}[fault]
    assert expect & set(failed), res["checks"]
