"""The port's training recipes on a card against ``--device cpu``.

These tests need an NVIDIA GPU and skip without one; they import neither
JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_examples_gpu.py

Each recipe's ``main`` runs at tiny sizes on the card and on the CPU
(the kernels' plain versions) from the same seeds: every step's loss
agrees to 1e-4 of |loss|, the card's run launches the recipe's kernels,
and mini-batch GraphSAGE gives the same batches and losses with and
without ``--workers 4``.  The distributed recipe runs on two gloo
processes sharing the card, flat and hierarchical, against the
single-card recipe.
"""

import numpy as np
import pytest
import torch

from pytorch_sparse_tpu_torch.examples import (
    train_cluster_gcn, train_gat, train_gcn, train_sage_minibatch)
from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm, edge_softmax, edge_softmax_bwd)

import _torch_dist_workers as W

GATE = 1e-4
RECIPES = {
    "train_gcn": (train_gcn, ["--nodes", "128", "--edges", "600",
                              "--features", "16", "--hidden", "8",
                              "--epochs", "3"], (csr_spmm,)),
    "train_gat": (train_gat, ["--nodes", "200", "--edges", "1200",
                              "--features", "16", "--hidden", "8",
                              "--classes", "3", "--heads", "2",
                              "--epochs", "3"],
                  (csr_spmm, edge_softmax, edge_softmax_bwd)),
    "train_cluster_gcn": (train_cluster_gcn, [
        "--nodes", "300", "--edges", "2400", "--features", "16",
        "--hidden", "8", "--classes", "4", "--parts", "4", "--epochs",
        "2"], (csr_spmm,)),
    "train_sage_minibatch": (train_sage_minibatch, [
        "--steps", "3", "--nodes", "400", "--edges", "3000", "--features",
        "16", "--hidden", "8", "--batch", "32", "--fanouts", "4", "3"],
        (csr_spmm,)),
}


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (CUDA kernels have no "
                    "CPU mode)")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= GATE * np.abs(want)), (got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_on_the_card_equals_the_cpu(name):
    _need_gpu()
    mod, argv, kernels = RECIPES[name]
    for k in kernels:
        k.launches = 0
    card = mod.main(argv)
    assert card["device"].startswith("cuda")
    assert all(k.launches > 0 for k in kernels), {
        k.__name__: k.launches for k in kernels}
    cpu = mod.main(argv + ["--device", "cpu"])
    _close(card["losses"], cpu["losses"])
    assert np.isfinite(card["losses"]).all() and card["ms_per_step"] > 0


@pytest.mark.gpu
def test_sage_prefetch_on_the_card_gives_the_same_batches():
    _need_gpu()
    mod, argv, _ = RECIPES["train_sage_minibatch"]
    sync = mod.main(argv)
    pre = mod.main(argv + ["--workers", "4"])
    assert sync["losses"] == pre["losses"]
    for a, b in zip(sync["batches"], pre["batches"]):
        assert np.array_equal(a["targets"], b["targets"])
        for key in ("n_id", "e_id", "rowptr"):
            for x, y in zip(a[key], b[key]):
                assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.gpu
def test_distributed_recipe_on_the_card_equals_the_single_card():
    """Two gloo processes on the card (ring, then the hierarchical
    schedule on (2, 1)) from the recipe's own initial weights: each
    step's loss within 1e-4 of the single-card recipe's."""
    _need_gpu()
    argv = RECIPES["train_gcn"][1]
    single = train_gcn.main(argv)
    model = train_gcn.make_model(train_gcn.parse_args(argv), "cpu")
    layers = [(w.detach().clone(), b.detach().clone())
              for w, b in zip(model.weights, model.biases)]
    ranks = W.spawn(W.run_train_gcn, 2, "gloo",
                    args=dict(argv=argv + ["--distributed"], layers=layers,
                              slices=(2,)), timeout=600.0)
    for r in ranks:
        for sched in ("ring", "hier"):
            _close(r[sched]["losses"].numpy(), single["losses"])
            assert r[sched]["shard_spmm_launches"] > 0
