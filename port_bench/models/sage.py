"""The port's GraphSAGE (mean aggregator) as the cell drives it: the
coalesced adjacency as it is, ``pytorch_sparse_tpu_torch.models.
GraphSAGE``, its masked loss (no dropout: the port's model has none) and
its eval forward; and the model's operations an epoch."""

from __future__ import annotations

from typing import Dict, List

import torch

from pytorch_sparse_tpu_torch.models import GraphSAGE

from ..metrics import _work


def _dims(cfg: Dict) -> List[int]:
    return ([cfg["in_channels"]]
            + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            + [cfg["out_channels"]])


def prepare(adj):
    return adj


def spmm_calls(cfg: Dict) -> List[Dict]:
    """The SpMMs of one forward, in order: each layer aggregates at its
    input width; the first layer's operand (the features) needs no
    gradient."""
    return [{"K": k, "reduce": "mean", "backward": i > 0}
            for i, k in enumerate(_dims(cfg)[:-1])]


def make(cfg: Dict, params: Dict[str, torch.Tensor], device) -> GraphSAGE:
    model = GraphSAGE(cfg["in_channels"], cfg["hidden_channels"],
                      cfg["out_channels"], num_layers=cfg["num_layers"],
                      device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model


def train_loss(model: GraphSAGE, adj, x, y, mask, cfg: Dict, gen):
    return model.loss(adj, x, y, mask)


def logits(model: GraphSAGE, adj, x):
    return model(adj, x)


def epoch_flops(cfg: Dict, M: int, nnz: int) -> float:
    """Operations of one epoch: the train forward (the SpMM and both
    projections a layer), its backward (every weight's gradient; the
    inputs' and the SpMM's transpose from the second layer on) and the
    eval forward."""
    dims = _dims(cfg)
    fwd = bwd = 0.0
    for i in range(len(dims) - 1):
        f, b = _work.dense_layer_flops(M, dims[i], dims[i + 1], i > 0)
        s = _work.spmm_flops(nnz, dims[i])
        fwd += 2.0 * f + s
        bwd += 2.0 * b + (s if i > 0 else 0.0)
    return 2.0 * fwd + bwd
