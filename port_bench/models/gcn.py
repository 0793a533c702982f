"""The port's GCN as the cell drives it: ``gcn_norm`` of the coalesced
adjacency, ``pytorch_sparse_tpu_torch.models.GCN``, its masked loss with
dropout, and its eval forward; and the model's operations an epoch."""

from __future__ import annotations

from typing import Dict, List

import torch

from pytorch_sparse_tpu_torch.models import GCN, gcn_norm

from ..metrics import _work


def _dims(cfg: Dict) -> List[int]:
    return ([cfg["in_channels"]]
            + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            + [cfg["out_channels"]])


def prepare(adj):
    """The matrix the model multiplies by: ``D^-1/2 (A + I) D^-1/2``."""
    return gcn_norm(adj)


def spmm_calls(cfg: Dict) -> List[Dict]:
    """The SpMMs of one forward, in order: each layer aggregates at its
    output width, and every operand (``x W``) needs its gradient."""
    return [{"K": k, "reduce": "sum", "backward": True}
            for k in _dims(cfg)[1:]]


def make(cfg: Dict, params: Dict[str, torch.Tensor], device) -> GCN:
    model = GCN(cfg["in_channels"], cfg["hidden_channels"],
                cfg["out_channels"], num_layers=cfg["num_layers"],
                device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params[name])
    return model


def train_loss(model: GCN, adj, x, y, mask, cfg: Dict, gen):
    return model.loss(adj, x, y, mask, dropout_rate=float(cfg["dropout"]),
                      generator=gen)


def logits(model: GCN, adj, x):
    return model(adj, x)


def epoch_flops(cfg: Dict, M: int, nnz: int) -> float:
    """Operations of one epoch: the train forward, its backward (every
    weight's gradient, every input's but the features', every SpMM's
    transpose) and the eval forward."""
    dims = _dims(cfg)
    fwd = bwd = 0.0
    for i in range(len(dims) - 1):
        f, b = _work.dense_layer_flops(M, dims[i], dims[i + 1], i > 0)
        s = _work.spmm_flops(nnz, dims[i + 1])
        fwd += f + s
        bwd += b + s
    return 2.0 * fwd + bwd
