"""Plain reference of GraphSAGE with the mean aggregator (Hamilton et
al., as OGB's products script trains it with ``--use_sage``): per layer
``x = x W_self + mean_{j in N(i)} x_j W_neigh + b`` over the unique
edges (a row with no edge aggregates to 0), ReLU after the hidden
layers, no dropout (the port's ``GraphSAGE`` has none)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import Adj, coalesce, mm, spmm


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    dims = ([cfg["in_channels"]]
            + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            + [cfg["out_channels"]])
    n = cfg["num_layers"]
    return ([(f"w_self.{i}", (dims[i], dims[i + 1])) for i in range(n)]
            + [(f"w_neigh.{i}", (dims[i], dims[i + 1])) for i in range(n)]
            + [(f"b.{i}", (dims[i + 1],)) for i in range(n)])


def adjacency(row: torch.Tensor, col: torch.Tensor, M: int) -> Adj:
    row, col = coalesce(row, col, M, M)
    deg = torch.bincount(row, minlength=M).clamp_min(1).to(torch.float32)
    return Adj(row, col, None, M, M, scale=deg)


def forward(p: Dict[str, torch.Tensor], adj: Adj, x: torch.Tensor,
            train: bool, gen, tf32: bool, cfg: Dict) -> torch.Tensor:
    n = cfg["num_layers"]
    for i in range(n):
        neigh = spmm(adj, x, tf32)
        x = (mm(x, p[f"w_self.{i}"], tf32)
             + mm(neigh, p[f"w_neigh.{i}"], tf32) + p[f"b.{i}"])
        if i < n - 1:
            x = torch.relu(x)
    return x
