"""Plain reference of the GCN (Kipf and Welling, as OGB's products
script trains it): ``A_hat = D^-1/2 (A + I) D^-1/2`` over the unique
edges with every self-loop set to 1, and per layer
``x = A_hat @ (x W) + b``, ReLU and dropout after the hidden layers.
Dropout masks are drawn as the port's ``GCN`` draws them (one
``torch.rand`` of the activation's shape a hidden layer, kept where the
draw is at least the rate), from an identical generator."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import Adj, coalesce, mm, spmm


def leaf_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    dims = ([cfg["in_channels"]]
            + [cfg["hidden_channels"]] * (cfg["num_layers"] - 1)
            + [cfg["out_channels"]])
    n = cfg["num_layers"]
    return ([(f"weights.{i}", (dims[i], dims[i + 1])) for i in range(n)]
            + [(f"biases.{i}", (dims[i + 1],)) for i in range(n)])


def adjacency(row: torch.Tensor, col: torch.Tensor, M: int) -> Adj:
    row, col = coalesce(row, col, M, M)
    off = row != col
    loop = torch.arange(M, device=row.device)
    row = torch.cat([row[off], loop])
    col = torch.cat([col[off], loop])
    deg = torch.bincount(row, minlength=M).to(torch.float32)
    dinv = torch.rsqrt(deg)
    return Adj(row, col, dinv[row] * dinv[col], M, M)


def forward(p: Dict[str, torch.Tensor], adj: Adj, x: torch.Tensor,
            train: bool, gen, tf32: bool, cfg: Dict) -> torch.Tensor:
    n = cfg["num_layers"]
    rate = float(cfg["dropout"]) if train else 0.0
    for i in range(n):
        x = spmm(adj, mm(x, p[f"weights.{i}"], tf32), tf32) + p[f"biases.{i}"]
        if i < n - 1:
            x = torch.relu(x)
            if rate > 0.0:
                keep = torch.rand(x.shape, generator=gen,
                                  device=x.device) >= rate
                x = torch.where(keep, x / (1.0 - rate), 0.0)
    return x
