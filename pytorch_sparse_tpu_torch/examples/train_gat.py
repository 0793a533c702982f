"""GAT training on a synthetic citation-style graph (the port of the JAX
package's ``examples/train_gat.py``, same flags and defaults: 2,708
nodes, 10,556 edges with self-loops, 256 -> 4 heads x 64 -> 7,
``Adam(5e-3)``, the full-graph negative log-likelihood).

Each attention layer runs the edge-softmax kernel and one CSR SpMM a
head, forward and backward (``models/gat.py``); the card by default,
``--device cpu`` the kernels' plain versions.

    python -m pytorch_sparse_tpu_torch.examples.train_gat
    python -m pytorch_sparse_tpu_torch.examples.train_gat --device cpu \\
        --nodes 500
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from ..models import GAT
from ..tensor import SparseTensor
from ..typing import resolve_device
from ._common import (accuracy, add_device_flag, steady_ms,
                      step, timed_steps)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=2708)
    p.add_argument("--edges", type=int, default=10556)
    p.add_argument("--features", type=int, default=256)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--classes", type=int, default=7)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--epochs", type=int, default=30)
    add_device_flag(p)
    return p.parse_args(argv)


def synthetic_graph(M: int, E: int, F: int, C: int, seed: int = 0,
                    device=None):
    """``(A, x, labels)``: ``E`` uniform draws over ``M`` nodes,
    coalesced, with every self-loop (``set_diag``, the GAT convention),
    ``(M, F)`` normal features and ``C`` uniform classes, from
    ``RandomState(seed)`` in the JAX recipe's order."""
    rng = np.random.RandomState(seed)
    adj = SparseTensor(row=rng.randint(0, M, E), col=rng.randint(0, M, E),
                       sparse_sizes=(M, M),
                       device=device).coalesce("add").set_diag()
    x = torch.from_numpy(rng.randn(M, F).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, C, M).astype(np.int32)).to(
        device)
    return adj, x, labels


def make_model(args, device) -> GAT:
    """The recipe's GAT, its weights from
    ``torch.Generator().manual_seed(0)``."""
    return GAT(args.features, args.hidden, args.classes, heads=args.heads,
               generator=torch.Generator().manual_seed(0), device=device)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    adj, x, labels = synthetic_graph(args.nodes, args.edges, args.features,
                                     args.classes, device=device)
    model = make_model(args, device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    losses, ms = timed_steps(lambda i: step(model, opt, adj, x, labels),
                             args.epochs, device)
    for epoch, loss in enumerate(losses):
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch}: loss={loss:.4f}")
    with torch.no_grad():
        acc = accuracy(model(adj, x), labels)
    res = dict(recipe="train_gat", device=str(device), losses=losses,
               accuracy=acc, ms_per_step=steady_ms(ms), step_ms=ms,
               first_step_ms=ms[0], route="csr (per-head CSR SpMM)",
               nodes=args.nodes, nnz=adj.nnz())
    print(f"train accuracy: {acc:.3f} (first step {ms[0] / 1e3:.2f}s, then "
          f"~{res['ms_per_step']:.2f} ms/step on {device})")
    return res


if __name__ == "__main__":
    main()
