"""Cluster-GCN training: partitions as mini-batches (the port of the JAX
package's ``examples/train_cluster_gcn.py``, same flags and defaults:
20,000 nodes in 32 planted communities, 200,000 edges, 64 -> 128 -> 16,
8 parts, ``Adam(1e-2)``, 5 epochs).

The graph is partitioned k-way by the port's multilevel partitioner
(``adj.partition``, its host library); each part's diagonal block is cut
by ``narrow`` twice and normalised by ``gcn_norm``, and takes one GCN
step a epoch through the routed SpMM.  Parts keep their own sizes: the
JAX recipe pads every block to the largest part and masks the padding
rows, which only its ``jit`` needs.  After training, the full graph's
``gcn_norm`` gives the train accuracy.

    python -m pytorch_sparse_tpu_torch.examples.train_cluster_gcn
    python -m pytorch_sparse_tpu_torch.examples.train_cluster_gcn \\
        --device cpu --nodes 2000
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models import GCN, gcn_norm
from ..tensor import SparseTensor
from ..typing import resolve_device
from ._common import accuracy, add_device_flag, route, step, sync


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--edges", type=int, default=200000)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--epochs", type=int, default=5)
    add_device_flag(p)
    return p.parse_args(argv)


def synthetic_community_graph(M: int, E: int, F: int, C: int, n_comm: int,
                              seed: int = 0, device=None):
    """``(A, x, labels)`` with planted communities (partitions with a low
    cut, the regime Cluster-GCN assumes): 85% of the ``E`` draws stay
    inside the source's community.  ``A`` coalesced on ``device``; ``x``
    ``(M, F)`` and ``labels`` host numpy; all from ``RandomState(seed)``
    in the JAX recipe's order."""
    rng = np.random.RandomState(seed)
    comm = rng.randint(0, n_comm, M)
    order = np.argsort(comm)
    ptr = np.searchsorted(comm[order], np.arange(n_comm + 1))
    src = rng.randint(0, M, E)
    intra = rng.rand(E) < 0.85
    c = comm[src[intra]]
    dst = rng.randint(0, M, E)
    dst[intra] = order[ptr[c] + (rng.rand(int(intra.sum()))
                                 * (ptr[c + 1] - ptr[c])).astype(int)]
    adj = SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                       device=device).coalesce("add")
    x = rng.randn(M, F).astype(np.float32)
    labels = rng.randint(0, C, M).astype(np.int32)
    return adj, x, labels


def cluster_batches(adj: SparseTensor, x: np.ndarray, labels: np.ndarray,
                    num_parts: int) -> Tuple[List[Tuple], np.ndarray,
                                             np.ndarray]:
    """Partition, then cut each part's diagonal block (``narrow`` twice,
    then ``gcn_norm``) and its features and labels, on ``adj``'s device.
    Returns the batches ``(block, x, labels)`` in part order, ``partptr``
    and ``perm`` (new position -> old node)."""
    dev = adj.device()
    padj, partptr, perm = adj.partition(num_parts)
    pp, perm_np = partptr.cpu().numpy(), perm.cpu().numpy()
    x_p, labels_p = x[perm_np], labels[perm_np]
    batches = []
    for p in range(num_parts):
        lo, hi = int(pp[p]), int(pp[p + 1])
        blk = gcn_norm(padj.narrow(0, lo, hi - lo).narrow(1, lo, hi - lo))
        batches.append((blk, torch.from_numpy(x_p[lo:hi]).to(dev),
                        torch.from_numpy(labels_p[lo:hi]).to(dev)))
    return batches, pp, perm_np


def make_model(args, device) -> GCN:
    """The recipe's two-layer GCN, glorot weights from
    ``torch.Generator().manual_seed(0)``."""
    return GCN(args.features, args.hidden, args.classes,
               generator=torch.Generator().manual_seed(0), device=device)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    adj, x, labels = synthetic_community_graph(
        args.nodes, args.edges, args.features, args.classes,
        n_comm=args.parts * 4, device=device)
    t0 = time.perf_counter()
    batches, partptr, perm = cluster_batches(adj, x, labels, args.parts)
    build_s = time.perf_counter() - t0
    sizes = np.diff(partptr)
    print(f"partition + batch build: {build_s:.2f}s ({len(batches)} "
          f"clusters, sizes {int(sizes.min())}-{int(sizes.max())})")

    model = make_model(args, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses, step_ms, epoch_ms = [], [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        tot = 0.0
        for blk, xb, yb in batches:
            t1 = time.perf_counter()
            loss = step(model, opt, blk, xb, yb).item()
            sync(device)
            step_ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(loss)
            tot += loss
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"epoch {epoch}: loss {tot / len(batches):.4f} "
              f"({epoch_ms[-1] / 1e3:.2f}s, {len(batches)} cluster steps)")

    # Full-graph evaluation with the cluster-trained weights.
    full = gcn_norm(adj)
    with torch.no_grad():
        acc = accuracy(model(full, torch.from_numpy(x).to(device)),
                       torch.from_numpy(labels).to(device))
    print(f"full-graph train accuracy: {acc:.3f}")
    rest = step_ms[len(batches):] or step_ms
    return dict(recipe="train_cluster_gcn", device=str(device),
                losses=losses, accuracy=acc,
                ms_per_step=sum(rest) / len(rest), step_ms=step_ms,
                epoch_ms=epoch_ms, build_s=build_s,
                part_sizes=sizes.tolist(), partptr=partptr, perm=perm,
                routes=[route(b[0]) for b in batches])


if __name__ == "__main__":
    main()
