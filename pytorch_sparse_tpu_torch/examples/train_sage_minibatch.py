"""Mini-batch GraphSAGE training: the sampler -> batch -> step pipeline
(the port of the JAX package's ``examples/train_sage_minibatch.py``,
same flags and defaults: 50,000 nodes, 400,000 edges, 128 -> 64 -> 16,
batches of 512 targets, fanouts 10, 5, ``Adam(1e-3)``, 20 steps).

Per batch, ``sample_adj`` draws one bipartite adjacency per hop,
innermost hop first, on the host (the port's host library), from a
host copy of the graph whose values are its edge ids; the hops go to
the card without their values, the features are gathered there, and
GraphSAGE aggregates each hop by the mean SpMM over the exact, unpadded
hop (no static shapes or scratch rows: the JAX recipe pads only for
``jit``).

``--workers N`` overlaps sampling with the card's step through
``MinibatchPrefetcher``: the library's calls are ``ctypes`` foreign
calls, which release the interpreter lock, so worker threads sample at
once; batch order and every seed derive from the batch index, so the
batches are the same at any worker count.

    python -m pytorch_sparse_tpu_torch.examples.train_sage_minibatch
    python -m pytorch_sparse_tpu_torch.examples.train_sage_minibatch \\
        --workers 4
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np
import torch

from ..models import GraphSAGE, nll_loss
from ..ops.matmul import spmm_mean
from ..sample import MinibatchPrefetcher, sample_adj
from ..tensor import SparseTensor
from ..typing import resolve_device
from ._common import accuracy, add_device_flag, sync


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=50_000)
    p.add_argument("--edges", type=int, default=400_000)
    p.add_argument("--features", type=int, default=128)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--fanouts", type=int, nargs="+", default=[10, 5])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--workers", type=int, default=0,
                   help="prefetch worker threads (0 = synchronous)")
    add_device_flag(p)
    return p.parse_args(argv)


def synthetic_graph(M: int, E: int, F: int, C: int, seed: int = 0,
                    device=None):
    """``(A, feats, labels)``: ``A`` the coalesced graph of ``E`` uniform
    draws over ``M`` nodes on the host, its values the edge ids (int32)
    so that each sampled hop carries its edges' ids; ``(M, F)`` normal
    features and ``C`` uniform classes on ``device``; all from
    ``RandomState(seed)`` in the JAX recipe's order."""
    rng = np.random.RandomState(seed)
    A = SparseTensor(row=rng.randint(0, M, E).astype(np.int32),
                     col=rng.randint(0, M, E).astype(np.int32),
                     sparse_sizes=(M, M), device="cpu").coalesce("add")
    A = A.set_value(torch.arange(A.nnz(), dtype=torch.int32), layout="coo")
    feats = torch.from_numpy(rng.randn(M, F).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, C, M).astype(np.int32)).to(
        device)
    return A, feats, labels


def make_model(args, device) -> GraphSAGE:
    """The recipe's GraphSAGE (a layer a hop), its weights from
    ``torch.Generator().manual_seed(0)``."""
    return GraphSAGE(args.features, args.hidden, args.classes,
                     num_layers=len(args.fanouts),
                     generator=torch.Generator().manual_seed(0),
                     device=device)


def make_batch(A: SparseTensor, feats: torch.Tensor, labels: torch.Tensor,
               batch: int, fanouts: List[int], it: int) -> Dict:
    """Batch ``it``, all of its randomness keyed by ``it`` (the
    prefetcher's determinism contract): targets from
    ``RandomState(100_000 + it)``, hop ``h`` by ``sample_adj`` with
    ``seed=1000 + it * 10 + h``, innermost hop first.  ``adjs`` are the
    hops on the features' device without values, ``x`` the features of
    the last hop's ``n_id``, ``y`` the targets' labels; ``n_id``,
    ``e_id`` and ``rowptr`` of each hop stay on the host."""
    device = feats.device
    targets = np.random.RandomState(100_000 + it).choice(
        A.sparse_size(0), batch, replace=False).astype(np.int64)
    frontier = torch.from_numpy(targets)
    n_ids, e_ids, rowptrs, adjs = [], [], [], []
    for h, k in enumerate(fanouts):
        adj, n_id = sample_adj(A, frontier, k, replace=False,
                               seed=1000 + it * 10 + h)
        n_ids.append(n_id)
        e_ids.append(adj.storage.value())
        rowptrs.append(adj.storage.numpy_view("rowptr"))
        adjs.append(adj.set_value(None).to_device(device))
        frontier = n_id
    return dict(it=it, targets=targets, n_id=n_ids, e_id=e_ids,
                rowptr=rowptrs, adjs=adjs,
                x=feats[frontier.to(device).long()],
                y=labels[torch.from_numpy(targets).to(device)])


def sage_forward(model: GraphSAGE, adjs, x: torch.Tensor, agg=spmm_mean,
                 relu=torch.relu) -> torch.Tensor:
    """GraphSAGE over sampled bipartite hops, innermost hop first in
    ``adjs``: layer ``i`` aggregates over ``adjs[n-1-i]`` with ``agg(adj,
    x)`` (the mean SpMM) and keeps the hop's target rows of ``x``; ReLU
    (``relu``) between layers.  The unpadded form of the JAX recipe's
    ``sage_bipartite_apply``, on the module's parameters."""
    n = len(model.b)
    for i in range(n):
        adj = adjs[n - 1 - i]
        n_tgt = adj.sparse_size(0)
        x = x[:n_tgt] @ model.w_self[i] + agg(adj, x) @ model.w_neigh[i] \
            + model.b[i]
        if i < n - 1:
            x = relu(x)
    return x


def step(model: GraphSAGE, opt: torch.optim.Optimizer, batch: Dict
         ) -> torch.Tensor:
    """One step on a batch: the targets' mean negative log-likelihood,
    backward, Adam.  Returns the loss."""
    opt.zero_grad()
    loss = nll_loss(sage_forward(model, batch["adjs"], batch["x"]),
                    batch["y"])
    loss.backward()
    opt.step()
    return loss.detach()


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    A, feats, labels = synthetic_graph(args.nodes, args.edges, args.features,
                                       args.classes, device=device)
    model = make_model(args, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def make(it):
        return make_batch(A, feats, labels, args.batch, args.fanouts, it)

    losses, batches = [], []
    res = dict(recipe="train_sage_minibatch", device=str(device),
               workers=args.workers, batch=args.batch,
               fanouts=list(args.fanouts), route="csr (mean SpMM per hop)")
    if args.workers > 0:
        # Warm the kernels' first launches outside the timed loop without
        # a parameter update, so that the run trains the batches of the
        # synchronous path from the same weights.
        warm = make(0)
        nll_loss(sage_forward(model, warm["adjs"], warm["x"]),
                 warm["y"]).backward()
        opt.zero_grad()
        sync(device)
        t0 = time.perf_counter()
        for batch in MinibatchPrefetcher(make, args.steps,
                                         num_workers=args.workers):
            losses.append(step(model, opt, batch).item())
            batches.append(batch)
        sync(device)
        wall = time.perf_counter() - t0
        res.update(ms_per_step=wall / args.steps * 1e3,
                   steps_per_s=args.steps / wall)
        print(f"minibatch SAGE (prefetch x{args.workers}): final "
              f"loss={losses[-1]:.4f}  {res['steps_per_s']:.2f} steps/s "
              f"end-to-end ({res['ms_per_step']:.2f} ms/step, "
              f"batch={args.batch}, fanouts={args.fanouts}, {device})")
    else:
        sample_ms, step_ms = [], []
        t_start = time.perf_counter()
        for it in range(args.steps):
            t0 = time.perf_counter()
            batch = make(it)
            t1 = time.perf_counter()
            losses.append(step(model, opt, batch).item())
            sync(device)
            t2 = time.perf_counter()
            batches.append(batch)
            if it == 0:  # the kernels' first launches: out of the averages
                t_start += t2 - t0
            sample_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
        n = max(args.steps - 1, 1)
        wall = time.perf_counter() - t_start
        res.update(sample_ms=sample_ms, step_ms=step_ms,
                   sample_ms_per_batch=sum(sample_ms[1:]) / n,
                   ms_per_step=sum(step_ms[1:]) / n,
                   steps_per_s=n / wall)
        print(f"minibatch SAGE: final loss={losses[-1]:.4f}  sample "
              f"{res['sample_ms_per_batch']:.2f} ms/batch, train step "
              f"{res['ms_per_step']:.2f} ms/batch, "
              f"{res['steps_per_s']:.2f} steps/s end-to-end "
              f"(batch={args.batch}, fanouts={args.fanouts}, {device})")
    last = batches[-1]
    with torch.no_grad():
        res["accuracy"] = accuracy(
            sage_forward(model, last["adjs"], last["x"]), last["y"])
    res.update(losses=losses, batches=[
        {k: b[k] for k in ("targets", "n_id", "e_id", "rowptr")}
        for b in batches])
    return res


if __name__ == "__main__":
    main()
