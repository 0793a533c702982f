"""End-to-end GCN training on a synthetic Cora-scale graph (the port of
the JAX package's ``examples/train_gcn.py``, same flags and defaults:
Kipf and Welling's Cora widths, 2,708 nodes, 10,556 edges, 1433 -> 16
-> 7, ``Adam(1e-2)``, full-graph).

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions); ``--distributed`` trains the row-partitioned ``DistGCN`` over
``torch.distributed``: on the default process group when one is
initialized, else on one started from the environment that ``torchrun``
sets (loopback only).  Each rank uses ``cuda:{local_rank %
device_count}``.  The schedule is ``ring`` (the JAX recipe's), or the
hierarchical one on ``make_mesh_hier(S, world // S)`` with ``--slices
S``.

    python -m pytorch_sparse_tpu_torch.examples.train_gcn
    python -m pytorch_sparse_tpu_torch.examples.train_gcn --device cpu
    torchrun --standalone --nproc-per-node 4 \\
        -m pytorch_sparse_tpu_torch.examples.train_gcn --distributed \\
        --backend gloo
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..models import GCN, DistGCN, gcn_norm
from ..parallel import (HierShardedSparseMatrix, ShardedSparseMatrix,
                        make_mesh, make_mesh_hier)
from ..parallel import _comm
from ..tensor import SparseTensor
from ..typing import resolve_device
from ._common import (accuracy, add_device_flag, route,
                      steady_ms, step, timed_steps)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodes", type=int, default=2708)
    p.add_argument("--edges", type=int, default=10556)
    p.add_argument("--features", type=int, default=1433)
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--classes", type=int, default=7)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--slices", type=int, default=1,
                   help="with --distributed: split the processes into this "
                        "many slices (the hierarchical schedule, "
                        "parallel/hier.py)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="with --distributed and no process group yet: the "
                        "backend (default nccl on cuda, gloo on cpu)")
    add_device_flag(p)
    return p.parse_args(argv)


def synthetic_graph(M: int, E: int, F: int, C: int, seed: int = 0,
                    device=None):
    """``(gcn_norm(A), x, labels)``: ``E`` uniform draws over ``M``
    nodes coalesced, ``(M, F)`` normal features and ``C`` uniform
    classes, from ``RandomState(seed)`` in the JAX recipe's order."""
    rng = np.random.RandomState(seed)
    adj = gcn_norm(SparseTensor(
        row=rng.randint(0, M, E).astype(np.int32),
        col=rng.randint(0, M, E).astype(np.int32),
        sparse_sizes=(M, M), device=device).coalesce("add"))
    x = torch.from_numpy(rng.randn(M, F).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, C, M).astype(np.int32)).to(
        device)
    return adj, x, labels


def make_model(args, device, cls=GCN):
    """The recipe's two-layer model, glorot weights from
    ``torch.Generator().manual_seed(0)``."""
    return cls(args.features, args.hidden, args.classes,
               generator=torch.Generator().manual_seed(0), device=device)


def train_single(args, device: torch.device) -> Dict:
    adj, x, labels = synthetic_graph(args.nodes, args.edges, args.features,
                                     args.classes, device=device)
    model = make_model(args, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses, ms = timed_steps(lambda i: step(model, opt, adj, x, labels),
                             args.epochs, device)
    with torch.no_grad():
        acc = accuracy(model(adj, x), labels)
    res = dict(recipe="train_gcn", device=str(device), losses=losses,
               accuracy=acc, ms_per_step=steady_ms(ms), step_ms=ms,
               route=route(adj), nodes=args.nodes, nnz=adj.nnz())
    print(f"single-device: final loss={losses[-1]:.4f} train-acc={acc:.3f}"
          f"  ~{res['ms_per_step']:.2f} ms/step ({device}, route "
          f"{res['route']})")
    return res


def rank_device(device_name: str) -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (the local
    rank from ``LOCAL_RANK``, else the group rank), or the CPU."""
    if resolve_device(device_name).type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", tdist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def train_distributed(args, make: Optional[Callable] = None) -> Dict:
    """``DistGCN`` over the default process group (started from the
    environment when there is none, and then destroyed at the end).
    ``make(device)`` gives the model (the recipe's by default)."""
    own_group = not tdist.is_initialized()
    if own_group:
        backend = args.backend or (
            "gloo" if resolve_device(args.device).type == "cpu" else "nccl")
        tdist.init_process_group(backend)
    try:
        device = rank_device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        world = tdist.get_world_size()
        adj, x, labels = synthetic_graph(args.nodes, args.edges,
                                         args.features, args.classes,
                                         device=device)
        if args.slices > 1:
            # Hierarchical (DCN x ICI) layout: intra-slice halos, slice-
            # deduplicated unions across slices (parallel/hier.py).
            mesh = make_mesh_hier(args.slices, world // args.slices,
                                  device=device)
            Ash = HierShardedSparseMatrix.from_sparse_tensor(adj, mesh)
        else:
            mesh = make_mesh(world, device=device)
            Ash = ShardedSparseMatrix.from_sparse_tensor(adj, mesh)
        xs = Ash.shard_dense(x)
        # Labels and a 0/1 mask sharded as the operand: the padding rows
        # past the last node take label 0 and mask 0.
        labels_s = Ash.shard_dense(labels)
        mask_s = Ash.shard_dense(torch.ones(args.nodes, device=device))
        model = (make or (lambda d: make_model(args, d, DistGCN)))(device)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        losses, ms = timed_steps(
            lambda i: model.train_step(opt, Ash, xs, labels_s, mask_s),
            args.epochs, device)
        with torch.no_grad():
            hit = (model(Ash, xs).argmax(-1) == labels_s.long()).float()
            acc = float(_comm.all_reduce_sum(Ash.world, (hit * mask_s).sum())
                        / args.nodes)
        res = dict(recipe="train_gcn --distributed", device=str(device),
                   world=world, slices=args.slices,
                   schedule="hier" if args.slices > 1 else "ring",
                   backend=str(tdist.get_backend()), losses=losses,
                   accuracy=acc, ms_per_step=steady_ms(ms), step_ms=ms)
        if tdist.get_rank() == 0:
            print(f"distributed ({world} devices, {res['schedule']}): "
                  f"final loss={losses[-1]:.4f} train-acc={acc:.3f}  "
                  f"~{res['ms_per_step']:.2f} ms/step ({device})")
        return res
    finally:
        if own_group:
            tdist.destroy_process_group()


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.distributed:
        return train_distributed(args)
    return train_single(args, resolve_device(args.device))


if __name__ == "__main__":
    main()
