"""Distributed GCN over ``torch.distributed`` (counterpart of
``pytorch_sparse_tpu/models/dist_gcn.py``).

Rows of the (partition-permuted) adjacency are split over the mesh; each
rank holds its row block of the node features and of every activation;
each graph aggregation is a distributed SpMM (``dist_spmm``); the dense
projections act on the rank's rows.  :meth:`DistGCN.loss` is the GLOBAL
masked mean, and :meth:`DistGCN.train_step` all-reduces the parameter
gradients with SUM before every rank takes the same optimizer step, so
that the parameters stay identical on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import _comm
from ..parallel.dist import ShardedSparseMatrix, dist_spmm
from .gcn import GCN


class DistGCN(GCN):
    """The parameters of :class:`GCN` (and its ``from_jax_params``) with
    a distributed forward: ``x = dist_spmm(adj, x @ w) + b``, ReLU
    between layers, no dropout (as the JAX package's ``DistGCN``).

    ``adj`` is this rank's :class:`ShardedSparseMatrix` of a square
    matrix, ``x`` its ``(Nb, in_dim)`` feature block
    (``adj.shard_dense``).  ``schedule`` is ``"ring"`` (default),
    ``"allgather"`` or ``"halo"``; ``local_format`` selects the halo
    schedule's local compute (default ``"auto"``: the interior dense
    blocks where they are built, since training differentiates features
    and weights, never edge values).
    """

    def forward(self, adj: ShardedSparseMatrix, x: torch.Tensor,
                schedule: Optional[str] = None,
                local_format: str = "auto") -> torch.Tensor:
        if not isinstance(adj, ShardedSparseMatrix):
            raise TypeError("DistGCN takes a ShardedSparseMatrix (the "
                            "hierarchical layout is not ported yet)")
        if adj.M != adj.N:
            raise ValueError("DistGCN needs a square adjacency")
        schedule = schedule or "ring"
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = dist_spmm(adj, x @ w, schedule, "sum", local_format) + b
            if i < n - 1:
                x = torch.relu(x)
        return x

    def loss(self, adj: ShardedSparseMatrix, x: torch.Tensor,
             labels: torch.Tensor, mask: torch.Tensor,
             schedule: Optional[str] = None,
             local_format: str = "auto") -> torch.Tensor:
        """This rank's share of the global masked mean negative
        log-likelihood: ``sum(nll * mask)`` over its rows divided by the
        all-reduced ``sum(mask)`` (at least 1).  ``labels`` and ``mask``
        are ``(Nb,)`` blocks; ``mask`` is 0 on the padding rows.  The
        shares of all ranks add up to the loss."""
        logits = self(adj, x, schedule, local_format)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
        mask = mask.to(nll.dtype)
        count = _comm.all_reduce_sum(adj.mesh, mask.sum().detach())
        return (nll * mask).sum() / count.clamp_min(1.0)

    def train_step(self, optimizer: torch.optim.Optimizer,
                   adj: ShardedSparseMatrix, x: torch.Tensor,
                   labels: torch.Tensor, mask: torch.Tensor,
                   schedule: Optional[str] = None,
                   local_format: str = "auto") -> torch.Tensor:
        """One step on every rank: backward of this rank's share, the
        parameter gradients all-reduced with SUM (one flat buffer), then
        ``optimizer.step()``.  Returns the global loss."""
        optimizer.zero_grad()
        share = self.loss(adj, x, labels, mask, schedule, local_format)
        share.backward()
        params = [p for p in self.parameters() if p.grad is not None]
        flat = _comm.all_reduce_sum(
            adj.mesh, torch.cat([p.grad.reshape(-1) for p in params]))
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
        optimizer.step()
        return _comm.all_reduce_sum(adj.mesh, share.detach())
