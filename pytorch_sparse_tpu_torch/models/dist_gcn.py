"""Distributed GCN over ``torch.distributed`` (counterpart of
``pytorch_sparse_tpu/models/dist_gcn.py``).

Rows of the (partition-permuted) adjacency are split over the mesh; each
rank holds its row block of the node features and of every activation;
each graph aggregation is a distributed SpMM (``dist_spmm`` on a flat
layout, ``dist_spmm_hier`` on the hierarchical one); the dense
projections act on the rank's rows.  On a ``(data, feat)`` grid
(``make_mesh2d``) a rank holds only its feature block of those rows'
columns: each projection gathers the row block's columns over the
feature sub-mesh and computes the rank's block of output columns.
:meth:`DistGCN.loss` is the GLOBAL masked mean, and
:meth:`DistGCN.train_step` all-reduces the parameter gradients with SUM
before every rank takes the same optimizer step, so that the parameters
stay identical on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import _comm
from ..parallel.dist import ShardedSparseMatrix, dist_spmm
from ..parallel.hier import HierShardedSparseMatrix, dist_spmm_hier
from ..parallel.mesh import Mesh, feat_axis
from .gcn import GCN


class _GatherColumns(torch.autograd.Function):
    """The ``(Nb, Kf)`` column blocks of every rank of a feature
    sub-mesh side by side in rank order, ``(Nb, Pf*Kf)``.  Its transpose
    hands each rank the sum of every rank's gradient of its columns,
    added over the sub-mesh in rank order (``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        ctx.mesh = mesh
        parts = _comm.all_gather(mesh, x).view(mesh.size, *x.shape)
        return parts.transpose(0, 1).reshape(x.shape[0], -1)

    @staticmethod
    def backward(ctx, g):
        P, Nb = ctx.mesh.size, g.shape[0]
        parts = g.reshape(Nb, P, -1).transpose(0, 1).reshape(P * Nb, -1)
        return None, _comm.reduce_scatter(ctx.mesh, parts)


def _feature_mesh(adj) -> Optional[Mesh]:
    """The feature sub-mesh of a ``(data, feat)`` grid of more than one
    feature block, else None."""
    if isinstance(adj, ShardedSparseMatrix) and adj.Pf > 1:
        return adj.grid.axis(feat_axis)
    return None


class DistGCN(GCN):
    """The parameters of :class:`GCN` (and its ``from_jax_params``) with
    a distributed forward: ``x = dist_spmm(adj, x @ w) + b``, ReLU
    between layers, no dropout (as the JAX package's ``DistGCN``).

    ``adj`` is this rank's :class:`ShardedSparseMatrix` (on a 1-D mesh
    or a ``(data, feat)`` grid) or :class:`HierShardedSparseMatrix` of a
    square matrix, ``x`` its feature block (``adj.shard_dense``): ``(Nb,
    in_dim)``, or ``(Nb, in_dim/Pf)`` on a grid of ``Pf`` feature blocks,
    where the logits are likewise the rank's ``(Nb, out_dim/Pf)`` block.
    On a grid every width must divide by ``Pf``: the forward raises
    ``ValueError`` before any collective otherwise, as the JAX package's
    ``shard_map`` does.  The parameters are whole on every rank.
    ``schedule`` is ``"ring"`` (default), ``"allgather"`` or ``"halo"``
    for a flat layout; a hierarchical one runs its own schedule (``None``
    or ``"hier"``; another name raises ``ValueError``, as in the JAX
    package).  ``local_format`` selects the local compute of the halo
    and hierarchical schedules (default ``"auto"``: the interior dense
    blocks where they are built, since training differentiates features
    and weights, never edge values).  The loss and the gradients are
    all-reduced over every process of the layout (``adj.world``).
    """

    def forward(self, adj, x: torch.Tensor, schedule: Optional[str] = None,
                local_format: str = "auto") -> torch.Tensor:
        if isinstance(adj, HierShardedSparseMatrix):
            if schedule not in (None, "hier"):
                raise ValueError(
                    f"schedule={schedule!r} requested but `adj` is a "
                    "HierShardedSparseMatrix (it runs the hierarchical "
                    "schedule only)")

            def agg(h):
                return dist_spmm_hier(adj, h, "sum", local_format)
        elif isinstance(adj, ShardedSparseMatrix):
            schedule = schedule or "ring"

            def agg(h):
                return dist_spmm(adj, h, schedule, "sum", local_format)
        else:
            raise TypeError("DistGCN takes a ShardedSparseMatrix or a "
                            "HierShardedSparseMatrix")
        if adj.M != adj.N:
            raise ValueError("DistGCN needs a square adjacency")
        feat = _feature_mesh(adj)
        if feat is not None:
            self._check_widths(feat.size, x)
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            if feat is not None:
                # Every column of the row block in, this rank's block of
                # the output columns out.
                Hf = w.shape[1] // feat.size
                cols = slice(feat.rank * Hf, (feat.rank + 1) * Hf)
                x, w, b = _GatherColumns.apply(feat, x), w[:, cols], b[cols]
            x = agg(x @ w) + b
            if i < n - 1:
                x = torch.relu(x)
        return x

    def _check_widths(self, Pf: int, x: torch.Tensor) -> None:
        """Every width divides by ``Pf`` and ``x`` holds ``in_dim/Pf``
        columns.  The parameters are alike on every rank, and so are the
        shapes of the blocks, so every rank raises here or none does."""
        dims = [self.weights[0].shape[0]] + [w.shape[1]
                                             for w in self.weights]
        if any(d % Pf for d in dims):
            raise ValueError(
                f"DistGCN on a (data, feat) grid needs every width "
                f"divisible by the feature-axis size {Pf}; widths {dims}")
        if x.shape[-1] * Pf != dims[0]:
            raise ValueError(
                f"x has {x.shape[-1]} columns; in_dim={dims[0]} over {Pf} "
                f"feature blocks gives {dims[0] // Pf}")

    def loss(self, adj, x: torch.Tensor,
             labels: torch.Tensor, mask: torch.Tensor,
             schedule: Optional[str] = None,
             local_format: str = "auto") -> torch.Tensor:
        """This rank's share of the global masked mean negative
        log-likelihood: ``sum(nll * mask)`` over its rows divided by the
        all-reduced ``sum(mask)`` (at least 1).  ``labels`` and ``mask``
        are ``(Nb,)`` blocks; ``mask`` is 0 on the padding rows.  The
        shares of all ranks add up to the loss.  On a ``(data, feat)``
        grid every feature rank of a row block gathers the block's
        logits; the all-reduced count then counts each row once per
        feature rank, so each holds ``1/Pf`` of the block's share, and
        the gather's transpose adds the ``Pf`` gradients of each
        feature block back up."""
        logits = self(adj, x, schedule, local_format)
        feat = _feature_mesh(adj)
        if feat is not None:
            logits = _GatherColumns.apply(feat, logits)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
        mask = mask.to(nll.dtype)
        count = _comm.all_reduce_sum(adj.world, mask.sum().detach())
        return (nll * mask).sum() / count.clamp_min(1.0)

    def train_step(self, optimizer: torch.optim.Optimizer,
                   adj, x: torch.Tensor,
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
            adj.world, torch.cat([p.grad.reshape(-1) for p in params]))
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
        optimizer.step()
        return _comm.all_reduce_sum(adj.world, share.detach())
