"""Plain PyTorch pieces of the reference: the adjacency worked out
again from the edge list, a sparse-dense product by ``index_add_`` in
blocks of edges, the masked negative log-likelihood, and the training
loop whose readings the check compares.

Nothing here imports the port.  Products run in float32 with TF32 off;
``tf32=True`` rounds every product's operands to TF32 (10
mantissa bits, round to nearest) first, which is the control: the
reference in the nearest precision below the configuration's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

# Edges a block of the product: a block gathers (EDGE_BLOCK, K) floats.
EDGE_BLOCK = 1 << 22


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    (ties away from zero), kept in float32."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclass
class Adj:
    """A sparse ``(M, N)`` matrix as an edge list: ``w`` None means
    ones; ``scale`` (``(M,)`` or None) divides each output row."""
    row: torch.Tensor
    col: torch.Tensor
    w: Optional[torch.Tensor]
    M: int
    N: int
    scale: Optional[torch.Tensor] = None

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])


def coalesce(row: torch.Tensor, col: torch.Tensor, M: int, N: int):
    """Unique ``(row, col)`` pairs, row-major."""
    key = torch.unique(row.long() * N + col.long())
    return key // N, key % N


def _spmm(row, col, w, x, M, tf32: bool):
    out = torch.zeros((M, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    if tf32:
        x = round_tf32(x)
        w = None if w is None else round_tf32(w)
    for lo in range(0, row.shape[0], EDGE_BLOCK):
        r = row[lo:lo + EDGE_BLOCK]
        h = x[col[lo:lo + EDGE_BLOCK]]
        if w is not None:
            h = h * w[lo:lo + EDGE_BLOCK, None]
        out.index_add_(0, r, h)
    return out


class _Spmm(torch.autograd.Function):
    """``A @ x``; backward ``A^T @ g`` by the same product."""

    @staticmethod
    def forward(ctx, adj: Adj, x, tf32: bool):
        ctx.adj, ctx.tf32 = adj, tf32
        return _spmm(adj.row, adj.col, adj.w, x, adj.M, tf32)

    @staticmethod
    def backward(ctx, g):
        adj = ctx.adj
        return None, _spmm(adj.col, adj.row, adj.w, g.contiguous(), adj.N,
                           ctx.tf32), None


def spmm(adj: Adj, x: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    out = _Spmm.apply(adj, x, tf32)
    if adj.scale is not None:
        out = out / adj.scale[:, None]
    return out


class _MmTf32(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, forward
    and backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False):
    return _MmTf32.apply(a, b) if tf32 else a @ b


def nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
    """Mean negative log-likelihood over the nodes of ``mask``."""
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, y[:, None])[:, 0]
    m = mask.to(loss.dtype)
    return (loss * m).sum() / m.sum().clamp_min(1.0)


def train(forward: Callable, adj: Adj, x: torch.Tensor, y: torch.Tensor,
          train_mask: torch.Tensor, params: Dict[str, torch.Tensor],
          lr: float, epochs: int, tf32: bool = False,
          dropout_gen: Optional[torch.Generator] = None,
          fault: Optional[str] = None) -> Dict:
    """``epochs`` full-batch epochs from ``params``: the loss on the
    training mask, its backward, an Adam step, then an eval forward.
    ``forward(params, adj, x, train, gen, tf32)`` gives the logits.

    The readings: each epoch's loss, the first gradient as Adam holds it
    after one step (``exp_avg / (1 - beta1)``), the parameters' change
    after the last epoch, the parameters after each epoch and each eval
    forward's predicted classes.  ``fault`` plants a fault where the
    program would have it: ``"half"`` (the loss over half of the
    training nodes), ``"frozen"`` (no step)."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr)
    mask = train_mask
    if fault == "half":
        idx = torch.nonzero(train_mask)[:, 0]
        mask = torch.zeros_like(train_mask)
        mask[idx[: idx.shape[0] // 2]] = True
    out = {"losses": [], "params": [], "preds": [], "grad1": None}
    for epoch in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = nll(forward(p, adj, x, True, dropout_gen, tf32), y, mask)
        loss.backward()
        if fault != "frozen":
            opt.step()
        out["losses"].append(float(loss.detach()))
        if epoch == 0:
            b1 = opt.param_groups[0]["betas"][0]
            out["grad1"] = {
                k: (v.grad.detach().clone() if fault == "frozen"
                    else opt.state[v]["exp_avg"].detach() / (1.0 - b1))
                for k, v in p.items()}
        out["params"].append({k: v.detach().clone() for k, v in p.items()})
        with torch.no_grad():
            out["preds"].append(
                forward(p, adj, x, False, None, tf32).argmax(dim=-1))
    out["change"] = {k: v.detach() - params[k] for k, v in p.items()}
    return out


def eval_logits(forward: Callable, adj: Adj, x: torch.Tensor,
                params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The eval forward's logits at ``params`` (float32, TF32 off)."""
    with torch.no_grad():
        return forward(params, adj, x, False, None, False)
