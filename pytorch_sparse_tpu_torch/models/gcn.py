"""Graph Convolutional Network on top of the SpMM stack (counterpart of
``pytorch_sparse_tpu/models/gcn.py``).

Each layer projects first and then aggregates, ``x = A_hat @ (x W) + b``,
so the SpMM runs at the layer's output width.  ReLU, then dropout when
asked for, follow every layer but the last.  The adjacency is a
:class:`SparseTensor` (the routed SpMM) or, as in the JAX package's
``GCN.apply``, a prebuilt :class:`HybridFormat` or :class:`DenseFormat`
(aggregated by ``hybrid_spmm``, whose store gets a gradient when it
requires one).  :meth:`GCN.loss` is the masked mean negative
log-likelihood; a train step is ``loss.backward()`` and an optimizer
step (``torch.optim.Adam(lr=1e-2)`` in the JAX package's example).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.diag import fill_diag
from ..ops.kernels.hybrid import DenseFormat, HybridFormat, hybrid_spmm
from ..ops.matmul import spmm
from ..segment import segment_sum
from ..tensor import SparseTensor
from ..typing import DeviceLike, resolve_device


def gcn_norm(adj: SparseTensor, add_self_loops: bool = True) -> SparseTensor:
    """``A_hat = D^-1/2 (A + I) D^-1/2`` with the degree taken over the
    values (ones where ``adj`` has none)."""
    if adj.storage.value() is None:
        adj = adj.fill_value(1.0)
    if add_self_loops:
        adj = fill_diag(adj, 1.0)
    row, col, value = adj.coo()
    deg = segment_sum(value, row, adj.sparse_size(0))
    dinv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    value = dinv[row] * value * dinv[col]
    return adj.set_value(value, layout="coo")


def _glorot(generator: torch.Generator, fan_in: int, fan_out: int,
            dtype: torch.dtype) -> torch.Tensor:
    scale = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand((fan_in, fan_out), generator=generator,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * scale).to(dtype)


def _layer_dims(in_dim: int, hidden_dim: int, out_dim: int,
                num_layers: int):
    return [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]


def _copy_layer_params(model: nn.Module, layers, names) -> None:
    """Copy the numpy arrays ``layers[i][name]`` into ``model.<name>[i]``,
    checking shapes."""
    with torch.no_grad():
        for i, layer in enumerate(layers):
            for name in names:
                p, arr = getattr(model, name)[i], np.array(layer[name])
                if tuple(p.shape) != arr.shape:
                    raise ValueError(f"layer {i} {name} has shape "
                                     f"{arr.shape}, expected {tuple(p.shape)}")
                p.copy_(torch.from_numpy(arr))


def nll_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under the log-softmax
    of ``logits``; with ``mask`` (one weight per node, e.g. the training
    split as 0/1) the masked mean ``sum(nll * mask) / max(sum(mask),
    1)``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _aggregate(adj, h: torch.Tensor) -> torch.Tensor:
    """``adj @ h``: a prebuilt hybrid or dense view through
    ``hybrid_spmm``, a :class:`SparseTensor` through the routed SpMM."""
    if isinstance(adj, (HybridFormat, DenseFormat)):
        return hybrid_spmm(adj, h)
    return spmm(adj, h, reduce="sum")


class GCN(nn.Module):
    """n-layer GCN: ``in_dim -> hidden_dim x (num_layers-1) -> out_dim``.

    Weights are ``(fan_in, fan_out)`` as in the JAX package, glorot
    uniform from ``generator`` (a CPU ``torch.Generator``; seed 0 when
    None), biases zero.  :meth:`from_jax_params` carries a JAX parameter
    dict across instead.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = _layer_dims(in_dim, hidden_dim, out_dim, num_layers)
        self.weights = nn.ParameterList(
            nn.Parameter(_glorot(generator, dims[i], dims[i + 1],
                                 dtype).to(dev))
            for i in range(num_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i + 1], dtype=dtype, device=dev))
            for i in range(num_layers))

    @classmethod
    def from_jax_params(cls, params: Dict,
                        device: DeviceLike = None) -> "GCN":
        """The module with the weights of a JAX ``GCN.init`` parameter
        dict ``{"layers": [{"w": (fan_in, fan_out), "b": (fan_out,)}]}``
        whose leaves are numpy arrays."""
        layers = params["layers"]
        ws = [np.array(layer["w"]) for layer in layers]
        dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
        model = cls(dims[0], dims[1], dims[-1], num_layers=len(layers),
                    device=device, dtype=torch.from_numpy(ws[0]).dtype)
        if any(w.shape != (dims[i], dims[i + 1]) for i, w in enumerate(ws)):
            raise ValueError("layer widths do not chain")
        with torch.no_grad():
            for i, layer in enumerate(layers):
                model.weights[i].copy_(torch.from_numpy(ws[i]))
                model.biases[i].copy_(torch.from_numpy(np.array(layer["b"])))
        return model

    def forward(self, adj, x: torch.Tensor,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``(M, out_dim)``.  With ``dropout_rate > 0`` each hidden
        activation is kept with probability ``1 - dropout_rate`` and
        scaled by ``1 / (1 - dropout_rate)``; the mask is drawn from
        ``generator``, a ``torch.Generator`` on ``x``'s device (the
        device's default generator when None)."""
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = _aggregate(adj, x @ w) + b
            if i < n - 1:
                x = torch.relu(x)
                if dropout_rate > 0.0:
                    keep = torch.rand(x.shape, generator=generator,
                                      device=x.device) >= dropout_rate
                    x = torch.where(keep, x / (1.0 - dropout_rate), 0.0)
        return x

    def loss(self, adj, x: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """:func:`nll_loss` of the logits."""
        return nll_loss(self(adj, x, dropout_rate, generator), labels, mask)
