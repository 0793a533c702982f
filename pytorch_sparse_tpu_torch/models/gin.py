"""Graph Isomorphism Network (counterpart of
``pytorch_sparse_tpu/models/gin.py``).

Each layer is ``x = (1 + eps_i) x + sum_neigh(x)`` through the routed
``sum`` SpMM at the layer's input width, then a two-layer MLP
``relu(x W1 + b1) W2 + b2``; ReLU follows every layer but the last.  No
kernel of its own: the SpMM and its backward route as every SpMM does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.matmul import spmm
from ..tensor import SparseTensor
from ..typing import DeviceLike, resolve_device
from .gcn import _copy_layer_params, _glorot, _layer_dims, nll_loss

_LAYER_PARAMS = ("w1", "w2", "b1", "b2")


class GIN(nn.Module):
    """n-layer GIN: ``in_dim -> hidden_dim x (num_layers-1) -> out_dim``,
    with the JAX package's parameter names and shapes: ``eps``
    ``(num_layers,)``, and per layer ``w1`` ``(fan_in, fan_in)``, ``b1``
    ``(fan_in,)``, ``w2`` ``(fan_in, fan_out)``, ``b2`` ``(fan_out,)``.

    Weights are glorot uniform from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None), ``w1`` before ``w2`` in each
    layer; ``eps`` and the biases are zero.  :meth:`from_jax_params`
    carries a JAX ``GIN.init`` dict across instead.
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

        def zeros(n):
            return nn.Parameter(torch.zeros(n, dtype=dtype, device=dev))

        w1, w2 = [], []
        for i in range(num_layers):
            w1.append(nn.Parameter(_glorot(generator, dims[i], dims[i],
                                           dtype).to(dev)))
            w2.append(nn.Parameter(_glorot(generator, dims[i], dims[i + 1],
                                           dtype).to(dev)))
        self.eps = zeros(num_layers)
        self.w1 = nn.ParameterList(w1)
        self.w2 = nn.ParameterList(w2)
        self.b1 = nn.ParameterList(zeros(dims[i]) for i in range(num_layers))
        self.b2 = nn.ParameterList(zeros(dims[i + 1])
                                   for i in range(num_layers))

    @classmethod
    def from_jax_params(cls, params: Dict, device: DeviceLike = None) -> "GIN":
        """The module with the weights of a JAX ``GIN.init`` parameter
        dict ``{"eps", "layers": [{"w1", "w2", "b1", "b2"}]}`` whose leaves
        are numpy arrays."""
        layers = params["layers"]
        w2s = [np.array(layer["w2"]) for layer in layers]
        model = cls(w2s[0].shape[0], w2s[0].shape[1], w2s[-1].shape[1],
                    num_layers=len(layers), device=device,
                    dtype=torch.from_numpy(w2s[0]).dtype)
        eps = np.array(params["eps"])
        if eps.shape != tuple(model.eps.shape):
            raise ValueError(f"eps has shape {eps.shape}, expected "
                             f"{tuple(model.eps.shape)}")
        with torch.no_grad():
            model.eps.copy_(torch.from_numpy(eps))
        _copy_layer_params(model, layers, _LAYER_PARAMS)
        return model

    def forward(self, adj: SparseTensor, x: torch.Tensor) -> torch.Tensor:
        """Logits ``(M, out_dim)``."""
        n = len(self.w1)
        for i in range(n):
            x = (1.0 + self.eps[i]) * x + spmm(adj, x, reduce="sum")
            x = torch.relu(x @ self.w1[i] + self.b1[i])
            x = x @ self.w2[i] + self.b2[i]
            if i < n - 1:
                x = torch.relu(x)
        return x

    def loss(self, adj: SparseTensor, x: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:func:`~pytorch_sparse_tpu_torch.models.gcn.nll_loss` of the
        logits."""
        return nll_loss(self(adj, x), labels, mask)
