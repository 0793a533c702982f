"""GraphSAGE with the mean aggregator (counterpart of
``pytorch_sparse_tpu/models/sage.py``).

Each layer is ``x = x W_self + mean_neigh(x) W_neigh + b``, where
``mean_neigh`` is the routed ``mean`` SpMM over the adjacency at the
layer's input width; ReLU follows every layer but the last.  No kernel
of its own: the SpMM and its backward route as every SpMM does.
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

_LAYER_PARAMS = ("w_self", "w_neigh", "b")


class GraphSAGE(nn.Module):
    """n-layer GraphSAGE: ``in_dim -> hidden_dim x (num_layers-1) ->
    out_dim``, with the JAX package's parameter names and shapes per
    layer: ``w_self`` and ``w_neigh`` ``(fan_in, fan_out)``, ``b``
    ``(fan_out,)``.

    Weights are glorot uniform from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None), ``w_self`` before ``w_neigh``
    in each layer, biases zero.  :meth:`from_jax_params` carries a JAX
    ``GraphSAGE.init`` dict across instead.
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
        w_self, w_neigh = [], []
        for i in range(num_layers):
            for ws in (w_self, w_neigh):
                ws.append(nn.Parameter(_glorot(generator, dims[i],
                                               dims[i + 1], dtype).to(dev)))
        self.w_self = nn.ParameterList(w_self)
        self.w_neigh = nn.ParameterList(w_neigh)
        self.b = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i + 1], dtype=dtype, device=dev))
            for i in range(num_layers))

    @classmethod
    def from_jax_params(cls, params: Dict,
                        device: DeviceLike = None) -> "GraphSAGE":
        """The module with the weights of a JAX ``GraphSAGE.init``
        parameter dict ``{"layers": [{"w_self", "w_neigh", "b"}]}`` whose
        leaves are numpy arrays."""
        layers = params["layers"]
        ws = [np.array(layer["w_self"]) for layer in layers]
        model = cls(ws[0].shape[0], ws[0].shape[1], ws[-1].shape[1],
                    num_layers=len(layers), device=device,
                    dtype=torch.from_numpy(ws[0]).dtype)
        _copy_layer_params(model, layers, _LAYER_PARAMS)
        return model

    def forward(self, adj: SparseTensor, x: torch.Tensor) -> torch.Tensor:
        """Logits ``(M, out_dim)``."""
        n = len(self.b)
        for i in range(n):
            neigh = spmm(adj, x, reduce="mean")
            x = x @ self.w_self[i] + neigh @ self.w_neigh[i] + self.b[i]
            if i < n - 1:
                x = torch.relu(x)
        return x

    def loss(self, adj: SparseTensor, x: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:func:`~pytorch_sparse_tpu_torch.models.gcn.nll_loss` of the
        logits."""
        return nll_loss(self(adj, x), labels, mask)
