"""Graph Attention Network (counterpart of
``pytorch_sparse_tpu/models/gat.py``).

Two attention layers: ``in_dim -> heads x hidden_dim`` with ELU, then one
output head of ``out_dim``.  In each layer the logit of edge ``(row,
col)`` and head ``h`` is ``LeakyReLU_0.2(alpha_src[row, h] +
alpha_dst[col, h])``, with ``alpha_* = <h_node, a_*>`` per head (the JAX
package's convention: ``alpha_src`` is taken at ``row``); the
``edge_softmax`` kernel normalises the logits over each row's edges, and
each head aggregates with the CSR SpMM autograd function, the attention
as its per-call values.  That call bypasses the router, which would bake
the values into a block store.  The adjacency's own values are ignored.

Training runs on the kernels on both passes: the edge softmax's
backward kernel, ``edge_dot`` for each head's attention gradient and
``csr_spmm`` over the CSC view for each head's operand gradient.
:meth:`GAT.loss` is the masked mean negative log-likelihood; the JAX
package's example trains with Adam at ``lr=5e-3``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.edge_softmax import edge_softmax
from ..ops.matmul import _CsrSum
from ..tensor import SparseTensor
from ..typing import DeviceLike, resolve_device
from .gcn import _glorot, nll_loss

_PARAMS = ("w1", "a1_src", "a1_dst", "w2", "a2_src", "a2_dst")


def _attention_layer(adj: SparseTensor, h: torch.Tensor, a_src: torch.Tensor,
                     a_dst: torch.Tensor,
                     negative_slope: float = 0.2) -> torch.Tensor:
    """``h`` ``(N, H, D)`` -> ``(M, H, D)``: per head, the
    attention-weighted sum of ``h[col]`` over each row's edges."""
    st = adj.storage
    row, col = st.row().long(), st.col().long()
    alpha_src = torch.einsum("nhd,hd->nh", h, a_src)
    alpha_dst = torch.einsum("nhd,hd->nh", h, a_dst)
    logits = F.leaky_relu(alpha_src[row] + alpha_dst[col], negative_slope)
    att = edge_softmax(st.rowptr(), logits.contiguous())        # (E, H)
    outs = [_CsrSum.apply(st, att[:, i].contiguous(), h[:, i].contiguous())
            for i in range(h.shape[1])]
    return torch.stack(outs, dim=1)


class GAT(nn.Module):
    """Two-layer GAT with the JAX package's parameter names and shapes:
    ``w1`` ``(in_dim, heads*hidden_dim)``, ``a1_src``/``a1_dst``
    ``(heads, hidden_dim)``, ``w2`` ``(heads*hidden_dim, out_dim)``,
    ``a2_src``/``a2_dst`` ``(1, out_dim)``.

    Weights are glorot uniform and the attention vectors N(0, 0.1^2),
    from ``generator`` (a CPU ``torch.Generator``; seed 0 when None).
    :meth:`from_jax_params` carries a JAX ``GAT.init`` dict across
    instead.
    """

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 heads: int = 4, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def param(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(device=dev, dtype=dtype))

        def attention(rows: int, cols: int) -> nn.Parameter:
            return param(torch.randn((rows, cols), generator=generator) * 0.1)

        self.w1 = param(_glorot(generator, in_dim, heads * hidden_dim, dtype))
        self.a1_src = attention(heads, hidden_dim)
        self.a1_dst = attention(heads, hidden_dim)
        self.w2 = param(_glorot(generator, heads * hidden_dim, out_dim, dtype))
        self.a2_src = attention(1, out_dim)
        self.a2_dst = attention(1, out_dim)

    @classmethod
    def from_jax_params(cls, params: Dict,
                        device: DeviceLike = None) -> "GAT":
        """The module with the weights of a JAX ``GAT.init`` parameter
        dict whose leaves are numpy arrays."""
        arrs = {name: np.array(params[name]) for name in _PARAMS}
        heads, hid = arrs["a1_src"].shape
        in_dim, out_dim = arrs["w1"].shape[0], arrs["w2"].shape[1]
        model = cls(in_dim, hid, out_dim, heads=heads, device=device,
                    dtype=torch.from_numpy(arrs["w1"]).dtype)
        with torch.no_grad():
            for name, arr in arrs.items():
                p = getattr(model, name)
                if tuple(p.shape) != arr.shape:
                    raise ValueError(f"{name} has shape {arr.shape}, "
                                     f"expected {tuple(p.shape)}")
                p.copy_(torch.from_numpy(arr))
        return model

    def forward(self, adj: SparseTensor, x: torch.Tensor) -> torch.Tensor:
        """Logits ``(M, out_dim)``."""
        H, D = self.a1_src.shape
        h = (x @ self.w1).reshape(-1, H, D)
        h = _attention_layer(adj, h, self.a1_src, self.a1_dst)
        h = F.elu(h).reshape(-1, H * D)
        h2 = (h @ self.w2).reshape(-1, 1, self.w2.shape[1])
        h2 = _attention_layer(adj, h2, self.a2_src, self.a2_dst)
        return h2[:, 0, :]

    def loss(self, adj: SparseTensor, x: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:func:`~pytorch_sparse_tpu_torch.models.gcn.nll_loss` of the
        logits."""
        return nll_loss(self(adj, x), labels, mask)
