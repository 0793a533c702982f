"""GraphSAINT's node-induced subgraph (counterpart of
``pytorch_sparse_tpu/sample/saint.py``): keep the edges whose endpoints
both lie in ``node_idx``, relabelled by position in ``node_idx``."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..tensor import SparseTensor
from ..utils.host_sort import lexsort2
from ._common import expand_ranges, host_index, to_index


def saint_subgraph(src: SparseTensor, node_idx
                   ) -> Tuple[SparseTensor, torch.Tensor]:
    """``(subgraph, e_id)``: the ``(n, n)`` subgraph induced by the ``n``
    nodes of ``node_idx``, on the graph's device, and the edge id of each
    of its edges.

    Only the rows of ``node_idx`` are walked on the host (as the native
    sampler does), then the edges are sorted by (row, col)."""
    idx = host_index(node_idx)
    rowptr = src.storage.numpy_view("rowptr")
    col = src.storage.numpy_view("col")
    assoc = np.full(max(src.sparse_sizes()), -1, np.int64)
    assoc[idx] = np.arange(idx.shape[0])
    owner, pos = expand_ranges(rowptr[idx], rowptr[idx + 1] - rowptr[idx])
    new_col = assoc[col[pos]]
    keep = new_col >= 0
    new_row, new_col, e_id = owner[keep], new_col[keep], pos[keep]
    order = lexsort2(new_row, new_col, idx.shape[0])
    new_row, new_col, e_id = new_row[order], new_col[order], e_id[order]

    dev = src.device()
    value = src.storage.value()
    if value is not None:
        value = value[torch.from_numpy(e_id).to(value.device)]
    out = SparseTensor(
        row=new_row, col=new_col, value=value,
        sparse_sizes=(idx.shape[0], idx.shape[0]),
        is_sorted=True, trust_data=True, device=dev)
    return out, to_index(e_id, dev)


SparseTensor.saint_subgraph = lambda self, node_idx: saint_subgraph(
    self, node_idx)
