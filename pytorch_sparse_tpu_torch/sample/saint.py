"""GraphSAINT's node-induced subgraph (counterpart of
``pytorch_sparse_tpu/sample/saint.py``): keep the edges whose endpoints
both lie in ``node_idx``, relabelled by position in ``node_idx``.  The
walk runs on the port's host library (``csrc/host_sample.cpp``, a copy
of the JAX package's native ``saint_subgraph``);
:func:`saint_subgraph_plain` is its plain version in numpy."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..tensor import SparseTensor
from ..utils.host_sort import lexsort2
from . import _native
from ._common import check_nodes, expand_ranges, host_index, to_index


def saint_subgraph(src: SparseTensor, node_idx
                   ) -> Tuple[SparseTensor, torch.Tensor]:
    """``(subgraph, e_id)``: the ``(n, n)`` subgraph induced by the ``n``
    nodes of ``node_idx`` (rows of the graph; others raise
    ``ValueError``), on the graph's device, and the edge id of each of
    its edges.

    Only the rows of ``node_idx`` are walked on the host
    (``_native.saint_subgraph``), then the edges are sorted by (row,
    col)."""
    idx = host_index(node_idx)
    rowptr = src.storage.numpy_view("rowptr")
    check_nodes(idx, rowptr.shape[0] - 1, "node_idx")
    new_row, new_col, e_id = _native.saint_subgraph(
        rowptr, src.storage.numpy_view("col"), idx, max(src.sparse_sizes()))
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


def saint_subgraph_plain(rowptr: np.ndarray, col: np.ndarray,
                         idx: np.ndarray, n_nodes: int
                         ) -> Tuple[np.ndarray, ...]:
    """The plain version of the library's ``saint_subgraph``, in numpy:
    ``(row, col, e_id)`` in the library's order (the rows of ``idx`` in
    turn, each row's edges in order).  The tests hold the library
    against it; no sampler calls it."""
    assoc = np.full(n_nodes, -1, np.int64)
    assoc[idx] = np.arange(idx.shape[0])
    owner, pos = expand_ranges(rowptr[idx], rowptr[idx + 1] - rowptr[idx])
    new_col = assoc[col[pos]]
    keep = new_col >= 0
    return owner[keep], new_col[keep], pos[keep]


SparseTensor.saint_subgraph = lambda self, node_idx: saint_subgraph(
    self, node_idx)
