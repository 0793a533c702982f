"""Ego-network sampling (counterpart of ``pytorch_sparse_tpu/sample/
ego.py``; reference ``csrc/cpu/ego_sample_cpu.cpp``): per-seed k-hop
BFS with a per-node neighbour cap, the induced subgraph over the sorted
visited set, and the ego nets stitched block-diagonally.  It runs the
port's host library (``csrc/host_sample.cpp``), a stream per root.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..tensor import SparseTensor
from ..typing import DeviceLike, resolve_device
from . import _native
from ._common import host_index
from ._draws import native_seed


def ego_k_hop_sample_adj(
    src: SparseTensor, idx, depth: int, num_neighbors: int,
    replace: bool = False, seed: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Returns ``(adj, n_id, e_id, ptr, root_n_id)``: one ego net per
    node of ``idx``, stitched diagonally into ``adj`` (values carried
    through the edge ids), ``n_id`` each net's nodes in ascending order,
    ``e_id`` the edges, ``ptr`` each net's node range and ``root_n_id``
    each root's position in the stitched numbering; int64 index tensors.

    Everything lands on ``device``, by default the graph's.  Each hop
    visits every neighbour of a node with at most ``num_neighbors``
    (all when ``num_neighbors < 0``), else draws that many; the draws
    equal the JAX package's native sampler's for ``seed`` (an ``int``;
    None means 0)."""
    seed = native_seed(seed)
    dev = src.device() if device is None else resolve_device(device)
    rowptr = src.storage.numpy_view("rowptr")
    col = src.storage.numpy_view("col")
    idx_np = host_index(idx)
    n = rowptr.shape[0] - 1
    if idx_np.size and (idx_np.min() < 0 or idx_np.max() >= n):
        raise ValueError("a root of `idx` lies outside [0, M)")
    if src.sparse_size(1) > n and col.size and col.max() >= n:
        raise ValueError("a column lies past the last row: the walk needs "
                         "every neighbour to be a row")
    row, colc, e_id, n_id, ptr, roots = _native.ego_k_hop(
        rowptr, col, idx_np, depth, num_neighbors, replace, seed)
    value = src.storage.value()
    if value is not None:
        value = value[torch.from_numpy(e_id).to(value.device)].to(dev)
    size = int(n_id.shape[0])
    out = SparseTensor(row=row, col=colc, value=value,
                       sparse_sizes=(size, size), is_sorted=True,
                       trust_data=True, device=dev)
    return (out, *(torch.from_numpy(a).to(dev)
                   for a in (n_id, e_id, ptr, roots)))
