"""Multi-hop neighbour sampling, CSC-driven (counterpart of the
homogeneous ``neighbor_sample`` of
``pytorch_sparse_tpu/sample/neighbor.py``): the loader primitive behind
PyG's ``NeighborLoader``.  An edge (src -> dst) is stored with
``colptr`` over dst and ``row`` holding src, so sampling walks the
incoming edges of the frontier.

Host numpy, as in the JAX package.  Each hop draws the frontier's edges
with the native sampler's stream ``hop + 1`` (``_draws``) and appends
unseen sources in the order they are drawn.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device
from ._common import expand_ranges, host_index, to_index
from ._draws import draw_candidates, native_seed


def _cat(parts) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def neighbor_sample(colptr, row, input_node, num_neighbors: List[int],
                    replace: bool = False, directed: bool = True,
                    seed: Optional[int] = None, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Returns ``(node_id, row_local, col_local, edge_id)`` on ``device``.

    ``node_id`` starts with ``input_node`` (distinct nodes), then the
    sampled sources in the order they were first drawn.  With
    ``directed=True`` the edges are the sampled ones (a source's local
    id, its target's local id, the edge id); with ``directed=False`` they
    are every edge between sampled nodes.  The draws are those of the
    JAX package's native sampler for ``seed`` (an ``int``; None means
    0)."""
    seed = native_seed(seed)
    dev = resolve_device(device)
    colptr_np, row_np = host_index(colptr), host_index(row)
    inp = host_index(input_node)
    local_of = np.full(colptr_np.shape[0] - 1, -1, np.int64)
    local_of[inp] = np.arange(inp.shape[0])
    samples = [inp]
    n_samples = inp.shape[0]
    rows_l, cols_l, edges_l = [], [], []
    frontier, frontier_base = inp, 0
    for hop, num in enumerate(num_neighbors):
        starts = colptr_np[frontier]
        rix, edges = draw_candidates(starts, colptr_np[frontier + 1] - starts,
                                     int(num), replace, seed, stream=hop + 1)
        v = row_np[edges]
        vi = v[local_of[v] < 0]
        uniq, first = np.unique(vi, return_index=True)
        new_nodes = uniq[np.argsort(first, kind="stable")]
        local_of[new_nodes] = n_samples + np.arange(new_nodes.shape[0])
        samples.append(new_nodes)
        if directed:
            rows_l.append(local_of[v])
            cols_l.append(frontier_base + rix)
            edges_l.append(edges)
        frontier_base = n_samples
        n_samples += new_nodes.shape[0]
        frontier = new_nodes

    all_samples = _cat(samples)
    if not directed:
        starts = colptr_np[all_samples]
        rix, edges = expand_ranges(starts, colptr_np[all_samples + 1] - starts)
        v = row_np[edges]
        keep = local_of[v] >= 0
        rows_l, cols_l, edges_l = ([local_of[v[keep]]], [rix[keep]],
                                   [edges[keep]])
    return (to_index(all_samples, dev), to_index(_cat(rows_l), dev),
            to_index(_cat(cols_l), dev), to_index(_cat(edges_l), dev))
