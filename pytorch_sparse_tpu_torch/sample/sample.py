"""Per-row neighbour sampling (counterpart of
``pytorch_sparse_tpu/sample/sample.py``).

``sample`` is the with-replacement draw over a pre-drawn uniform matrix,
in torch on the graph's device.  ``sample_adj`` is GraphSAGE's one-hop
bipartite sampler: host numpy whose draws equal the JAX package's native
path (``_draws``), with first-seen relabelling.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..tensor import SparseTensor
from ..utils.convert import INDEX_DTYPE
from ..utils.host_sort import lexsort2
from ._common import first_seen_relabel, host_index, to_index
from ._draws import draw_candidates, native_seed
from .rw import uniforms

# What ``jnp.take`` fills in for an int32 index past the end.
_TAKE_FILL = -(2**31)


def sample(src: SparseTensor, num_neighbors: int, subset=None,
           generator: Optional[torch.Generator] = None,
           rand=None) -> torch.Tensor:
    """With-replacement uniform neighbour draw: ``(n, num_neighbors)``
    int32 column ids for the rows of ``subset`` (all rows when None).

    Draws come from ``rand`` (an ``(n, num_neighbors)`` float32 matrix
    in ``[0, 1)``) or from ``torch.rand`` with ``generator``.  As in the
    JAX package, a row of degree 0 takes position ``rowptr[row]``: the
    next row's first column, or ``-2**31`` past the last edge."""
    rowptr, col, _ = src.csr()
    rowcount = src.storage.rowcount()
    dev = src.device()
    if subset is not None:
        subset = torch.as_tensor(subset).to(dev).long()
        rowcount = rowcount[subset]
        rowptr = rowptr[subset]
    else:
        rowptr = rowptr[:-1]
    rand = uniforms((rowcount.shape[0], num_neighbors), dev, generator, rand)
    pos = (rand * rowcount.to(rand.dtype)[:, None]).to(INDEX_DTYPE)
    pos = pos + rowptr[:, None]
    padded = torch.cat([col, col.new_full((1,), _TAKE_FILL)])
    return padded[pos.long()]


def sample_adj(src: SparseTensor, subset, num_neighbors: int,
               replace: bool = False, seed: Optional[int] = None
               ) -> Tuple[SparseTensor, torch.Tensor]:
    """One-hop sampled bipartite adjacency ``(len(subset), len(n_id))``
    and the node mapping ``n_id`` (``subset`` first, then new columns in
    first-seen order), both on the graph's device; values are carried
    through the sampled edge ids.

    ``subset`` holds distinct nodes.  The draws are those of the JAX
    package's native sampler for ``seed`` (an ``int``; None means 0)."""
    seed = native_seed(seed)
    rowptr = src.storage.numpy_view("rowptr")
    col = src.storage.numpy_view("col")
    subset_np = host_index(subset)
    # The native sample_adj (native.cpp:151): stream-0 draws per frontier
    # row, new columns relabelled in first-seen order, each row sorted by
    # (local id, e_id): stable sorts by e_id, then by (row, local id).
    starts = rowptr[subset_np]
    rix, e_id = draw_candidates(starts, rowptr[subset_np + 1] - starts,
                                num_neighbors, replace, seed, stream=0)
    n_id, local_col = first_seen_relabel(col[e_id], subset_np)
    pre = np.argsort(e_id, kind="stable")
    order = pre[lexsort2(rix[pre], local_col[pre], n_id.shape[0])]
    local_col, e_id = local_col[order], e_id[order]
    out_rowptr = np.concatenate(
        [[0], np.cumsum(np.bincount(rix, minlength=subset_np.shape[0]))])
    dev = src.device()
    value = src.storage.value()
    if value is not None:
        value = value[torch.from_numpy(e_id).to(value.device)]
    out = SparseTensor(
        rowptr=out_rowptr, col=local_col, value=value,
        sparse_sizes=(subset_np.shape[0], n_id.shape[0]),
        is_sorted=True, trust_data=True, device=dev)
    return out, to_index(n_id, dev)


SparseTensor.sample = (
    lambda self, num_neighbors, subset=None, generator=None, rand=None:
    sample(self, num_neighbors, subset, generator, rand)
)
SparseTensor.sample_adj = (
    lambda self, subset, num_neighbors, replace=False, seed=None: sample_adj(
        self, subset, num_neighbors, replace, seed)
)
