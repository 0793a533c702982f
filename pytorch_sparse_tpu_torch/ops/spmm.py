"""Legacy tuple-API SpMM (counterpart of
``pytorch_sparse_tpu/ops/spmm.py``; reference ``torch_sparse/spmm.py``):
gather ``matrix[col]``, scale by the value, and add up each row's terms.

The JAX package's scatter-add adds each row's terms in edge order on the
CPU.  Here every device adds them in that order too: the edges are
sorted stably by row on the host and each row's run is summed left to
right (``segment.Runs``: on the card the CSR kernel over the identity
columns for float32), never by an atomic ``index_add_``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..segment import Runs, gather_rows
from ..utils.host_sort import stable_argsort
from .coalesce import legacy_device


def spmm(index, value: torch.Tensor, m: int, n: int,
         matrix: torch.Tensor) -> torch.Tensor:
    """``A @ matrix`` for the ``(m, n)`` COO matrix ``(index, value)``
    (``index`` ``(2, E)``, any order, duplicates added) and a dense
    ``(n, K)`` or batched ``(B, n, K)`` matrix; a 1-D matrix is a
    column."""
    if n != matrix.shape[-2 if matrix.dim() > 1 else 0]:
        raise ValueError(f"matrix has {matrix.shape} rows, A has {n} "
                         f"columns")
    dev = legacy_device(index, None)
    if matrix.device != dev:
        raise ValueError(f"matrix lies on {matrix.device}, index on {dev}")
    host = (index.cpu().numpy() if isinstance(index, torch.Tensor)
            else np.asarray(index)).astype(np.int64)
    row, col = host[0], host[1]
    if row.size and (row.min() < 0 or row.max() >= m):
        raise ValueError(f"row indices must lie in [0, {m})")
    perm = stable_argsort(row)
    ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=m))])
    matrix = matrix if matrix.dim() > 1 else matrix[:, None]
    # (E, [B,] K): each edge's row of the matrix, its gradient summed
    # in edge order too.
    out = gather_rows(matrix.movedim(-2, 0), col[perm])
    value = gather_rows(torch.as_tensor(value, device=dev), perm)
    out = out * value.reshape((-1,) + (1,) * (out.dim() - 1)).to(out.dtype)
    return Runs(ptr, dev).sum(out).movedim(0, -2)
