"""Diagonal edits (counterpart of ``pytorch_sparse_tpu/ops/diag.py``).

The output nnz depends on the data, so the index arithmetic runs on the
host copies of ``row``/``col``; values are gathered and scattered on the
storage's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..storage import SparseStorage, _dev_index
from ..tensor import SparseTensor


def _diag_count(M: int, N: int, k: int) -> int:
    return min(M + k, N) if k < 0 else min(M, N - k)


def non_diag_mask(row: torch.Tensor, col: torch.Tensor, M: int, N: int,
                  k: int) -> torch.Tensor:
    """Bool mask of length ``E + num_diag``, on ``row``'s device: True
    at the positions the nonzeros ``(row, col)`` (sorted) take once a
    full k-offset diagonal is inserted."""
    row, col = torch.as_tensor(row), torch.as_tensor(col, device=row.device)
    E = row.shape[0]
    num_diag = _diag_count(M, N, k)
    start = -k if k < 0 else 0
    # Diagonal entry d lives at (start + d, start + d + k); it precedes
    # nnz (r, c) iff its row is above, or same row with smaller column.
    row, col = row.long(), col.long()
    above = (row - start).clamp(0, num_diag)
    same_row = (row >= start) & (row < start + num_diag) & (row + k < col)
    pos = torch.arange(E, device=row.device) + above + same_row
    mask = torch.zeros(E + num_diag, dtype=torch.bool, device=row.device)
    mask[pos] = True
    return mask


def remove_diag(src: SparseTensor, k: int = 0) -> SparseTensor:
    """Drop the k-offset diagonal, patching cached row/col counts."""
    st = src.storage
    dev = st.device
    hrow = st.numpy_view("row")
    hcol = st.numpy_view("col")
    keep = hrow != hcol if k == 0 else hrow != (hcol - k)
    new_row, new_col = hrow[keep], hcol[keep]
    value = st.value()
    if value is not None:
        value = value[torch.from_numpy(np.flatnonzero(keep)).to(dev)]
    rowcount, colcount = st._rowcount, st._colcount
    if rowcount is not None:
        gone = _dev_index(hrow[~keep], dev).long()
        rowcount = rowcount.clone().index_add_(
            0, gone, torch.full_like(gone, -1, dtype=rowcount.dtype))
    if colcount is not None:
        gone = _dev_index(hcol[~keep], dev).long()
        colcount = colcount.clone().index_add_(
            0, gone, torch.full_like(gone, -1, dtype=colcount.dtype))
    storage = SparseStorage._new(
        row=_dev_index(new_row, dev), rowptr=None,
        col=_dev_index(new_col, dev), value=value,
        sparse_sizes=st.sparse_sizes(), rowcount=rowcount,
        colcount=colcount, np_cache={"row": new_row, "col": new_col},
    )
    return src.from_storage(storage)


def set_diag(src: SparseTensor, values: Optional[torch.Tensor] = None,
             k: int = 0) -> SparseTensor:
    """Insert a full k-offset diagonal (existing diagonal entries are
    replaced)."""
    src = remove_diag(src, k=k)
    st = src.storage
    dev = st.device
    value = st.value()
    M, N = src.sparse_size(0), src.sparse_size(1)
    hrow = st.numpy_view("row")
    hcol = st.numpy_view("col")

    # Diagonal entry d lives at (start + d, start + d + k): see
    # non_diag_mask, here on the host copies.
    E = hrow.shape[0]
    num_diag = max(_diag_count(M, N, k), 0)
    start = -k if k < 0 else 0
    above = np.clip(hrow - start, 0, num_diag)
    same_row = (hrow >= start) & (hrow < start + num_diag) & (hrow + k < hcol)
    pos_np = np.arange(E, dtype=np.int64) + above + same_row
    E_out = E + num_diag
    mask = np.zeros(E_out, bool)
    mask[pos_np] = True
    inv_pos_np = np.flatnonzero(~mask)
    diag_np = np.arange(start, start + num_diag, dtype=np.int64)
    new_row = np.zeros(E_out, np.int64)
    new_row[pos_np] = hrow
    new_row[inv_pos_np] = diag_np
    new_col = np.zeros(E_out, np.int64)
    new_col[pos_np] = hcol
    new_col[inv_pos_np] = diag_np + k

    new_value = None
    if value is not None:
        pos = torch.from_numpy(pos_np).to(dev)
        inv_pos = torch.from_numpy(inv_pos_np).to(dev)
        if values is None:
            values = torch.ones((num_diag,) + tuple(value.shape[1:]),
                                dtype=value.dtype, device=dev)
        new_value = value.new_zeros((E_out,) + tuple(value.shape[1:]))
        new_value[pos] = value
        new_value[inv_pos] = torch.as_tensor(values).to(device=dev,
                                                       dtype=value.dtype)

    rowcount = st._rowcount
    if rowcount is not None:
        rowcount = rowcount.clone()
        rowcount[start:start + num_diag] += 1
    colcount = st._colcount
    if colcount is not None:
        colcount = colcount.clone()
        colcount[start + k:start + num_diag + k] += 1

    storage = SparseStorage._new(
        row=_dev_index(new_row, dev), rowptr=None,
        col=_dev_index(new_col, dev), value=new_value,
        sparse_sizes=src.sparse_sizes(), rowcount=rowcount,
        colcount=colcount, np_cache={"row": new_row, "col": new_col},
    )
    return src.from_storage(storage)


def fill_diag(src: SparseTensor, fill_value: float, k: int = 0
              ) -> SparseTensor:
    """Set the k-offset diagonal to ``fill_value``."""
    num_diag = max(_diag_count(src.sparse_size(0), src.sparse_size(1), k), 0)
    value = src.storage.value()
    if value is not None:
        sizes = (num_diag,) + tuple(value.shape[1:])
        return set_diag(src, torch.full(sizes, fill_value, dtype=value.dtype,
                                        device=value.device), k)
    return set_diag(src, None, k)


def get_diag(src: SparseTensor) -> torch.Tensor:
    """The main diagonal, ``(min(M, N), ...)`` in the value's dtype
    (float32 ones for implicit values); absent entries are 0."""
    st = src.storage
    value = st.value()
    if value is None:
        value = torch.ones(st.nnz(), dtype=torch.float32, device=st.device)
    k = min(st.sparse_sizes())
    out = value.new_zeros((k,) + tuple(value.shape[1:]))
    hrow = st.numpy_view("row")
    on_diag = np.flatnonzero(hrow == st.numpy_view("col"))
    if on_diag.size:
        idx = torch.from_numpy(on_diag).to(st.device)
        out[torch.from_numpy(hrow[on_diag]).to(st.device)] = value[idx]
    return out


SparseTensor.remove_diag = lambda self, k=0: remove_diag(self, k)
SparseTensor.set_diag = lambda self, values=None, k=0: set_diag(
    self, values, k)
SparseTensor.fill_diag = lambda self, fill_value, k=0: fill_diag(
    self, fill_value, k)
SparseTensor.get_diag = lambda self: get_diag(self)
