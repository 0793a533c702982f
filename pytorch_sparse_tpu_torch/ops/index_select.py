"""Row and column gathers (counterpart of
``pytorch_sparse_tpu/ops/index_select.py``; reference
``torch_sparse/index_select.py``).

The new structure depends on the data, so the index math runs on the
storage's host copies, as in the JAX package; the value is gathered once
on the storage's device with the composed permutation, so that its
gradient flows back to ``value``.  ``dim=0`` walks the CSR runs of the
chosen rows; ``dim=1`` walks the CSC view and sorts back to CSR order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..segment import gather_rows
from ..storage import SparseStorage, _dev_index, get_layout
from ..tensor import SparseTensor
from ..utils.host_sort import lexsort2


def host_index(idx) -> np.ndarray:
    """A 1-D host copy of an index or mask (tensor, numpy or list)."""
    if isinstance(idx, torch.Tensor):
        idx = idx.detach().cpu().numpy()
    idx = np.asarray(idx)
    if idx.ndim != 1:
        raise ValueError("the index must be 1-D")
    return idx


def gather_value(value: Optional[torch.Tensor], perm: np.ndarray
                 ) -> Optional[torch.Tensor]:
    """``value[perm]`` on the value's device (None stays None), its
    gradient summed in a fixed order (``segment.gather_rows``)."""
    return None if value is None else gather_rows(value, perm)


def index_select(src: SparseTensor, dim: int, idx) -> SparseTensor:
    dim = src.dim() + dim if dim < 0 else dim
    idx = host_index(idx)
    st = src.storage
    dev = st.device

    if dim == 0:
        old_rowptr = st.numpy_view("rowptr")
        rowcount = np.diff(old_rowptr)[idx]
        rowptr = np.zeros(idx.shape[0] + 1, dtype=np.int64)
        np.cumsum(rowcount, out=rowptr[1:])
        row = np.repeat(np.arange(idx.shape[0], dtype=np.int64), rowcount)
        perm = (np.arange(int(rowptr[-1]), dtype=np.int64)
                + (old_rowptr[idx] - rowptr[:-1])[row])
        col = st.numpy_view("col")[perm]
        storage = SparseStorage._new(
            row=_dev_index(row, dev), rowptr=_dev_index(rowptr, dev),
            col=_dev_index(col, dev), value=gather_value(st.value(), perm),
            sparse_sizes=(idx.shape[0], src.sparse_size(1)),
            rowcount=_dev_index(rowcount, dev),
            np_cache={"row": row, "rowptr": rowptr, "col": col})
        return src.from_storage(storage)

    if dim == 1:
        hcsr2csc = st.numpy_view("csr2csc")
        old_colptr = st.numpy_view("colptr")
        row_csc = st.numpy_view("row")[hcsr2csc]
        colcount = np.diff(old_colptr)[idx]
        colptr = np.zeros(idx.shape[0] + 1, dtype=np.int64)
        np.cumsum(colcount, out=colptr[1:])
        col = np.repeat(np.arange(idx.shape[0], dtype=np.int64), colcount)
        perm = (np.arange(int(colptr[-1]), dtype=np.int64)
                + (old_colptr[idx] - colptr[:-1])[col])
        row = row_csc[perm]
        csc2csr = lexsort2(row, col)
        row, col = row[csc2csr], col[csc2csr]
        storage = SparseStorage._new(
            row=_dev_index(row, dev), rowptr=None, col=_dev_index(col, dev),
            value=gather_value(st.value(), hcsr2csc[perm][csc2csr]),
            sparse_sizes=(src.sparse_size(0), idx.shape[0]),
            colptr=_dev_index(colptr, dev),
            colcount=_dev_index(colcount, dev),
            csc2csr=_dev_index(csc2csr, dev),
            np_cache={"row": row, "col": col, "colptr": colptr,
                      "csc2csr": csc2csr})
        return src.from_storage(storage)

    value = st.value()
    if value is None:
        raise ValueError("Cannot index-select dense dims without values")
    return src.set_value(gather_rows(value.movedim(dim - 1, 0), idx)
                         .movedim(0, dim - 1), layout="coo")


def index_select_nnz(src: SparseTensor, idx,
                     layout: Optional[str] = None) -> SparseTensor:
    """The nonzeros at positions ``idx`` (in ``layout`` order), kept in
    the given order."""
    idx = host_index(idx).astype(np.int64)
    st = src.storage
    if get_layout(layout) == "csc":
        idx = st.numpy_view("csc2csr")[idx]
    row, col = st.numpy_view("row")[idx], st.numpy_view("col")[idx]
    dev = st.device
    storage = SparseStorage._new(
        row=_dev_index(row, dev), rowptr=None, col=_dev_index(col, dev),
        value=gather_value(st.value(), idx),
        sparse_sizes=src.sparse_sizes(), np_cache={"row": row, "col": col})
    return src.from_storage(storage)


SparseTensor.index_select = lambda self, dim, idx: index_select(self, dim,
                                                                idx)
SparseTensor.index_select_nnz = (
    lambda self, idx, layout=None: index_select_nnz(self, idx, layout))
