"""Boolean-mask selection of rows, columns or nonzeros (counterpart of
``pytorch_sparse_tpu/ops/masked_select.py``; reference
``torch_sparse/masked_select.py``).  Index math on the host copies, one
value gather on the storage's device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..storage import SparseStorage, _dev_index, get_layout
from ..tensor import SparseTensor
from ..utils.host_sort import lexsort2
from .index_select import gather_value, host_index, index_select_nnz


def masked_select(src: SparseTensor, dim: int, mask) -> SparseTensor:
    dim = src.dim() + dim if dim < 0 else dim
    mask = host_index(mask).astype(bool)
    st = src.storage
    dev = st.device

    if dim == 0:
        rowcount = np.diff(st.numpy_view("rowptr"))[mask]
        keep = np.flatnonzero(mask[st.numpy_view("row")])
        row = np.repeat(np.arange(rowcount.shape[0], dtype=np.int64),
                        rowcount)
        col = st.numpy_view("col")[keep]
        storage = SparseStorage._new(
            row=_dev_index(row, dev), rowptr=None, col=_dev_index(col, dev),
            value=gather_value(st.value(), keep),
            sparse_sizes=(rowcount.shape[0], src.sparse_size(1)),
            rowcount=_dev_index(rowcount, dev),
            np_cache={"row": row, "col": col})
        return src.from_storage(storage)

    if dim == 1:
        csr2csc = st.numpy_view("csr2csc")
        row_csc = st.numpy_view("row")[csr2csc]
        col_csc = st.numpy_view("col")[csr2csc]
        colcount = np.bincount(st.numpy_view("col"),
                               minlength=src.sparse_size(1))[mask]
        keep = np.flatnonzero(mask[col_csc])
        col = np.repeat(np.arange(colcount.shape[0], dtype=np.int64),
                        colcount)
        row = row_csc[keep]
        csc2csr = lexsort2(row, col)
        row, col = row[csc2csr], col[csc2csr]
        storage = SparseStorage._new(
            row=_dev_index(row, dev), rowptr=None, col=_dev_index(col, dev),
            value=gather_value(st.value(), csr2csc[keep][csc2csr]),
            sparse_sizes=(src.sparse_size(0), colcount.shape[0]),
            colcount=_dev_index(colcount, dev),
            csc2csr=_dev_index(csc2csr, dev),
            np_cache={"row": row, "col": col, "csc2csr": csc2csr})
        return src.from_storage(storage)

    value = st.value()
    if value is None:
        raise ValueError("Cannot masked-select dense dims without values")
    idx = torch.from_numpy(np.flatnonzero(mask)).to(dev)
    return src.set_value(value.index_select(dim - 1, idx), layout="coo")


def masked_select_nnz(src: SparseTensor, mask,
                      layout: Optional[str] = None) -> SparseTensor:
    """The nonzeros where ``mask`` (one entry a nonzero, in ``layout``
    order) is True, in CSR order."""
    mask = host_index(mask).astype(bool)
    if get_layout(layout) == "csc":
        mask = mask[src.storage.numpy_view("csc2csr")]
    return index_select_nnz(src, np.flatnonzero(mask), "coo")


SparseTensor.masked_select = lambda self, dim, mask: masked_select(
    self, dim, mask)
SparseTensor.masked_select_nnz = (
    lambda self, mask, layout=None: masked_select_nnz(self, mask, layout))
