"""Row and column slicing (counterpart of
``pytorch_sparse_tpu/ops/narrow.py``; reference
``torch_sparse/narrow.py``).

``dim=0`` slices the CSR arrays: the nonzeros of a run of rows are one
run of the arrays, so the device tensors are sliced in place and the
host copies alike.  ``dim=1`` keeps the nonzeros whose column falls in
the range.  ``__narrow_diag__`` inverts ``cat_diag`` and keeps every
cache.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..storage import SparseStorage, _dev_index
from ..tensor import SparseTensor
from .index_select import gather_value


def narrow(src: SparseTensor, dim: int, start: int,
           length: int) -> SparseTensor:
    if dim < 0:
        dim = src.dim() + dim
    if start < 0:
        start = src.size(dim) + start
    st = src.storage
    value = st.value()

    if dim == 0:
        hptr = st.numpy_view("rowptr")[start:start + length + 1]
        lo, hi = int(hptr[0]), int(hptr[-1])
        np_cache = {"rowptr": hptr - lo, "col": st.numpy_view("col")[lo:hi]}
        row = st._row
        if row is not None:
            row = row[lo:hi] - start
            np_cache["row"] = st.numpy_view("row")[lo:hi] - start
        # The rowcount cache survives only where it was filled.
        rowcount = st._rowcount
        if rowcount is not None:
            rowcount = rowcount[start:start + length]
        storage = SparseStorage._new(
            row=row, rowptr=st.rowptr()[start:start + length + 1] - lo,
            col=st.col()[lo:hi],
            value=None if value is None else value[lo:hi],
            sparse_sizes=(length, src.sparse_size(1)), rowcount=rowcount,
            np_cache=np_cache)
        return src.from_storage(storage)

    if dim == 1:
        hcol = st.numpy_view("col")
        keep = np.flatnonzero((hcol >= start) & (hcol < start + length))
        row, col = st.numpy_view("row")[keep], hcol[keep] - start
        np_cache = {"row": row, "col": col}
        colptr, colcount = st._colptr, st._colcount
        if colptr is not None:
            colptr = colptr[start:start + length + 1]
            colptr = colptr - colptr[0]
            if "colptr" in st._np_cache:
                hptr = st._np_cache["colptr"][start:start + length + 1]
                np_cache["colptr"] = hptr - hptr[0]
        if colcount is not None:
            colcount = colcount[start:start + length]
        dev = st.device
        storage = SparseStorage._new(
            row=_dev_index(row, dev), rowptr=None, col=_dev_index(col, dev),
            value=gather_value(value, keep),
            sparse_sizes=(src.sparse_size(0), length), colptr=colptr,
            colcount=colcount, np_cache=np_cache)
        return src.from_storage(storage)

    if value is None:
        raise ValueError("Cannot narrow dense dims without values")
    return src.set_value(value.narrow(dim - 1, start, length), layout="coo")


def __narrow_diag__(src: SparseTensor, start: Tuple[int, int],
                    length: Tuple[int, int]) -> SparseTensor:
    """The diagonal block of ``length`` at ``start`` of a block-diagonal
    matrix (the inverse of ``cat_diag``), with every cache the source
    holds cut to the block."""
    st = src.storage
    r0, c0 = int(start[0]), int(start[1])
    M, N = int(length[0]), int(length[1])
    rowptr = st.rowptr()[r0:r0 + M + 1]
    hptr = st.numpy_view("rowptr")[r0:r0 + M + 1]
    lo, hi = int(hptr[0]), int(hptr[-1])
    # Each entry of a cache or host copy: (its slice, what to subtract).
    cut = {"row": (slice(lo, hi), r0), "rowptr": (slice(r0, r0 + M + 1), lo),
           "col": (slice(lo, hi), c0), "rowcount": (slice(r0, r0 + M), 0),
           "colptr": (slice(c0, c0 + N + 1), None),
           "colcount": (slice(c0, c0 + N), 0),
           "csr2csc": (slice(lo, hi), lo), "csc2csr": (slice(lo, hi), lo)}

    def block(x, name):
        if x is None:
            return None
        sl, off = cut[name]
        x = x[sl]
        return x - x[0] if off is None else (x - off if off else x)

    value = st.value()
    storage = SparseStorage._new(
        row=block(st._row, "row"), rowptr=rowptr - lo,
        col=block(st.col(), "col"),
        value=None if value is None else value[lo:hi], sparse_sizes=(M, N),
        rowcount=block(st._rowcount, "rowcount"),
        colptr=block(st._colptr, "colptr"),
        colcount=block(st._colcount, "colcount"),
        csr2csc=block(st._csr2csc, "csr2csc"),
        csc2csr=block(st._csc2csr, "csc2csr"),
        np_cache={k: block(v, k) for k, v in st._np_cache.items()})
    return src.from_storage(storage)


SparseTensor.narrow = lambda self, dim, start, length: narrow(
    self, dim, start, length)
SparseTensor.__narrow_diag__ = lambda self, start, length: __narrow_diag__(
    self, start, length)
