"""Transpose through the cached ``csr2csc`` permutation (counterpart of
``pytorch_sparse_tpu/ops/transpose.py``).

The CSC view of A is the CSR view of A^T: ``t()`` gathers the value
through ``csr2csc`` (on the device) and the indices on the host, and the
new storage reuses the caches: ``colptr``/``colcount`` become
``rowptr``/``rowcount`` (and back), and the two permutations swap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..storage import SparseStorage, _dev_index
from ..tensor import SparseTensor
from ..typing import DeviceLike
from .coalesce import legacy_device


def t(src: SparseTensor) -> SparseTensor:
    st = src.storage
    M, N = st.sparse_sizes()
    csr2csc = st.csr2csc()
    perm = st.numpy_view("csr2csc")
    new_row = st.numpy_view("col")[perm]
    new_col = st.numpy_view("row")[perm]
    value = st.value()
    if value is not None:
        value = value[csr2csc]
    # Host copies move with their caches: colptr -> rowptr and back.
    np_cache = {"row": new_row, "col": new_col, "csc2csr": perm}
    for old, new in (("colptr", "rowptr"), ("rowptr", "colptr"),
                     ("csc2csr", "csr2csc")):
        if old in st._np_cache:
            np_cache[new] = st._np_cache[old]
    storage = SparseStorage._new(
        row=_dev_index(new_row, st.device), rowptr=st._colptr,
        col=_dev_index(new_col, st.device), value=value,
        sparse_sizes=(N, M), rowcount=st._colcount, colptr=st._rowptr,
        colcount=st._rowcount, csr2csc=st._csc2csr, csc2csr=csr2csc,
        np_cache=np_cache)
    return src.from_storage(storage)


SparseTensor.t = lambda self: t(self)


def transpose(index, value: Optional[torch.Tensor], m: int, n: int,
              coalesced: bool = True, device: DeviceLike = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Legacy tuple-API transpose of an ``(m, n)`` COO ``(2, E)`` index
    and its value; ``coalesced`` sorts and merges duplicates (``add``)."""
    dev = legacy_device(index, device)
    index = torch.as_tensor(index, device=dev)
    row, col = index[1], index[0]
    if coalesced:
        storage = SparseStorage(row=row, col=col, value=value,
                                sparse_sizes=(n, m), is_sorted=False,
                                device=dev)
        storage = storage.coalesce()
        row, col, value = storage.row(), storage.col(), storage.value()
    return torch.stack([row, col]), value
