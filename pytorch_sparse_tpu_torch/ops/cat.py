"""Concatenation along rows, columns, the diagonal or a dense value
dimension (counterpart of ``pytorch_sparse_tpu/ops/cat.py``; reference
``torch_sparse/cat.py``), keeping every cache that all inputs hold:
``cat_first`` keeps row, rowptr and rowcount, ``cat_second`` colptr and
colcount, ``cat_diag`` everything (each block's indices shift by the
sizes and nonzeros before it).  Device tensors are concatenated on the
device and their host copies on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..storage import SparseStorage
from ..tensor import SparseTensor


class _Parts:
    """The pieces of one index array or cache over the inputs: each
    piece's device tensor and, for an index array, its host copy."""

    def __init__(self, n: int, host: bool = True):
        self.n, self.host = n, host
        self.dev: List[torch.Tensor] = []
        self.hst: List[np.ndarray] = []

    def add(self, st: SparseStorage, attr: str, shift: int = 0,
            tail: bool = False) -> None:
        """Append ``st``'s ``attr`` plus ``shift``, without its first
        entry when ``tail`` (a pointer after the first); nothing when
        the storage lacks it."""
        t = getattr(st, f"_{attr}")
        if t is None:
            return
        sl = slice(1, None) if tail else slice(None)
        self.dev.append(t[sl] + shift if shift else t[sl])
        if self.host:
            self.hst.append(st.numpy_view(attr)[sl] + shift)

    def device(self) -> Optional[torch.Tensor]:
        return torch.cat(self.dev) if len(self.dev) == self.n else None

    def host_copy(self) -> Optional[np.ndarray]:
        return np.concatenate(self.hst) if len(self.hst) == self.n else None


def _values(tensors: List[SparseTensor]) -> Optional[torch.Tensor]:
    values = [t.storage.value() for t in tensors]
    if any(v is None for v in values):
        return None
    return torch.cat(values)


def _check_devices(tensors: List[SparseTensor]) -> torch.device:
    if not tensors:
        raise ValueError("cat needs at least one tensor")
    devs = {t.device() for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"cat operands lie on {sorted(map(str, devs))}")
    return devs.pop()


def cat(tensors: List[SparseTensor],
        dim: Union[int, Tuple[int, int], List[int]]) -> SparseTensor:
    _check_devices(tensors)
    if isinstance(dim, int):
        nd = tensors[0].dim()
        dim = nd + dim if dim < 0 else dim
        if dim == 0:
            return cat_first(tensors)
        if dim == 1:
            return cat_second(tensors)
        if 1 < dim < nd:
            values = [t.storage.value() for t in tensors]
            if any(v is None for v in values):
                raise ValueError("cat over a dense dim needs values")
            return tensors[0].set_value(torch.cat(values, dim=dim - 1),
                                        layout="coo")
        raise IndexError(
            f"cat dim {dim} is outside the valid range [{-nd}, {nd - 1}] "
            f"for {nd}-dimensional sparse tensors")
    if len(dim) != 2 or sorted(dim) != [0, 1]:
        raise ValueError("a diagonal cat takes dim=(0, 1)")
    return cat_diag(tensors)


def _rows_storage(tensors, sizes, parts, **counts) -> SparseStorage:
    """The storage of a row-ordered concatenation (``cat_first``,
    ``cat_diag``): ``parts`` maps each index array or permutation to its
    pieces; what every input holds is kept, with its host copy."""
    if not (len(parts["row"].dev) == len(tensors)
            or len(parts["rowptr"].dev) == len(tensors)):
        # The inputs hold row and rowptr unevenly: take every row.
        parts["row"] = _Parts(len(tensors))
        M = 0
        for t in tensors:
            t.storage.row()
            parts["row"].add(t.storage, "row", M)
            M += t.sparse_size(0)
    fields = {name: p.device() for name, p in parts.items()}
    np_cache = {name: p.host_copy() for name, p in parts.items()
                if fields[name] is not None}
    return SparseStorage._new(value=_values(tensors), sparse_sizes=sizes,
                              np_cache=np_cache, **fields, **counts)


def cat_first(tensors: List[SparseTensor]) -> SparseTensor:
    _check_devices(tensors)
    n = len(tensors)
    rows, rowptrs, cols = _Parts(n), _Parts(n), _Parts(n)
    rowcounts = _Parts(n, host=False)
    M = N = nnz = 0
    for t in tensors:
        st = t.storage
        rows.add(st, "row", M)
        rowptrs.add(st, "rowptr", nnz, tail=bool(rowptrs.dev))
        cols.add(st, "col")
        rowcounts.add(st, "rowcount")
        M += t.sparse_size(0)
        N = max(N, t.sparse_size(1))
        nnz += t.nnz()
    return tensors[0].from_storage(_rows_storage(
        tensors, (M, N), {"row": rows, "rowptr": rowptrs, "col": cols},
        rowcount=rowcounts.device()))


def cat_second(tensors: List[SparseTensor]) -> SparseTensor:
    """Side by side: the nonzeros are sorted again, so only the column
    caches survive."""
    dev = _check_devices(tensors)
    n = len(tensors)
    rows, cols, colptrs = _Parts(n), _Parts(n), _Parts(n)
    colcounts = _Parts(n, host=False)
    M = N = nnz = 0
    for t in tensors:
        st = t.storage
        st.row()
        rows.add(st, "row")
        cols.add(st, "col", N)
        colptrs.add(st, "colptr", nnz, tail=bool(colptrs.dev))
        colcounts.add(st, "colcount")
        M = max(M, t.sparse_size(0))
        N += t.sparse_size(1)
        nnz += t.nnz()
    storage = SparseStorage(
        row=rows.host_copy(), col=cols.host_copy(), value=_values(tensors),
        sparse_sizes=(M, N), colptr=colptrs.device(),
        colcount=colcounts.device(), device=dev)
    return tensors[0].from_storage(storage)


def cat_diag(tensors: List[SparseTensor]) -> SparseTensor:
    """Block-diagonal: every cache all inputs hold is kept."""
    _check_devices(tensors)
    n = len(tensors)
    rows, rowptrs, cols = _Parts(n), _Parts(n), _Parts(n)
    colptrs, c2c, c2r = _Parts(n), _Parts(n), _Parts(n)
    rowcounts, colcounts = _Parts(n, host=False), _Parts(n, host=False)
    M = N = nnz = 0
    for t in tensors:
        st = t.storage
        rows.add(st, "row", M)
        rowptrs.add(st, "rowptr", nnz, tail=bool(rowptrs.dev))
        cols.add(st, "col", N)
        rowcounts.add(st, "rowcount")
        colptrs.add(st, "colptr", nnz, tail=bool(colptrs.dev))
        colcounts.add(st, "colcount")
        c2c.add(st, "csr2csc", nnz)
        c2r.add(st, "csc2csr", nnz)
        M += t.sparse_size(0)
        N += t.sparse_size(1)
        nnz += t.nnz()
    return tensors[0].from_storage(_rows_storage(
        tensors, (M, N), {"row": rows, "rowptr": rowptrs, "col": cols,
                          "colptr": colptrs, "csr2csc": c2c,
                          "csc2csr": c2r},
        rowcount=rowcounts.device(), colcount=colcounts.device()))
