"""User-facing ``SparseTensor`` facade over :class:`SparseStorage`
(counterpart of ``pytorch_sparse_tpu/tensor.py``).

The op modules in ``pytorch_sparse_tpu_torch.ops`` attach further
methods (``spmm``, ``matmul``, ``@``, the diagonal, selection,
reduction and ``torch_compat`` methods) on import.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .segment import Runs
from .storage import SparseStorage, _to_numpy, get_layout
from .typing import DeviceLike, input_device, resolve_device


class SparseTensor:
    storage: SparseStorage

    def __init__(
        self,
        row=None,
        rowptr=None,
        col=None,
        value=None,
        sparse_sizes: Optional[Tuple[Optional[int], Optional[int]]] = None,
        is_sorted: bool = False,
        trust_data: bool = False,
        device: DeviceLike = None,
    ):
        self.storage = SparseStorage(
            row=row, rowptr=rowptr, col=col, value=value,
            sparse_sizes=sparse_sizes, is_sorted=is_sorted,
            trust_data=trust_data, device=device,
        )

    @classmethod
    def from_storage(cls, storage: SparseStorage) -> "SparseTensor":
        out = object.__new__(cls)
        out.storage = storage
        return out

    @classmethod
    def from_edge_index(cls, edge_index, edge_attr=None,
                        sparse_sizes: Optional[Tuple[Optional[int],
                                                     Optional[int]]] = None,
                        is_sorted: bool = False, trust_data: bool = False,
                        device: DeviceLike = None) -> "SparseTensor":
        """From a ``(2, E)`` edge index and optional per-edge values; a
        tensor index keeps its device unless ``device`` is given."""
        return cls(row=edge_index[0], col=edge_index[1], value=edge_attr,
                   sparse_sizes=sparse_sizes, is_sorted=is_sorted,
                   trust_data=trust_data,
                   device=input_device(edge_index, device))

    @classmethod
    def from_scipy(cls, mat, device: DeviceLike = None) -> "SparseTensor":
        """From a scipy sparse matrix (its data's dtype kept); a CSC
        matrix also seeds the ``colptr`` cache."""
        import scipy.sparse

        colptr = None
        if isinstance(mat, scipy.sparse.csc_matrix):
            colptr = mat.indptr
        mat = mat.tocsr()
        rowptr = mat.indptr
        mat = mat.tocoo()
        storage = SparseStorage(
            row=mat.row, rowptr=rowptr, col=mat.col, value=mat.data,
            sparse_sizes=(int(mat.shape[0]), int(mat.shape[1])),
            colptr=colptr, is_sorted=True, trust_data=True, device=device)
        return cls.from_storage(storage)

    @classmethod
    def eye(cls, M: int, N: Optional[int] = None, has_value: bool = True,
            dtype=None, fill_cache: bool = False,
            device: DeviceLike = None) -> "SparseTensor":
        """The ``(M, N)`` identity, with every cache filled when
        ``fill_cache``."""
        N = M if N is None else N
        k = min(M, N)
        diag = np.arange(k, dtype=np.int64)
        rowptr = np.concatenate([np.arange(k + 1, dtype=np.int64),
                                 np.full(max(M - k, 0), k, np.int64)])
        dev = resolve_device(device)
        value = (torch.ones(k, dtype=dtype or torch.float32, device=dev)
                 if has_value else None)
        caches = {}
        if fill_cache:
            caches = dict(
                rowcount=(rowptr[1:] - rowptr[:-1]),
                colptr=np.concatenate([np.arange(k + 1, dtype=np.int64),
                                       np.full(max(N - k, 0), k, np.int64)]),
                colcount=np.concatenate([np.ones(k, np.int64),
                                         np.zeros(max(N - k, 0), np.int64)]),
                csr2csc=diag, csc2csr=diag)
        storage = SparseStorage(
            row=diag, rowptr=rowptr, col=diag, value=value,
            sparse_sizes=(M, N), is_sorted=True, trust_data=True,
            device=dev, **caches)
        return cls.from_storage(storage)

    @classmethod
    def from_dense(cls, mat, has_value: bool = True,
                   device: DeviceLike = None) -> "SparseTensor":
        """Nonzeros of a dense (2-D or more) array, in row-major order."""
        dev = resolve_device(device)
        mat = torch.as_tensor(mat).to(dev)
        if mat.dim() > 2:
            nonzero = mat.abs().sum(dim=tuple(range(2, mat.dim()))) != 0
        else:
            nonzero = mat != 0
        row, col = torch.nonzero(nonzero, as_tuple=True)
        value = mat[row, col] if has_value else None
        return cls(row=row, col=col, value=value,
                   sparse_sizes=(int(mat.shape[0]), int(mat.shape[1])),
                   is_sorted=True, trust_data=True, device=dev)

    # ------------------------------------------------------------------
    # Views
    # ------------------------------------------------------------------
    def coo(self):
        return self.storage.row(), self.storage.col(), self.storage.value()

    def csr(self):
        return self.storage.rowptr(), self.storage.col(), self.storage.value()

    def csc(self):
        perm = self.storage.csr2csc()
        value = self.storage.value()
        if value is not None:
            value = value[perm]
        return self.storage.colptr(), self.storage.row()[perm], value

    def has_value(self) -> bool:
        return self.storage.has_value()

    def set_value(self, value, layout: Optional[str] = None
                  ) -> "SparseTensor":
        return self.from_storage(self.storage.set_value(value, layout))

    set_value_ = set_value

    def fill_value(self, fill_value: float, dtype=None) -> "SparseTensor":
        value = torch.full((self.nnz(),), fill_value,
                           dtype=dtype or torch.float32,
                           device=self.device())
        return self.set_value(value, layout="coo")

    fill_value_ = fill_value

    # ------------------------------------------------------------------
    # Sizes
    # ------------------------------------------------------------------
    def sparse_sizes(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    def sparse_size(self, dim: int) -> int:
        return self.storage.sparse_size(dim)

    def nnz(self) -> int:
        return self.storage.nnz()

    def numel(self) -> int:
        value = self.storage.value()
        return self.nnz() if value is None else value.numel()

    def sparse_resize(self, sparse_sizes: Tuple[int, int]) -> "SparseTensor":
        return self.from_storage(self.storage.sparse_resize(sparse_sizes))

    def sparse_reshape(self, num_rows: int, num_cols: int
                       ) -> "SparseTensor":
        return self.from_storage(
            self.storage.sparse_reshape(num_rows, num_cols))

    def size(self, dim: Optional[int] = None):
        value = self.storage.value()
        size: Tuple[int, ...] = self.sparse_sizes()
        if value is not None and value.dim() > 1:
            size = size + tuple(value.shape[1:])
        return size if dim is None else size[dim]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.size()

    def sizes(self) -> List[int]:
        return list(self.size())

    def dim(self) -> int:
        return len(self.size())

    def density(self) -> float:
        M, N = self.sparse_sizes()
        return self.nnz() / (M * N) if M and N else 0.0

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def avg_row_length(self) -> float:
        M = self.sparse_size(0)
        return self.nnz() / M if M > 0 else 0.0

    def avg_col_length(self) -> float:
        N = self.sparse_size(1)
        return self.nnz() / N if N > 0 else 0.0

    def _offsets(self) -> np.ndarray:
        """``|row - col|`` of every nonzero, on the host."""
        return np.abs(self.storage.numpy_view("row")
                      - self.storage.numpy_view("col"))

    def bandwidth(self) -> int:
        return int(self._offsets().max()) if self.nnz() else 0

    def bandwidth_proportion(self, bandwidth: int) -> float:
        if not self.nnz():
            return 0.0
        return float(np.mean(self._offsets() <= bandwidth))

    def is_quadratic(self) -> bool:
        return self.sparse_size(0) == self.sparse_size(1)

    def device(self) -> torch.device:
        return self.storage.device

    def dtype(self):
        value = self.storage.value()
        return None if value is None else value.dtype

    def requires_grad(self) -> bool:
        """Whether the value requires grad (False without a value)."""
        value = self.storage.value()
        return value is not None and value.requires_grad

    def astype(self, dtype) -> "SparseTensor":
        return self.from_storage(self.storage.astype_value(dtype))

    def to_device(self, device: DeviceLike) -> "SparseTensor":
        return self.from_storage(self.storage.to_device(device))

    # ------------------------------------------------------------------
    # Symmetry
    # ------------------------------------------------------------------
    def is_symmetric(self) -> bool:
        if not self.is_quadratic():
            return False
        rowptr, col, val1 = self.csr()
        colptr, row, val2 = self.csc()
        if not (torch.equal(rowptr, colptr) and torch.equal(col, row)):
            return False
        return val1 is None or bool(torch.equal(val1, val2))

    def to_symmetric(self, reduce: str = "sum") -> "SparseTensor":
        """``reduce(A, A^T)`` over the union of both patterns, as a square
        matrix of the larger side."""
        N = max(self.sparse_sizes())
        hrow = self.storage.numpy_view("row")
        hcol = self.storage.numpy_view("col")
        value = self.storage.value()
        if value is not None:
            value = torch.cat([value, value])
        out = SparseTensor(row=np.concatenate([hrow, hcol]),
                           col=np.concatenate([hcol, hrow]), value=value,
                           sparse_sizes=(N, N), device=self.device())
        return out.coalesce(reduce)

    # ------------------------------------------------------------------
    # Structure and caches
    # ------------------------------------------------------------------
    def coalesce(self, reduce: str = "add") -> "SparseTensor":
        return self.from_storage(self.storage.coalesce(reduce))

    def is_coalesced(self) -> bool:
        return self.storage.is_coalesced()

    def fill_cache_(self) -> "SparseTensor":
        self.storage.fill_cache_()
        return self

    def clear_cache_(self) -> "SparseTensor":
        self.storage.clear_cache_()
        return self

    def copy(self) -> "SparseTensor":
        return self.from_storage(self.storage.copy())

    clone = copy

    def to_dense(self, dtype=None) -> torch.Tensor:
        """Dense (M, N, ...) tensor; duplicate entries add up, each
        position's in edge order (``segment.Runs``), so that the card
        gives the same bits on every run."""
        row, col, value = self.coo()
        M, N = self.sparse_sizes()
        if value is None:
            value = torch.ones(row.shape, dtype=dtype or torch.float32,
                               device=row.device)
        out = value.new_zeros((M, N) + tuple(value.shape[1:]))
        # The storage keeps (row, col) sorted: duplicates are adjacent.
        hrow = self.storage.numpy_view("row")
        hcol = self.storage.numpy_view("col")
        new = np.concatenate([[True], (hrow[1:] != hrow[:-1])
                              | (hcol[1:] != hcol[:-1])])
        if not new.all():
            first = np.flatnonzero(new)
            value = Runs(np.append(first, new.size), row.device).sum(value)
            keep = torch.from_numpy(first).to(row.device)
            row, col = row[keep], col[keep]
        return out.index_put_((row.long(), col.long()), value)

    def to_scipy(self, dtype=None, layout: Optional[str] = None):
        """A scipy ``coo_matrix``, ``csr_matrix`` (the default) or
        ``csc_matrix``; implicit values become ones of ``dtype``
        (float32 by default), bfloat16 values float32."""
        import scipy.sparse

        layout = "csr" if layout is None else get_layout(layout)
        M, N = self.sparse_sizes()
        st = self.storage
        if layout == "coo":
            ptr, idx, value = None, st.numpy_view("col"), st.value()
        elif layout == "csr":
            ptr, idx, value = (st.numpy_view("rowptr"), st.numpy_view("col"),
                               st.value())
        else:
            ptr, idx, value = self.csc()
            ptr, idx = ptr.cpu().numpy(), idx.cpu().numpy()
        value = (np.ones(idx.shape, dtype=dtype or np.float32)
                 if value is None else _to_numpy(value))
        if layout == "coo":
            return scipy.sparse.coo_matrix(
                (value, (st.numpy_view("row"), idx)), (M, N))
        if layout == "csr":
            return scipy.sparse.csr_matrix((value, idx, ptr), (M, N))
        return scipy.sparse.csc_matrix((value, idx, ptr), (M, N))

    # ------------------------------------------------------------------
    # Python protocol
    # ------------------------------------------------------------------
    def __eq__(self, other) -> bool:
        """Same sizes, structure and values (both implicit, or equal
        tensors of one shape)."""
        if not isinstance(other, SparseTensor):
            return False
        if self.sparse_sizes() != other.sparse_sizes():
            return False
        rowptrA, colA, valueA = self.csr()
        rowptrB, colB, valueB = other.csr()
        if colA.shape != colB.shape or colA.device != colB.device:
            return False
        if not (torch.equal(rowptrA, rowptrB) and torch.equal(colA, colB)):
            return False
        if valueA is None or valueB is None:
            return valueA is None and valueB is None
        return valueA.shape == valueB.shape and bool(
            torch.equal(valueA, valueB))

    __hash__ = object.__hash__

    def __getitem__(self, index: Any) -> "SparseTensor":
        """numpy-style indexing: an int selects, a slice (step 1)
        narrows, an integer array, list or tensor index-selects, a bool
        one masked-selects; ``...`` fills the remaining dimensions."""
        index = index if isinstance(index, tuple) else (index,)
        if any(item is Ellipsis for item in index):
            pos = next(i for i, item in enumerate(index) if item is Ellipsis)
            fill = (slice(None),) * (2 - (len(index) - 1))
            index = index[:pos] + fill + index[pos + 1:]
        out = self
        dim = 0
        for item in index:
            if isinstance(item, slice):
                if item != slice(None):
                    if item.step not in (None, 1):
                        raise IndexError("slices take a step of 1")
                    size = self.sparse_size(dim)
                    start, stop, _ = item.indices(size)
                    out = out.narrow(dim, start, max(stop - start, 0))
            elif isinstance(item, int):
                out = out.select(dim, item)
            elif isinstance(item, (torch.Tensor, np.ndarray, list)):
                arr = (item.detach().cpu().numpy()
                       if isinstance(item, torch.Tensor) else np.asarray(item))
                if arr.dtype == np.bool_:
                    out = out.masked_select(dim, arr)
                else:
                    out = out.index_select(dim, arr)
            else:
                raise IndexError(
                    f"Unsupported index type {type(item)} at dim {dim}")
            dim += 1
        return out

    def __repr__(self) -> str:
        M, N = self.sparse_sizes()
        info = [f"size=({M}, {N})", f"nnz={self.nnz()}"]
        value = self.storage.value()
        if value is not None:
            info.append(f"dtype={value.dtype}")
        info.append(f"device={self.device()}")
        return f"{self.__class__.__name__}({', '.join(info)})"
