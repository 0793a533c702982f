"""User-facing ``SparseTensor`` facade over :class:`SparseStorage`
(counterpart of ``pytorch_sparse_tpu/tensor.py``).

The op modules in ``pytorch_sparse_tpu_torch.ops`` attach further
methods (``spmm``, ``matmul``, ``@``, the diagonal ops) on import.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .segment import Runs
from .storage import SparseStorage
from .typing import DeviceLike, resolve_device


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

    def device(self) -> torch.device:
        return self.storage.device

    def dtype(self):
        value = self.storage.value()
        return None if value is None else value.dtype

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

    def __repr__(self) -> str:
        M, N = self.sparse_sizes()
        info = [f"size=({M}, {N})", f"nnz={self.nnz()}"]
        value = self.storage.value()
        if value is not None:
            info.append(f"dtype={value.dtype}")
        info.append(f"device={self.device()}")
        return f"{self.__class__.__name__}({', '.join(info)})"
