"""Reductions over a sparse matrix (counterpart of
``pytorch_sparse_tpu/ops/reduce.py``; reference
``torch_sparse/reduce.py``).

``dim=None`` reduces every value; ``dim=1`` each row and ``dim=0`` each
column; ``dim>1`` a dense value dimension.  Empty rows and columns give
0, and ``mean`` divides by ``max(count, 1)``.

Sums add in a fixed order on every device, so that the card's bits are
the CPU's: a row's values left to right in CSR order (the JAX package's
sorted segment sum), a column's in CSC order (``csr2csc`` is stable, so
each column keeps CSR order).  float32 runs ``segment_sum_csr`` (on the
card, the CSR kernel ``csr_spmm`` over the identity columns), other
dtypes ``segment.Runs``; neither is an atomic ``index_add_``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..segment import Runs, segment_max, segment_min, segment_sum_csr
from ..tensor import SparseTensor

_REDUCES = ("sum", "add", "mean", "min", "max")


def _ordered_sum(value: torch.Tensor, ptr: torch.Tensor,
                 host_ptr: np.ndarray) -> torch.Tensor:
    """The sum of each run ``value[ptr[i]:ptr[i + 1]]``, left to right."""
    if value.dtype == torch.float32:
        return segment_sum_csr(value.contiguous(), ptr)
    return Runs(host_ptr, value.device).sum(value)


def _segments(src: SparseTensor, dim: int, value: torch.Tensor,
              reduce: str) -> torch.Tensor:
    """Reduce ``value`` over the rows (``dim=1``) or columns (0)."""
    st = src.storage
    if reduce in ("min", "max"):
        ids = (st.row() if dim == 1 else st.col()).long()
        fn = segment_min if reduce == "min" else segment_max
        return fn(value, ids, src.sparse_size(1 - dim))
    if dim == 1:
        ptr = st.rowptr()
        out = _ordered_sum(value, ptr, st.numpy_view("rowptr"))
    else:
        # Fills the csr2csc and colptr caches: the CSC order it sums in.
        ptr = st.colptr()
        out = _ordered_sum(value.index_select(0, st.csr2csc().long()),
                           ptr, st.numpy_view("colptr"))
    if reduce == "mean":
        count = (ptr[1:] - ptr[:-1]).clamp_min(1).to(out.dtype)
        out = out / count.reshape((-1,) + (1,) * (out.dim() - 1))
    return out


def reduction(src: SparseTensor, dim: Optional[int] = None,
              reduce: str = "sum") -> torch.Tensor:
    if reduce not in _REDUCES:
        raise ValueError(f"Unknown reduce mode: {reduce!r}")
    value = src.storage.value()
    dev = src.device()
    if (reduce == "mean" and value is not None
            and not value.is_floating_point()):
        value = value.to(torch.float32)  # an integer mean is float32
    if dim is None:
        if value is None:
            n = src.nnz() if reduce in ("sum", "add") else 1
            return torch.tensor(float(n), dtype=torch.float32, device=dev)
        if reduce in ("sum", "add"):
            return value.sum()
        if reduce == "mean":
            return value.mean()
        return value.min() if reduce == "min" else value.max()

    if dim < 0:
        dim = src.dim() + dim
    if dim in (0, 1):
        if value is None:
            if reduce in ("sum", "add"):
                st = src.storage
                count = st.rowcount() if dim == 1 else st.colcount()
                return count.to(torch.float32)
            return torch.ones(src.sparse_size(1 - dim), dtype=torch.float32,
                              device=dev)
        return _segments(src, dim, value, reduce)
    if value is None:
        raise ValueError(f"Cannot reduce dim {dim} without values")
    if reduce in ("sum", "add"):
        return value.sum(dim=dim - 1)
    if reduce == "mean":
        return value.mean(dim=dim - 1)
    return (value.amin if reduce == "min" else value.amax)(dim=dim - 1)


def sum(src: SparseTensor, dim: Optional[int] = None) -> torch.Tensor:
    return reduction(src, dim, reduce="sum")


def mean(src: SparseTensor, dim: Optional[int] = None) -> torch.Tensor:
    return reduction(src, dim, reduce="mean")


def min(src: SparseTensor, dim: Optional[int] = None) -> torch.Tensor:
    return reduction(src, dim, reduce="min")


def max(src: SparseTensor, dim: Optional[int] = None) -> torch.Tensor:
    return reduction(src, dim, reduce="max")


SparseTensor.sum = lambda self, dim=None: sum(self, dim)
SparseTensor.mean = lambda self, dim=None: mean(self, dim)
SparseTensor.min = lambda self, dim=None: min(self, dim)
SparseTensor.max = lambda self, dim=None: max(self, dim)
