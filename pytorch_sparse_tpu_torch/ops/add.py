"""Sparse + sparse and broadcast addition (counterpart of
``pytorch_sparse_tpu/ops/add.py``; reference ``torch_sparse/add.py``).

Sparse + sparse concatenates the two COO lists on the host and
coalesces with ``sum``; the sum has a value only when both operands
have one.  A ``(M, 1, ...)`` (row-wise) or ``(1, N, ...)`` (column-wise)
dense operand broadcasts into the nonzeros through ``row`` or ``col``.
PyTorch updates in place where JAX cannot, but the in-place spellings
return a new tensor here, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..tensor import SparseTensor


def _as_operand(src: SparseTensor, other) -> torch.Tensor:
    if isinstance(other, torch.Tensor):
        if other.device != src.device():
            raise ValueError(f"operand lies on {other.device}, the sparse "
                             f"matrix on {src.device()}")
        return other
    return torch.as_tensor(np.asarray(other), device=src.device())


def _broadcast_nnz(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    """A ``(M, 1, ...)`` or ``(1, N, ...)`` operand expanded to one entry
    per nonzero."""
    M, N = src.sparse_sizes()
    if other.dim() >= 2 and other.shape[0] == M and other.shape[1] == 1:
        return other.reshape((M,) + tuple(other.shape[2:]))[
            src.storage.row().long()]
    if other.dim() >= 2 and other.shape[0] == 1 and other.shape[1] == N:
        return other.reshape((N,) + tuple(other.shape[2:]))[
            src.storage.col().long()]
    raise ValueError(
        f"broadcast operand of shape {tuple(other.shape)} does not match "
        f"the sparse operand: need ({M}, 1, ...) for row-wise or (1, {N}, "
        f"...) for column-wise broadcasting")


def add(src: SparseTensor,
        other: Union[torch.Tensor, SparseTensor]) -> SparseTensor:
    if isinstance(other, SparseTensor):
        if other.device() != src.device():
            raise ValueError(f"operands lie on {src.device()} and "
                             f"{other.device()}")
        valueA, valueB = src.storage.value(), other.storage.value()
        value: Optional[torch.Tensor] = None
        if valueA is not None and valueB is not None:
            value = torch.cat([valueA, valueB])
        st_a, st_b = src.storage, other.storage
        out = SparseTensor(
            row=np.concatenate([st_a.numpy_view("row"),
                                st_b.numpy_view("row")]),
            col=np.concatenate([st_a.numpy_view("col"),
                                st_b.numpy_view("col")]),
            value=value,
            sparse_sizes=(max(src.sparse_size(0), other.sparse_size(0)),
                          max(src.sparse_size(1), other.sparse_size(1))),
            device=src.device())
        return out.coalesce(reduce="sum")

    per_nnz = _broadcast_nnz(src, _as_operand(src, other))
    value = src.storage.value()
    if value is not None:
        value = per_nnz.to(value.dtype) + value
    else:
        value = per_nnz + 1
    return src.set_value(value, layout="coo")


add_ = add


def add_nnz(src: SparseTensor, other,
            layout: Optional[str] = None) -> SparseTensor:
    """Add ``other`` (one entry per nonzero, in ``layout`` order) to the
    values; implicit ones count as 1."""
    other = _as_operand(src, other)
    value = src.storage.value()
    if value is not None:
        value = value + other.to(value.dtype)
    else:
        value = other + 1
    return src.set_value(value, layout=layout)


add_nnz_ = add_nnz

SparseTensor.add = lambda self, other: add(self, other)
SparseTensor.add_ = lambda self, other: add_(self, other)
SparseTensor.add_nnz = lambda self, other, layout=None: add_nnz(
    self, other, layout)
SparseTensor.add_nnz_ = lambda self, other, layout=None: add_nnz_(
    self, other, layout)
SparseTensor.__add__ = SparseTensor.add
SparseTensor.__radd__ = SparseTensor.add
SparseTensor.__iadd__ = SparseTensor.add_
