"""Broadcast and sparse x sparse (intersection) multiplication
(counterpart of ``pytorch_sparse_tpu/ops/mul.py``; reference
``torch_sparse/mul.py``).

Sparse x sparse keeps the positions present in both coalesced operands:
the two COO lists are concatenated and stably sorted on the host, and
each adjacent duplicate pair's values are gathered and multiplied on the
device.  A ``(M, 1, ...)`` or ``(1, N, ...)`` dense operand broadcasts
into the nonzeros through ``row`` or ``col``.  The in-place spellings
return a new tensor, as ``ops/add.py``'s do.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..segment import gather_rows
from ..tensor import SparseTensor
from ..utils.host_sort import lexsort2_decode
from .add import _as_operand, _broadcast_nnz


def mul(src: SparseTensor,
        other: Union[torch.Tensor, SparseTensor]) -> SparseTensor:
    if isinstance(other, SparseTensor):
        if other.device() != src.device():
            raise ValueError(f"operands lie on {src.device()} and "
                             f"{other.device()}")
        if not src.is_coalesced():
            raise ValueError("sparse*sparse mul needs a coalesced `src` "
                             "(call src.coalesce() first)")
        if not other.is_coalesced():
            raise ValueError("sparse*sparse mul needs a coalesced `other` "
                             "(call other.coalesce() first)")
        valueA, valueB = src.storage.value(), other.storage.value()
        if valueA is None or valueB is None:
            raise ValueError("sparse*sparse mul needs explicit values on "
                             "both operands")
        stA, stB = src.storage, other.storage
        perm, row, col = lexsort2_decode(
            np.concatenate([stA.numpy_view("row"), stB.numpy_view("row")]),
            np.concatenate([stA.numpy_view("col"), stB.numpy_view("col")]))
        idx = 1 + np.flatnonzero((row[1:] == row[:-1])
                                 & (col[1:] == col[:-1]))
        values = torch.cat([valueA, valueB])
        dev = values.device
        left, right = gather_rows(values, perm[idx - 1]), gather_rows(
            values, perm[idx])
        return SparseTensor(
            row=row[idx], col=col[idx], value=left * right,
            sparse_sizes=(max(src.sparse_size(0), other.sparse_size(0)),
                          max(src.sparse_size(1), other.sparse_size(1))),
            is_sorted=True, trust_data=True, device=dev)

    per_nnz = _broadcast_nnz(src, _as_operand(src, other))
    value = src.storage.value()
    value = per_nnz if value is None else per_nnz.to(value.dtype) * value
    return src.set_value(value, layout="coo")


mul_ = mul


def mul_nnz(src: SparseTensor, other,
            layout: Optional[str] = None) -> SparseTensor:
    """Multiply the values by ``other`` (one entry per nonzero, in
    ``layout`` order); implicit ones take ``other`` itself."""
    other = _as_operand(src, other)
    value = src.storage.value()
    value = other if value is None else value * other.to(value.dtype)
    return src.set_value(value, layout=layout)


mul_nnz_ = mul_nnz

SparseTensor.mul = lambda self, other: mul(self, other)
SparseTensor.mul_ = lambda self, other: mul_(self, other)
SparseTensor.mul_nnz = lambda self, other, layout=None: mul_nnz(
    self, other, layout)
SparseTensor.mul_nnz_ = lambda self, other, layout=None: mul_nnz_(
    self, other, layout)
SparseTensor.__mul__ = SparseTensor.mul
SparseTensor.__rmul__ = SparseTensor.mul
SparseTensor.__imul__ = SparseTensor.mul_
