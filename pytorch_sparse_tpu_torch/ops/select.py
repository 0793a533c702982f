"""Single-index select, a narrow of length 1 (counterpart of
``pytorch_sparse_tpu/ops/select.py``)."""

from __future__ import annotations

from ..tensor import SparseTensor
from .narrow import narrow


def select(src: SparseTensor, dim: int, idx: int) -> SparseTensor:
    return narrow(src, dim, start=idx, length=1)


SparseTensor.select = lambda self, dim, idx: select(self, dim, idx)
