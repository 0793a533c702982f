"""Legacy tuple-API SpSpMM (counterpart of
``pytorch_sparse_tpu/ops/spspmm.py``; reference
``torch_sparse/spspmm.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..tensor import SparseTensor
from ..typing import DeviceLike
from .coalesce import legacy_device
from .matmul import matmul


def spspmm(indexA, valueA: Optional[torch.Tensor], indexB,
           valueB: Optional[torch.Tensor], m: int, k: int, n: int,
           coalesced: bool = False, device: DeviceLike = None
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Product of two COO matrices, ``(m, k)`` and ``(k, n)``, given as
    ``(2, E)`` indices and values.  As in the reference, the operands
    are built with ``is_sorted=not coalesced``: by default the indices
    are taken as already sorted."""
    dev = legacy_device(indexA, device)
    A = SparseTensor(row=indexA[0], col=indexA[1], value=valueA,
                     sparse_sizes=(m, k), is_sorted=not coalesced,
                     device=dev)
    B = SparseTensor(row=indexB[0], col=indexB[1], value=valueB,
                     sparse_sizes=(k, n), is_sorted=not coalesced,
                     device=legacy_device(indexB, dev))
    row, col, value = matmul(A, B).coo()
    return torch.stack([row, col]), value
