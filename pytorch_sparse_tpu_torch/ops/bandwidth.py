"""Reverse Cuthill-McKee bandwidth reduction through scipy on the host
(counterpart of ``pytorch_sparse_tpu/ops/bandwidth.py``; reference
``torch_sparse/bandwidth.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..tensor import SparseTensor
from .permute import permute


def reverse_cuthill_mckee(src: SparseTensor,
                          is_symmetric: Optional[bool] = None
                          ) -> Tuple[SparseTensor, torch.Tensor]:
    """``(A[perm][:, perm], perm)`` for scipy's RCM order of the
    symmetrised pattern; ``perm`` is int32 on the matrix's device."""
    import scipy.sparse.csgraph

    if is_symmetric is None:
        is_symmetric = src.is_symmetric()
    if not is_symmetric:
        src = src.to_symmetric()
    perm = scipy.sparse.csgraph.reverse_cuthill_mckee(
        src.to_scipy(layout="csr"), symmetric_mode=True).astype(np.int32)
    return permute(src, perm), torch.from_numpy(perm).to(src.device())


SparseTensor.reverse_cuthill_mckee = reverse_cuthill_mckee
