"""Legacy tuple conversions (counterpart of
``pytorch_sparse_tpu/ops/convert.py``; reference
``torch_sparse/convert.py``).

``to_torch_sparse``/``from_torch_sparse`` give and take a
``torch.sparse_coo_tensor``, as the reference's do; the JAX package
maps these names to its BCOO conversions, which have no counterpart
here.  Indices come back int32, on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device
from ..utils.convert import INDEX_DTYPE


def to_torch_sparse(index: torch.Tensor, value: torch.Tensor, m: int,
                    n: int) -> torch.Tensor:
    return torch.sparse_coo_tensor(index.detach().long(), value,
                                   (m, n) + tuple(value.shape[1:]))


def from_torch_sparse(A: torch.Tensor):
    """``(index, value)`` of a sparse COO tensor, in its stored order
    (an uncoalesced tensor is not coalesced)."""
    if A.is_coalesced():
        index, value = A.indices(), A.values()
    else:
        index, value = A._indices(), A._values()
    return index.detach().to(INDEX_DTYPE), value


def to_scipy(index, value, m: int, n: int):
    import scipy.sparse

    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return scipy.sparse.coo_matrix(
        (np.asarray(value), (np.asarray(index[0]), np.asarray(index[1]))),
        (m, n))


def from_scipy(A, device: DeviceLike = None):
    """``(index, value)`` of a scipy matrix's COO form, on ``device``
    (``"cuda"`` by default)."""
    dev = resolve_device(device)
    A = A.tocoo()
    index = torch.from_numpy(
        np.stack([A.row, A.col]).astype(np.int32)).to(dev)
    return index, torch.from_numpy(np.ascontiguousarray(A.data)).to(dev)
