"""Legacy tuple-API coalesce (counterpart of
``pytorch_sparse_tpu/ops/coalesce.py``; reference
``torch_sparse/coalesce.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..storage import SparseStorage
from ..typing import DeviceLike, resolve_device


def legacy_device(index, device: DeviceLike = None) -> torch.device:
    """The device of a legacy tuple-API call: the index tensor's, else
    ``device`` (default ``"cuda"``)."""
    if isinstance(index, torch.Tensor):
        if device is not None and torch.device(device) != index.device:
            raise ValueError(f"index lies on {index.device}, not {device}")
        return index.device
    return resolve_device(device)


def coalesce(index, value: Optional[torch.Tensor], m: int, n: int,
             op: str = "add", device: DeviceLike = None
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort ``(index, value)`` by (row, col) and reduce duplicate entries
    with ``op``; ``index`` is ``(2, E)``.  Returns ``(index, value)`` on
    the index's device, the index int32."""
    storage = SparseStorage(
        row=index[0], col=index[1], value=value, sparse_sizes=(m, n),
        is_sorted=False, device=legacy_device(index, device))
    storage = storage.coalesce(reduce=op)
    return torch.stack([storage.row(), storage.col()]), storage.value()
