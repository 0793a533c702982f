"""Legacy tuple-API identity matrix (counterpart of
``pytorch_sparse_tpu/ops/eye.py``; reference ``torch_sparse/eye.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..typing import DeviceLike, resolve_device
from ..utils.convert import INDEX_DTYPE


def eye(m: int, dtype=None, device: DeviceLike = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse identity: ``(index, value)``, a ``(2, m)`` int32 index and
    ``m`` ones of ``dtype`` (float32 by default)."""
    dev = resolve_device(device)
    row = torch.arange(m, dtype=INDEX_DTYPE, device=dev)
    return (torch.stack([row, row]),
            torch.ones(m, dtype=dtype or torch.float32, device=dev))
