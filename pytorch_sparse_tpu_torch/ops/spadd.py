"""Legacy tuple-API sparse + sparse add (counterpart of
``pytorch_sparse_tpu/ops/spadd.py``; reference ``torch_sparse/spadd.py``):
concatenate, then coalesce with ``op='add'``."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..typing import DeviceLike
from .coalesce import coalesce, legacy_device


def spadd(indexA, valueA: Optional[torch.Tensor], indexB,
          valueB: Optional[torch.Tensor], m: int, n: int,
          device: DeviceLike = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``A + B`` of two ``(2, E)`` COO index/value pairs; the value is
    None unless both operands carry one."""
    dev = legacy_device(indexA, device)
    legacy_device(indexB, dev)  # raises when indexB lies elsewhere
    index = torch.cat([torch.as_tensor(indexA, device=dev),
                       torch.as_tensor(indexB, device=dev)], dim=-1)
    value = None
    if valueA is not None and valueB is not None:
        value = torch.cat([valueA, valueB], dim=0)
    return coalesce(index, value, m, n, op="add")
