"""Stable index sorting (counterpart of
``pytorch_sparse_tpu/utils/index_sort.py``): ``torch.sort(stable=True)``
on the input's device, ties in their input order."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def index_sort(inputs: torch.Tensor, max_value: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort a 1-D integer tensor: ``(values, permutation)``.
    ``max_value`` (the reference's radix-sort hint) is accepted and
    unused."""
    del max_value
    return torch.sort(inputs, stable=True)


def lexsort_rows(primary: torch.Tensor,
                 secondary: torch.Tensor) -> torch.Tensor:
    """The permutation sorting by ``(primary, secondary)``, stable: a
    stable sort by ``secondary``, then one by ``primary``."""
    perm = torch.argsort(secondary, stable=True)
    return perm[torch.argsort(primary[perm], stable=True)]
