"""Frontier relabelling (counterpart of
``pytorch_sparse_tpu/sample/relabel.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device
from ._common import expand_ranges, first_seen_relabel, host_index, to_index


def relabel(col, idx, device: DeviceLike = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact ``col`` against the frontier ``idx``: frontier nodes keep
    ids ``0..len(idx)-1``, unseen columns get fresh ids in first-seen
    order.  Returns ``(local, n_ids)`` on ``device``."""
    dev = resolve_device(device)
    n_ids, local = first_seen_relabel(host_index(col), host_index(idx))
    return to_index(local, dev), to_index(n_ids, dev)


def relabel_one_hop(rowptr, col, value: Optional[torch.Tensor], idx,
                    bipartite: bool = True, device: DeviceLike = None
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor], torch.Tensor]:
    """The whole one-hop neighbourhood of ``idx``, relabelled.  Returns
    ``(rowptr, col, value, n_id)``, indices on ``device`` and ``value``
    gathered on its own device; ``bipartite=False`` pads the row pointer
    so that the output is square over the union of the nodes."""
    dev = resolve_device(device)
    rowptr_np, col_np, idx_np = (host_index(rowptr), host_index(col),
                                 host_index(idx))
    counts = rowptr_np[idx_np + 1] - rowptr_np[idx_np]
    _, positions = expand_ranges(rowptr_np[idx_np], counts)
    n_ids, local = first_seen_relabel(col_np[positions], idx_np)
    out_rowptr = np.concatenate([[0], np.cumsum(counts)])
    if not bipartite:
        n_new = n_ids.shape[0] - idx_np.shape[0]
        out_rowptr = np.concatenate([
            out_rowptr, np.full(n_new, positions.shape[0], np.int64)])
    out_value = None
    if value is not None:
        value = torch.as_tensor(value)
        out_value = value[torch.from_numpy(positions).to(value.device)]
    return (to_index(out_rowptr, dev), to_index(local, dev), out_value,
            to_index(n_ids, dev))
