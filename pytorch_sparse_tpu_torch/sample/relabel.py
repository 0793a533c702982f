"""Frontier relabelling (counterpart of
``pytorch_sparse_tpu/sample/relabel.py``).  ``relabel_one_hop`` runs on
the port's host library (``csrc/host_sample.cpp``, a copy of the JAX
package's native ``relabel_one_hop``); :func:`relabel_one_hop_plain` is
its plain version in numpy."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..typing import DeviceLike, resolve_device
from . import _native
from ._common import (check_nodes, expand_ranges, first_seen_relabel,
                      host_index, to_index)


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
    so that the output is square over the union of the nodes.  ``idx``
    holds rows of ``rowptr`` whose ranges lie within ``col`` (others
    raise ``ValueError``)."""
    dev = resolve_device(device)
    rowptr_np, col_np, idx_np = (host_index(rowptr), host_index(col),
                                 host_index(idx))
    check_nodes(idx_np, rowptr_np.shape[0] - 1, "idx")
    starts, ends = rowptr_np[idx_np], rowptr_np[idx_np + 1]
    if idx_np.size and (starts.min() < 0 or ends.max() > col_np.shape[0]
                        or np.any(ends < starts)):
        raise ValueError("rowptr does not delimit rows of col at idx")
    out_rowptr, local, positions, n_ids = _native.relabel_one_hop(
        rowptr_np, col_np, idx_np)
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


def relabel_one_hop_plain(rowptr: np.ndarray, col: np.ndarray,
                          idx: np.ndarray) -> Tuple[np.ndarray, ...]:
    """The plain version of the library's ``relabel_one_hop``, in numpy:
    ``(rowptr, local col, positions, n_id)``.  The tests hold the library
    against it; no sampler calls it."""
    counts = rowptr[idx + 1] - rowptr[idx]
    _, positions = expand_ranges(rowptr[idx], counts)
    n_ids, local = first_seen_relabel(col[positions], idx)
    return (np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
            local, positions, n_ids)
