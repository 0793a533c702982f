"""Shared host helpers of the samplers (counterpart of
``pytorch_sparse_tpu/sample/_common.py``).

The checks that the host library's callers make before it indexes with
their node ids, and the plain versions' numpy: the native samplers'
insertion-ordered hash maps become first-seen ids from ``np.unique`` and
first positions, and CSR row walks one ``np.repeat``.  The results go to
the device as int32 index tensors, as the JAX package's
``to_index_array`` gives.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def host_index(x) -> np.ndarray:
    """A host int64 array of ``x`` (a tensor, numpy array or list)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.int64)


def check_nodes(nodes: np.ndarray, n: int, what: str) -> None:
    """Raise ``ValueError`` unless every id of ``nodes`` is in ``[0, n)``."""
    if nodes.size and (nodes.min() < 0 or nodes.max() >= n):
        raise ValueError(f"{what} holds a node outside [0, {n})")


def check_pointer(ptr: np.ndarray, n_entries: int, what: str) -> None:
    """Raise ``ValueError`` unless ``ptr`` runs from 0 to ``n_entries``
    and never falls."""
    if (ptr.ndim != 1 or ptr.shape[0] < 1 or ptr[0] != 0
            or ptr[-1] != n_entries or np.any(np.diff(ptr) < 0)):
        raise ValueError(f"{what} does not run from 0 to {n_entries} "
                         "without falling")


def to_index(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` as an int32 index tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(device)


def first_seen_relabel(
    stream: np.ndarray, priors: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Assign compact ids in first-seen order.

    ``priors`` (distinct) get ids ``0..len(priors)-1``; each new value in
    ``stream`` gets the next id at its first occurrence.  Returns
    ``(n_ids, local)``: the id -> value mapping and ``stream`` relabelled.
    """
    combined = np.concatenate([priors, stream])
    uniq, first_pos, inverse = np.unique(combined, return_index=True,
                                         return_inverse=True)
    order = np.argsort(first_pos, kind="stable")
    rank_of_uniq = np.empty(uniq.shape[0], dtype=np.int64)
    rank_of_uniq[order] = np.arange(uniq.shape[0])
    local = rank_of_uniq[inverse]
    n_ids = combined[np.sort(first_pos)]
    return n_ids, local[priors.shape[0]:]


def expand_ranges(
    starts: np.ndarray, counts: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """For each i, emit positions ``starts[i] .. starts[i]+counts[i]-1``.

    Returns ``(owner, positions)`` where ``owner[j]`` is the index i of
    ``positions[j]``, grouped by i in ascending position order.
    """
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    owner = np.repeat(np.arange(counts.shape[0]), counts)
    run_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offset = np.arange(total) - run_start[owner]
    return owner, starts[owner] + offset
