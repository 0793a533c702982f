"""Synthetic graphs and tolerance helpers shared by the port's tests and
``chip_smoke.py`` (counterpart of ``pytorch_sparse_tpu/testing.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .tensor import SparseTensor
from .typing import DeviceLike


def tolerance(dtype) -> float:
    """Bound for oracles that reassociate sums: 1e-1 for half dtypes,
    1e-5 for float32 (rounding order), 1e-7 for float64."""
    if dtype in (torch.float16, torch.bfloat16):
        return 1e-1
    if dtype == torch.float64:
        return 1e-7
    return 1e-5


def strict_tolerance(dtype) -> float:
    """1e-7 for float32/float64 and 1e-1 for half dtypes; valid only
    against an oracle that sums in the kernels' order (CSR edge order)."""
    if dtype in (torch.float16, torch.bfloat16):
        return 1e-1
    return 1e-7


def rel_err(got, ref) -> float:
    """``max |got - ref| / max |ref|`` in float64 (0 for empty or zero
    references)."""
    got = np.asarray(got.detach().cpu().double() if isinstance(
        got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref.detach().cpu().double() if isinstance(
        ref, torch.Tensor) else ref, np.float64)
    if ref.size == 0:
        return 0.0
    scale = np.abs(ref).max()
    diff = np.abs(got - ref).max()
    return float(diff / scale) if scale > 0 else float(diff)


def community_graph(
    M: int,
    E: int,
    n_comm: int,
    intra_p: float = 0.9,
    rng: Optional[np.random.RandomState] = None,
    seed: int = 0,
    equal_sizes: bool = False,
    values: bool = True,
    device: DeviceLike = None,
) -> SparseTensor:
    """Synthetic community graph in community-sorted layout; the same
    seed gives the same graph and values as the JAX package's
    ``community_graph``.

    ``intra_p`` of the edges stay inside the source node's community.
    ``equal_sizes`` uses ``n_comm`` contiguous equal blocks; otherwise
    community sizes are multinomial.  Duplicate draws merge by ``add``
    and, when ``values``, N(0, 1) float32 values are drawn after
    coalescing, one per surviving nnz.
    """
    if rng is None:
        rng = np.random.RandomState(seed)
    if equal_sizes:
        cp = np.linspace(0, M, n_comm + 1).astype(np.int64)
        comm_of = np.repeat(np.arange(n_comm), np.diff(cp))
        order = np.arange(M, dtype=np.int64)
    else:
        comm_of = rng.randint(0, n_comm, M)
        order = np.argsort(comm_of)
        cp = np.searchsorted(comm_of[order], np.arange(n_comm + 1))
    src = rng.randint(0, M, E)
    intra = rng.rand(E) < intra_p
    c = comm_of[src[intra]]
    dst = rng.randint(0, M, E)
    lo, hi = cp[c], cp[c + 1]
    dst[intra] = order[
        lo + (rng.rand(int(intra.sum())) * (hi - lo)).astype(np.int64)
    ]
    A = SparseTensor(row=src, col=dst, sparse_sizes=(M, M),
                     device=device).coalesce("add")
    if values:
        A = A.set_value(torch.from_numpy(rng.randn(A.nnz()).astype(
            np.float32)), layout="coo")
    return A
