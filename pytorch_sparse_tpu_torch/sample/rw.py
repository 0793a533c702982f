"""Uniform random walks (counterpart of ``pytorch_sparse_tpu/sample/rw.py``).

A ``(n, L)`` uniform matrix is drawn first, then the walk kernel steps
every walk through the CSR arrays on the graph's device.  Degree-0 nodes
stay in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.kernels.random_walk import random_walk as _walk
from ..tensor import SparseTensor
from ..utils.convert import INDEX_DTYPE


def uniforms(shape, device: torch.device,
             generator: Optional[torch.Generator],
             rand=None) -> torch.Tensor:
    """``rand`` on ``device`` (its dtype kept, for the kernel to check),
    or uniforms of ``shape`` from ``generator`` (seed 0 when None)."""
    if rand is not None:
        if not isinstance(rand, torch.Tensor):
            rand = torch.tensor(np.asarray(rand))
        rand = rand.to(device)
        if tuple(rand.shape) != tuple(shape):
            raise ValueError(f"rand must have shape {tuple(shape)}, got "
                             f"{tuple(rand.shape)}")
        if not bool(((rand >= 0) & (rand < 1)).all()):
            raise ValueError("rand must lie in [0, 1)")
        return rand
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.rand(shape, generator=generator, device=device)


def random_walk(src: SparseTensor, start, walk_length: int,
                generator: Optional[torch.Generator] = None,
                rand=None) -> torch.Tensor:
    """Walks of ``walk_length`` steps from ``start``: int32 node ids of
    shape ``(len(start), walk_length + 1)``, the start node first.

    The steps draw from ``rand`` when given (an ``(n, walk_length)``
    float32 matrix in ``[0, 1)``), else from ``torch.rand`` with
    ``generator`` on the graph's device.  On CUDA the walk runs the
    ``random_walk`` kernel.  A start node outside ``[0, M)`` raises
    ``ValueError``."""
    rowptr, col, _ = src.csr()
    dev = src.device()
    start = torch.as_tensor(start).to(device=dev)
    if start.numel():
        lo, hi = torch.stack(torch.aminmax(start)).tolist()
        if lo < 0 or hi >= rowptr.shape[0] - 1:
            raise ValueError(f"start nodes must lie in [0, "
                             f"{rowptr.shape[0] - 1}), got [{lo}, {hi}]")
    start = start.to(INDEX_DTYPE)
    rand = uniforms((start.shape[0], walk_length), dev, generator, rand)
    return _walk(rowptr, col, start.contiguous(), rand.contiguous())


SparseTensor.random_walk = (
    lambda self, start, walk_length, generator=None, rand=None: random_walk(
        self, start, walk_length, generator, rand)
)
