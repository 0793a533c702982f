"""Index-format conversions (counterpart of
``pytorch_sparse_tpu/utils/convert.py``).

``ind2ptr`` is a ``searchsorted`` over sorted row indices and ``ptr2ind``
its inverse, both on torch built-ins on whatever device the input lies.
"""

from __future__ import annotations

import torch

# Indices are int32 on the device, as in the JAX package: the CUDA
# kernels read 4-byte column indices and row pointers.
INDEX_DTYPE = torch.int32


def ind2ptr(ind: torch.Tensor, M: int) -> torch.Tensor:
    """Sorted COO row indices -> CSR row pointer of length ``M + 1``.

    ``ptr[i]`` is the first position ``p`` with ``ind[p] >= i``: empty
    rows repeat the previous pointer, leading gaps are 0 and trailing
    gaps are ``len(ind)``.
    """
    targets = torch.arange(M + 1, dtype=ind.dtype, device=ind.device)
    return torch.searchsorted(ind, targets, right=False).to(INDEX_DTYPE)


def ptr2ind(ptr: torch.Tensor, E: int) -> torch.Tensor:
    """CSR row pointer -> COO row indices of length ``E`` (the inverse of
    :func:`ind2ptr`)."""
    counts = (ptr[1:] - ptr[:-1]).long()
    rows = torch.arange(counts.numel(), dtype=INDEX_DTYPE,
                        device=ptr.device)
    return torch.repeat_interleave(rows, counts, output_size=E)
