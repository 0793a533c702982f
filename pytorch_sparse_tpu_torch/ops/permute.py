"""Symmetric permutation ``A[perm][:, perm]`` (counterpart of
``pytorch_sparse_tpu/ops/permute.py``)."""

from __future__ import annotations

from ..tensor import SparseTensor
from .index_select import index_select


def permute(src: SparseTensor, perm) -> SparseTensor:
    if not src.is_quadratic():
        raise ValueError("permute needs a square matrix")
    return index_select(index_select(src, 0, perm), 1, perm)


SparseTensor.permute = lambda self, perm: permute(self, perm)
