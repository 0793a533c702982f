"""Sparse x dense matmul (SpMM), forward only.

Counterpart of the SpMM half of ``pytorch_sparse_tpu/ops/matmul.py``
(``spmm_sum``, ``spmm_mean``, ``spmm`` and ``matmul`` over dense
operands).  Each call goes through the storage router: a cached or newly
built :class:`HybridFormat`/:class:`DenseFormat` when the block-density
statistics say the block routes pay, else the CSR kernel.

Half-precision operands (float16, bfloat16) compute in float32 and
return their own dtype.  3-D operands ``(batch, N, K)`` take the CSR
route, as in the JAX package.

Gradients are not implemented yet: a call with autograd enabled on an
operand or value that requires grad raises ``NotImplementedError``
rather than return an output that carries no gradient.
"""

from __future__ import annotations

import torch

from ..tensor import SparseTensor
from .kernels.csr_spmm import csr_spmm
from .kernels.hybrid import hybrid_spmm

_HALF = (torch.float16, torch.bfloat16)


def _check_operands(src: SparseTensor, other: torch.Tensor) -> None:
    if not isinstance(other, torch.Tensor):
        raise TypeError("the dense operand must be a torch.Tensor")
    if other.dim() not in (2, 3):
        raise ValueError("the dense operand must be (N, K) or (batch, N, K)")
    if other.shape[-2] != src.sparse_size(1):
        raise ValueError(
            f"operand has {other.shape[-2]} rows, the sparse matrix "
            f"{src.sparse_size(1)} columns")
    if other.device != src.device():
        raise ValueError(f"operand lies on {other.device}, the sparse "
                         f"matrix on {src.device()}")
    value = src.storage.value()
    if torch.is_grad_enabled() and (
            other.requires_grad
            or (value is not None and value.requires_grad)):
        raise NotImplementedError(
            "spmm has no backward yet (backward lands in slice 2); call "
            "it under torch.no_grad() or on inputs that do not require "
            "grad")


def _hybrid_view(src: SparseTensor, other: torch.Tensor):
    """The cached or auto-built hybrid view when it can serve this call."""
    if other.dim() != 2 or not other.is_floating_point():
        return None
    return src.storage.hybrid(K_hint=int(other.shape[-1]))


def _csr_sum(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    rowptr, col, value = src.csr()
    x = other.float() if other.dtype in _HALF else other
    if value is not None:
        value = value.to(x.dtype)
    if other.dim() == 3:
        # (batch, N, K) -> (N, batch*K): one pass over the edges, the
        # same per-element sum order as a loop over the batch.
        bt, n, k = x.shape
        x2 = x.permute(1, 0, 2).reshape(n, bt * k)
        out = csr_spmm(rowptr, col, value, x2.contiguous())
        out = out.reshape(-1, bt, k).permute(1, 0, 2)
    else:
        out = csr_spmm(rowptr, col, value, x.contiguous())
    return out.to(other.dtype)


def spmm_sum(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    _check_operands(src, other)
    hyb = _hybrid_view(src, other)
    if hyb is not None:
        return hybrid_spmm(hyb, other)
    return _csr_sum(src, other)


def spmm_add(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    return spmm_sum(src, other)


def spmm_mean(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    """``spmm_sum`` divided by ``max(rowcount, 1)``."""
    out = spmm_sum(src, other)
    deg = src.storage.rowcount().clamp_min(1).to(other.dtype)
    if other.dim() == 3:
        return out / deg[None, :, None]
    return out / deg[:, None]


def _minmax_missing(*_):
    raise NotImplementedError(
        "spmm min/max are not ported yet (ROADMAP.md, kernel K6)")


spmm_min = _minmax_missing
spmm_max = _minmax_missing


def spmm(src: SparseTensor, other: torch.Tensor, reduce: str = "sum"):
    """Reduce-mode dispatcher."""
    if reduce in ("sum", "add"):
        return spmm_sum(src, other)
    if reduce == "mean":
        return spmm_mean(src, other)
    if reduce in ("min", "max"):
        _minmax_missing()
    raise ValueError(f"Unknown reduce mode: {reduce!r}")


def matmul(src: SparseTensor, other, reduce: str = "sum"):
    """Sparse x dense matmul.  Sparse x sparse (SpSpMM) is not ported
    yet."""
    if isinstance(other, SparseTensor):
        raise NotImplementedError(
            "sparse x sparse matmul is not ported yet (ROADMAP.md)")
    return spmm(src, other, reduce)


SparseTensor.spmm = lambda self, other, reduce="sum": spmm(self, other, reduce)
SparseTensor.matmul = lambda self, other, reduce="sum": matmul(
    self, other, reduce)
SparseTensor.__matmul__ = lambda self, other: matmul(self, other, "sum")
