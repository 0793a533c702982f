"""Sparse x dense matmul (SpMM) with autograd.

Counterpart of the SpMM half of ``pytorch_sparse_tpu/ops/matmul.py``
(``spmm_sum``, ``spmm_mean``, ``spmm`` and ``matmul`` over dense
operands).  Each call goes through the storage router: a cached or newly
built :class:`HybridFormat`/:class:`DenseFormat` when the block-density
statistics say the block routes pay, else the CSR kernel.

Half-precision operands (float16, bfloat16) compute in float32 and
return their own dtype.  3-D operands ``(batch, N, K)`` take the CSR
route, as in the JAX package.

``min``/``max`` (:func:`spmm_min`, :func:`spmm_max`) bypass the router,
as in the JAX package: they run the ``csr_spmm_minmax`` kernel and
return ``(out, arg)`` with the argout contract of
``ops/kernels/spmm_minmax.py`` (first CSR edge on ties, sentinel
``arg == E`` on empty rows).  Half operands compare in their own dtype.
Their gradients flow only through the argout: ``minmax_edge_dot`` for
``value`` and ``minmax_spmm_t`` over the cached CSC view for the
operand.

Gradients follow the JAX package's contract (after the reference's
``csrc/spmm.cpp:88-112``): they flow to ``value`` and to the dense
operand, never to the indices;
``grad_value[e] = <mat[col e], grad[row e]>`` (the ``edge_dot`` kernel,
over every edge, on every route: the output is linear in ``value``, so
this is exact even where the block stores baked the values) and
``grad_mat = A^T @ grad`` (the CSR kernel over the cached CSC view, or
the transpose block pass of the hybrid and dense routes).  ``mean``
divides by the row degree outside the autograd functions, so autograd
folds ``1/deg`` into both gradients.  A backward computes only the
gradients asked for, and is not itself differentiable (the kernels have
no backward of their own).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..storage import SparseStorage
from ..tensor import SparseTensor
from .kernels.csr_spmm import csr_spmm
from .kernels.edge_dot import edge_dot
from .kernels.hybrid import hybrid_spmm, hybrid_spmm_t
from .kernels.spmm_minmax import (
    csr_spmm_minmax, minmax_edge_dot, minmax_spmm_t,
)

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


def _grad_value(st: SparseStorage, mat: torch.Tensor, grad: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
    """``grad_value[e] = <mat[col e], grad[row e]>`` over every edge."""
    return edge_dot(st.rowptr(), st.col(), mat, grad).to(value.dtype)


class _CsrSum(torch.autograd.Function):
    """``A @ mat`` on the CSR route (kernel ``csr_spmm``).  Backward:
    ``grad_mat`` runs ``csr_spmm`` over the cached CSC view (``colptr``,
    ``row[csr2csc]``, ``value[csr2csc]``), as the JAX package runs its
    gather kernel over the transpose ELL.  ``mat`` is kept for backward
    only when ``value`` needs its gradient."""

    @staticmethod
    def forward(ctx, st: SparseStorage, value, mat):
        ctx.st = st
        ctx.save_for_backward(value,
                              mat if ctx.needs_input_grad[1] else None)
        return csr_spmm(st.rowptr(), st.col(), value, mat)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        value, mat = ctx.saved_tensors
        st = ctx.st
        grad = grad.contiguous()  # autograd gives it the output's dtype
        grad_value = grad_mat = None
        if ctx.needs_input_grad[1]:
            grad_value = _grad_value(st, mat, grad, value)
        if ctx.needs_input_grad[2]:
            value_t = None if value is None else value[st.csr2csc()]
            grad_mat = csr_spmm(st.colptr(), st.csc_row(), value_t, grad)
        return None, grad_value, grad_mat


class _RoutedSum(torch.autograd.Function):
    """``A @ mat`` on the hybrid or dense route.  ``value`` enters only
    so that autograd can give it its gradient: the block and dense
    stores baked the same values at build time.  Backward: ``grad_mat``
    is :func:`hybrid_spmm_t`."""

    @staticmethod
    def forward(ctx, st: SparseStorage, h, value, mat):
        ctx.st, ctx.h = st, h
        ctx.save_for_backward(value,
                              mat if ctx.needs_input_grad[2] else None)
        return hybrid_spmm(h, mat)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        value, mat = ctx.saved_tensors
        grad = grad.contiguous()  # autograd gives it the output's dtype
        grad_value = grad_mat = None
        if ctx.needs_input_grad[2]:
            grad_value = _grad_value(ctx.st, mat, grad, value)
        if ctx.needs_input_grad[3]:
            grad_mat = hybrid_spmm_t(ctx.h, grad)
        return None, None, grad_value, grad_mat


def _hybrid_view(src: SparseTensor, other: torch.Tensor):
    """The cached or auto-built hybrid view when it can serve this call."""
    if other.dim() != 2 or not other.is_floating_point():
        return None
    return src.storage.hybrid(K_hint=int(other.shape[-1]))


def spmm_sum(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    _check_operands(src, other)
    st = src.storage
    x = other.float() if other.dtype in _HALF else other
    value = st.value()
    if value is not None:
        value = value.to(x.dtype)
    hyb = _hybrid_view(src, other)
    if hyb is not None:
        out = _RoutedSum.apply(st, hyb, value, x.contiguous())
    elif other.dim() == 3:
        # (batch, N, K) -> (N, batch*K): one pass over the edges, the
        # same per-element sum order as a loop over the batch.
        bt, n, k = x.shape
        x2 = x.permute(1, 0, 2).reshape(n, bt * k)
        out = _CsrSum.apply(st, value, x2.contiguous())
        out = out.reshape(-1, bt, k).permute(1, 0, 2)
    else:
        out = _CsrSum.apply(st, value, x.contiguous())
    return out.to(other.dtype)


def spmm_add(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    return spmm_sum(src, other)


def spmm_mean(src: SparseTensor, other: torch.Tensor) -> torch.Tensor:
    """``spmm_sum`` divided by ``max(rowcount, 1)``."""
    out = spmm_sum(src, other)
    deg = src.storage.rowcount().clamp_min(1).to(other.dtype)
    if other.dim() == 3:
        return out / deg[None, :, None]
    return out / deg[:, None]


class _CsrMinMax(torch.autograd.Function):
    """Min or max of ``A @ mat`` on the CSR route (kernel
    ``csr_spmm_minmax``), with its argout.  Backward routes the gradient
    through the argout: ``grad_value`` by ``minmax_edge_dot``,
    ``grad_mat`` by ``minmax_spmm_t`` over the cached CSC view, each only
    when asked for.  Both compute in float32 with ``value`` rounded to
    ``mat``'s dtype, as the forward used it."""

    @staticmethod
    def forward(ctx, st: SparseStorage, value, mat, is_min: bool):
        out, arg = csr_spmm_minmax(st.rowptr(), st.col(), value, mat, is_min)
        ctx.mark_non_differentiable(arg)
        ctx.st = st
        ctx.value_dtype = None if value is None else value.dtype
        ctx.save_for_backward(value if ctx.needs_input_grad[2] else None,
                              mat if ctx.needs_input_grad[1] else None, arg)
        return out, arg

    @staticmethod
    @once_differentiable
    def backward(ctx, grad, _grad_arg):
        value, mat, arg = ctx.saved_tensors
        st = ctx.st
        g = grad.float().contiguous()
        grad_value = grad_mat = None
        if ctx.needs_input_grad[1]:
            grad_value = minmax_edge_dot(
                st.rowptr(), st.col(), mat.float().contiguous(), g,
                arg).to(ctx.value_dtype)
        if ctx.needs_input_grad[2]:
            v = None if value is None else (
                value.to(grad.dtype).float().contiguous())
            grad_mat = minmax_spmm_t(st.colptr(), st.csc_row(), st.csr2csc(),
                                     v, g, arg).to(grad.dtype)
        return None, grad_value, grad_mat, None


def _spmm_minmax(src: SparseTensor, other: torch.Tensor, is_min: bool):
    _check_operands(src, other)
    st = src.storage
    if other.dim() == 3:
        # (batch, N, K) -> (N, batch*K), as spmm_sum does.
        bt, n, k = other.shape
        x2 = other.permute(1, 0, 2).reshape(n, bt * k)
        out, arg = _CsrMinMax.apply(st, st.value(), x2.contiguous(), is_min)
        return (out.reshape(-1, bt, k).permute(1, 0, 2),
                arg.reshape(-1, bt, k).permute(1, 0, 2))
    return _CsrMinMax.apply(st, st.value(), other.contiguous(), is_min)


def spmm_min(src: SparseTensor, other: torch.Tensor):
    """``(out, arg)``: the row-wise minimum of ``value[e] * other[col e]``
    and the first CSR edge that reaches it (``arg == E`` on empty
    rows)."""
    return _spmm_minmax(src, other, True)


def spmm_max(src: SparseTensor, other: torch.Tensor):
    """``(out, arg)``: the row-wise maximum, as :func:`spmm_min`."""
    return _spmm_minmax(src, other, False)


def spmm(src: SparseTensor, other: torch.Tensor, reduce: str = "sum"):
    """Reduce-mode dispatcher."""
    if reduce in ("sum", "add"):
        return spmm_sum(src, other)
    if reduce == "mean":
        return spmm_mean(src, other)
    if reduce == "min":
        return spmm_min(src, other)[0]
    if reduce == "max":
        return spmm_max(src, other)[0]
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
