"""Sparse x dense (SpMM) and sparse x sparse (SpSpMM) matmul with
autograd.

Counterpart of ``pytorch_sparse_tpu/ops/matmul.py`` (``spmm_sum``,
``spmm_mean``, ``spmm``, ``spspmm_sum`` and ``matmul``).  Each SpMM call
goes through the storage router: a cached or newly built
:class:`HybridFormat`/:class:`DenseFormat` when the block-density
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

SpSpMM (``A @ B`` with a sparse ``B``) runs an eager host structure pass
and a numeric pass on the ``plan_numeric`` kernel, whose backward gives
both values their gradients with the same kernel; products past
``ops.spgemm.PLAN_MAX_TERMS`` terms take the host library's Gustavson
SpGEMM on the CPU, and the chunked plan on the card or where a value
requires grad.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..storage import SparseStorage
from ..tensor import SparseTensor
from ..utils.host_sort import stable_argsort
from .kernels.csr_spmm import csr_spmm
from .kernels.edge_dot import edge_dot
from .kernels.hybrid import hybrid_spmm, hybrid_spmm_t, store_of, with_store
from .kernels.plan_numeric import plan_numeric
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
    stores hold the same values (``SparseStorage.hybrid`` refreshes
    them).  Backward: ``grad_mat``
    is :func:`hybrid_spmm_t`."""

    @staticmethod
    def forward(ctx, st: SparseStorage, h, value, mat):
        # The store is saved, not kept in ctx.h, so that autograd frees
        # it after the backward.
        ctx.st, ctx.h = st, with_store(h, None)
        ctx.save_for_backward(value,
                              mat if ctx.needs_input_grad[2] else None,
                              store_of(h))
        return hybrid_spmm(h, mat)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        value, mat, store = ctx.saved_tensors
        grad = grad.contiguous()  # autograd gives it the output's dtype
        grad_value = grad_mat = None
        if ctx.needs_input_grad[2]:
            grad_value = _grad_value(ctx.st, mat, grad, value)
        if ctx.needs_input_grad[3]:
            grad_mat = hybrid_spmm_t(with_store(ctx.h, store), grad)
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


# ----------------------------------------------------------------------
# SpSpMM (counterpart of the JAX package's ``matmul.py:497-668``): an
# eager host structure pass, then a differentiable numeric pass on the
# ``plan_numeric`` kernel.  Large products go through ``ops/spgemm.py``.
# ----------------------------------------------------------------------

# Terms per host sort in the structure pass (as the JAX package's).
_SORT_CHUNK = 1 << 25


def _expansion_degrees(colA: np.ndarray, rowptrB: np.ndarray) -> np.ndarray:
    """Expansion terms of each A entry: ``deg_B(colA[e])`` (host int64)."""
    return rowptrB[colA + 1] - rowptrB[colA]


def _spspmm_structure(A: SparseTensor, B: SparseTensor, e_lo: int = 0,
                      e_hi: Optional[int] = None):
    """Expansion-pass structure of ``A @ B`` over the A entries
    ``[e_lo, e_hi)`` (complete rows, for the output to be a row block of
    C): for each A entry (i, k), every entry of B's row k.

    Returns host int64 arrays ``(a_pos, b_pos, t_ptr, rowC, colC)``: the
    A entry (absolute) and B entry of each product term, sorted by
    output (row, col) and stably within it; the term pointer ``t_ptr``
    (n_out + 1) of each output entry's contiguous run; and the output
    structure.  The JAX package's bucket tables (``t_tabs``/``inv``),
    which keep XLA:TPU scatter-free, are not built: ``t_ptr`` is all the
    kernel reads.  Every term's entry is kept, also one whose values
    cancel to zero."""
    rowA = A.storage.numpy_view("row")
    colA = A.storage.numpy_view("col")
    if e_hi is None:
        e_hi = rowA.shape[0]
    rowA, colA = rowA[e_lo:e_hi], colA[e_lo:e_hi]
    rowptrB = B.storage.numpy_view("rowptr")
    colB = B.storage.numpy_view("col")

    deg = _expansion_degrees(colA, rowptrB)
    total = int(deg.sum())
    a_pos = np.repeat(np.arange(colA.shape[0], dtype=np.int64), deg)
    run_start = np.cumsum(deg) - deg
    b_pos = rowptrB[colA[a_pos]] + (np.arange(total, dtype=np.int64)
                                    - run_start[a_pos])
    out_row = rowA[a_pos]
    out_col = colB[b_pos]

    # Sort by (row, col) as one int64 key.  The terms are row-major
    # already (A is row-sorted), so each bounded chunk of complete rows
    # sorts on its own: the same stable order, a bounded working set.
    key = out_row * B.sparse_size(1) + out_col
    if total > _SORT_CHUNK:
        row_change = np.flatnonzero(
            np.concatenate([[True], out_row[1:] != out_row[:-1]]))
        order = np.empty(total, np.int64)
        s = 0
        while s < total:
            e = min(s + _SORT_CHUNK, total)
            if e < total:  # extend to the next complete-row boundary
                ip = np.searchsorted(row_change, e)
                e = int(row_change[ip]) if ip < row_change.size else total
            order[s:e] = s + stable_argsort(key[s:e])
            s = e
    else:
        order = stable_argsort(key)
    key = key[order]
    a_pos, b_pos = a_pos[order] + e_lo, b_pos[order]
    new = np.ones(total, bool)
    new[1:] = key[1:] != key[:-1]
    t_start = np.flatnonzero(new)
    t_ptr = np.append(t_start, total)
    rowC, colC = out_row[order][t_start], out_col[order][t_start]
    return a_pos, b_pos, t_ptr, rowC, colC


class _Plan:
    """One structure plan of ``A @ B`` (or of a row block of it) with its
    index arrays on the operands' device, and the two backward orderings,
    built on first use: the terms stably re-sorted by ``a_pos`` (or
    ``b_pos``), each term's output entry, and the pointer over the A (or
    B) entries."""

    def __init__(self, A: SparseTensor, B: SparseTensor, e_lo: int = 0,
                 e_hi: Optional[int] = None):
        if e_hi is None:
            e_hi = A.nnz()
        self.a_pos, self.b_pos, self.t_ptr, self.rowC, self.colC = (
            _spspmm_structure(A, B, e_lo, e_hi))
        self.e_lo, self.e_hi = e_lo, e_hi
        self.nnzA, self.nnzB = A.nnz(), B.nnz()
        self.device = A.device()
        self._dev = {}

    @property
    def n_out(self) -> int:
        return int(self.rowC.shape[0])

    def dev(self, name: str) -> torch.Tensor:
        """The host array ``name`` as an int32 tensor on the device."""
        if name not in self._dev:
            self._dev[name] = torch.from_numpy(
                getattr(self, name).astype(np.int32)).to(self.device)
        return self._dev[name]

    def _by(self, side: str):
        """``(out_id, other_pos, ptr)`` of the terms stably sorted by
        their ``side`` entry, with ``ptr`` over ``side``'s entries (A's
        restricted to ``[e_lo, e_hi)``)."""
        key = f"by_{side}"
        if key not in self._dev:
            pos, other = ((self.a_pos - self.e_lo, self.b_pos) if side == "a"
                          else (self.b_pos, self.a_pos))
            n = self.e_hi - self.e_lo if side == "a" else self.nnzB
            perm = stable_argsort(pos)
            out_id = np.repeat(np.arange(self.n_out, dtype=np.int64),
                               np.diff(self.t_ptr))[perm]
            ptr = np.concatenate([[0], np.cumsum(np.bincount(pos,
                                                              minlength=n))])

            def up(a):
                return torch.from_numpy(a.astype(np.int32)).to(self.device)

            self._dev[key] = (up(out_id), up(other[perm]), up(ptr))
        return self._dev[key]

    def numeric(self, valueA: Optional[torch.Tensor],
                valueB: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The output values: ``None`` when both operands have implicit
        ones, else the differentiable :class:`_PlanNumeric` pass."""
        if valueA is None and valueB is None:
            return None
        return _PlanNumeric.apply(self, valueA, valueB)


class _PlanNumeric(torch.autograd.Function):
    """``valueC[s] = sum of valueA[a_pos[t]] * valueB[b_pos[t]]`` over the
    terms of output entry ``s`` (kernel ``plan_numeric``).  A ``None``
    side means ones in the other's dtype; the kernel then reads the other
    side alone.  Backward: ``grad_valueA[e] = sum of grad_C[out_id[t]] *
    valueB[b_pos[t]]`` over the terms of A entry ``e``, the same kernel
    over the terms re-sorted by ``a_pos``; ``grad_valueB`` alike, re-sorted
    by ``b_pos``.  This is the gradient JAX gets by autodiff; each runs
    only when asked for."""

    @staticmethod
    def forward(ctx, plan: _Plan, valueA, valueB):
        ctx.plan = plan
        ctx.save_for_backward(valueA, valueB)
        t_ptr = plan.dev("t_ptr")
        if valueA is None:
            return plan_numeric(valueB, plan.dev("b_pos"), None, None, t_ptr)
        if valueB is None:
            return plan_numeric(valueA, plan.dev("a_pos"), None, None, t_ptr)
        return plan_numeric(valueA, plan.dev("a_pos"), valueB,
                            plan.dev("b_pos"), t_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        valueA, valueB = ctx.saved_tensors
        plan = ctx.plan
        grad = grad.contiguous()
        grad_a = grad_b = None
        if ctx.needs_input_grad[1]:
            out_id, b_pos, ptr = plan._by("a")
            g = plan_numeric(grad, out_id, valueB, b_pos, ptr).to(
                valueA.dtype)
            if g.shape[0] != plan.nnzA:  # a row block of A's entries
                g = torch.cat([g.new_zeros(plan.e_lo), g,
                               g.new_zeros(plan.nnzA - plan.e_hi)])
            grad_a = g
        if ctx.needs_input_grad[2]:
            out_id, a_pos, ptr = plan._by("b")
            grad_b = plan_numeric(grad, out_id, valueA, a_pos, ptr).to(
                valueB.dtype)
        return None, grad_a, grad_b


def check_pair(A: SparseTensor, B: SparseTensor) -> None:
    """Raise unless ``A @ B`` is defined and both lie on one device."""
    if A.sparse_size(1) != B.sparse_size(0):
        raise ValueError(f"A has {A.sparse_size(1)} columns, B "
                         f"{B.sparse_size(0)} rows")
    if A.device() != B.device():
        raise ValueError(f"A lies on {A.device()}, B on {B.device()}")


def spspmm_sum(A: SparseTensor, B: SparseTensor) -> SparseTensor:
    """``A @ B`` as a SparseTensor on the operands' device.  Products of
    more than ``ops.spgemm.PLAN_MAX_TERMS`` terms take
    :func:`~pytorch_sparse_tpu_torch.ops.spgemm.spspmm_large`."""
    check_pair(A, B)
    from . import spgemm

    if spgemm.expansion_terms(A, B) > spgemm.PLAN_MAX_TERMS:
        return spgemm.spspmm_large(A, B)
    plan = _Plan(A, B)
    value = plan.numeric(A.storage.value(), B.storage.value())
    return SparseTensor(
        row=plan.rowC, col=plan.colC, value=value,
        sparse_sizes=(A.sparse_size(0), B.sparse_size(1)), is_sorted=True,
        trust_data=True, device=A.device())


def spspmm(A: SparseTensor, B: SparseTensor,
           reduce: str = "sum") -> SparseTensor:
    """SpSpMM reduce-mode dispatcher: only ``sum`` (``add``) exists."""
    if reduce in ("sum", "add"):
        return spspmm_sum(A, B)
    raise ValueError(
        f"`spspmm` reduce mode {reduce!r} not supported (only 'sum', as in "
        "the reference's matmul.py:118-126).")


def matmul(src: SparseTensor, other, reduce: str = "sum"):
    """Sparse x dense (SpMM) or sparse x sparse (SpSpMM) matmul."""
    if isinstance(other, SparseTensor):
        return spspmm(src, other, reduce)
    return spmm(src, other, reduce)


SparseTensor.spmm = lambda self, other, reduce="sum": spmm(self, other, reduce)
SparseTensor.spspmm = lambda self, other, reduce="sum": spspmm(
    self, other, reduce)
SparseTensor.matmul = lambda self, other, reduce="sum": matmul(
    self, other, reduce)
SparseTensor.__matmul__ = lambda self, other: matmul(self, other, "sum")
