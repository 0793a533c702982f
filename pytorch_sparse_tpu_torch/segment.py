"""Segment reductions with the reference's empty-segment semantics
(counterpart of ``pytorch_sparse_tpu/segment.py``): empty segments give
0, and *mean* divides by ``max(count, 1)``."""

from __future__ import annotations

import numpy as np
import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


class _SegmentSumCsr(torch.autograd.Function):
    """Forward: the CSR kernel ``csr_spmm`` over the identity columns.
    Backward: each edge takes its segment's gradient."""

    @staticmethod
    def forward(ctx, data: torch.Tensor, rowptr: torch.Tensor):
        from .ops.kernels.csr_spmm import csr_spmm

        E, M = data.shape[0], rowptr.shape[0] - 1
        ctx.save_for_backward(rowptr)
        ctx.E = E
        cols = torch.arange(E, dtype=rowptr.dtype, device=data.device)
        out = csr_spmm(rowptr, cols, None, data.reshape(E, -1))
        return out.reshape((M,) + tuple(data.shape[1:]))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        from .utils.convert import ptr2ind

        (rowptr,) = ctx.saved_tensors
        rows = ptr2ind(rowptr, ctx.E).long()
        return grad.index_select(0, rows), None


def segment_sum_csr(data: torch.Tensor, rowptr: torch.Tensor) -> torch.Tensor:
    """Sum of each segment ``data[rowptr[r]:rowptr[r + 1]]`` of a sorted
    (CSR) layout, added left to right from 0 in edge order: the JAX
    package's ``segment_sum(..., indices_are_sorted=True)``.

    The order is fixed on every device, so the card's sums equal the
    CPU's bit for bit: a CUDA tensor runs the CSR kernel ``csr_spmm``
    over the identity columns (one ``fmaf(1, x, acc)`` chain per output,
    float32 only), a CPU tensor its plain version (a sequential
    ``index_add_``).  ``index_add_`` on the card adds atomically, in an
    order that changes from run to run."""
    if rowptr.shape[0] == 0 or int(rowptr[-1]) != data.shape[0]:
        raise ValueError("rowptr must end at the number of rows of data")
    return _SegmentSumCsr.apply(data, rowptr)


class Runs:
    """The runs of a sorted layout, ``data[ptr[r]:ptr[r + 1]]`` for the
    host pointer ``ptr`` (non-decreasing, from 0), and their sums in one
    fixed order on every device: each run added left to right from 0,
    the JAX package's ``segment_sum(..., indices_are_sorted=True)``.

    float32 data takes :func:`segment_sum_csr` (on the card, the CSR
    kernel over the identity columns); other dtypes take one
    ``index_add`` pass per place in the runs, pass ``d`` adding the
    ``d``-th element of every run longer than ``d``, so that no two
    writes of a pass reach one run and the card's atomics add in a fixed
    order.  Both keep the gradient of ``data``."""

    def __init__(self, ptr: np.ndarray, device):
        ptr = np.asarray(ptr, np.int64)
        if ptr.ndim != 1 or ptr.size == 0 or ptr[0] != 0 or np.any(
                np.diff(ptr) < 0):
            raise ValueError("a run pointer is non-decreasing from 0")
        if ptr[-1] >= 2**31:
            raise ValueError("runs index their elements with int32")
        self.n, self.total = ptr.size - 1, int(ptr[-1])
        self.rowptr = torch.from_numpy(ptr.astype(np.int32)).to(device)
        self._ptr = ptr
        self._passes = None

    def passes(self):
        """``(runs, elements)`` index pairs, one a place ``d`` in the
        runs: the runs longer than ``d`` and their ``d``-th elements."""
        if self._passes is None:
            lens = np.diff(self._ptr)
            dev = self.rowptr.device
            self._passes = []
            for d in range(int(lens.max(initial=0))):
                runs = np.flatnonzero(lens > d)
                self._passes.append((
                    torch.from_numpy(runs).to(dev),
                    torch.from_numpy(self._ptr[runs] + d).to(dev)))
        return self._passes

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """``(n, ...)``: the sum of each run of ``data`` ``(total, ...)``
        (0 for an empty run)."""
        if data.shape[0] != self.total:
            raise ValueError("data must have one row per element of the "
                             "runs")
        if data.dtype == torch.float32:
            return _SegmentSumCsr.apply(data.contiguous(), self.rowptr)
        out = data.new_zeros((self.n,) + tuple(data.shape[1:]))
        for runs, elems in self.passes():
            out = out.index_add(0, runs, data.index_select(0, elems))
        return out


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    return torch.bincount(segment_ids, minlength=num_segments).to(
        torch.int32)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments).clamp_min(1)
    return total / count.to(total.dtype).reshape(
        (-1,) + (1,) * (total.dim() - 1))


def _segment_extreme(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int, reduce: str) -> torch.Tensor:
    # include_self=False: a segment that receives nothing keeps its 0.
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    idx = segment_ids.long().reshape(
        (-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, idx, data, reduce, include_self=False)


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amax")
