"""Segment reductions with the reference's empty-segment semantics
(counterpart of ``pytorch_sparse_tpu/segment.py``): empty segments give
0, and *mean* divides by ``max(count, 1)``."""

from __future__ import annotations

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
