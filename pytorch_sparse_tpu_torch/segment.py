"""Segment reductions with the reference's empty-segment semantics
(counterpart of ``pytorch_sparse_tpu/segment.py``): empty segments give
0, and *mean* divides by ``max(count, 1)``."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


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
