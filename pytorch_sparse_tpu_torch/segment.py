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
