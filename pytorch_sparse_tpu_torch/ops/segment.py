"""Re-export shim (counterpart of ``pytorch_sparse_tpu/ops/segment.py``):
the segment reductions live at the package top level
(``pytorch_sparse_tpu_torch/segment.py``), where ``storage.py`` reaches
them without importing the op package."""

from ..segment import (  # noqa
    Runs, segment_count, segment_max, segment_mean, segment_min,
    segment_reduce, segment_sum, segment_sum_csr,
)
