"""Functional ops over :class:`SparseTensor`.

Importing this package attaches methods onto ``SparseTensor``.
"""

from ..segment import segment_count, segment_mean, segment_sum  # noqa
from .matmul import (  # noqa
    matmul, spmm_add, spmm_max, spmm_mean, spmm_min, spmm_sum,
    spmm as spmm_dispatch,
)
from .kernels.hybrid import (  # noqa
    DenseFormat, HybridFormat, build_dense, build_hybrid, dense_spmm,
    hybrid_spmm,
)
from .diag import fill_diag, remove_diag, set_diag  # noqa
