"""Functional ops over :class:`SparseTensor`.

Importing this package attaches methods onto ``SparseTensor``.
"""

from ..segment import segment_count, segment_mean, segment_sum  # noqa
from .matmul import (  # noqa
    matmul, spmm_add, spmm_max, spmm_mean, spmm_min, spmm_sum, spspmm_sum,
    spmm as spmm_dispatch,
)
from .matmul import spspmm as spspmm_tensor  # noqa
from .spgemm import (  # noqa
    expansion_terms, spspmm_chunked, spspmm_diag, spspmm_large,
    spspmm_stream, spspmm_stream_device,
)
from .kernels.hybrid import (  # noqa
    DenseFormat, HybridFormat, build_dense, build_hybrid,
    build_hybrid_from_tensor, dense_spmm, hybrid_spmm,
)
from .transpose import t, transpose  # noqa
from .coalesce import coalesce  # noqa
from .spspmm import spspmm  # noqa (legacy tuple API)
from .spadd import spadd  # noqa
from .add import add, add_, add_nnz, add_nnz_  # noqa
from .diag import fill_diag, get_diag, remove_diag, set_diag  # noqa
