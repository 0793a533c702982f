"""Functional ops over :class:`SparseTensor`.

Importing this package attaches methods onto ``SparseTensor``.
"""

from .segment import (  # noqa
    segment_count, segment_max, segment_mean, segment_min, segment_reduce,
    segment_sum,
)
from .matmul import (  # noqa
    matmul, spmm_add, spmm_max, spmm_mean, spmm_min, spmm_sum, spspmm_sum,
    spmm as spmm_dispatch,
)
from .matmul import spspmm as spspmm_tensor  # noqa
from .spgemm import (  # noqa
    expansion_terms, spspmm_chunked, spspmm_diag, spspmm_large,
    spspmm_native, spspmm_stream, spspmm_stream_device,
)
from .kernels.hybrid import (  # noqa
    DenseFormat, HybridFormat, build_dense, build_hybrid,
    build_hybrid_from_tensor, dense_spmm, hybrid_spmm,
)
from .transpose import t, transpose  # noqa
from .coalesce import coalesce  # noqa
from .eye import eye  # noqa
from .spmm import spmm  # noqa (legacy tuple API)
from .spspmm import spspmm  # noqa (legacy tuple API)
from .spadd import spadd  # noqa
from .convert import (  # noqa
    from_scipy, from_torch_sparse, to_scipy, to_torch_sparse,
)
from .add import add, add_, add_nnz, add_nnz_  # noqa
from .mul import mul, mul_, mul_nnz, mul_nnz_  # noqa
from .reduce import max, mean, min, reduction, sum  # noqa
from .diag import (  # noqa
    fill_diag, get_diag, non_diag_mask, remove_diag, set_diag,
)
from .index_select import index_select, index_select_nnz  # noqa
from .masked_select import masked_select, masked_select_nnz  # noqa
from .narrow import __narrow_diag__, narrow  # noqa
from .select import select  # noqa
from .cat import cat, cat_diag, cat_first, cat_second  # noqa
from .permute import permute  # noqa
from .bandwidth import reverse_cuthill_mckee  # noqa

# torch-style dtype, device, memory and torch.sparse methods.
from . import torch_compat  # noqa
