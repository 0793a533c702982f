from .block_spmm import block_spmm, block_spmm_plain  # noqa
from .csr_spmm import csr_spmm, csr_spmm_plain  # noqa
from .hybrid import (  # noqa
    DenseFormat, HybridFormat, build_dense, build_hybrid, dense_spmm,
    hybrid_spmm,
)
