"""pytorch_sparse_tpu_torch — the PyTorch and CUDA port of
``pytorch_sparse_tpu``, for NVIDIA Hopper GPUs.

It carries ``SparseStorage``/``SparseTensor`` with their caches; the
routed SpMM (a hand-written CSR row kernel, a hand-written block-dense
kernel, and the whole-matrix dense route) forward and backward; SpMM
min/max with its argout, forward and backward; GCN inference and
training; and GAT inference with a hand-written edge-softmax kernel.
Names follow the JAX package.  Entry points run on ``cuda`` unless
given ``device="cpu"``; the CPU runs each kernel's plain PyTorch
version.
"""

__version__ = "0.1.0"

from .storage import SparseStorage  # noqa
from .tensor import SparseTensor  # noqa
from .ops import (  # noqa
    spmm_sum, spmm_add, spmm_mean, spmm_min, spmm_max, matmul,
    HybridFormat, DenseFormat, build_hybrid, build_dense, hybrid_spmm,
    dense_spmm, remove_diag, set_diag, fill_diag,
)
from .utils import ind2ptr, ptr2ind  # noqa

__all__ = [
    "SparseStorage",
    "SparseTensor",
    "spmm_sum",
    "spmm_add",
    "spmm_mean",
    "spmm_min",
    "spmm_max",
    "matmul",
    "HybridFormat",
    "DenseFormat",
    "build_hybrid",
    "build_dense",
    "hybrid_spmm",
    "dense_spmm",
    "remove_diag",
    "set_diag",
    "fill_diag",
    "ind2ptr",
    "ptr2ind",
    "__version__",
]
