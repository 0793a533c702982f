"""pytorch_sparse_tpu_torch — the PyTorch and CUDA port of
``pytorch_sparse_tpu``, for NVIDIA Hopper GPUs.

It carries ``SparseStorage``/``SparseTensor`` with their caches; the
routed SpMM (a hand-written CSR row kernel, a hand-written block-dense
kernel, and the whole-matrix dense route) forward and backward; SpMM
min/max with its argout, forward and backward; the block-aligned hybrid
format, differentiable in the operand and in its block store (a
hand-written block-gradient kernel); GCN, GAT (hand-written edge-softmax
kernels, forward and backward), GraphSAGE and GIN inference and
training; SpSpMM (a hand-written plan-numeric kernel and block-pair
kernel) with its chunked, streaming and block-split paths; and the
structural ops of a SpSpMM pipeline (transpose, add, diagonal edits, the
legacy tuple API); and the samplers: random walks (a hand-written walk
kernel), with-replacement ``sample``, and on the host ``sample_adj``,
``saint_subgraph``, ``relabel``, ``relabel_one_hop`` and the
homogeneous ``neighbor_sample``, whose draws equal the JAX package's
native sampler's; and the distribution layer (``parallel``): row shards
over ``torch.distributed`` process groups with the all-gather, ring and
halo SpMM schedules, also on a ``(data, feat)`` grid, and the
hierarchical (DCN x ICI) schedule (hand-written shard kernels), forward
and backward, and ``models.DistGCN`` on the flat and hierarchical
layouts.
Names follow the JAX package.  Entry points run on ``cuda`` unless
given ``device="cpu"``; the CPU runs each kernel's plain PyTorch
version.
"""

__version__ = "0.1.0"

from .storage import SparseStorage  # noqa
from .tensor import SparseTensor  # noqa
from .ops import (  # noqa
    spmm_sum, spmm_add, spmm_mean, spmm_min, spmm_max, spspmm_sum, matmul,
    expansion_terms, spspmm_chunked, spspmm_stream, spspmm_diag,
    spspmm_stream_device, HybridFormat, DenseFormat, build_hybrid,
    build_hybrid_from_tensor, build_dense, hybrid_spmm, dense_spmm, t, transpose, coalesce, spspmm,
    spadd, add, add_, add_nnz, add_nnz_, remove_diag, set_diag, fill_diag,
    get_diag,
)
from .sample import (  # noqa
    random_walk, sample, sample_adj, saint_subgraph, relabel,
    relabel_one_hop, neighbor_sample,
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
    "spspmm_sum",
    "expansion_terms",
    "spspmm_chunked",
    "spspmm_stream",
    "spspmm_diag",
    "spspmm_stream_device",
    "matmul",
    "HybridFormat",
    "DenseFormat",
    "build_hybrid",
    "build_hybrid_from_tensor",
    "build_dense",
    "hybrid_spmm",
    "dense_spmm",
    "t",
    "transpose",
    "coalesce",
    "spspmm",
    "spadd",
    "add",
    "add_",
    "add_nnz",
    "add_nnz_",
    "remove_diag",
    "set_diag",
    "fill_diag",
    "get_diag",
    "random_walk",
    "sample",
    "sample_adj",
    "saint_subgraph",
    "relabel",
    "relabel_one_hop",
    "neighbor_sample",
    "ind2ptr",
    "ptr2ind",
    "__version__",
]
