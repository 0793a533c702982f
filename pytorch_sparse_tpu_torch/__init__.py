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
kernel) with its chunked, streaming and block-split paths and the host
library's Gustavson SpGEMM past the plan's limit; the
structural op set (transpose, add, mul, diagonal edits, select, narrow,
index and mask selection, cat, permute, reductions whose sums run the
CSR kernel on the card, reverse Cuthill-McKee, scipy and ``torch.sparse``
conversions, torch-style dtype and device methods, the legacy tuple
API); and the samplers: random walks (a hand-written walk
kernel), with-replacement ``sample``, ``relabel``, and on the port's
host C++ library ``sample_adj``, ``saint_subgraph``,
``relabel_one_hop``, the homogeneous ``neighbor_sample`` and the typed,
temporal, HGT and ego samplers, whose draws equal the JAX package's
native sampler's; and the distribution layer (``parallel``): row shards
over ``torch.distributed`` process groups with the all-gather, ring and
halo SpMM schedules, also on a ``(data, feat)`` grid, and the
hierarchical (DCN x ICI) schedule (hand-written shard kernels), forward
and backward, and ``models.DistGCN`` on the flat and hierarchical
layouts; and the JAX package's on-chip gather probe
(``benchmarks.probe_vmem_gather``: hand-written shared-memory gather,
edge-scan and tile-staged SpMM kernels, measured on the card).
Names follow the JAX package.  Entry points run on ``cuda`` unless
given ``device="cpu"``; the CPU runs each kernel's plain PyTorch
version.
"""

__version__ = "0.1.0"

from .storage import SparseStorage  # noqa
from .tensor import SparseTensor  # noqa
from .ops import (  # noqa
    spmm_sum, spmm_add, spmm_mean, spmm_min, spmm_max, spspmm_sum, matmul,
    expansion_terms, spspmm_chunked, spspmm_native, spspmm_stream,
    spspmm_diag, spspmm_stream_device, HybridFormat, DenseFormat,
    build_hybrid,
    build_hybrid_from_tensor, build_dense, hybrid_spmm, dense_spmm, t,
    transpose, coalesce, eye, spmm, spspmm, spadd, to_torch_sparse,
    from_torch_sparse, to_scipy, from_scipy, add, add_, add_nnz, add_nnz_,
    mul, mul_, mul_nnz, mul_nnz_, reduction, sum, mean, min, max,
    non_diag_mask, remove_diag, set_diag, fill_diag, get_diag, index_select,
    index_select_nnz, masked_select, masked_select_nnz, narrow,
    __narrow_diag__, select, cat, permute, reverse_cuthill_mckee,
)
from .sample import (  # noqa
    random_walk, sample, sample_adj, saint_subgraph, ego_k_hop_sample_adj,
    relabel, relabel_one_hop, neighbor_sample, hetero_neighbor_sample,
    hetero_temporal_neighbor_sample, hgt_sample,
)
from .utils import ind2ptr, ptr2ind, index_sort, save_npz, load_npz  # noqa
from .partition import (  # noqa
    mt_partition, partition, partition_fine, weight2metis,
)

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
    "spspmm_native",
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
    "eye",
    "spmm",
    "spspmm",
    "spadd",
    "to_torch_sparse",
    "from_torch_sparse",
    "to_scipy",
    "from_scipy",
    "add",
    "add_",
    "add_nnz",
    "add_nnz_",
    "mul",
    "mul_",
    "mul_nnz",
    "mul_nnz_",
    "reduction",
    "sum",
    "mean",
    "min",
    "max",
    "__narrow_diag__",
    "non_diag_mask",
    "remove_diag",
    "set_diag",
    "fill_diag",
    "get_diag",
    "index_select",
    "index_select_nnz",
    "masked_select",
    "masked_select_nnz",
    "narrow",
    "select",
    "cat",
    "permute",
    "reverse_cuthill_mckee",
    "random_walk",
    "sample",
    "sample_adj",
    "saint_subgraph",
    "ego_k_hop_sample_adj",
    "relabel",
    "relabel_one_hop",
    "neighbor_sample",
    "hetero_neighbor_sample",
    "hetero_temporal_neighbor_sample",
    "hgt_sample",
    "ind2ptr",
    "ptr2ind",
    "index_sort",
    "save_npz",
    "load_npz",
    "partition",
    "partition_fine",
    "mt_partition",
    "weight2metis",
    "__version__",
]
