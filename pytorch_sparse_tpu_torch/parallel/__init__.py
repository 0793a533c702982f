"""Distribution layer: row-partitioned sparse matrices over a
``torch.distributed`` process group, one row shard per process, with
the all-gather, ring and halo SpMM schedules (counterpart of
``pytorch_sparse_tpu/parallel``).  Every process joins the group
itself (``torch.distributed.init_process_group``) before
:func:`make_mesh`.

The hierarchical (ICI/DCN) schedule and the 2-D ``(data, feat)`` mesh of
the JAX package are not ported yet.
"""

from .mesh import Mesh, data_axis, make_mesh  # noqa
from .dist import (  # noqa
    ShardedSparseMatrix, dist_spmm, dist_spmm_allgather, dist_spmm_halo,
    dist_spmm_ring,
)
