"""Distribution layer: row-partitioned sparse matrices over
``torch.distributed`` process groups, one row shard per process
(counterpart of ``pytorch_sparse_tpu/parallel``).  Every process joins
the default group itself (``torch.distributed.init_process_group``)
before making a mesh.

* :func:`make_mesh` and :class:`ShardedSparseMatrix`: the all-gather,
  ring and halo SpMM schedules (:func:`dist_spmm`) over one axis.
* :func:`make_mesh2d`: a ``(data, feat)`` grid on which the same
  schedules run over the data axis, each feature group on its own
  columns of the dense operand.
* :func:`make_mesh_hier`, :class:`HierShardedSparseMatrix` and
  :func:`dist_spmm_hier`: the hierarchical (DCN x ICI) schedule, whose
  intra-slice halos stay on the fast fabric and whose cross-slice rows
  cross the slow one once per slice.
"""

from .mesh import (  # noqa
    Grid, Mesh, data_axis, dcn_axis, feat_axis, make_mesh, make_mesh2d,
    make_mesh_hier)
from .dist import (  # noqa
    ShardedSparseMatrix, dist_spmm, dist_spmm_allgather, dist_spmm_halo,
    dist_spmm_ring,
)
from .hier import HierShardedSparseMatrix, dist_spmm_hier  # noqa
