from .block_spgemm import (  # noqa
    block_spgemm_plan, block_spgemm_stream, block_spgemm_window,
    block_spgemm_window_plain, block_spgemm_windows,
)
from .block_spmm import (  # noqa
    block_spmm, block_spmm_dblocks, block_spmm_dblocks_plain, block_spmm_plain,
    block_spmm_t, block_spmm_t_plain,
)
from .csr_spmm import csr_spmm, csr_spmm_plain  # noqa
from .edge_dot import edge_dot, edge_dot_plain  # noqa
from .edge_softmax import (  # noqa
    edge_softmax, edge_softmax_bwd, edge_softmax_bwd_plain, edge_softmax_plain,
)
from .hybrid import (  # noqa
    DenseFormat, HybridFormat, build_dense, build_hybrid,
    build_hybrid_from_tensor, dense_spmm, dense_spmm_t, hybrid_spmm,
    hybrid_spmm_t,
)
from .plan_numeric import plan_numeric, plan_numeric_plain  # noqa
from .random_walk import random_walk, random_walk_plain  # noqa
from .shard_spmm import (  # noqa
    shard_spmm, shard_spmm_minmax, shard_spmm_minmax_plain, shard_spmm_plain,
)
from .smem_gather import (  # noqa
    TilePlan, edge_scan_loop, edge_scan_loop_plain, smem_gather,
    smem_gather_plain, tiled_spmm, tiled_spmm_plain, tiled_spmm_plan,
)
from .spmm_minmax import (  # noqa
    csr_spmm_minmax, csr_spmm_minmax_plain, minmax_edge_dot,
    minmax_edge_dot_plain, minmax_spmm_t, minmax_spmm_t_plain,
)
