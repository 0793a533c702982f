"""The port's row schedules on a 2-D ``(data, feat)`` grid
(``pytorch_sparse_tpu_torch.parallel.make_mesh2d``) against the JAX
package on the same numpy inputs.

The port runs on ``(P, Pf)`` grids of 4 and 3 gloo processes on the CPU,
(2, 2) and (1, 3), each spawned once (workers in
``_torch_dist_workers.py``, which imports no JAX): each feature rank
runs the all-gather, ring and halo schedules over its data sub-mesh on
its ``K/Pf`` columns.  Its gathered results are held against JAX's
single-device ``matmul`` / ``spmm_min`` / ``spmm_max`` and ``jax.grad``
for every schedule x reduce, forward and both gradients (1e-5 of max
|ref| for sums and gradients, ``out`` and ``arg`` exactly for min/max);
its structure against JAX's host-side ``from_sparse_tensor`` on
``make_mesh2d``; its halo sum against JAX's own 2-D ``dist_spmm``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.parallel import dist as jdist
from pytorch_sparse_tpu.parallel import make_mesh2d as jmake_mesh2d
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W
from test_torch_dist import check_case, jax_reference

M, K, BLOCK_B, SEED = 118, 6, 8, 5
GRAPH = (12, 1600, 150, 3, 7)
GRIDS = [(2, 2), (1, 3)]
GRID_IDS = [f"P{p}F{f}" for p, f in GRIDS]
ALL_CASES = [(s, f, r) for s, f in W.SCHEDULES for r in W.REDUCES
             if not (f == "hybrid" and r in ("min", "max"))]


@pytest.fixture(scope="module")
def graph():
    row, col, val = W.community_coo(M, *GRAPH)
    A = jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                         col=jnp.asarray(col.astype(np.int32)),
                         value=jnp.asarray(val), sparse_sizes=(M, M))
    return row, col, val, A


@pytest.fixture(scope="module")
def port():
    """Rank 0's results of ``run_2d`` by grid, each grid spawned once."""
    cache = {}

    def get(grid):
        if grid not in cache:
            cache[grid] = W.spawn(
                W.run_2d, grid[0] * grid[1], "gloo",
                args=dict(P=grid[0], Pf=grid[1], M=M, K=K, graph=GRAPH,
                          block_B=BLOCK_B, seed=SEED), threads=1)[0]
        return cache[grid]
    return get


@pytest.fixture(scope="module")
def oracle(graph):
    cache = {}

    def get(reduce):
        if reduce not in cache:
            cache[reduce] = jax_reference(graph[3], W.operand(SEED, M, K),
                                          graph[2], W.operand(SEED + 1, M, K),
                                          reduce)
        return cache[reduce]
    return get


@pytest.mark.parametrize("schedule,fmt,reduce", ALL_CASES,
                         ids=["-".join(c) for c in ALL_CASES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_2d_schedule_matches_jax_single_device(port, oracle, grid, schedule,
                                               fmt, reduce):
    """Every schedule x reduce on the feature-sharded operand: the
    gathered ``(M, K)`` result, the ``x`` gradient and (but for the
    hybrid, which bakes values) the ``value`` gradient all-reduced over
    the whole grid."""
    res = port(grid)
    assert res["Pf"] == grid[1] and res["x_cols"] == K // grid[1]
    check_case(res[f"{schedule}-{fmt}-{reduce}"], oracle(reduce), reduce,
               value_grad=fmt != "hybrid")


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_2d_shard_dense_requires_divisible_k(port, grid):
    """As JAX's ``shard_dense``: ``K % Pf != 0`` raises a ``ValueError``
    that says "divisible"."""
    assert port(grid)["indivisible_raises"]
    J = jdist.ShardedSparseMatrix.from_sparse_tensor(
        jts.SparseTensor(row=jnp.array([0, 1]), col=jnp.array([1, 0]),
                         sparse_sizes=(2, 2)),
        jmake_mesh2d(*grid))
    with pytest.raises(ValueError, match="divisible"):
        J.shard_dense(jnp.zeros((2, 2 * grid[1] + 1)))


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_2d_structure_matches_jax(port, graph, grid):
    """The data axis sets ``P``: the halo width, served rows, row counts
    and the block and frontier decisions are JAX's on the same grid."""
    got = port(grid)["structure"]
    J = jdist.ShardedSparseMatrix.from_sparse_tensor(
        graph[3], jmake_mesh2d(*grid), block_B=BLOCK_B)
    assert (J.P, J.Pf) == grid
    assert (got["Mb"], got["Nb"], got["H"]) == (J.Mb, J.Nb, J.halo_width)
    np.testing.assert_array_equal(got["serve"].numpy(),
                                  np.asarray(J.serve_idx))
    np.testing.assert_array_equal(got["rowcount"].numpy(),
                                  np.asarray(J.rowcount).reshape(-1))
    assert got["has_interior_blocks"] == J.has_interior_blocks()
    assert got["has_frontier_dense"] == J.has_frontier_dense()


def test_2d_halo_matches_jax_shard_map(port, graph):
    """JAX's own halo sum on the (2, 2) grid."""
    J = jdist.ShardedSparseMatrix.from_sparse_tensor(
        graph[3], jmake_mesh2d(2, 2), block_B=BLOCK_B)
    xs = J.shard_dense(jnp.asarray(W.operand(SEED, M, K)))
    ref = np.asarray(J.unshard_dense(jdist.dist_spmm(J, xs, "halo", "sum")))
    assert rel_err(port((2, 2))["halo-ell-sum"]["out"], ref) <= 1e-5
