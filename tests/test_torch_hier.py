"""The port's hierarchical (DCN x ICI) schedule
(``pytorch_sparse_tpu_torch.parallel.hier``) and ``DistGCN`` on it,
against the JAX package on the same numpy inputs.

The port runs on ``(S, C)`` grids of 1, 4 and 3 gloo processes on the
CPU, (1, 1), (2, 2), (3, 1) and (1, 3), each spawned once (workers in
``_torch_dist_workers.py``, which imports no JAX), where every kernel
runs its plain version.  Its gathered results are held against:

* JAX's single-device ``matmul`` / ``spmm_min`` / ``spmm_max`` and
  ``jax.grad``, for every reduce x {ell, auto}, forward and both
  gradients: 1e-5 of max |ref| for sums and gradients (summation order
  differs), ``out`` and ``arg`` exactly for min/max;
* JAX's host-side ``HierShardedSparseMatrix.from_sparse_tensor`` on
  ``make_mesh_hier(S, C)`` for the structure: ``Hi``, ``Hx``, the served
  rows of both fabrics, every frontier edge's buffer row, ``rowcount``,
  the wire statistics and report, and the interior-block and per-tier
  dense-frontier decisions, exactly;
* JAX's own ``dist_spmm_hier`` at (2, 2): sum, max with its argout, and
  the hybrid sum;
* for ``DistGCN``, one Adam step against JAX's single-device GCN with
  ``optax.adam`` and once against JAX's ``DistGCN.train_step`` on the
  hierarchical layout.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models.dist_gcn import DistGCN as JDistGCN
from pytorch_sparse_tpu.ops.kernels import hybrid as jhyb
from pytorch_sparse_tpu.parallel import hier as jhier
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W
from test_torch_dist import (
    SERVED, check_case, jax_reference, jax_x_grad, served_peers)

M, K, BLOCK_B, SEED = 118, 6, 8, 5
GRAPH = (12, 1600, 150, 3, 7)
GRIDS = [(1, 1), (2, 2), (3, 1), (1, 3)]
GRID_IDS = [f"S{s}C{c}" for s, c in GRIDS]
CASES = [(f, r) for f in W.HIER_FORMATS for r in W.REDUCES]
# DistGCN: widths in, hidden, out, layers; the graph without empty rows.
GCN_WIDTHS, GCN_GRAPH, GCN_SEED, LR = (8, 16, 4, 3), (12, 1600, 150, 3, 0), \
    11, 1e-2
GCN_SCHEDULES = [("hier", "ell"), (None, "auto")]


def _jax_tensor(row, col, val):
    return jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                            col=jnp.asarray(col.astype(np.int32)),
                            value=jnp.asarray(val), sparse_sizes=(M, M))


@pytest.fixture(scope="module")
def graph():
    row, col, val = W.community_coo(M, *GRAPH)
    return row, col, val, _jax_tensor(row, col, val)


@pytest.fixture(scope="module")
def port():
    """Every rank's results of ``run_hier`` by grid, each grid spawned
    once."""
    cache = {}

    def get(grid):
        if grid not in cache:
            cache[grid] = W.spawn(
                W.run_hier, grid[0] * grid[1], "gloo",
                args=dict(S=grid[0], C=grid[1], M=M, K=K, graph=GRAPH,
                          block_B=BLOCK_B, seed=SEED), threads=1)
        return cache[grid]
    return get


@pytest.fixture(scope="module")
def oracle(graph):
    cache = {}

    def get(x_np, v_np, reduce):
        key = (x_np.tobytes(), v_np.tobytes(), reduce)
        if key not in cache:
            cache[key] = jax_reference(graph[3], x_np, v_np,
                                       W.operand(SEED + 1, M, K), reduce)
        return cache[key]
    return get


@pytest.mark.parametrize("fmt,reduce", CASES,
                         ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hier_matches_jax_single_device(port, oracle, graph, grid, fmt,
                                        reduce):
    """Every reduce on the group format ("ell", with the ``value``
    gradient) and on "auto" (the interior blocks for sum and mean, the
    groups for min and max; ``x`` gradient only)."""
    got = port(grid)[0][f"hier-{fmt}-{reduce}"]
    ref = oracle(W.operand(SEED, M, K), graph[2], reduce)
    check_case(got, ref, reduce, value_grad=fmt == "ell")
    if reduce in ("min", "max"):
        empty = np.bincount(graph[0], minlength=M) == 0
        assert empty.any()
        assert (got["arg"].numpy()[empty] == len(graph[2])).all()
        assert (got["out"].numpy()[empty] == 0).all()


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hier_minmax_ties_go_to_the_lower_edge_id(port, oracle, graph, grid,
                                                  reduce):
    """+-1 values and a small-integer operand: rows tie across the
    interior, intra-slice and cross-slice groups; the argout is still the
    first CSR edge."""
    got = port(grid)[0][f"ties-{reduce}"]
    ref = oracle(W.tie_operand(SEED + 2, M, K), np.sign(graph[2]), reduce)
    check_case(got, ref, reduce)


def _jax_hier(A, grid, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jhier.HierShardedSparseMatrix.from_sparse_tensor(
            A, jhier.make_mesh_hier(*grid), block_B=BLOCK_B, **kw)


def _jax_buffer_rows(J, itabs, etabs, p):
    """Shard ``p``'s ``{edge id: buffer row}`` from JAX's group tables
    (padding slots carry the edge id ``nnz``)."""
    eid = np.concatenate([np.asarray(e)[p].ravel() for e in etabs])
    buf = np.concatenate([np.asarray(t)[p].ravel() for t in itabs])
    real = eid < J.nnz
    return dict(zip(eid[real].tolist(), buf[real].tolist()))


@pytest.mark.parametrize("frontier_dense", ["auto", "never"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hier_structure_matches_jax(port, graph, grid, frontier_dense):
    ranks = port(grid)
    got = ranks[0][f"{'' if frontier_dense == 'auto' else 'never_'}"
                   "structure"]
    J = _jax_hier(graph[3], grid, frontier_dense=frontier_dense)
    assert (got["Mb"], got["Nb"], got["Hi"], got["Hx"]) == (
        J.Mb, J.Nb, J.Hi, J.Hx)
    np.testing.assert_array_equal(got["serve_ici"].numpy(),
                                  np.asarray(J.serve_ici))
    np.testing.assert_array_equal(got["serve_dcn"].numpy(),
                                  np.asarray(J.serve_dcn))
    np.testing.assert_array_equal(got["rowcount"].numpy(),
                                  np.asarray(J.rowcount).reshape(-1))
    assert got["wire_stats"] == J.wire_stats
    assert got["wire_report"] == J.wire_report(K=8)
    assert got["has_interior_blocks"] == J.has_interior_blocks()
    assert got["fi_dense"] == (J.fi_dense is not None)
    assert got["fx_dense"] == (J.fx_dense is not None)
    if frontier_dense == "auto":
        # Every frontier edge reads the buffer row JAX's tables give it.
        for p, r in enumerate(ranks):
            for (eids, rows), (itabs, etabs) in zip(
                    r["structure"]["edges"],
                    [(J.fi_itabs, J.fi_etabs), (J.fx_itabs, J.fx_etabs)]):
                assert dict(zip(eids.tolist(), rows.tolist())) == \
                    _jax_buffer_rows(J, itabs, etabs, p)
    if grid == (2, 2):
        # Both fabrics carry traffic, padded slots travel (so real rows
        # of x ride in them), the blocks are built, and "auto" builds both
        # dense frontier tiers at this size.
        w = got["wire_stats"]
        assert w["ici_rows"] and w["dcn_rows_hier"]
        assert w["ici_rows"] < grid[0] * grid[1] * grid[1] * got["Hi"]
        assert w["dcn_rows_hier"] < w["dcn_row_slots"]
        assert got["has_interior_blocks"]
        assert (got["fi_dense"] and got["fx_dense"]) == (
            frontier_dense == "auto")


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hier_hybrid_with_frontier_groups_matches_jax(port, oracle, graph,
                                                      grid, reduce):
    """``frontier_dense="never"``: the interior blocks with both frontier
    tiers on their groups ("auto" takes the dense tiers at this size)."""
    check_case(port(grid)[0][f"never-{reduce}"],
               oracle(W.operand(SEED, M, K), graph[2], reduce), reduce,
               value_grad=False)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_hier_hybrid_refuses_minmax(port, grid):
    assert port(grid)[0]["hybrid_max_raises"]


@pytest.fixture(scope="module")
def shard_map_runs(graph):
    """JAX's own ``dist_spmm_hier`` at (2, 2): sum, max with its argout,
    the hybrid sum (block precision HIGHEST, as the port's block kernel
    computes in full f32)."""
    J = _jax_hier(graph[3], (2, 2))
    xs = J.shard_dense(jnp.asarray(W.operand(SEED, M, K)))
    old = jhyb._BLOCK_PRECISION
    jhyb._BLOCK_PRECISION = jax.lax.Precision.HIGHEST
    try:
        # jit-compiled programs compile faster than eager shard_map calls.
        def run(*args):
            return jax.jit(lambda a, x: jhier.dist_spmm_hier(a, x, *args))(
                J, xs)

        out = {"hier-ell-sum": {"out": J.unshard_dense(run("sum"))},
               "hier-auto-sum": {"out": J.unshard_dense(
                   run("sum", "hybrid"))}}
        o, a = run("max")
        out["hier-ell-max"] = {"out": J.unshard_dense(o),
                               "arg": J.unshard_dense(a)}
    finally:
        jhyb._BLOCK_PRECISION = old
    return {k: {n: np.asarray(v) for n, v in d.items()}
            for k, d in out.items()}


@pytest.mark.parametrize("case", ["hier-ell-sum", "hier-ell-max",
                                  "hier-auto-sum"])
def test_hier_matches_jax_shard_map(port, shard_map_runs, case):
    got, ref = port((2, 2))[0][case], shard_map_runs[case]
    if "arg" in ref:
        np.testing.assert_array_equal(got["arg"].numpy(), ref["arg"])
        np.testing.assert_array_equal(got["out"].numpy(), ref["out"])
    else:
        assert rel_err(got["out"], ref["out"]) <= 1e-5


# ----------------------------------------------------------------------
# DistGCN on the hierarchical layout
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gcn_params():
    p = JGCN.init(jax.random.PRNGKey(3), GCN_WIDTHS[0], GCN_WIDTHS[1],
                  GCN_WIDTHS[2], num_layers=GCN_WIDTHS[3])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def gcn_inputs():
    row, col, _ = W.community_coo(M, *GCN_GRAPH)
    row, col, val = W.gcn_norm_coo(row, col, M)
    x = W.operand(GCN_SEED, M, GCN_WIDTHS[0])
    rng = np.random.RandomState(GCN_SEED + 1)
    labels = rng.randint(0, GCN_WIDTHS[2], M)
    mask = (rng.rand(M) < 0.6).astype(np.float32)
    return _jax_tensor(row, col, val), x, labels, mask


@pytest.fixture(scope="module")
def gcn_port(gcn_params):
    cache = {}
    layers = [(torch.from_numpy(np.array(layer["w"])),
               torch.from_numpy(np.array(layer["b"])))
              for layer in gcn_params["layers"]]

    def get(grid):
        if grid not in cache:
            cache[grid] = W.spawn(
                W.run_dist_gcn, grid[0] * grid[1], "gloo",
                args=dict(M=M, graph=GCN_GRAPH, layers=layers,
                          n_classes=GCN_WIDTHS[2], seed=GCN_SEED,
                          schedules=GCN_SCHEDULES, lr=LR, hier=grid),
                threads=1)
        return cache[grid]
    return get


def _flat(tree):
    """JAX's per-layer ``(w, b)`` in the port's parameter order."""
    layers = tree["layers"]
    return ([np.asarray(layer["w"]) for layer in layers]
            + [np.asarray(layer["b"]) for layer in layers])


@pytest.fixture(scope="module")
def gcn_reference(gcn_params, gcn_inputs):
    A, x, labels, mask = gcn_inputs
    params = jax.tree_util.tree_map(jnp.asarray, gcn_params)
    loss, grads = jax.value_and_grad(JGCN.loss)(
        params, A, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask))
    opt = optax.adam(LR)
    updates, _ = opt.update(grads, opt.init(params), params)
    new = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    return float(loss), _flat(grads), _flat(new)


@pytest.mark.parametrize("schedule,fmt", GCN_SCHEDULES,
                         ids=[f"{s}-{f}" for s, f in GCN_SCHEDULES])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn_hier_step_matches_jax_gcn(gcn_port, gcn_reference, grid,
                                            schedule, fmt):
    got = gcn_port(grid)[0][f"{schedule or 'default'}-{fmt}"]
    loss, grads, params = gcn_reference
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    for g, r in zip(got["grads"], grads):
        assert rel_err(g, r) <= 1e-5
    for p, r in zip(got["params"], params):
        assert rel_err(p, r) <= 1e-5


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_dist_gcn_hier_parameters_identical_on_every_rank(gcn_port, grid):
    res = gcn_port(grid)
    for key in [f"{s or 'default'}-{f}" for s, f in GCN_SCHEDULES]:
        for rank in range(1, len(res)):
            for p, q in zip(res[0][key]["params"], res[rank][key]["params"]):
                assert torch.equal(p, q)
            assert torch.equal(res[0][key]["loss"], res[rank][key]["loss"])


def test_dist_gcn_hier_step_matches_jax_dist_gcn(gcn_port, gcn_params,
                                                 gcn_inputs):
    """JAX's own ``DistGCN.train_step`` (``optax.adam``, local format
    "auto", block precision HIGHEST) on the (2, 2) hierarchical layout
    against the port's."""
    A, x, labels, mask = gcn_inputs
    J = jhier.HierShardedSparseMatrix.from_sparse_tensor(
        A, jhier.make_mesh_hier(2, 2), block_B=8)
    pad = J.P * J.Nb - M

    def stack(a):
        return jnp.asarray(np.concatenate(
            [a, np.zeros((pad,) + a.shape[1:], a.dtype)]).reshape(
                J.P, J.Nb, *a.shape[1:]))

    params = jax.tree_util.tree_map(jnp.asarray, gcn_params)
    opt = optax.adam(LR)
    old = jhyb._BLOCK_PRECISION
    jhyb._BLOCK_PRECISION = jax.lax.Precision.HIGHEST
    try:
        # One jit-compiled program: eager shard_map calls under grad
        # compile one by one, for most of a minute.
        step = jax.jit(lambda p, s, adj, xs, ls, ms: JDistGCN.train_step(
            p, s, adj, xs, ls, ms, opt, "hier"))
        new, _, loss = step(params, opt.init(params), J,
                            J.shard_dense(jnp.asarray(x)), stack(labels),
                            stack(mask))
    finally:
        jhyb._BLOCK_PRECISION = old
    got = gcn_port((2, 2))[0]["default-auto"]
    assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    for p, r in zip(got["params"], _flat(new)):
        assert rel_err(p, r) <= 1e-5


@pytest.mark.parametrize("grid", [(1, 3), (3, 1), (1, 4), (4, 1)],
                         ids=["1x3", "3x1", "1x4", "4x1"])
def test_hier_backward_sums_rows_served_to_several_peers(grid):
    """On one fabric (ICI on a (1, C) grid, DCN on an (S, 1) one) a row
    is served to two or more peers; its returned gradients are summed in
    a fixed order and added once: the gathered gradient of ``x`` matches
    JAX's to 1e-5, twice alike."""
    M, K, E, seed = (SERVED[k] for k in ("M", "K", "E", "seed"))
    row, col, val = W.uniform_coo(M, E, seed)
    assert served_peers(row, col, M, grid[0] * grid[1], grid[1]) >= 2
    got = W.spawn(W.run_served_backward, grid[0] * grid[1], "gloo",
                  args=dict(SERVED, grid=grid, runs=2), threads=1)[0]
    ref = jax_x_grad(row, col, val, M, W.operand(seed + 1, M, K),
                     W.operand(seed + 2, M, K))
    assert torch.equal(got[0], got[1])
    assert rel_err(got[0], ref) <= 1e-5
