"""The port's distributed SpMM (``pytorch_sparse_tpu_torch.parallel``)
against the JAX package on the same numpy inputs.

The port runs on 1, 3 and 4 gloo processes on the CPU (spawned once per
world size; the workers are in ``_torch_dist_workers.py``, which imports
no JAX), where every kernel runs its plain version.  Its gathered
results are held against:

* JAX's single-device ``matmul`` / ``spmm_min`` / ``spmm_max`` and
  ``jax.grad`` (cheap), for every schedule x reduce, forward and both
  gradients: 1e-5 of max |ref| for sums and gradients (summation order
  differs), ``out`` and ``arg`` exactly for min/max;
* JAX's host-side ``ShardedSparseMatrix.from_sparse_tensor`` for the
  structure (``Mb``, ``Nb``, ``H``, ``serve_idx``, ``rowcount`` and the
  interior-block and dense-frontier decisions), exactly;
* a few of JAX's ``shard_map`` programs (each compiles for seconds on
  the virtual 8-device CPU mesh): halo sum, ring max with its argout,
  and the hybrid local format.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.ops.kernels import hybrid as jhyb
from pytorch_sparse_tpu.parallel import dist as jdist
from pytorch_sparse_tpu.parallel import make_mesh as jmake_mesh
from pytorch_sparse_tpu_torch.ops.kernels import (
    shard_spmm, shard_spmm_minmax, shard_spmm_minmax_plain, shard_spmm_plain)
from pytorch_sparse_tpu_torch.testing import rel_err

import _torch_dist_workers as W

M, K, BLOCK_B, SEED = 118, 6, 8, 5
# 12 communities, 1,600 intra-community and 150 uniform draws, graph
# seed 3, every 7th row (r % 7 == 1) empty.
GRAPH = (12, 1600, 150, 3, 7)
WORLD_SIZES = (1, 3, 4)
ALL_CASES = [(s, f, r) for s, f in W.SCHEDULES for r in W.REDUCES
             if not (f == "hybrid" and r in ("min", "max"))]
JFN = {"min": jts.spmm_min, "max": jts.spmm_max}


@pytest.fixture(scope="module")
def port():
    """Rank 0's results of ``run_schedules`` by world size, each world
    size spawned once."""
    cache = {}

    def get(ws):
        if ws not in cache:
            cache[ws] = W.spawn(
                W.run_schedules, ws, "gloo",
                args=dict(M=M, K=K, graph=GRAPH, block_B=BLOCK_B, seed=SEED),
                threads=1)[0]
        return cache[ws]
    return get


def _jax_tensor(row, col, val):
    return jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                            col=jnp.asarray(col.astype(np.int32)),
                            value=jnp.asarray(val), sparse_sizes=(M, M))


@pytest.fixture(scope="module")
def graph():
    row, col, val = W.community_coo(M, *GRAPH)
    return row, col, val, _jax_tensor(row, col, val)


def jax_reference(A, x_np, v_np, gout_np, reduce):
    """JAX's single-device forward of ``A`` with values ``v_np`` on
    ``x_np``, and the gradients of ``<out, gout>`` in the values and
    ``x``: numpy ``out``, ``arg`` (None for sums), ``gx``, ``gv``."""
    def f(v, xx):
        a = A.set_value(v, layout="coo")
        if reduce in ("min", "max"):
            return JFN[reduce](a, xx)
        return jts.matmul(a, xx, reduce), None

    out, arg = f(jnp.asarray(v_np), jnp.asarray(x_np))
    gv, gx = jax.grad(lambda v, xx: (f(v, xx)[0] * gout_np).sum(),
                      argnums=(0, 1))(jnp.asarray(v_np), jnp.asarray(x_np))
    return {"out": np.asarray(out), "gx": np.asarray(gx),
            "gv": np.asarray(gv),
            "arg": None if arg is None else np.asarray(arg)}


@pytest.fixture(scope="module")
def oracle(graph):
    """JAX's single-device forward and gradients, by (operand, values,
    reduce)."""
    cache = {}

    def get(x_np, v_np, reduce):
        key = (x_np.tobytes(), v_np.tobytes(), reduce)
        if key not in cache:
            cache[key] = jax_reference(graph[3], x_np, v_np,
                                       W.operand(SEED + 1, M, K), reduce)
        return cache[key]
    return get


def check_case(got, ref, reduce, value_grad=True):
    if reduce in ("min", "max"):
        np.testing.assert_array_equal(got["arg"].numpy(), ref["arg"])
        np.testing.assert_array_equal(got["out"].numpy(), ref["out"])
    else:
        assert rel_err(got["out"], ref["out"]) <= 1e-5
    assert rel_err(got["gx"], ref["gx"]) <= 1e-5
    if value_grad:
        assert rel_err(got["gv"], ref["gv"]) <= 1e-5


@pytest.mark.parametrize("schedule,fmt,reduce", ALL_CASES,
                         ids=["-".join(c) for c in ALL_CASES])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_schedule_matches_jax_single_device(port, oracle, graph, ws,
                                            schedule, fmt, reduce):
    """Every schedule x reduce, forward and the ``x`` and ``value``
    gradients (the hybrid format bakes values: ``x`` only)."""
    val = graph[2]
    got = port(ws)[f"{schedule}-{fmt}-{reduce}"]
    ref = oracle(W.operand(SEED, M, K), val, reduce)
    check_case(got, ref, reduce, value_grad=fmt != "hybrid")
    if reduce in ("min", "max"):
        empty = np.bincount(graph[0], minlength=M) == 0
        assert empty.any()
        assert (got["arg"].numpy()[empty] == len(val)).all()
        assert (got["out"].numpy()[empty] == 0).all()


@pytest.mark.parametrize("schedule", ["allgather", "ring", "halo"])
@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_minmax_ties_go_to_the_lower_edge_id(port, oracle, graph, ws,
                                             schedule, reduce):
    """+-1 values and a small-integer operand: most rows tie across
    groups and ring steps; the argout still equals the single-device
    one (the first CSR edge)."""
    got = port(ws)[f"ties-{schedule}-{reduce}"]
    ref = oracle(W.tie_operand(SEED + 2, M, K), np.sign(graph[2]), reduce)
    check_case(got, ref, reduce)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_dense_frontier_matches_jax(port, oracle, graph, ws, reduce):
    got = port(ws)[f"frontier_dense-{reduce}"]
    check_case(got, oracle(W.operand(SEED, M, K), graph[2], reduce), reduce,
           value_grad=False)


def _jax_sharded(A, ws, **kw):
    return jdist.ShardedSparseMatrix.from_sparse_tensor(
        A, jmake_mesh(ws), block_B=BLOCK_B, **kw)


@pytest.mark.parametrize("frontier_dense", ["auto", "always"])
@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_structure_matches_jax(port, graph, ws, frontier_dense):
    got = port(ws)["structure" if frontier_dense == "auto"
                   else "frontier_dense_structure"]
    with warnings.catch_warnings():  # "always" unhonored at ws=1
        warnings.simplefilter("ignore")
        J = _jax_sharded(graph[3], ws, frontier_dense=frontier_dense)
    assert (got["Mb"], got["Nb"], got["H"]) == (J.Mb, J.Nb, J.halo_width)
    np.testing.assert_array_equal(got["serve"].numpy(),
                                  np.asarray(J.serve_idx))
    np.testing.assert_array_equal(got["rowcount"].numpy(),
                                  np.asarray(J.rowcount).reshape(-1))
    assert got["has_interior_blocks"] == J.has_interior_blocks()
    assert got["has_frontier_dense"] == J.has_frontier_dense()
    if ws > 1:  # the graph is built to exercise both
        assert got["has_interior_blocks"] and got["H"] > 1


@pytest.fixture(scope="module")
def shard_map_runs(graph, port):
    """JAX's own distributed programs at world size 4: halo sum, ring
    max with its argout, the hybrid halo sum (block precision HIGHEST,
    as the port's block kernel computes in full f32)."""
    J = _jax_sharded(graph[3], 4)
    xs = J.shard_dense(jnp.asarray(W.operand(SEED, M, K)))
    old = jhyb._BLOCK_PRECISION
    jhyb._BLOCK_PRECISION = jax.lax.Precision.HIGHEST
    try:
        out = {
            "halo-ell-sum": {"out": J.unshard_dense(
                jdist.dist_spmm(J, xs, "halo", "sum"))},
            "halo-hybrid-sum": {"out": J.unshard_dense(
                jdist.dist_spmm(J, xs, "halo", "sum", "hybrid"))},
        }
        o, a = jdist.dist_spmm(J, xs, "ring", "max")
        out["ring-ell-max"] = {"out": J.unshard_dense(o),
                               "arg": J.unshard_dense(a)}
    finally:
        jhyb._BLOCK_PRECISION = old
    return {k: {n: np.asarray(v) for n, v in d.items()}
            for k, d in out.items()}


@pytest.mark.parametrize("case", ["halo-ell-sum", "ring-ell-max",
                                  "halo-hybrid-sum"])
def test_matches_jax_shard_map(port, shard_map_runs, case):
    got, ref = port(4)[case], shard_map_runs[case]
    if "arg" in ref:
        np.testing.assert_array_equal(got["arg"].numpy(), ref["arg"])
        np.testing.assert_array_equal(got["out"].numpy(), ref["out"])
    else:
        assert rel_err(got["out"], ref["out"]) <= 1e-5


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_value_length_is_checked_reference_defect(port, graph, ws):
    """Reference defect (ROADMAP C.3): JAX's ``_vtabs_from_value`` takes
    an edge-space value of the wrong length without complaint (its
    gathers clamp); the port raises ``ValueError``."""
    J = _jax_sharded(graph[3], ws)
    tabs = jdist._vtabs_from_value(jnp.ones(J.nnz + 5), J.flat_etabs)
    assert all(t.shape == e.shape for t, e in zip(tabs, J.flat_etabs))
    assert port(ws)["value_length_raises"]


# ----------------------------------------------------------------------
# K11a/K11b (their plain versions on the CPU) against JAX's group
# functions on one group built by JAX's own table builder.
# ----------------------------------------------------------------------

def _group(seed, R, n_buf, E, n_rows):
    """A group of ``E`` edges over ``R`` distinct shard rows of
    ``n_rows``, in CSR order, with positions into a 3E-edge shard."""
    rng = np.random.RandomState(seed)
    rows = np.sort(rng.choice(n_rows, R, replace=False))
    r = np.sort(rng.choice(rows, E))
    c = rng.randint(0, n_buf, E)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    v = rng.randn(E).astype(np.float32)
    pos = np.sort(rng.choice(3 * E, E, replace=False))
    return r, c, v, pos


def _port_group(r, c, v, pos, n_rows, compact):
    if compact:
        keep, counts = np.unique(r, return_counts=True)
        rowptr, row_map = np.concatenate([[0], np.cumsum(counts)]), keep
    else:
        rowptr, row_map = np.searchsorted(r, np.arange(n_rows + 1)), None
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32))
    return (t(rowptr), t(c), torch.from_numpy(v), t(pos), t(row_map))


def _jax_tables(r, c, v, pos, n_rows, n_buf, e0, nnz):
    itabs, vtabs, etabs, inv, _ = jdist._build_group_ell(
        [(r, c, v, pos + e0)], n_rows, sentinel=n_buf, E_total=nnz)
    return ([t[0] for t in itabs], [t[0] for t in vtabs],
            [t[0] for t in etabs], inv[0])


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("accumulate", [False, True])
def test_shard_spmm_matches_jax_group_apply(compact, accumulate):
    n_rows, n_buf, Kx = 40, 55, 12
    r, c, v, pos = _group(31, 25, n_buf, 300, n_rows)
    rowptr, col, val, _, row_map = _port_group(r, c, v, pos, n_rows,
                                               compact)
    buf = W.operand(32, n_buf, Kx)
    base = W.operand(33, n_rows, Kx)
    it, vt, _, inv = _jax_tables(r, c, v, pos, n_rows, n_buf, 0, 900)
    ref = np.asarray(jdist._group_ell_apply(it, vt, inv, jnp.asarray(buf)))
    if accumulate:
        ref = base + ref
    out = torch.from_numpy(base.copy()) if accumulate else None
    got = shard_spmm(rowptr, col, val, torch.from_numpy(buf), out=out,
                     row_map=row_map, n_rows=n_rows)
    assert got.shape == (n_rows, Kx)
    assert rel_err(got, ref) <= 1e-5
    if accumulate:
        assert got.data_ptr() == out.data_ptr()  # in place


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("combine", [False, True])
def test_shard_spmm_minmax_matches_jax_group_minmax(is_min, compact,
                                                    combine):
    """The group's extreme with its global argout, written (rows with no
    edge: JAX's pad) or combined by ``_combine_minmax`` into a running
    pair that ties it on purpose."""
    n_rows, n_buf, Kx, e0, nnz = 40, 55, 12, 1000, 5000
    r, c, v, pos = _group(41, 25, n_buf, 300, n_rows)
    v = np.sign(v)
    rowptr, col, val, ppos, row_map = _port_group(r, c, v, pos, n_rows,
                                                  compact)
    buf = W.tie_operand(42, n_buf, Kx)
    it, vt, et, inv = _jax_tables(r, c, v, pos, n_rows, n_buf, e0, nnz)
    ext, arg = jdist._group_ell_minmax(it, vt, et, inv, jnp.asarray(buf),
                                       is_min)
    run_out = W.tie_operand(43, n_rows, Kx)
    run_arg = np.random.RandomState(44).randint(
        e0, e0 + 900, (n_rows, Kx)).astype(np.int32)
    if combine:
        ext, arg = jdist._combine_minmax(
            (jnp.asarray(run_out), jnp.asarray(run_arg)), (ext, arg), is_min)
        out, a = torch.from_numpy(run_out.copy()), torch.from_numpy(
            run_arg.copy())
    else:
        out = a = None
    got, got_arg = shard_spmm_minmax(
        rowptr, col, val, torch.from_numpy(buf), is_min, e0, pos=ppos,
        out=out, arg=a, row_map=row_map, n_rows=n_rows)
    np.testing.assert_array_equal(got_arg.numpy(), np.asarray(arg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ext))


def test_shard_wrappers_take_the_plain_version_on_cpu():
    rowptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    col = torch.tensor([0, 1, 1], dtype=torch.int32)
    buf = torch.arange(6, dtype=torch.float32).view(2, 3)
    torch.testing.assert_close(shard_spmm(rowptr, col, None, buf),
                               shard_spmm_plain(rowptr, col, None, buf))
    for got, ref in zip(
            shard_spmm_minmax(rowptr, col, None, buf, False, 7),
            shard_spmm_minmax_plain(rowptr, col, None, buf, False, 7)):
        torch.testing.assert_close(got, ref)
    with pytest.raises(NotImplementedError):
        shard_spmm(rowptr.to("meta"), col.to("meta"), None, buf.to("meta"))


@pytest.mark.parametrize("bad", [None, 1])
def test_spawn_returns_every_rank_or_raises(bad):
    """Every rank's result comes back in rank order; a rank that raises
    fails the launch with its traceback."""
    if bad is None:
        assert W.spawn(W.rank_or_raise, 3, "gloo", args=dict(bad=None),
                       timeout=120, threads=1) == [(0, 3), (1, 3), (2, 3)]
        return
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        W.spawn(W.rank_or_raise, 3, "gloo", args=dict(bad=bad), timeout=120,
                threads=1)


# ----------------------------------------------------------------------
# The halo backward where a row is served to several peers
# ----------------------------------------------------------------------

SERVED = dict(M=240, K=5, E=3000, seed=23)


def served_peers(row, col, M, P, C=None):
    """The most peers one row is served to: on the flat layout (``C``
    None) the row blocks other than its own that read it; on a
    hierarchical ``(P // C, C)`` grid the most over its two fabrics (the
    other chips of its slice that read it, and the other slices)."""
    Mb = -(-M // P)
    owner, block = row // Mb, col // Mb
    far = owner != block
    if C is None:
        pairs = np.unique(col[far] * P + owner[far])
        return int(np.bincount(pairs // P).max(initial=0))
    ici = far & (owner // C == block // C)
    dcn = owner // C != block // C
    most = 0
    for m, peer in ((ici, owner % C), (dcn, owner // C)):
        pairs = np.unique(col[m] * P + peer[m])
        most = max(most, int(np.bincount(pairs // P).max(initial=0)))
    return most


def jax_x_grad(row, col, val, M, x_np, gout_np):
    """``jax.grad`` of ``<A @ x, gout>`` in ``x`` on one device."""
    A = jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                         col=jnp.asarray(col.astype(np.int32)),
                         value=jnp.asarray(val), sparse_sizes=(M, M))
    return np.asarray(jax.grad(
        lambda xx: (jts.matmul(A, xx) * gout_np).sum())(jnp.asarray(x_np)))


@pytest.mark.parametrize("ws", [3, 4])
def test_halo_backward_sums_rows_served_to_several_peers(ws):
    """Every row is served to two or more peers; the gradients that come
    back for a row are summed in a fixed order and added once: the
    gathered gradient of ``x`` matches JAX's to 1e-5, twice alike."""
    M, K, E, seed = (SERVED[k] for k in ("M", "K", "E", "seed"))
    row, col, val = W.uniform_coo(M, E, seed)
    assert served_peers(row, col, M, ws) >= 2
    got = W.spawn(W.run_served_backward, ws, "gloo",
                  args=dict(SERVED, runs=2), threads=1)[0]
    ref = jax_x_grad(row, col, val, M, W.operand(seed + 1, M, K),
                     W.operand(seed + 2, M, K))
    assert torch.equal(got[0], got[1])
    assert rel_err(got[0], ref) <= 1e-5
