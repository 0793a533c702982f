"""The port's routed SpMM forward against the JAX package on the same
numpy inputs (CPU, where each kernel runs its plain version), plus the
kernels' plain versions against host oracles.

Tolerances (max |diff| / max |ref|): 1e-5 for float32 (summation order
and FMA contraction differ), 1e-4 for bf16 block/dense stores (JAX
splits the f32 operand into bf16 terms, the port multiplies it
exactly), 1e-2 for float16/bfloat16 operands (the output is rounded to
the operand's dtype).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.ops.kernels import hybrid as jhyb
from pytorch_sparse_tpu.ops.matmul import spmm as jspmm
from pytorch_sparse_tpu.testing import community_graph as jcommunity
from pytorch_sparse_tpu_torch.ops.kernels import block_spmm, csr_spmm
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.ops.matmul import spmm as pspmm
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.testing import rel_err


def _pair(row, col, val, sizes):
    A = jts.SparseTensor(row=row, col=col,
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=sizes)
    B = pts.SparseTensor(row=row, col=col,
                         value=None if val is None else torch.from_numpy(val),
                         sparse_sizes=sizes, device="cpu")
    return A, B


def _graph(seed, M, N, E, values=True, empty_rows=False):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M // 2 if empty_rows else M, E)
    col = rng.randint(0, N, E)
    val = rng.randn(E).astype(np.float32) if values else None
    return _pair(row, col, val, (M, N))


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(A, B, x, reduce="sum", dtype=None):
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    if dtype is not None:
        xj, xp = xj.astype(getattr(jnp, dtype)), xp.to(getattr(torch, dtype))
    out_j = np.asarray(jspmm(A, xj, reduce).astype(jnp.float32))
    out_p = pspmm(B, xp, reduce)
    assert out_p.dtype == xp.dtype
    return out_j, out_p.float().numpy()


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 40, 128])
def test_csr_route_matches_jax(K, values, reduce):
    A, B = _graph(0, 60, 50, 500, values=values)
    out_j, out_p = _both(A, B, _x(1, 50, K), reduce)
    assert not B.storage.has_hybrid()
    assert rel_err(out_p, out_j) <= 1e-5


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_csr_route_empty_rows(reduce):
    A, B = _graph(2, 40, 30, 200, empty_rows=True)
    out_j, out_p = _both(A, B, _x(3, 30, 40), reduce)
    assert np.all(out_p[20:] == 0)
    assert rel_err(out_p, out_j) <= 1e-5


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_csr_route_batched_operand(reduce):
    A, B = _graph(4, 35, 25, 150)
    out_j, out_p = _both(A, B, _x(5, 3, 25, 12), reduce)
    assert out_p.shape == (3, 35, 12)
    assert rel_err(out_p, out_j) <= 1e-5


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_operands_compute_in_f32(dtype):
    A, B = _graph(6, 50, 45, 400)
    out_j, out_p = _both(A, B, _x(7, 45, 40), "sum", dtype)
    assert rel_err(out_p, out_j) <= 1e-2
    # Against the exact f32 product the only error is the final rounding.
    exact = pspmm(B, torch.from_numpy(_x(7, 45, 40)).to(
        getattr(torch, dtype)).float())
    assert rel_err(out_p, exact) <= 1e-2


def _hybrid_pair(store, B_blk, reduce, x_seed):
    rng = np.random.RandomState(8)
    M, N, E = 120, 100, 3000
    row = rng.randint(0, M, E)
    col = rng.randint(0, N, E)
    col[: E // 2] = row[: E // 2] % N  # a dense band: blocks densify
    val = rng.randn(E).astype(np.float32)
    A, B = _pair(row, col, val, (M, N))
    A, B = A.coalesce(), B.coalesce()
    r = A.storage.numpy_view("row")
    c = A.storage.numpy_view("col")
    v = np.asarray(A.storage.value())
    jdt = None if store == "float32" else jnp.bfloat16
    pdt = None if store == "float32" else torch.bfloat16
    hj = jhyb.build_hybrid(r, c, v, M, N, B=B_blk, min_density=0.05,
                           block_dtype=jdt)
    hp = phyb.build_hybrid(r, c, v, M, N, B=B_blk, min_density=0.05,
                           block_dtype=pdt, device="cpu")
    A.storage.set_hybrid_(hj)
    B.storage.set_hybrid_(hp)
    return A, B, hj, hp


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("B_blk", [16, 32])
@pytest.mark.parametrize("store,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-4)])
def test_hybrid_route_matches_jax(store, tol, B_blk, reduce):
    A, B, hj, hp = _hybrid_pair(store, B_blk, reduce, 9)
    assert 0 < hp.dense_nnz < B.nnz() and hp.rest is not None
    assert hp.dense_nnz == hj.dense_nnz and hp.nb == hj.nb
    np.testing.assert_array_equal(hp.slot_row.numpy(),
                                  np.asarray(hj.slot_row))
    np.testing.assert_array_equal(hp.slot_col.numpy(),
                                  np.asarray(hj.slot_col))
    np.testing.assert_array_equal(
        hp.blocks.float().numpy(), np.asarray(hj.blocks.astype(jnp.float32)))
    out_j, out_p = _both(A, B, _x(9, 100, 24), reduce)
    assert B.storage.hybrid(auto=False) is hp
    assert rel_err(out_p, out_j) <= tol


@pytest.mark.parametrize("store,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-4)])
def test_dense_route_matches_jax(store, tol):
    A, B = _graph(10, 70, 60, 1500)
    A, B = A.coalesce(), B.coalesce()
    r = A.storage.numpy_view("row")
    c = A.storage.numpy_view("col")
    v = np.asarray(A.storage.value())
    A.storage.set_hybrid_(jhyb.build_dense(
        r, c, v, 70, 60, dtype=None if store == "float32" else jnp.bfloat16))
    B.storage.set_hybrid_(phyb.build_dense(
        r, c, v, 70, 60, device="cpu",
        dtype=None if store == "float32" else torch.bfloat16))
    out_j, out_p = _both(A, B, _x(11, 60, 33), "sum")
    assert rel_err(out_p, out_j) <= tol


ROUTER_GRAPHS = {
    # uniform: no block clears the break-even -> CSR kernel
    "uniform": lambda pkg: _uniform(pkg, 20_000, 220_000),
    # overall density past the break-even -> whole-matrix dense store
    "dense community": lambda pkg: _community(pkg, 2_048, 300_000, 8),
    # sparse overall, dense communities -> block hybrid
    "sparse community": lambda pkg: _community(pkg, 8_192, 300_000, 8),
}


def _uniform(pkg, M, E):
    rng = np.random.RandomState(12)
    row, col = rng.randint(0, M, E), rng.randint(0, M, E)
    val = rng.randn(E).astype(np.float32)
    if pkg == "jax":
        return jts.SparseTensor(row=row, col=col, value=jnp.asarray(val),
                                sparse_sizes=(M, M))
    return pts.SparseTensor(row=row, col=col, value=torch.from_numpy(val),
                            sparse_sizes=(M, M), device="cpu")


def _community(pkg, M, E, n_comm):
    if pkg == "jax":
        return jcommunity(M, E, n_comm=n_comm, seed=1, equal_sizes=True)
    return pcommunity(M, E, n_comm=n_comm, seed=1, equal_sizes=True,
                      device="cpu")


@pytest.mark.parametrize("graph,budget,route", [
    ("uniform", 0.0, None),
    ("uniform", 2e-3, None),
    ("dense community", 0.0, "DenseFormat"),
    ("dense community", 2e-3, "DenseFormat"),
    ("sparse community", 0.0, "HybridFormat"),
    # a bf16 store halves the block cost, so the whole matrix densifies
    ("sparse community", 2e-3, "DenseFormat"),
])
def test_router_agrees_with_jax(graph, budget, route):
    A = ROUTER_GRAPHS[graph]("jax")
    B = ROUTER_GRAPHS[graph]("torch")
    assert A.nnz() == B.nnz() >= 200_000
    jhyb.set_store_budget(budget)
    phyb.set_store_budget(budget)
    try:
        hj = A.storage.hybrid(K_hint=128)
        hp = B.storage.hybrid(K_hint=128)
    finally:
        jhyb.set_store_budget(0.0)
        phyb.set_store_budget(0.0)
    assert type(hp).__name__ == type(hj).__name__ == (route or "NoneType")
    if route == "HybridFormat":
        assert (hp.nb, hp.dense_nnz) == (hj.nb, int(hj.dense_nnz))
        assert hp.blocks.dtype == (torch.bfloat16 if str(hj.blocks.dtype)
                                   == "bfloat16" else torch.float32)
    if route == "DenseFormat":
        assert str(hp.dense.dtype).split(".")[-1] == str(hj.dense.dtype)
    if route is not None:
        tol = 1e-5 if budget == 0.0 else 1e-4
        out_j, out_p = _both(A, B, _x(13, A.sparse_size(1), 8), "sum")
        assert rel_err(out_p, out_j) <= tol


def _csr_walk(rowptr, col, value, x):
    """Sequential f32 row walk in CSR order (the kernels' sum order)."""
    out = np.zeros((len(rowptr) - 1, x.shape[1]), np.float32)
    for r in range(len(rowptr) - 1):
        acc = np.zeros(x.shape[1], np.float32)
        for e in range(rowptr[r], rowptr[r + 1]):
            v = np.float32(1.0) if value is None else value[e]
            acc = acc + v * x[col[e]]
        out[r] = acc
    return out


@pytest.mark.parametrize("values", [True, False])
def test_csr_plain_version_sums_in_csr_order(values):
    rng = np.random.RandomState(14)
    deg = rng.randint(0, 6, 30)
    deg[::7] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.randint(0, 20, rowptr[-1]).astype(np.int32)
    val = rng.randn(rowptr[-1]).astype(np.float32) if values else None
    x = _x(15, 20, 37)
    out = csr_spmm(torch.from_numpy(rowptr), torch.from_numpy(col),
                   None if val is None else torch.from_numpy(val),
                   torch.from_numpy(x))
    assert rel_err(out, _csr_walk(rowptr, col, val, x)) <= 1e-7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_plain_version_matches_dense_oracle(dtype):
    rng = np.random.RandomState(16)
    B, R, C, K, nb = 8, 3, 4, 5, 6
    keys = np.sort(rng.choice(R * C, nb, replace=False))
    slot_row, slot_col = keys // C, keys % C
    blocks = rng.randn(nb + 1, B, B).astype(np.float32)
    blocks[nb] = 0
    xb = _x(17, C * B, K)
    dense = np.zeros((R * B, C * B), np.float32)
    bt = torch.from_numpy(blocks).to(dtype)
    for s in range(nb):
        r, c = slot_row[s], slot_col[s]
        dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = bt[s].float().numpy()
    rb_ptr = np.searchsorted(slot_row, np.arange(R + 1)).astype(np.int32)
    out = block_spmm(bt, torch.from_numpy(slot_col.astype(np.int32)),
                     torch.from_numpy(rb_ptr), torch.from_numpy(xb))
    assert out.shape == (R * B, K)
    assert rel_err(out, dense @ xb) <= 1e-6


def test_wrappers_take_plain_versions_only_on_cpu():
    rowptr = torch.tensor([0, 1, 2], dtype=torch.int32)
    col = torch.tensor([1, 0], dtype=torch.int32)
    x = torch.randn(2, 3)
    before = (csr_spmm.launches, block_spmm.launches)
    csr_spmm(rowptr, col, None, x)
    blocks = torch.zeros(2, 4, 4)
    block_spmm(blocks, torch.tensor([0], dtype=torch.int32),
               torch.tensor([0, 1], dtype=torch.int32), torch.zeros(4, 3))
    assert (csr_spmm.launches, block_spmm.launches) == before
    meta = torch.empty(2, 3, device="meta")
    with pytest.raises(NotImplementedError):
        csr_spmm(rowptr.to("meta"), col.to("meta"), None, meta)
    with pytest.raises(NotImplementedError):
        block_spmm(blocks.to("meta"),
                   torch.tensor([0], dtype=torch.int32, device="meta"),
                   torch.tensor([0, 1], dtype=torch.int32, device="meta"),
                   torch.empty(4, 3, device="meta"))


@pytest.mark.parametrize("precision,tol", [("default", 1e-5),
                                           ("high", 1e-4),
                                           ("highest", 1e-5)])
def test_dense_bf16_split_follows_precision(precision, tol):
    """The bf16-store dense route splits the f32 operand into 1, 2 or 3
    bf16 terms, as the JAX package's DEFAULT/HIGH/HIGHEST do (each side
    then sums the terms' products in f32)."""
    import jax

    A, B = _graph(23, 64, 64, 1500)
    A, B = A.coalesce(), B.coalesce()
    r = A.storage.numpy_view("row")
    c = A.storage.numpy_view("col")
    v = np.asarray(A.storage.value())
    dj = jhyb.build_dense(r, c, v, 64, 64, dtype=jnp.bfloat16)
    dp = phyb.build_dense(r, c, v, 64, 64, dtype=torch.bfloat16,
                          device="cpu")
    x = _x(24, 64, 16)
    jprec = getattr(jax.lax.Precision, precision.upper())
    out_j = np.asarray(jhyb.dense_spmm(dj, jnp.asarray(x), jprec))
    phyb.set_block_precision(precision)
    try:
        out_p = phyb.dense_spmm(dp, torch.from_numpy(x))
    finally:
        phyb.set_block_precision("high")
    assert rel_err(out_p, out_j) <= tol
    exact = dp.dense.float() @ torch.from_numpy(x)
    if precision == "default":  # one bf16 term: x itself is rounded
        assert rel_err(out_p, exact) > 1e-4
    else:
        assert rel_err(out_p, exact) <= 1e-4
