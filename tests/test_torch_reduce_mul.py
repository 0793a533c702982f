"""The port's ``mul`` (sparse x sparse, broadcast, ``mul_nnz``), the
reductions (``sum``, ``mean``, ``min``, ``max`` over every dim), the
legacy tuple ``spmm``, ``non_diag_mask`` and the ``ops.segment`` shim
against the JAX package on the same seeded numpy inputs (CPU).

Structure and cache keys agree exactly.  Products that no sum touches
agree exactly.  Sums add in the JAX package's order (a row's terms in
CSR order, a column's in CSC order), so float32 sums agree to a few
ulps: they are held to 1e-6 of max |ref|, as are the value gradients
(``jax.grad`` against ``torch.autograd``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as T
import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.ops.diag import non_diag_mask as jnon_diag_mask
from pytorch_sparse_tpu.ops.spmm import spmm as jspmm

DTS = ["f16", "f32", "i32", "bf16"]


@pytest.mark.parametrize("dt", DTS)
def test_sparse_sparse_mul(dt):
    """The JAX package's ``tests/test_mul.py``."""
    A = pts.SparseTensor(row=[0, 0, 1, 2, 2], col=[0, 2, 1, 0, 1],
                         value=torch.tensor([1, 2, 4, 1, 3]).to(T.PDT[dt]),
                         device="cpu")
    B = pts.SparseTensor(row=[0, 0, 1, 2, 2], col=[1, 2, 2, 1, 2],
                         value=torch.tensor([2, 3, 1, 2, 4]).to(T.PDT[dt]),
                         device="cpu")
    rowC, colC, valueC = (A * B).coo()
    assert rowC.tolist() == [0, 2] and colC.tolist() == [2, 1]
    assert valueC.tolist() == [6, 6]
    A = pts.SparseTensor(row=[0], col=[1], value=torch.ones(1, dtype=T.PDT[
        dt]), device="cpu")
    B = pts.SparseTensor(row=[1], col=[0], value=torch.ones(1, dtype=T.PDT[
        dt]) * 2, device="cpu")
    rowC, colC, valueC = (A * B).coo()
    assert rowC.tolist() == colC.tolist() == valueC.tolist() == []


@pytest.mark.parametrize("dt,width", [("f32", None), ("bf16", None),
                                      ("i32", None), ("f32", 3)])
def test_sparse_sparse_mul_matches_jax(dt, width):
    Ja, Pa = T.pair(51, dt=dt, width=width)
    Jb, Pb = T.pair(52, M=35, N=18, dt=dt, width=width)
    T.assert_same(Ja * Jb, Pa * Pb)
    with pytest.raises(ValueError, match="coalesced"):
        Pa * T.pair(53, coalesced=False, unique=False)[1]
    with pytest.raises(ValueError, match="explicit values"):
        Pa * Pa.set_value(None)


@pytest.mark.parametrize("dt", ["f32", "bf16", "i32", None])
@pytest.mark.parametrize("side", ["row", "col"])
def test_broadcast_mul_and_mul_nnz_match_jax(side, dt):
    J, P = T.pair(54, dt=dt or "f32", has_value=dt is not None)
    M, N = J.sparse_sizes()
    o = np.random.RandomState(55).randn(*((M, 1) if side == "row"
                                         else (1, N))).astype(np.float32)
    T.assert_same(J.mul(jnp.asarray(o)), P.mul(torch.from_numpy(o)))
    T.assert_same(jnp.asarray(o) * J, torch.from_numpy(o) * P)
    on = np.random.RandomState(56).randn(J.nnz()).astype(np.float32)
    for layout in ("coo", "csc"):
        T.assert_same(J.mul_nnz(jnp.asarray(on), layout),
                      P.mul_nnz(torch.from_numpy(on), layout))
    T.assert_same(J.mul_(jnp.asarray(o)), P.mul_(torch.from_numpy(o)))


def test_overload():
    """The JAX package's ``tests/test_overload.py``."""
    mat = pts.SparseTensor(row=[0, 1, 1, 2, 2], col=[1, 0, 2, 1, 2],
                           device="cpu")
    for other in (torch.tensor([1.0, 2.0, 3.0]).reshape(3, 1),
                  torch.tensor([1.0, 2.0, 3.0]).reshape(1, 3)):
        assert (other + mat) == (mat + other)
        assert (other * mat) == (mat * other)
        dense = mat.to_dense()
        assert torch.equal((mat * other).to_dense(), dense * other)


@pytest.mark.parametrize("side", ["row", "col"])
def test_broadcast_mul_gradients_match_jax(side):
    J, P = T.pair(57, width=2)
    M, N = J.sparse_sizes()
    o = np.random.RandomState(58).randn(*((M, 1, 2) if side == "row"
                                         else (1, N, 2))).astype(np.float32)
    v = T.np_(P.storage.value())
    w = np.random.RandomState(59).randn(P.nnz(), 2).astype(np.float32)

    def jloss(jv, jo):
        out = J.set_value(jv, layout="coo").mul(jo).storage.value()
        return jnp.sum(out * jnp.asarray(w))

    gv, go = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(o))
    pv = torch.from_numpy(v).requires_grad_(True)
    po = torch.from_numpy(o).requires_grad_(True)
    out = P.set_value(pv, layout="coo").mul(po).storage.value()
    (out * torch.from_numpy(w)).sum().backward()
    T.assert_values(gv, pv.grad, exact=False)
    T.assert_values(go, po.grad, exact=False)


@pytest.mark.parametrize("reduce", ["sum", "add", "mean", "min", "max"])
@pytest.mark.parametrize("dim", [None, 0, 1, 2, -1])
@pytest.mark.parametrize("dt,width", [("f32", None), ("f32", 3),
                                      ("i32", None), ("bf16", 2),
                                      ("f16", None)])
def test_reductions_match_jax(dt, width, dim, reduce):
    J, P = T.pair(60, M=40, N=30, E=400, dt=dt, width=width)
    if dim in (2, -1) and width is None:
        dim = -2 if dim == -1 else None
        if dim is None:
            return
    J.storage.row()  # every cache the JAX side may fill, filled alike
    got = pts.reduction(P, dim, reduce)
    want = jts.reduction(J, dim, reduce)
    assert tuple(got.shape) == tuple(want.shape)
    exact = reduce in ("min", "max") or (dt == "i32" and reduce != "mean")
    T.assert_values(want, got, exact=exact,
                    rel=T.REL if dt == "f32" else 1e-2)
    assert getattr(P, reduce if reduce != "add" else "sum")(dim).shape \
        == got.shape


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_reductions_fill_caches(dim, reduce):
    """Row reductions fill no cache (as JAX's); column sums and means
    fill ``csr2csc`` and ``colptr``, the CSC order they add in (JAX's
    unsorted segment sum fills none)."""
    J, P = T.pair(67)
    jts.reduction(J, dim, reduce)
    pts.reduction(P, dim, reduce)
    want = J.storage.cached_keys()
    if dim == 0 and reduce != "max":
        want = sorted(set(want) | {"colptr", "csr2csc"},
                      key=T.CACHES.index)
    assert P.storage.cached_keys() == want


def test_reductions_of_implicit_ones_and_empty_rows():
    J, P = T.pair(61, M=50, N=45, E=60, has_value=False)
    for dim in (None, 0, 1):
        for reduce in ("sum", "mean", "min", "max"):
            got, want = pts.reduction(P, dim, reduce), \
                jts.reduction(J, dim, reduce)
            np.testing.assert_array_equal(T.np_(got), T.np_(want))
            assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        pts.reduction(P, 2)
    with pytest.raises(ValueError):
        pts.reduction(P, 0, "prod")


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_reduction_gradients_match_jax(dim, reduce):
    J, P = T.pair(62, M=30, N=25, E=200, width=3)
    v = T.np_(P.storage.value())
    n = P.sparse_size(1 - dim)
    w = np.random.RandomState(63).randn(n, 3).astype(np.float32)

    def jloss(jv):
        out = jts.reduction(J.set_value(jv, layout="coo"), dim, reduce)
        return jnp.sum(out * jnp.asarray(w))

    g = jax.grad(jloss)(jnp.asarray(v))
    pv = torch.from_numpy(v).requires_grad_(True)
    out = pts.reduction(P.set_value(pv, layout="coo"), dim, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    T.assert_values(g, pv.grad, exact=False)


@pytest.mark.parametrize("shape", [(8, 1), (8, 3), (2, 8, 3)])
@pytest.mark.parametrize("dt", ["f32", "f16"])
def test_legacy_spmm_matches_jax(shape, dt):
    """Unsorted edges with duplicates; each row's terms add in edge
    order, as the JAX package's scatter-add does on the CPU."""
    rng = np.random.RandomState(64)
    E, m, n = 60, 10, 8
    index = np.stack([rng.randint(0, m, E), rng.randint(0, n, E)])
    value = rng.randn(E).astype(np.float32)
    mat = rng.randn(*shape).astype(np.float32)
    got = pts.spmm(torch.from_numpy(index), torch.from_numpy(value).to(
        T.PDT[dt]), m, n, torch.from_numpy(mat).to(T.PDT[dt]))
    want = jspmm(jnp.asarray(index), jnp.asarray(value, T.JDT[dt]), m, n,
                 jnp.asarray(mat, T.JDT[dt]))
    assert tuple(got.shape) == tuple(want.shape)
    T.assert_values(want, got, exact=False,
                    rel=T.REL if dt == "f32" else 1e-2)
    # the value's and the matrix's gradients (float32 only)
    if dt == "f32":
        w = rng.randn(*want.shape).astype(np.float32)
        g, gm = jax.grad(lambda jv, jm: jnp.sum(jspmm(
            jnp.asarray(index), jv, m, n, jm) * w), argnums=(0, 1))(
            jnp.asarray(value), jnp.asarray(mat))
        pv = torch.from_numpy(value).requires_grad_(True)
        pm = torch.from_numpy(mat).requires_grad_(True)
        (pts.spmm(torch.from_numpy(index), pv, m, n, pm)
         * torch.from_numpy(w)).sum().backward()
        T.assert_values(g, pv.grad, exact=False)
        T.assert_values(gm, pm.grad, exact=False)
    if shape == (8, 1):  # a 1-D matrix is a column (JAX takes 2-D only)
        assert torch.equal(pts.spmm(torch.from_numpy(index), torch.from_numpy(
            value), m, n, torch.from_numpy(mat[:, 0])), pts.spmm(
            torch.from_numpy(index), torch.from_numpy(value), m, n,
            torch.from_numpy(mat)))


@pytest.mark.parametrize("k", [0, 2, -3])
@pytest.mark.parametrize("sizes", [(12, 12), (9, 14), (14, 9)])
def test_non_diag_mask_matches_jax(sizes, k):
    J, P = T.pair(65, M=sizes[0], N=sizes[1], E=40)
    row, col = P.storage.row(), P.storage.col()
    got = pts.non_diag_mask(row, col, *sizes, k)
    want = jnon_diag_mask(J.storage.row(), J.storage.col(), *sizes, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.bool


def test_segment_shim_matches_jax():
    from pytorch_sparse_tpu.ops import segment as jseg
    from pytorch_sparse_tpu_torch.ops import segment as pseg

    rng = np.random.RandomState(66)
    ids = np.sort(rng.randint(0, 9, 50))
    data = rng.randn(50, 2).astype(np.float32)
    for reduce in ("sum", "add", "mean", "min", "max"):
        got = pseg.segment_reduce(torch.from_numpy(data),
                                  torch.from_numpy(ids), 11, reduce)
        want = jseg.segment_reduce(jnp.asarray(data), jnp.asarray(ids), 11,
                                   reduce)
        T.assert_values(want, got, exact=False)
    with pytest.raises(ValueError):
        pseg.segment_reduce(torch.from_numpy(data), torch.from_numpy(ids),
                            11, "prod")
