"""The port's ``SparseTensor``/``SparseStorage`` API against the JAX
package on the same seeded numpy inputs (CPU): constructors
(``from_edge_index``, ``from_scipy``, ``eye``), ``sparse_resize``,
``sparse_reshape``, ``empty``, ``apply``/``apply_value``/``astype_value``,
``to_device``, symmetry, the structure metrics, ``to_scipy``, ``__eq__``,
``__getitem__``, ``utils.index_sort`` and the legacy ``eye`` and
``convert`` tuples.  Structure, permutations and ``cached_keys()`` must
agree exactly, and so must values that no sum touches; summed values
(``to_symmetric``) to 1e-6 of max |ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import _torch_parity as T
import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.ops.convert import from_scipy as jfrom_scipy
from pytorch_sparse_tpu.ops.convert import to_scipy as jto_scipy
from pytorch_sparse_tpu.ops.eye import eye as jeye

DTS = ["f32", "f16", "i32", "bf16"]


# ---------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------

@pytest.mark.parametrize("is_sorted", [False, True])
@pytest.mark.parametrize("index_type", ["numpy", "tensor"])
def test_from_edge_index_matches_jax(index_type, is_sorted):
    rng = np.random.RandomState(1)
    ei = rng.randint(0, 12, (2, 40))
    if is_sorted:
        ei = ei[:, np.lexsort((ei[1], ei[0]))]
    v = rng.randn(40).astype(np.float32)
    J = jts.SparseTensor.from_edge_index(jnp.asarray(ei), jnp.asarray(v),
                                         sparse_sizes=(12, 14),
                                         is_sorted=is_sorted)
    idx = torch.from_numpy(ei) if index_type == "tensor" else ei
    P = pts.SparseTensor.from_edge_index(idx, torch.from_numpy(v),
                                         sparse_sizes=(12, 14),
                                         is_sorted=is_sorted, device="cpu")
    T.assert_same(J, P)


def test_from_edge_index_keeps_a_tensors_device(monkeypatch):
    """A tensor index stays on its device; a numpy one resolves to CUDA,
    which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ei = torch.tensor([[0, 1], [1, 0]])
    assert pts.SparseTensor.from_edge_index(ei).device().type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.from_edge_index(ei.numpy())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.from_scipy(scipy.sparse.eye(3, format="csr"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.SparseTensor.eye(3)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_from_scipy_matches_jax(fmt):
    rng = np.random.RandomState(2)
    dense = (rng.rand(9, 7) > 0.6) * rng.randn(9, 7)
    mat = scipy.sparse.csr_matrix(dense.astype(np.float32)).asformat(fmt)
    J = jts.SparseTensor.from_scipy(mat)
    P = pts.SparseTensor.from_scipy(mat, device="cpu")
    T.assert_same(J, P)
    assert P.dtype() == torch.float32


@pytest.mark.parametrize("dt", DTS)
def test_eye(dt):
    """The JAX package's ``tests/test_eye.py``, in both packages."""
    for args, kw in [((3,), dict(dtype=T.JDT[dt])),
                     ((3,), dict(has_value=False)),
                     ((3, 4), dict(fill_cache=True)),
                     ((4, 3), dict(fill_cache=True))]:
        J = jts.SparseTensor.eye(*args, **kw)
        pkw = dict(kw, device="cpu")
        if "dtype" in kw:
            pkw["dtype"] = T.PDT[dt]
        P = pts.SparseTensor.eye(*args, **pkw)
        assert P.storage.num_cached_keys() == J.storage.num_cached_keys()
        T.assert_same(J, P)
        if "dtype" in kw:
            assert P.dtype() == T.PDT[dt]


def test_legacy_eye_and_convert():
    index, value = pts.eye(4, dtype=torch.float16, device="cpu")
    jindex, jvalue = jeye(4, dtype=jnp.float16)
    np.testing.assert_array_equal(index.numpy(), np.asarray(jindex))
    assert index.dtype == torch.int32 and value.dtype == torch.float16
    np.testing.assert_array_equal(T.np_(value), T.np_(jvalue))

    index = np.array([[0, 0, 1, 2, 2], [0, 2, 1, 0, 1]])
    value = np.array([1.0, 2.0, 4.0, 1.0, 3.0], np.float32)
    out = pts.from_scipy(pts.to_scipy(torch.from_numpy(index),
                                      torch.from_numpy(value), 3, 3),
                         device="cpu")
    jout = jfrom_scipy(jto_scipy(jnp.asarray(index), jnp.asarray(value),
                                 3, 3))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
    assert out[0].tolist() == index.tolist()

    # The reference's torch.sparse tuple conversion (JAX's is a BCOO).
    A = pts.to_torch_sparse(torch.from_numpy(index), torch.from_numpy(value),
                            3, 3)
    assert A.layout == torch.sparse_coo and A.shape == (3, 3)
    back = pts.from_torch_sparse(A)
    assert back[0].tolist() == index.tolist()
    assert back[1].tolist() == value.tolist()
    back = pts.from_torch_sparse(A.coalesce())
    assert back[0].dtype == torch.int32
    assert back[0].tolist() == index.tolist()


def test_index_sort_is_stable_and_matches_jax():
    x = np.random.RandomState(3).randint(0, 5, 60)
    vals, perm = pts.index_sort(torch.from_numpy(x))
    jvals, jperm = jts.index_sort(jnp.asarray(x))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    from pytorch_sparse_tpu.utils.index_sort import lexsort_rows as jlex
    from pytorch_sparse_tpu_torch.utils import lexsort_rows

    a, b = x[:30], x[30:]
    np.testing.assert_array_equal(
        lexsort_rows(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jlex(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------
# storage API
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("sizes", [(40, 25), (20, 25), (30, 10), (30, 20),
                                   (10, 30)])
def test_sparse_resize_matches_jax(sizes, prefill):
    J, P = T.pair(4, prefill=prefill)
    J2, P2 = J.sparse_resize(sizes), P.sparse_resize(sizes)
    T.assert_keys(J2, P2)
    for name in T.CACHES:
        if name in J2.storage.cached_keys():
            np.testing.assert_array_equal(
                T.np_(getattr(P2.storage, name)()),
                T.np_(getattr(J2.storage, name)()), err_msg=name)
    if sizes[0] >= 30:  # no row of a nonzero is cut
        T.assert_same(J2, P2, caches=False)


def test_storage_utility_resize_and_copy():
    """The JAX package's ``test_utility`` (set_value in both layouts,
    resize, copy)."""
    row, col = np.array([0, 0, 1, 1]), np.array([1, 0, 1, 0])
    st = pts.SparseStorage(row=row, col=col,
                           value=torch.tensor([1., 2., 3., 4.]),
                           device="cpu")
    v = torch.tensor([1., 2., 3., 4.])
    assert st.set_value(v, layout="csc").value().tolist() == [1, 3, 2, 4]
    st = st.set_value(v, layout="coo").sparse_resize((3, 3))
    assert st.sparse_sizes() == (3, 3)
    assert st.rowptr().tolist() == [0, 2, 4, 4]
    new = st.copy()
    assert new is not st and new.col().tolist() == st.col().tolist()


@pytest.mark.parametrize("shape", [(2, 8), (-1, 4), (2, -1), (16, 1)])
def test_sparse_reshape_matches_jax(shape):
    J, P = T.pair(5, M=4, N=4, E=9)
    T.assert_same(J.sparse_reshape(*shape), P.sparse_reshape(*shape))
    st = pts.SparseStorage(row=[0, 1, 2, 3], col=[0, 1, 2, 3], device="cpu")
    st = st.sparse_reshape(2, 8)
    assert st.row().tolist() == [0, 0, 1, 1]
    assert st.col().tolist() == [0, 5, 2, 7]
    with pytest.raises(ValueError):
        st.sparse_reshape(3, 5)


def test_sparse_reshape_beyond_int32():
    M = 80_000
    A = pts.SparseTensor(row=[M - 1], col=[M - 1], value=torch.ones(1),
                         sparse_sizes=(M, M), device="cpu")
    r, c, _ = A.sparse_reshape(M * 2, M // 2).coo()
    flat = (M - 1) * M + (M - 1)
    assert int(r[0]) == flat // (M // 2) and int(c[0]) == flat % (M // 2)


def test_empty_apply_and_casts():
    e = pts.SparseStorage.empty(device="cpu")
    je = jts.SparseStorage.empty()
    assert e.sparse_sizes() == je.sparse_sizes() == (0, 0)
    assert e.nnz() == je.nnz() == 0 and e.cached_keys() == []

    J, P = T.pair(6, prefill=True)
    P2 = P.storage.apply(lambda x: x.clone())
    assert P2.cached_keys() == P.storage.cached_keys()
    for name in T.VIEWS + T.CACHES:
        assert torch.equal(getattr(P2, name)(), getattr(P.storage, name)())
    h = P.storage.astype_value(torch.float16)
    jh = J.storage.astype_value(jnp.float16)
    assert h.value().dtype == torch.float16
    T.assert_values(jh.value(), h.value())
    a = P.storage.apply_value(lambda v: v * 2)
    T.assert_values(J.storage.apply_value(lambda v: v * 2).value(),
                    a.value())
    assert P.astype(torch.float64).dtype() == torch.float64
    moved = P.to_device("cpu")
    assert moved.device().type == "cpu"
    assert moved.storage.cached_keys() == P.storage.cached_keys()


# ---------------------------------------------------------------------
# tensor API
# ---------------------------------------------------------------------

def test_metrics_match_jax():
    J, P = T.pair(7, M=30, N=20, E=150)
    for name in ("sparsity", "avg_row_length", "avg_col_length",
                 "bandwidth", "is_quadratic", "numel", "density"):
        assert getattr(P, name)() == pytest.approx(getattr(J, name)()), name
    for bw in (0, 3, 10):
        assert P.bandwidth_proportion(bw) == pytest.approx(
            J.bandwidth_proportion(bw))
    Jw, Pw = T.pair(7, width=3)
    assert Pw.numel() == Jw.numel() == 3 * Jw.nnz()
    Je, Pe = T.pair(7, E=0)
    assert Pe.bandwidth() == Je.bandwidth() == 0
    assert Pe.bandwidth_proportion(2) == Je.bandwidth_proportion(2) == 0.0


def test_requires_grad_is_the_values_flag():
    """A settled difference: JAX always answers False (it has no flags);
    the port answers the value's ``requires_grad``, as the reference."""
    J, P = T.pair(8)
    assert not J.requires_grad() and not P.requires_grad()
    v = P.storage.value().clone().requires_grad_(True)
    assert P.set_value(v, layout="coo").requires_grad()
    assert not P.set_value(None).requires_grad()


def test_to_symmetric():
    """The JAX package's ``test_to_symmetric`` in both packages, then a
    random matrix with duplicates (sums to 1e-6 of max |ref|)."""
    row, col = np.array([0, 0, 0, 1, 1]), np.array([0, 1, 2, 0, 2])
    value = np.arange(1, 6)
    J = jts.SparseTensor(row=row, col=col, value=jnp.asarray(value))
    P = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(value),
                         device="cpu")
    T.assert_same(J.to_symmetric(), P.to_symmetric())
    assert not P.is_symmetric()
    S = P.to_symmetric()
    assert S.is_symmetric()
    assert S.to_dense().tolist() == [[2, 6, 3], [6, 0, 5], [3, 5, 0]]
    for reduce in ("sum", "mean", "max"):
        J, P = T.pair(9, M=25, N=18, E=120, coalesced=False,
                      unique=False)
        Js, Ps = J.to_symmetric(reduce), P.to_symmetric(reduce)
        assert Ps.is_symmetric() == Js.is_symmetric()
        T.assert_same(Js, Ps, exact=False)
    J, P = T.pair(9, M=20, N=20, has_value=False)
    assert P.is_symmetric() == J.is_symmetric() is False
    T.assert_same(J.to_symmetric(), P.to_symmetric())
    assert P.to_symmetric().is_symmetric()


@pytest.mark.parametrize("layout", ["coo", "csr", "csc", None])
@pytest.mark.parametrize("has_value", [True, False])
def test_to_scipy_matches_jax(layout, has_value):
    J, P = T.pair(10, has_value=has_value)
    a = J.to_scipy(layout=layout)
    b = P.to_scipy(layout=layout)
    assert type(a) is type(b) and a.shape == b.shape
    assert a.dtype == b.dtype
    if layout != "coo":
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
    else:
        np.testing.assert_array_equal(a.row, b.row)
        np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.data, b.data)
    T.assert_keys(J, P)


def test_from_dense_scipy_roundtrip():
    rng = np.random.RandomState(1)
    dense = ((rng.rand(7, 9) > 0.5) * rng.randn(7, 9)).astype(np.float32)
    mat = pts.SparseTensor.from_dense(torch.from_numpy(dense), device="cpu")
    back = pts.SparseTensor.from_scipy(mat.to_scipy(layout="csr"),
                                       device="cpu")
    np.testing.assert_array_equal(back.to_dense().numpy(), dense)
    assert back == mat


def test_equal():
    """The JAX package's ``test_equal``."""
    row, col = np.array([0, 0, 0, 1, 1]), np.array([0, 1, 2, 0, 2])
    value = torch.arange(1, 6)
    a = pts.SparseTensor(row=row, col=col, value=value, device="cpu")
    b = pts.SparseTensor(row=row, col=col, value=value, device="cpu")
    c = pts.SparseTensor(row=row, col=np.array([0, 1, 2, 0, 1]),
                         value=value, device="cpu")
    assert a is not b and a == b
    assert a != c
    assert a != a.set_value(None) and a.set_value(None) == b.set_value(None)
    assert a != a.set_value(value + 1, layout="coo")
    assert a != a.sparse_resize((3, 3)) and a != value
    assert len({a, b}) == 2


@pytest.mark.parametrize("dt", ["f16", "f32", "bf16"])
def test_getitem_matches_jax(dt):
    """The JAX package's ``test_getitem``: every index kind, also as
    torch tensors, against JAX's results (structure, caches and values
    exactly)."""
    m, n, k = 50, 40, 10
    rng = np.random.RandomState(0)
    dense = rng.randn(m, n).astype(np.float32)
    J = jts.SparseTensor.from_dense(jnp.asarray(dense, T.JDT[dt]))
    P = pts.SparseTensor.from_dense(torch.from_numpy(dense).to(T.PDT[dt]),
                                    device="cpu")
    idx1, idx2 = rng.randint(0, m, (k,)), rng.randint(0, n, (k,))
    bool1, bool2 = np.zeros(m, bool), np.zeros(n, bool)
    bool1[idx1] = True
    bool2[idx2] = True
    t1, t2 = torch.from_numpy(idx1), torch.from_numpy(idx2)
    b1, b2 = torch.from_numpy(bool1), torch.from_numpy(bool2)
    cases = [
        ((slice(None, k), slice(None, k)), None, [k, k]),
        ((Ellipsis, slice(None, k)), None, [m, k]),
        ((slice(3, -4), slice(-9, None)), None, [m - 7, 9]),
        ((idx1, idx2), (t1, t2), [k, k]),
        ((list(idx1), list(idx2)), None, [k, k]),
        ((bool1, bool2), (b1, b2), [int(bool1.sum()), int(bool2.sum())]),
        ((idx1,), (t1,), [k, n]),
        ((bool1,), (b1,), [int(bool1.sum()), n]),
        ((3, slice(None)), None, [1, n]),
        ((slice(None), -2), None, [m, 1]),
    ]
    for jidx, pidx, sizes in cases:
        got = P[jidx if len(jidx) > 1 else jidx[0]]
        want = J[jidx if len(jidx) > 1 else jidx[0]]
        assert got.sizes() == want.sizes() == sizes
        T.assert_same(want, got)
        if pidx is not None:
            got_t = P[pidx if len(pidx) > 1 else pidx[0]]
            assert got_t == got
