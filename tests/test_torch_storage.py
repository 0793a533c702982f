"""The port's storage, tensor, diagonal and index helpers against the JAX
package on the same numpy inputs (CPU).  Indices, caches and coalesced
values must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu import segment as jseg
from pytorch_sparse_tpu.testing import community_graph as jcommunity
from pytorch_sparse_tpu.utils import convert as jconvert
from pytorch_sparse_tpu_torch import segment as pseg
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.utils import host_sort

CACHES = ["row", "rowptr", "col", "rowcount", "colptr", "colcount",
          "csr2csc", "csc2csr"]


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _coo(seed, M, N, E, dup=True):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, M, E)
    col = rng.randint(0, N, E)
    if not dup:
        keys = np.unique(row * N + col)
        row, col = keys // N, keys % N
        perm = rng.permutation(keys.size)
        row, col = row[perm], col[perm]
    val = rng.randn(row.size).astype(np.float32)
    return row, col, val


def _pair(row, col, val, sizes, **kw):
    A = jts.SparseTensor(row=row, col=col,
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=sizes, **kw)
    B = pts.SparseTensor(row=row, col=col,
                         value=None if val is None else torch.from_numpy(val),
                         sparse_sizes=sizes, device="cpu", **kw)
    return A, B


def _assert_same_views(A, B):
    for name in CACHES:
        a = _np(getattr(A.storage, name)())
        b = _np(getattr(B.storage, name)())
        np.testing.assert_array_equal(a, b, err_msg=name)
    va, vb = _np(A.storage.value()), _np(B.storage.value())
    if va is None:
        assert vb is None
    else:
        np.testing.assert_array_equal(va, vb)
    assert A.sparse_sizes() == B.sparse_sizes()
    assert A.nnz() == B.nnz()


@pytest.mark.parametrize("case", [
    dict(seed=0, M=30, N=20, E=200, dup=True, sizes=(30, 20)),
    dict(seed=1, M=50, N=50, E=120, dup=False, sizes=None),
    dict(seed=2, M=80, N=10, E=40, dup=True, sizes=(100, 12)),  # empty rows
    dict(seed=3, M=1, N=1, E=0, dup=True, sizes=(4, 5)),        # no edges
])
@pytest.mark.parametrize("values", [True, False])
def test_construction_views_and_caches_match(case, values):
    row, col, val = _coo(case["seed"], case["M"], case["N"], case["E"],
                         case["dup"])
    A, B = _pair(row, col, val if values else None, case["sizes"])
    _assert_same_views(A, B)
    assert A.storage.cached_keys() == B.storage.cached_keys()


def test_construction_from_rowptr_matches():
    row, col, val = _coo(4, 40, 30, 150, dup=False)
    order = np.lexsort((col, row))
    row, col, val = row[order], col[order], val[order]
    rowptr = np.searchsorted(row, np.arange(41))
    A = jts.SparseTensor(rowptr=rowptr, col=col, value=jnp.asarray(val),
                         sparse_sizes=(40, 30))
    B = pts.SparseTensor(rowptr=rowptr, col=col, value=torch.from_numpy(val),
                         sparse_sizes=(40, 30), device="cpu")
    _assert_same_views(A, B)


def test_cached_keys_follow_fill_and_clear():
    row, col, val = _coo(5, 25, 25, 90)
    A, B = _pair(row, col, val, (25, 25))
    steps = [lambda s: s.colcount(), lambda s: s.csc2csr(),
             lambda s: s.fill_cache_(), lambda s: s.clear_cache_(),
             lambda s: s.rowcount()]
    for step in steps:
        step(A.storage)
        step(B.storage)
        assert A.storage.cached_keys() == B.storage.cached_keys()
        assert A.storage.num_cached_keys() == B.storage.num_cached_keys()


@pytest.mark.parametrize("reduce", ["add", "mean", "min", "max"])
def test_coalesce_matches(reduce):
    row, col, val = _coo(6, 20, 15, 400)
    A, B = _pair(row, col, val, (20, 15))
    assert A.is_coalesced() == B.is_coalesced() is False
    Ac, Bc = A.coalesce(reduce), B.coalesce(reduce)
    _assert_same_views(Ac, Bc)
    assert Bc.is_coalesced()


def test_set_value_csc_layout_and_hybrid_guard():
    row, col, val = _coo(7, 30, 30, 100, dup=False)
    A, B = _pair(row, col, val, (30, 30))
    new = np.random.RandomState(8).randn(A.nnz()).astype(np.float32)
    A2 = A.set_value(jnp.asarray(new), layout="csc")
    B2 = B.set_value(torch.from_numpy(new), layout="csc")
    np.testing.assert_array_equal(_np(A2.storage.value()),
                                  _np(B2.storage.value()))
    # The hybrid view bakes values, so set_value must not carry it over.
    B.storage.set_hybrid_(object())
    assert not B.set_value(torch.from_numpy(new), "coo").storage.has_hybrid()
    # Index caches do carry over.
    B.storage.fill_cache_()
    assert B.set_value(None, "coo").storage.cached_keys() == [
        "rowcount", "colptr", "colcount", "csr2csc", "csc2csr"]


def test_csc_view_and_fill_value_match():
    row, col, val = _coo(9, 20, 25, 80)
    A, B = _pair(row, col, val, (20, 25))
    for a, b in zip(A.csc(), B.csc()):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(A.fill_value(2.5).storage.value()),
                                  _np(B.fill_value(2.5).storage.value()))


def test_dense_round_trip_matches():
    rng = np.random.RandomState(10)
    dense = rng.randn(12, 9).astype(np.float32)
    dense[rng.rand(12, 9) < 0.6] = 0
    A = jts.SparseTensor.from_dense(jnp.asarray(dense))
    B = pts.SparseTensor.from_dense(torch.from_numpy(dense), device="cpu")
    _assert_same_views(A, B)
    np.testing.assert_array_equal(_np(B.to_dense()), dense)
    row, col, val = _coo(11, 10, 10, 60)
    A, B = _pair(row, col, val, (10, 10))
    np.testing.assert_allclose(_np(A.to_dense()), _np(B.to_dense()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [-2, 0, 1])
@pytest.mark.parametrize("values", [True, False])
def test_diag_ops_match(k, values):
    row, col, val = _coo(12, 15, 18, 90, dup=False)
    A, B = _pair(row, col, val if values else None, (15, 18))
    A.storage.fill_cache_()
    B.storage.fill_cache_()
    _assert_same_views(jts.remove_diag(A, k), pts.remove_diag(B, k))
    for a, b in [(A.storage.rowcount(), B.storage.rowcount())]:
        np.testing.assert_array_equal(_np(a), _np(b))
    _assert_same_views(jts.fill_diag(A, 3.0, k), pts.fill_diag(B, 3.0, k))
    da = jts.remove_diag(A, k).storage
    db = pts.remove_diag(B, k).storage
    np.testing.assert_array_equal(_np(da._rowcount), _np(db._rowcount))
    np.testing.assert_array_equal(_np(da._colcount), _np(db._colcount))
    sa = jts.set_diag(A, None, k).storage
    sb = pts.set_diag(B, None, k).storage
    np.testing.assert_array_equal(_np(sa._rowcount), _np(sb._rowcount))
    np.testing.assert_array_equal(_np(sa._colcount), _np(sb._colcount))


def test_ind2ptr_ptr2ind_match():
    rng = np.random.RandomState(13)
    ind = np.sort(rng.randint(0, 20, 70)).astype(np.int32)
    ptr_j = _np(jconvert.ind2ptr(jnp.asarray(ind), 25))
    ptr_p = _np(pts.ind2ptr(torch.from_numpy(ind), 25))
    np.testing.assert_array_equal(ptr_j, ptr_p)
    np.testing.assert_array_equal(
        _np(jconvert.ptr2ind(jnp.asarray(ptr_j), 70)),
        _np(pts.ptr2ind(torch.from_numpy(ptr_p), 70)))


def test_segment_ops_match():
    rng = np.random.RandomState(14)
    ids = np.sort(rng.randint(0, 12, 50)).astype(np.int32)
    ids[ids == 5] = 6  # an empty segment
    data = rng.randn(50, 3).astype(np.float32)
    j_ids, p_ids = jnp.asarray(ids), torch.from_numpy(ids)
    j_d, p_d = jnp.asarray(data), torch.from_numpy(data)
    np.testing.assert_allclose(_np(jseg.segment_sum(j_d, j_ids, 12)),
                               _np(pseg.segment_sum(p_d, p_ids, 12)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(jseg.segment_count(j_ids, 12)),
                                  _np(pseg.segment_count(p_ids, 12)))
    np.testing.assert_allclose(_np(jseg.segment_mean(j_d, j_ids, 12)),
                               _np(pseg.segment_mean(p_d, p_ids, 12)),
                               rtol=1e-6, atol=1e-6)


def test_host_sorts_match_numpy():
    rng = np.random.RandomState(15)
    a, b = rng.randint(0, 50, 500), rng.randint(0, 7, 500)
    np.testing.assert_array_equal(host_sort.lexsort2(a, b),
                                  np.lexsort((b, a)))
    perm, a_s, b_s = host_sort.lexsort2_decode(a, b)
    np.testing.assert_array_equal(a_s, a[perm])
    np.testing.assert_array_equal(b_s, b[perm])
    np.testing.assert_array_equal(host_sort.stable_argsort(b),
                                  np.argsort(b, kind="stable"))
    neg = a - 25  # negative keys take the two-key lexsort
    np.testing.assert_array_equal(host_sort.lexsort2(neg, b),
                                  np.lexsort((b, neg)))


def test_construction_validates_indices():
    with pytest.raises(ValueError):
        pts.SparseTensor(row=[0, 3], col=[0, 1], sparse_sizes=(2, 2),
                         device="cpu")
    with pytest.raises(ValueError):
        pts.SparseTensor(row=[0, 1], col=[0, -1], device="cpu")
    with pytest.raises(ValueError):
        pts.SparseTensor(rowptr=[0, 2, 1], col=[0, 1], device="cpu")


@pytest.mark.parametrize("equal_sizes", [True, False])
def test_community_graph_matches_jax(equal_sizes):
    A = jcommunity(300, 4000, n_comm=5, seed=3, equal_sizes=equal_sizes)
    B = pcommunity(300, 4000, n_comm=5, seed=3, equal_sizes=equal_sizes,
                   device="cpu")
    _assert_same_views(A, B)
