"""The port's structural ops of the SpSpMM pipeline (``t``, the legacy
``transpose``, ``coalesce`` and ``spadd``, sparse and broadcast ``add``,
``add_nnz``, ``get_diag``) against the JAX package on the same numpy
inputs (CPU).  Indices, caches and permutations must agree exactly, and
so must values that no sum touches.  Where three or more duplicates
merge, the two packages may add them in another order: those values are
held to 1e-6 relative (a few float32 ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts

CACHES = ["row", "rowptr", "col", "rowcount", "colptr", "colcount",
          "csr2csc", "csc2csr"]
JDT = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16,
       "i32": jnp.int32}
PDT = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
       "i32": torch.int32}


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _values(rng, n, dt, width=None):
    shape = (n,) if width is None else (n, width)
    v = (rng.randint(-4, 5, shape) if dt == "i32" else rng.randn(*shape))
    return v.astype(np.float32)


def _pair(seed, M, N, E, dt="f32", values=True, width=None, sizes=None):
    rng = np.random.RandomState(seed)
    row, col = rng.randint(0, M, E), rng.randint(0, N, E)
    v = _values(rng, E, dt, width) if values else None
    J = jts.SparseTensor(row=row, col=col,
                         value=None if v is None else jnp.asarray(v).astype(
                             JDT[dt]), sparse_sizes=sizes)
    P = pts.SparseTensor(row=row, col=col,
                         value=None if v is None else torch.from_numpy(v).to(
                             PDT[dt]), sparse_sizes=sizes, device="cpu")
    return J, P


def _assert_same(J, P, caches=True, summed=False):
    """Same structure and values; ``summed`` values (merged duplicates)
    to 1e-6 relative."""
    assert J.sparse_sizes() == P.sparse_sizes()
    for name in (CACHES if caches else ["row", "col"]):
        np.testing.assert_array_equal(_np(getattr(J.storage, name)()),
                                      _np(getattr(P.storage, name)()),
                                      err_msg=name)
    jv, pv = J.storage.value(), P.storage.value()
    if jv is None:
        assert pv is None
    elif summed:
        np.testing.assert_allclose(_np(pv), _np(jv), rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_np(jv), _np(pv))


# ---------------------------------------------------------------------
# t() and the legacy transpose
# ---------------------------------------------------------------------

@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dt,width", [("f32", None), ("bf16", None),
                                      ("f32", 3), (None, None)])
def test_t_matches_jax_and_swaps_caches(dt, width, prefill):
    J, P = _pair(0, 30, 20, 150, dt or "f32", dt is not None, width,
                 sizes=(32, 21))
    if prefill:
        J.fill_cache_()
        P.fill_cache_()
    Jt, Pt = J.t(), P.t()
    assert Pt.storage.cached_keys() == Jt.storage.cached_keys()
    if prefill:
        st, st_t = P.storage, Pt.storage
        # the caches move over: colptr <-> rowptr, colcount <-> rowcount,
        # and the permutations swap
        for a, b in (("_colptr", "_rowptr"), ("_rowptr", "_colptr"),
                     ("_colcount", "_rowcount"), ("_rowcount", "_colcount"),
                     ("_csr2csc", "_csc2csr"), ("_csc2csr", "_csr2csc")):
            assert getattr(st_t, b) is getattr(st, a), (a, b)
    _assert_same(Jt, Pt)
    np.testing.assert_array_equal(_np(Pt.to_dense()),
                                  np.swapaxes(_np(P.to_dense()), 0, 1))
    Ptt = Pt.t()
    _assert_same(P, Ptt)
    assert Ptt.sparse_sizes() == P.sparse_sizes()


def test_t_of_empty_matrix():
    P = pts.SparseTensor(row=np.zeros(0, np.int64), col=np.zeros(0, np.int64),
                         sparse_sizes=(3, 4), device="cpu")
    Pt = P.t()
    assert Pt.sparse_sizes() == (4, 3) and Pt.nnz() == 0
    assert Pt.storage.rowptr().tolist() == [0] * 5


def test_t_keeps_the_value_gradient():
    J, P = _pair(1, 10, 12, 40)
    v = P.storage.value().clone().requires_grad_(True)
    Pt = P.set_value(v, layout="coo").t()
    g = torch.arange(Pt.nnz(), dtype=torch.float32)
    (Pt.storage.value() * g).sum().backward()
    np.testing.assert_array_equal(
        v.grad.numpy(), g[P.storage.csc2csr().long()].numpy())


@pytest.mark.parametrize("dt", ["f32", "f16", "bf16", "i32"])
def test_legacy_transpose_matches_jax(dt):
    """The counterparts of ``tests/test_transpose.py``."""
    row = np.array([1, 0, 1, 0, 2, 1])
    col = np.array([0, 1, 1, 1, 0, 0])
    value = np.array([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]],
                     np.float32)
    index = np.stack([row, col])
    ji, jv = jts.transpose(jnp.asarray(index),
                           jnp.asarray(value).astype(JDT[dt]), 3, 2)
    pi, pv = pts.transpose(torch.from_numpy(index),
                           torch.from_numpy(value).to(PDT[dt]), 3, 2)
    assert pi.tolist() == np.asarray(ji).tolist() == [[0, 0, 1, 1],
                                                      [1, 2, 0, 1]]
    assert _np(pv).tolist() == _np(jv).tolist() == [[7, 9], [5, 6], [6, 8],
                                                    [3, 4]]
    assert pv.dtype == PDT[dt]
    pi, pv = pts.transpose(torch.from_numpy(index[:, :4]),
                           torch.from_numpy(value[:4, 0]), 3, 2)
    ji, jv = jts.transpose(jnp.asarray(index[:, :4]),
                           jnp.asarray(value[:4, 0]), 3, 2)
    assert pi.tolist() == np.asarray(ji).tolist()
    assert pv.tolist() == np.asarray(jv).tolist()
    pi, pv = pts.transpose(torch.from_numpy(index), None, 3, 2,
                           coalesced=False)
    assert pi.tolist() == [col.tolist(), row.tolist()] and pv is None


# ---------------------------------------------------------------------
# Legacy coalesce and spadd
# ---------------------------------------------------------------------

@pytest.mark.parametrize("op", ["add", "max", "min", "mean"])
@pytest.mark.parametrize("values", [True, False])
def test_legacy_coalesce_matches_jax(op, values):
    """The counterparts of ``tests/test_coalesce.py``."""
    row = np.array([1, 0, 1, 0, 2, 1])
    col = np.array([0, 1, 1, 1, 0, 0])
    value = np.array([[1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7]],
                     np.float32)
    index = np.stack([row, col])
    ji, jv = jts.coalesce(jnp.asarray(index),
                          jnp.asarray(value) if values else None, 3, 2, op)
    pi, pv = pts.coalesce(torch.from_numpy(index),
                          torch.from_numpy(value) if values else None, 3, 2,
                          op)
    assert pi.tolist() == np.asarray(ji).tolist() == [[0, 1, 1, 2],
                                                      [1, 0, 1, 0]]
    if values:
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    else:
        assert pv is None and jv is None


def test_legacy_coalesce_random_matches_jax():
    rng = np.random.RandomState(2)
    index = np.stack([rng.randint(0, 20, 300), rng.randint(0, 15, 300)])
    value = rng.randn(300).astype(np.float32)
    ji, jv = jts.coalesce(jnp.asarray(index), jnp.asarray(value), 20, 15)
    pi, pv = pts.coalesce(torch.from_numpy(index), torch.from_numpy(value),
                          20, 15)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    assert pi.dtype == torch.int32


@pytest.mark.parametrize("values", [(True, True), (True, False)])
def test_legacy_spadd_matches_jax(values):
    rng = np.random.RandomState(3)
    iA = np.stack([rng.randint(0, 8, 30), rng.randint(0, 9, 30)])
    iB = np.stack([rng.randint(0, 8, 20), rng.randint(0, 9, 20)])
    vA = rng.randn(30).astype(np.float32)
    vB = rng.randn(20).astype(np.float32)
    ji, jv = jts.spadd(jnp.asarray(iA), jnp.asarray(vA), jnp.asarray(iB),
                       jnp.asarray(vB) if values[1] else None, 8, 9)
    pi, pv = pts.spadd(torch.from_numpy(iA), torch.from_numpy(vA),
                       torch.from_numpy(iB),
                       torch.from_numpy(vB) if values[1] else None, 8, 9)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    if values[1]:
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6)
        dense = np.zeros((8, 9), np.float32)
        np.add.at(dense, (iA[0], iA[1]), vA)
        np.add.at(dense, (iB[0], iB[1]), vB)
        np.testing.assert_allclose(dense[pi[0].numpy(), pi[1].numpy()],
                                   pv.numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert pv is None and jv is None


# ---------------------------------------------------------------------
# add and add_nnz
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "f16", "bf16", "i32"])
def test_add_matches_jax(dt):
    """The counterpart of ``tests/test_add.py::test_add``."""
    rowA, colA = np.array([0, 0, 1, 2, 2]), np.array([0, 2, 1, 0, 1])
    rowB, colB = np.array([0, 0, 1, 2, 2]), np.array([1, 2, 2, 1, 2])
    vA = np.array([1, 2, 4, 1, 3], np.float32)
    vB = np.array([2, 3, 1, 2, 4], np.float32)
    Pc = (pts.SparseTensor(row=rowA, col=colA, value=torch.from_numpy(
              vA).to(PDT[dt]), device="cpu")
          + pts.SparseTensor(row=rowB, col=colB, value=torch.from_numpy(
              vB).to(PDT[dt]), device="cpu"))
    Jc = (jts.SparseTensor(row=rowA, col=colA,
                           value=jnp.asarray(vA).astype(JDT[dt]))
          + jts.SparseTensor(row=rowB, col=colB,
                             value=jnp.asarray(vB).astype(JDT[dt])))
    row, col, value = Pc.coo()
    assert row.tolist() == [0, 0, 0, 1, 1, 2, 2, 2]
    assert col.tolist() == [0, 1, 2, 1, 2, 0, 1, 2]
    assert value.tolist() == [1, 2, 5, 4, 1, 1, 5, 4]
    assert value.dtype == PDT[dt]
    _assert_same(Jc, Pc, caches=False)


@pytest.mark.parametrize("values", [(True, True), (True, False),
                                    (False, False)])
def test_sparse_add_mismatched_sizes_matches_jax(values):
    JA, PA = _pair(4, 12, 7, 40, values=values[0], sizes=(12, 7))
    JB, PB = _pair(5, 9, 10, 30, values=values[1], sizes=(9, 10))
    Jc, Pc = JA + JB, PA + PB
    assert Pc.sparse_sizes() == (12, 10)
    _assert_same(Jc, Pc, caches=False)
    assert Pc.is_coalesced()
    if all(values):
        np.testing.assert_allclose(
            _np(Pc.to_dense()),
            np.pad(_np(PA.to_dense()), ((0, 0), (0, 3)))
            + np.pad(_np(PB.to_dense()), ((0, 3), (0, 0))), rtol=1e-6,
            atol=1e-6)


_GRAD_CASES = {
    "A + B": lambda A, B: A + B,
    "A + A.t()": lambda A, B: A + A.t(),
    "coalesce sum": lambda A, B: A.coalesce("sum"),
    "coalesce mean": lambda A, B: A.coalesce("mean"),
    "coalesce max": lambda A, B: A.coalesce("max"),
    "coalesce min": lambda A, B: A.coalesce("min"),
}


@pytest.mark.parametrize("case", list(_GRAD_CASES))
def test_add_and_coalesce_value_gradients_match_jax(case):
    """Merged duplicates keep the gradient to the values, as under
    ``jax.grad`` (the JAX package reduces traced values on the device)."""
    import jax

    op = _GRAD_CASES[case]
    JA, PA = _pair(8, 12, 12, 90, sizes=(12, 12))  # duplicate draws
    JB, PB = _pair(9, 12, 12, 50, sizes=(12, 12))
    n_out = op(PA, PB).nnz()
    g = np.random.RandomState(10).randn(n_out).astype(np.float32)

    def jf(va, vb):
        C = op(JA.set_value(va, layout="coo"), JB.set_value(vb, layout="coo"))
        return jnp.sum(C.storage.value() * g)

    jga, jgb = jax.grad(jf, argnums=(0, 1))(JA.storage.value(),
                                            JB.storage.value())
    va = PA.storage.value().clone().requires_grad_(True)
    vb = PB.storage.value().clone().requires_grad_(True)
    C = op(PA.set_value(va, layout="coo"), PB.set_value(vb, layout="coo"))
    assert C.nnz() == n_out and C.is_coalesced()
    pga, pgb = torch.autograd.grad(
        (C.storage.value() * torch.from_numpy(g)).sum(), (va, vb),
        allow_unused=True)
    np.testing.assert_allclose(pga.numpy(), np.asarray(jga), rtol=1e-5,
                               atol=1e-5)
    if case == "A + B":
        np.testing.assert_allclose(pgb.numpy(), np.asarray(jgb), rtol=1e-5,
                                   atol=1e-5)
    else:
        assert pgb is None and not np.asarray(jgb).any()


def test_a_plus_a_transpose_is_symmetric():
    J, P = _pair(6, 25, 25, 120)
    Ps = P + P.t()
    _assert_same(J + J.t(), Ps, caches=False, summed=True)
    np.testing.assert_allclose(_np(Ps.to_dense()), _np(Ps.to_dense()).T,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_broadcast_add_matches_jax(kind, values, dt):
    J, P = _pair(7, 6, 5, 14, dt, values, sizes=(6, 5))
    shape = (6, 1) if kind == "row" else (1, 5)
    other = np.random.RandomState(8).randn(*shape).astype(np.float32)
    Jc = jts.add(J, jnp.asarray(other))
    Pc = pts.add(P, torch.from_numpy(other))
    _assert_same(Jc, Pc, caches=False)
    if values and dt == "f32":
        # every edge, duplicates included, gets its row's (col's) entry
        row, col, v = (_np(x) for x in P.coo())
        per_edge = other[row, 0] if kind == "row" else other[0, col]
        want = np.zeros((6, 5))
        np.add.at(want, (row, col), v.astype(np.float64) + per_edge)
        np.testing.assert_allclose(_np(Pc.to_dense()), want, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="broadcast"):
        pts.add(P, torch.zeros(3, 3))


def test_broadcast_add_keeps_trailing_dims():
    J, P = _pair(9, 6, 5, 14, width=3, sizes=(6, 5))
    other = np.random.RandomState(10).randn(6, 1, 3).astype(np.float32)
    _assert_same(jts.add(J, jnp.asarray(other)),
                 pts.add(P, torch.from_numpy(other)), caches=False)


@pytest.mark.parametrize("layout", ["coo", "csc"])
@pytest.mark.parametrize("values", [True, False])
def test_add_nnz_matches_jax(values, layout):
    J, P = _pair(11, 10, 8, 30, values=values, sizes=(10, 8))
    other = np.random.RandomState(12).randn(P.nnz()).astype(np.float32)
    Jc = jts.add_nnz(J, jnp.asarray(other), layout=layout)
    Pc = pts.add_nnz(P, torch.from_numpy(other), layout=layout)
    _assert_same(Jc, Pc, caches=False)
    assert P.add_nnz_(torch.from_numpy(other), layout).nnz() == P.nnz()


# ---------------------------------------------------------------------
# get_diag
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "f16", "bf16", "i32"])
def test_get_diag_matches_jax(dt):
    """The counterpart of ``tests/test_diag.py::test_get_diag``."""
    row, col = np.array([0, 0, 1, 2]), np.array([0, 1, 2, 2])
    value = np.array([[1, 1], [2, 2], [3, 3], [4, 4]], np.float32)
    P = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(value).to(
        PDT[dt]), device="cpu")
    J = jts.SparseTensor(row=row, col=col,
                         value=jnp.asarray(value).astype(JDT[dt]))
    assert _np(P.get_diag()).tolist() == _np(J.get_diag()).tolist() == \
        [[1, 1], [0, 0], [4, 4]]
    assert P.get_diag().dtype == PDT[dt]
    P1 = pts.SparseTensor(row=row, col=col, device="cpu")
    J1 = jts.SparseTensor(row=row, col=col)
    assert P1.get_diag().tolist() == np.asarray(J1.get_diag()).tolist() == \
        [1, 0, 1]
    assert P1.get_diag().dtype == torch.float32


@pytest.mark.parametrize("sizes", [(20, 20), (20, 13), (13, 20)])
def test_get_diag_random_matches_jax(sizes):
    J, P = _pair(13, sizes[0], sizes[1], 200, sizes=sizes)
    J, P = J.coalesce(), P.coalesce()
    got = pts.get_diag(P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jts.get_diag(J)))
    np.testing.assert_array_equal(got.numpy(), np.diag(_np(P.to_dense())))
    E = pts.SparseTensor(row=np.zeros(0, np.int64), col=np.zeros(0, np.int64),
                         value=torch.zeros(0), sparse_sizes=sizes,
                         device="cpu")
    assert E.get_diag().tolist() == [0.0] * min(sizes)


def test_pipeline_ops_compose():
    """``remove_diag().set_diag(ones)``, ``get_diag`` and ``spspmm_diag``
    of ``A + A^T`` agree with the JAX package."""
    J, P = _pair(14, 30, 30, 200, sizes=(30, 30))
    J, P = J.coalesce(), P.coalesce()
    Js, Ps = J + J.t(), P + P.t()
    Jd = Js.remove_diag().set_diag(jnp.ones(30, jnp.float32))
    Pd = Ps.remove_diag().set_diag(torch.ones(30))
    _assert_same(Jd, Pd, caches=False)
    np.testing.assert_array_equal(Pd.get_diag().numpy(), np.ones(30))
    np.testing.assert_allclose(pts.spspmm_diag(Pd, Pd).numpy(),
                               np.asarray(jts.spspmm_diag(Jd, Jd)),
                               rtol=1e-6)
