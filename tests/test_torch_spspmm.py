"""The port's SpSpMM (structure plan, ``plan_numeric``, chunked and
streaming paths, ``spspmm_diag``, the block split and the
``block_spgemm_window`` pass) against the JAX package on the same numpy
inputs (CPU, where each kernel runs its plain version).

Tolerances (max |diff| / max |ref|): structure and term order exactly;
float32 values 1e-6 (the JAX package sums each output's terms through
bucket tables, the port in term order); float16/bfloat16 1e-2 (the JAX
package multiplies and sums in the half dtype, the port in float32 and
rounds once); gradients 1e-5; block products 1e-5 against JAX at
``Precision.HIGHEST`` (full float32 on both sides, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.ops import spgemm as jspgemm
from pytorch_sparse_tpu.ops.kernels import block_spgemm as jbs
from pytorch_sparse_tpu.ops.matmul import _spspmm_structure as jstructure
from pytorch_sparse_tpu.testing import community_graph as jcommunity
from pytorch_sparse_tpu_torch.ops import spgemm as pspgemm
from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spgemm_plan, block_spgemm_stream, block_spgemm_window,
    block_spgemm_window_plain, plan_numeric, plan_numeric_plain)
from pytorch_sparse_tpu_torch.ops.matmul import (
    _spspmm_structure as pstructure)
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.testing import rel_err

JDT = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16}
PDT = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}
TOL = {"f32": 1e-6, "f16": 1e-2, "bf16": 1e-2}


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if jnp.issubdtype(
        jnp.asarray(x).dtype, jnp.floating) else np.asarray(x)


def _mat(seed, M, N, density, dt="f32", values=True):
    """One random (M, N) matrix as scipy (the unrounded float64 values
    rounded to ``dt``), a JAX and a port SparseTensor."""
    coo = sp.random(M, N, density=density, format="csr",
                    random_state=np.random.RandomState(seed)).tocoo()
    v32 = coo.data.astype(np.float32)
    tv = torch.from_numpy(v32).to(PDT[dt])
    S = sp.csr_matrix((tv.double().numpy(), (coo.row, coo.col)),
                      shape=(M, N))
    J = jts.SparseTensor(row=coo.row, col=coo.col,
                         value=(jnp.asarray(v32).astype(JDT[dt])
                                if values else None), sparse_sizes=(M, N))
    P = pts.SparseTensor(row=coo.row, col=coo.col,
                         value=tv if values else None, sparse_sizes=(M, N),
                         device="cpu")
    return S, J, P


def _pair(dt="f32", va=True, vb=True, M=60, N=50, P=45, seed=1):
    Sa, Ja, Pa = _mat(seed, M, N, 0.15, dt, va)
    Sb, Jb, Pb = _mat(seed + 100, N, P, 0.12, dt, vb)
    return Sa, Sb, Ja, Jb, Pa, Pb


def _coo_of(T):
    return (_np(T.storage.row()), _np(T.storage.col()),
            _np(T.storage.value()))


def _assert_structure_equal(Jc, Pc):
    for name in ("row", "col"):
        np.testing.assert_array_equal(_np(getattr(Jc.storage, name)()),
                                      _np(getattr(Pc.storage, name)()))
    assert Jc.sparse_sizes() == Pc.sparse_sizes()


# ---------------------------------------------------------------------
# The structure pass
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rng_rows", [None, (10, 40), (0, 0), (59, 60)])
@pytest.mark.parametrize("seed", [1, 2])
def test_structure_matches_jax(seed, rng_rows):
    Sa, Sb, Ja, Jb, Pa, Pb = _pair(seed=seed)
    rp = Pa.storage.numpy_view("rowptr")
    lo, hi = (0, Pa.nnz()) if rng_rows is None else (
        int(rp[rng_rows[0]]), int(rp[rng_rows[1]]))
    ja_pos, jb_pos, _, _, n_out, jrow, jcol = jstructure(Ja, Jb, lo, hi)
    a_pos, b_pos, t_ptr, rowC, colC = pstructure(Pa, Pb, lo, hi)
    np.testing.assert_array_equal(np.asarray(ja_pos), a_pos)
    np.testing.assert_array_equal(np.asarray(jb_pos), b_pos)
    np.testing.assert_array_equal(np.asarray(jrow), rowC)
    np.testing.assert_array_equal(np.asarray(jcol), colC)
    assert t_ptr.shape == (n_out + 1,) and t_ptr[-1] == a_pos.shape[0]
    # each output entry's terms are exactly the run t_ptr points at
    row_t = Pa.storage.numpy_view("row")[a_pos]
    col_t = Pb.storage.numpy_view("col")[b_pos]
    seg = np.repeat(np.arange(n_out), np.diff(t_ptr))
    np.testing.assert_array_equal(row_t, rowC[seg])
    np.testing.assert_array_equal(col_t, colC[seg])


def test_structure_keeps_cancelled_entries():
    """An output entry whose terms cancel stays in the structure (the
    JAX package keeps every entry; scipy would drop the zero)."""
    A = pts.SparseTensor(row=[0, 0], col=[0, 1], value=torch.tensor(
        [1.0, -1.0]), sparse_sizes=(1, 2), device="cpu")
    B = pts.SparseTensor(row=[0, 1], col=[0, 0], value=torch.tensor(
        [1.0, 1.0]), sparse_sizes=(2, 1), device="cpu")
    C = A @ B
    assert C.nnz() == 1 and C.storage.value().tolist() == [0.0]


# ---------------------------------------------------------------------
# Values: single shot
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "f16", "bf16"])
@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_spspmm_values_match_jax(dt, sides):
    Sa, Sb, Ja, Jb, Pa, Pb = _pair(dt, *sides)
    Jc, Pc = Ja @ Jb, Pa @ Pb
    _assert_structure_equal(Jc, Pc)
    jv, pv = Jc.storage.value(), Pc.storage.value()
    if sides == (False, False):
        assert jv is None and pv is None
        return
    assert pv.dtype == PDT[dt]
    assert rel_err(_np(pv), _np(jv)) <= TOL[dt]
    # and against scipy's float64 product of the same (rounded) operands
    Sa1 = Sa if sides[0] else (Sa != 0).astype(np.float64)
    Sb1 = Sb if sides[1] else (Sb != 0).astype(np.float64)
    ref = (Sa1 @ Sb1).toarray()
    got = Pc.to_dense(dtype=torch.float32).double().numpy()
    assert rel_err(got, ref) <= TOL[dt]


def test_spspmm_mixed_dtypes_promote():
    Sa, _, Ja, _, Pa, _ = _pair("f32")
    Sb, Jb, Pb = _mat(5, 50, 45, 0.12, "f16")
    Jc, Pc = Ja @ Jb, Pa @ Pb
    assert Pc.storage.value().dtype == torch.float32
    assert Jc.storage.value().dtype == jnp.float32
    assert rel_err(_np(Pc.storage.value()), _np(Jc.storage.value())) <= 1e-6


@pytest.mark.parametrize("which", ["A", "B", "both", "disjoint"])
def test_spspmm_empty_operands(which):
    M = N = P = 5
    full = ([0, 1, 3], [1, 2, 4], [1.0, 2.0, 3.0])
    empty = ([], [], [])
    # "disjoint": A's columns meet none of B's rows
    ra, ca, va = {"A": empty, "both": empty, "B": full,
                  "disjoint": ([0, 1], [0, 0], [1.0, 2.0])}[which]
    rb, cb, vb = {"B": empty, "both": empty, "A": full,
                  "disjoint": ([3, 4], [1, 2], [1.0, 2.0])}[which]
    out = []
    for mk in (lambda r, c, v: jts.SparseTensor(
                   row=np.asarray(r, np.int64), col=np.asarray(c, np.int64),
                   value=jnp.asarray(v, jnp.float32), sparse_sizes=(M, N)),
               lambda r, c, v: pts.SparseTensor(
                   row=np.asarray(r, np.int64), col=np.asarray(c, np.int64),
                   value=torch.tensor(v, dtype=torch.float32),
                   sparse_sizes=(M, N), device="cpu")):
        out.append(mk(ra, ca, va) @ mk(rb, cb, vb))
    Jc, Pc = out
    assert Pc.nnz() == Jc.nnz() == 0 and Pc.sparse_sizes() == (M, P)
    assert Pc.storage.value().shape == (0,)
    assert Pc.storage.value().dtype == torch.float32


def test_legacy_spspmm_matches_jax():
    """The counterpart of ``tests/test_spspmm.py::test_spspmm``."""
    indexA = np.array([[0, 0, 1, 2, 2], [1, 2, 0, 0, 1]])
    valueA = np.array([1, 2, 3, 4, 5], np.float32)
    indexB = np.array([[0, 2], [1, 0]])
    valueB = np.array([2, 4], np.float32)
    ji, jv = jts.spspmm(jnp.asarray(indexA), jnp.asarray(valueA),
                        jnp.asarray(indexB), jnp.asarray(valueB), 3, 3, 2)
    pi, pv = pts.spspmm(torch.from_numpy(indexA), torch.from_numpy(valueA),
                        torch.from_numpy(indexB), torch.from_numpy(valueB),
                        3, 3, 2)
    assert pi.tolist() == np.asarray(ji).tolist() == [[0, 1, 2], [0, 1, 1]]
    assert pv.tolist() == np.asarray(jv).tolist() == [8, 6, 8]


def test_orthogonal_rows_times_transpose_is_identity():
    """The counterpart of ``tests/test_spspmm.py::
    test_sparse_tensor_spspmm``: X @ X^T = I for orthonormal rows."""
    row = np.array([0, 1, 1, 1, 2, 3, 4, 5, 5, 6, 6, 7, 7, 7, 8, 8, 9, 9])
    col = np.array([0, 5, 10, 15, 1, 2, 3, 7, 13, 6, 9, 5, 10, 15, 11, 14,
                    5, 15])
    value = np.array([1, 3**-0.5, 3**-0.5, 3**-0.5, 1, 1, 1, -2**-0.5,
                      -2**-0.5, -2**-0.5, -2**-0.5, 6**-0.5, -6**0.5 / 3,
                      6**-0.5, -2**-0.5, -2**-0.5, 2**-0.5, -2**-0.5],
                     np.float32)
    X = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(value),
                         device="cpu")
    Xj = jts.SparseTensor(row=row, col=col, value=jnp.asarray(value))
    got = (X @ X.t()).to_dense()
    np.testing.assert_allclose(got.numpy(), np.eye(10), atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray((Xj @ Xj.t()).to_dense()),
                               atol=1e-6)
    assert torch.equal(pts.matmul(X, X.t()).to_dense(), got)
    assert torch.equal(X.spspmm(X.t(), "add").to_dense(), got)


def test_spspmm_tensor_identity():
    """The counterpart of ``tests/test_matmul.py::test_spspmm_tensor``."""
    src = pts.SparseTensor.from_dense(torch.eye(3), device="cpu")
    out = pts.matmul(src, src)
    assert out.sizes() == [3, 3] and out.has_value()
    rowptr, col, value = out.csr()
    assert rowptr.tolist() == [0, 1, 2, 3] and col.tolist() == [0, 1, 2]
    assert value.tolist() == [1, 1, 1]
    src = src.set_value(None)
    out = pts.matmul(src, src)
    assert not out.has_value() and out.csr()[1].tolist() == [0, 1, 2]


def test_spspmm_operand_checks():
    A = pts.SparseTensor(row=[0], col=[1], sparse_sizes=(2, 3), device="cpu")
    with pytest.raises(ValueError, match="columns"):
        A @ A
    B = pts.SparseTensor(row=[0], col=[1], sparse_sizes=(3, 2), device="cpu")
    with pytest.raises(ValueError, match="reduce mode"):
        pts.matmul(A, B, "max")
    assert (A @ B).sparse_sizes() == (2, 2)


# ---------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------

def _jax_grads(Ja, Jb, gout, sides, fn=None):
    fn = fn or (lambda a, b: a @ b)
    ra, ca, va = Ja.storage.row(), Ja.storage.col(), Ja.storage.value()
    rb, cb, vb = Jb.storage.row(), Jb.storage.col(), Jb.storage.value()

    def loss(xa, xb):
        A = jts.SparseTensor(row=ra, col=ca, value=xa,
                             sparse_sizes=Ja.sparse_sizes(), is_sorted=True,
                             trust_data=True)
        B = jts.SparseTensor(row=rb, col=cb, value=xb,
                             sparse_sizes=Jb.sparse_sizes(), is_sorted=True,
                             trust_data=True)
        return (fn(A, B).storage.value() * gout).sum()

    args = (va if sides[0] else None, vb if sides[1] else None)
    argnums = tuple(i for i in (0, 1) if sides[i])
    g = jax.grad(loss, argnums=argnums)(*args)
    out = [None, None]
    for i, gi in zip(argnums, g):
        out[i] = np.asarray(gi)
    return out


def _port_grads(Pa, Pb, gout, sides, fn=None):
    fn = fn or (lambda a, b: a @ b)
    va = Pa.storage.value().clone().requires_grad_(True) if sides[0] \
        else None
    vb = Pb.storage.value().clone().requires_grad_(True) if sides[1] \
        else None
    C = fn(Pa.set_value(va, layout="coo"), Pb.set_value(vb, layout="coo"))
    (C.storage.value() * gout).sum().backward()
    return [None if v is None else v.grad.float().numpy() for v in (va, vb)]


@pytest.mark.parametrize("sides", [(True, True), (True, False),
                                   (False, True)])
@pytest.mark.parametrize("path", ["single", "chunked"])
def test_spspmm_grads_match_jax(sides, path):
    """Both value gradients against ``jax.grad`` of the JAX product
    (its autodiff through the plan); the chunked path at a small term
    budget against the JAX chunked path."""
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", True, True, M=30, N=25, P=22,
                                   seed=6)
    n_out = (Pa @ Pb).nnz()
    gout = np.random.RandomState(7).randn(n_out).astype(np.float32)
    jfn = pfn = None
    if path == "chunked":
        def jfn(a, b):
            return jts.spspmm_chunked(a, b, max_terms=64)

        def pfn(a, b):
            return pts.spspmm_chunked(a, b, max_terms=64)
    jg = _jax_grads(Ja, Jb, jnp.asarray(gout), sides, jfn)
    pg = _port_grads(Pa, Pb, torch.from_numpy(gout), sides, pfn)
    for i in (0, 1):
        if sides[i]:
            assert rel_err(pg[i], jg[i]) <= 1e-5
        else:
            assert pg[i] is None


def test_spspmm_grads_half_dtype():
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("bf16", M=30, N=25, P=22, seed=8)
    n_out = (Pa @ Pb).nnz()
    gout = np.random.RandomState(9).randn(n_out).astype(np.float32)
    jg = _jax_grads(Ja, Jb, jnp.asarray(gout, jnp.bfloat16), (True, True))
    pg = _port_grads(Pa, Pb, torch.from_numpy(gout).to(torch.bfloat16),
                     (True, True))
    for i in (0, 1):
        assert rel_err(pg[i], np.asarray(jg[i], np.float32)) <= 1e-2


# ---------------------------------------------------------------------
# Chunked, large and streaming paths
# ---------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
def test_chunked_matches_single_shot_and_jax(weighted):
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", weighted, weighted, seed=11)
    full = Pa @ Pb
    for max_terms in (64, 1024, 1 << 20):
        ck = pts.spspmm_chunked(Pa, Pb, max_terms=max_terms)
        jck = jts.spspmm_chunked(Ja, Jb, max_terms=max_terms)
        _assert_structure_equal(jck, ck)
        _assert_structure_equal(ck, full)
        if weighted:
            assert rel_err(_np(ck.storage.value()),
                           _np(full.storage.value())) <= 1e-6
            assert rel_err(_np(ck.storage.value()),
                           _np(jck.storage.value())) <= 1e-6
        else:
            assert ck.storage.value() is None


def test_expansion_terms_and_large_dispatch(monkeypatch):
    """Past ``PLAN_MAX_TERMS`` the port always takes the chunked plan,
    where the JAX package takes its native library when built; both give
    the same product."""
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", seed=12)
    assert pts.expansion_terms(Pa, Pb) == jts.expansion_terms(Ja, Jb) == \
        int(np.diff(Sb.indptr)[Sa.tocoo().col].sum())
    full = Pa @ Pb
    calls = []
    real = pspgemm.spspmm_chunked
    monkeypatch.setattr(pspgemm, "spspmm_chunked",
                        lambda a, b, max_terms=pspgemm.PLAN_MAX_TERMS:
                        calls.append(max_terms) or real(a, b, max_terms))
    monkeypatch.setattr(pspgemm, "PLAN_MAX_TERMS", 100)
    monkeypatch.setattr(jspgemm, "PLAN_MAX_TERMS", 100)
    C = Pa @ Pb
    assert len(calls) == 1
    Jc = Ja @ Jb
    _assert_structure_equal(Jc, C)
    _assert_structure_equal(full, C)
    assert rel_err(_np(C.storage.value()), _np(Jc.storage.value())) <= 1e-6


def test_stream_blocks_concatenate():
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", seed=13)
    full = Pa @ Pb
    jblocks = list(jts.spspmm_stream(Ja, Jb, max_terms=512))
    rows, cols, vals, covered = [], [], [], 0
    pblocks = list(pts.spspmm_stream(Pa, Pb, max_terms=512))
    assert [(lo, hi) for lo, hi, _ in pblocks] == \
        [(lo, hi) for lo, hi, _ in jblocks]
    for lo, hi, blk in pblocks:
        assert lo == covered and blk.sparse_size(0) == hi - lo
        covered = hi
        r, c, v = _coo_of(blk)
        rows.append(r + lo)
        cols.append(c)
        vals.append(v)
    assert covered == Pa.sparse_size(0)
    np.testing.assert_array_equal(np.concatenate(rows),
                                  _np(full.storage.row()))
    np.testing.assert_array_equal(np.concatenate(cols),
                                  _np(full.storage.col()))
    assert rel_err(np.concatenate(vals), _np(full.storage.value())) <= 1e-6


@pytest.mark.parametrize("dts", [("f32", "f32"), ("f32", "f16"),
                                 ("bf16", "bf16"), (None, "f16"),
                                 (None, None)])
def test_stream_raw_matches_wrapped(dts):
    """``raw=True`` host triples carry the wrapped blocks' data, values
    in the promoted dtype (bfloat16 widened to float32 on the host)."""
    Sa, Ja, Pa = _mat(14, 40, 40, 0.2, dts[0] or "f32", dts[0] is not None)
    Sb, Jb, Pb = _mat(15, 40, 40, 0.2, dts[1] or "f32", dts[1] is not None)
    got = list(pts.spspmm_stream(Pa, Pb, max_terms=300, raw=True))
    want = list(pts.spspmm_stream(Pa, Pb, max_terms=300))
    jwant = list(jts.spspmm_stream(Ja, Jb, max_terms=300, raw=True))
    assert len(got) == len(want) == len(jwant) > 1
    given = [PDT[d] for d in dts if d]
    promoted = (None if not given else given[0] if len(given) == 1
                else torch.promote_types(*given))
    for (lo, hi, (rp, cc, vv)), (lo2, hi2, blk), (_, _, (jrp, jcc, _)) in \
            zip(got, want, jwant):
        assert (lo, hi) == (lo2, hi2)
        assert isinstance(rp, np.ndarray) and isinstance(cc, np.ndarray)
        np.testing.assert_array_equal(rp, np.asarray(jrp))
        np.testing.assert_array_equal(cc, np.asarray(jcc))
        r2, c2, v2 = blk.coo()
        np.testing.assert_array_equal(cc, c2.numpy())
        np.testing.assert_array_equal(np.diff(rp), np.bincount(
            r2.numpy(), minlength=hi - lo))
        if promoted is None:
            assert vv is None and v2 is None
            continue
        assert v2.dtype == promoted
        want_np = {torch.float32: np.float32, torch.float16: np.float16,
                   torch.bfloat16: np.float32}[promoted]
        assert vv.dtype == want_np
        np.testing.assert_array_equal(vv, v2.float().numpy().astype(want_np))


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("shape", [(30, 25, 30), (20, 30, 40), (40, 30, 20)])
def test_spspmm_diag_matches_jax(weighted, shape):
    M, N, P = shape
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", weighted, weighted, M=M, N=N, P=P,
                                   seed=16)
    got = pts.spspmm_diag(Pa, Pb)
    want = np.asarray(jts.spspmm_diag(Ja, Jb))
    assert got.shape == (min(M, P),) and got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-6
    ref = (Sa @ Sb) if weighted else ((Sa != 0).astype(float)
                                      @ (Sb != 0).astype(float))
    np.testing.assert_allclose(got.numpy(), ref.diagonal()[:min(M, P)],
                               rtol=1e-5, atol=1e-6)


def test_spspmm_diag_empty_operands():
    A = pts.SparseTensor(row=[0, 1], col=[1, 0], value=torch.tensor(
        [2.0, 3.0]), sparse_sizes=(2, 2), device="cpu")
    B = pts.SparseTensor(row=np.zeros(0, np.int64), col=np.zeros(0, np.int64),
                         value=torch.zeros(0), sparse_sizes=(2, 2),
                         device="cpu")
    for X, Y in ((A, B), (B, A), (B, B)):
        assert pts.spspmm_diag(X, Y).tolist() == [0.0, 0.0]
    assert pts.spspmm_diag(A, A).tolist() == [6.0, 6.0]


# ---------------------------------------------------------------------
# plan_numeric and block_spgemm_window: plain versions and arguments
# ---------------------------------------------------------------------

def test_plan_numeric_plain_sums_term_runs():
    x = torch.tensor([1.0, 2.0, 3.0])
    y = torch.tensor([10.0, 20.0])
    i = torch.tensor([0, 2, 1, 1], dtype=torch.int32)
    j = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    t_ptr = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    want = [1 * 20 + 3 * 10, 0.0, 2 * 10 + 2 * 20]
    assert plan_numeric(x, i, y, j, t_ptr).tolist() == want
    assert plan_numeric_plain(x, i, None, None, t_ptr).tolist() == \
        [4.0, 0.0, 4.0]
    assert plan_numeric(x.half(), i, y.bfloat16(), j, t_ptr).dtype == \
        torch.float32
    with pytest.raises(ValueError, match="shape of i"):
        plan_numeric(x, i, y, j[:2], t_ptr)
    with pytest.raises(TypeError, match="int32"):
        plan_numeric(x, i.long(), y, j, t_ptr)


def _blocks(seed, nb, Bb, dtype=torch.float32):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        nb, Bb, Bb).astype(np.float32)).to(dtype)


def test_block_spgemm_window_plain_uneven_and_empty():
    """Uneven pair runs (3, 0, 1 pairs) and an empty window against
    float64 host products."""
    A, B = _blocks(20, 4, 8), _blocks(21, 3, 8)
    a_idx = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    b_idx = torch.tensor([2, 0, 1, 1], dtype=torch.int32)
    seg_ptr = torch.tensor([0, 3, 3, 4], dtype=torch.int32)
    got = block_spgemm_window(A, B, a_idx, b_idx, seg_ptr, 3)
    a, b = A.double().numpy(), B.double().numpy()
    want = np.stack([a[0] @ b[2] + a[3] @ b[0] + a[1] @ b[1],
                     np.zeros((8, 8)), a[2] @ b[1]])
    assert got.dtype == torch.float32 and rel_err(got, want) <= 1e-6
    e = torch.zeros(0, dtype=torch.int32)
    assert block_spgemm_window(A, B, e, e, torch.zeros(1, dtype=torch.int32),
                               0).shape == (0, 8, 8)
    bf = block_spgemm_window_plain(A.bfloat16(), B.bfloat16(), a_idx, b_idx,
                                   seg_ptr, 3)
    want_bf = np.einsum("pij,pjk->pik",
                        A.bfloat16().double().numpy()[a_idx.long()],
                        B.bfloat16().double().numpy()[b_idx.long()])
    assert rel_err(bf[0], want_bf[:3].sum(0)) <= 1e-6
    with pytest.raises(TypeError, match="share a dtype"):
        block_spgemm_window(A, B.bfloat16(), a_idx, b_idx, seg_ptr, 3)
    with pytest.raises(ValueError, match="n_out"):
        block_spgemm_window(A, B, a_idx, b_idx, seg_ptr, 2)


def _random_block_matrix(seed, nb_grid, Bb, p):
    r = np.random.RandomState(seed)
    sr, sc = np.nonzero(r.rand(nb_grid, nb_grid) < p)
    blocks = r.randn(sr.size, Bb, Bb).astype(np.float32)
    return blocks, sr.astype(np.int64), sc.astype(np.int64)


def test_block_spgemm_plan_matches_jax():
    bA, srA, scA = _random_block_matrix(1, 7, 4, 0.4)
    bB, srB, scB = _random_block_matrix(2, 7, 4, 0.5)
    for got, want in zip(block_spgemm_plan(srA, scA, srB, scB),
                         jbs.block_spgemm_plan(srA, scA, srB, scB)):
        np.testing.assert_array_equal(got, want)
    a_idx, b_idx, seg, orow, ocol = block_spgemm_plan(srA, scA, srB, scB)
    assert np.array_equal(scA[a_idx], srB[b_idx])
    assert np.array_equal(orow[seg], srA[a_idx])


@pytest.mark.parametrize("max_out", [3, 100])
def test_block_spgemm_stream_matches_jax_highest(max_out):
    Bb, g = 16, 6
    bA, srA, scA = _random_block_matrix(1, g, Bb, 0.4)
    bB, srB, scB = _random_block_matrix(2, g, Bb, 0.5)
    jout = list(jbs.block_spgemm_stream(
        jnp.asarray(bA), srA, scA, jnp.asarray(bB), srB, scB,
        max_out_blocks=max_out, precision=jax.lax.Precision.HIGHEST))
    pout = list(block_spgemm_stream(torch.from_numpy(bA), srA, scA,
                                    torch.from_numpy(bB), srB, scB,
                                    max_out_blocks=max_out))
    assert len(pout) == len(jout)
    for (r, c, cb), (jr, jc, jcb) in zip(pout, jout):
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_array_equal(c, jc)
        assert cb.shape[0] == r.size <= max_out
        assert rel_err(cb, np.asarray(jcb)) <= 1e-5


# ---------------------------------------------------------------------
# spspmm_stream_device: the block split and the three-way partition
# ---------------------------------------------------------------------

M_COMM = 512


def _community_pair():
    """Two 512-node community graphs (8 equal communities): their
    intra-community blocks are dense at every split below, and most of
    their inter-community edges stay in the remainder."""
    kw = dict(intra_p=0.85, equal_sizes=True)
    Ja = jcommunity(M_COMM, 12000, 8, rng=np.random.RandomState(5), **kw)
    Jb = jcommunity(M_COMM, 9000, 8, rng=np.random.RandomState(6), **kw)
    Pa = pcommunity(M_COMM, 12000, 8, rng=np.random.RandomState(5),
                    device="cpu", **kw)
    Pb = pcommunity(M_COMM, 9000, 8, rng=np.random.RandomState(6),
                    device="cpu", **kw)
    return Ja, Jb, Pa, Pb


def _sum_pieces(pieces, M, P, Bb):
    got = np.zeros((M, P))
    n_blocks = n_coo = 0
    for piece in pieces:
        if piece[0] == "blocks":
            _, rows, cols, cblk = piece
            cb = np.asarray(cblk, np.float64) if not isinstance(
                cblk, torch.Tensor) else cblk.double().numpy()
            for t in range(rows.size):
                got[rows[t] * Bb:(rows[t] + 1) * Bb,
                    cols[t] * Bb:(cols[t] + 1) * Bb] += cb[t]
            n_blocks += rows.size
        else:
            _, lo, hi, blk = piece
            if isinstance(blk, tuple):
                rp, c, v = blk
                r = np.repeat(np.arange(hi - lo), np.diff(rp)) + lo
            else:
                r = _np(blk.storage.row()) + lo
                c, v = _np(blk.storage.col()), _np(blk.storage.value())
            np.add.at(got, (r, c), 1.0 if v is None else v)
            n_coo += c.size
    return got, n_blocks, n_coo


def _dense(T):
    return _np(T.to_dense()).astype(np.float64)


@pytest.mark.parametrize("Bb,mind,bdt", [(32, 0.05, None), (16, 0.02, None),
                                         (32, 0.05, "bf16")])
@pytest.mark.parametrize("raw", [False, True])
def test_stream_device_pieces_sum_to_the_product(Bb, mind, bdt, raw):
    Ja, Jb, Pa, Pb = _community_pair()
    want = _dense(Pa) @ _dense(Pb)
    np.testing.assert_allclose(want, _dense(Ja) @ _dense(Jb), rtol=1e-6,
                               atol=1e-4)
    pieces = list(pts.spspmm_stream_device(
        Pa, Pb, Bb=Bb, min_density=mind, max_out_blocks=7, raw_coo=raw,
        block_dtype=None if bdt is None else torch.bfloat16))
    got, n_blocks, n_coo = _sum_pieces(pieces, M_COMM, M_COMM, Bb)
    assert n_blocks > 0 and n_coo > 0
    if bdt is None:
        assert rel_err(got, want) <= 1e-6
    else:
        # bf16 stores round the dense-block operands: hold the pieces
        # against the product of the rounded blocks, and the JAX pieces.
        assert rel_err(got, want) <= 2e-2
        jgot = _sum_pieces(jspgemm.spspmm_stream_device(
            Ja, Jb, Bb=Bb, min_density=mind, max_out_blocks=7,
            block_dtype=jnp.bfloat16), M_COMM, M_COMM, Bb)[0]
        assert rel_err(got, jgot) <= 1e-5


def test_block_split_matches_jax():
    Ja, _, Pa, _ = _community_pair()
    jb, jsr, jsc, jrem, jn = jspgemm._block_split(Ja, 32, 0.05)
    pb, psr, psc, prem, pn, mask = pspgemm._block_split(Pa, 32, 0.05)
    assert pn == jn == int(mask.sum()) > 0
    np.testing.assert_array_equal(psr, jsr)
    np.testing.assert_array_equal(psc, jsc)
    assert rel_err(pb, np.asarray(jb)) <= 1e-7
    _assert_structure_equal(jrem, prem)
    assert rel_err(_np(prem.storage.value()), _np(jrem.storage.value())) == 0
    assert prem.nnz() + pn == Pa.nnz()
    assert pspgemm._block_split(Pa, 32, 0.99)[0] is None


def test_stream_device_split_b_other_density_reference_defect():
    """Reference defect (``pytorch_sparse_tpu/ops/spgemm.py:394``): the
    JAX package rebuilds ``D_B`` from this call's ``min_density``, so a
    ``split_B`` built with another density breaks the three-way
    partition and its pieces miss terms.  The port takes ``D_B`` from the
    split it was given, and its pieces still sum to the product."""
    Ja, Jb, Pa, Pb = _community_pair()
    want = _dense(Pa) @ _dense(Pb)
    Bb = 32
    p_split_b = pspgemm._block_split(Pb, Bb, 0.005)
    p_pieces = pts.spspmm_stream_device(Pa, Pb, Bb=Bb, min_density=0.05,
                                        split_B=p_split_b)
    assert rel_err(_sum_pieces(p_pieces, M_COMM, M_COMM, Bb)[0], want) <= 1e-6
    j_split_b = jspgemm._block_split(Jb, Bb, 0.005)
    j_pieces = jspgemm.spspmm_stream_device(Ja, Jb, Bb=Bb, min_density=0.05,
                                            split_B=j_split_b)
    assert rel_err(_sum_pieces(j_pieces, M_COMM, M_COMM, Bb)[0], want) > 1e-2


def test_stream_device_without_dense_blocks_streams_everything():
    Sa, Sb, Ja, Jb, Pa, Pb = _pair("f32", M=50, N=50, P=50, seed=17)
    pieces = list(pts.spspmm_stream_device(Pa, Pb, Bb=16, min_density=0.9))
    assert all(p[0] == "coo" for p in pieces)
    got = _sum_pieces(pieces, 50, 50, 16)[0]
    assert rel_err(got, (Sa @ Sb).toarray()) <= 1e-6
    split = pspgemm._block_split(Pa, 16, 0.05)
    with pytest.raises(ValueError, match="block sizes"):
        list(pts.spspmm_stream_device(
            Pa, Pa, split_A=split, split_B=pspgemm._block_split(Pa, 8, 0.05)))
