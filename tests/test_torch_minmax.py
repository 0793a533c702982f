"""The port's SpMM min/max (forward with argout, and its gradients)
against the JAX package on the same numpy inputs (CPU, where each kernel
runs its plain version).

The reference is the JAX package's ELL path, ``ts.spmm_min`` and
``ts.spmm_max`` run eagerly.  ``out`` and ``arg`` must be exactly equal
in float32, float16 and bfloat16: both round each product once in the
operand's dtype and keep the first CSR edge on ties.  Gradients agree
with ``jax.grad`` to 1e-5 of max |ref| in float32 (summation order
differs) and 1e-2 for half operands (JAX computes the backward in the
operand's dtype, the port in float32).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu import segment as jseg
from pytorch_sparse_tpu.ops.matmul import _spmm_max, _spmm_min
from pytorch_sparse_tpu_torch import segment as pseg
from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm_minmax_plain, minmax_edge_dot_plain, minmax_spmm_t_plain)
from pytorch_sparse_tpu_torch.ops.matmul import spmm as pspmm
from pytorch_sparse_tpu_torch.testing import rel_err
from test_torch_spmm import _graph, _pair, _x

# The op packages re-export functions under their modules' names.
pmatmul = importlib.import_module("pytorch_sparse_tpu_torch.ops.matmul")
mm_mod = importlib.import_module(
    "pytorch_sparse_tpu_torch.ops.kernels.spmm_minmax")

JFN = {"min": jts.spmm_min, "max": jts.spmm_max}
PFN = {"min": pts.spmm_min, "max": pts.spmm_max}


def _both(A, B, x, reduce, dtype=None):
    """``(out, arg)`` of both packages as numpy (out widened to f32)."""
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    if dtype is not None:
        xj, xp = xj.astype(getattr(jnp, dtype)), xp.to(getattr(torch, dtype))
    oj, aj = JFN[reduce](A, xj)
    op, ap = PFN[reduce](B, xp)
    assert op.dtype == xp.dtype and ap.dtype == torch.int32
    torch.testing.assert_close(pspmm(B, xp, reduce), op, rtol=0, atol=0,
                               equal_nan=True)
    return ((np.asarray(oj.astype(jnp.float32)), np.asarray(aj)),
            (op.float().numpy(), ap.numpy()))


def _assert_exact(j, p):
    np.testing.assert_array_equal(p[1], j[1])  # arg
    np.testing.assert_array_equal(p[0], j[0])  # out (NaN equals NaN)


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 40, 128])
def test_minmax_matches_jax_exactly(K, values, reduce):
    A, B = _graph(0, 60, 50, 500, values=values)
    _assert_exact(*_both(A, B, _x(1, 50, K), reduce))
    assert not B.storage.has_hybrid() and B.storage._hybrid_skip is None


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_empty_rows_give_zero_and_the_sentinel(reduce):
    A, B = _graph(2, 40, 30, 200, empty_rows=True)
    j, p = _both(A, B, _x(3, 30, 40), reduce)
    _assert_exact(j, p)
    assert np.all(p[0][20:] == 0) and np.all(p[1][20:] == B.nnz())


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("values", [True, False])
def test_minmax_ties_keep_the_first_csr_edge(values, reduce):
    rng = np.random.RandomState(4)
    row, col = rng.randint(0, 30, 600), rng.randint(0, 25, 600)
    val = rng.randint(-2, 3, 600).astype(np.float32) if values else None
    A, B = _pair(row, col, val, (30, 25))
    x = rng.randint(-2, 3, (25, 16)).astype(np.float32)
    j, p = _both(A, B, x, reduce)
    _assert_exact(j, p)
    # The inputs do tie: count (row, k) whose extreme several edges reach.
    r, c, v = B.coo()
    h = torch.from_numpy(x)[c.long()]
    if v is not None:
        h = h * v[:, None]
    hits = (h == torch.from_numpy(p[0])[r.long()]).to(torch.int32)
    ties = pseg.segment_sum(hits, r.long(), 30)
    assert int((ties > 1).sum()) > 100
    first = B.storage.rowptr()[:-1].numpy()[:, None]
    assert np.all(p[1] >= first)


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_infinite_candidates(reduce):
    """An all -inf (max) or all +inf (min) row-column gives that infinity
    and the row's FIRST edge, not the sentinel."""
    A, B = _graph(5, 40, 30, 300, values=False)
    rng = np.random.RandomState(6)
    x = _x(7, 30, 24)
    x[rng.rand(30, 24) < 0.3] = -np.inf
    x[rng.rand(30, 24) < 0.1] = np.inf
    extreme = np.inf if reduce == "min" else -np.inf
    x[:, 0] = extreme
    j, p = _both(A, B, x, reduce)
    _assert_exact(j, p)
    rowptr = B.storage.rowptr().numpy()
    nonempty = rowptr[1:] > rowptr[:-1]
    assert np.all(p[0][nonempty, 0] == extreme)
    np.testing.assert_array_equal(p[1][nonempty, 0], rowptr[:-1][nonempty])


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_nan_follows_the_ell_path(reduce):
    """A NaN candidate wins, and the first NaN edge is the argout: the
    answer of the JAX ELL path that ``ts.spmm_max`` runs.  JAX's segment
    path (``_spmm_min``/``_spmm_max``) gives the same NaN ``out`` but the
    sentinel ``E`` as ``arg``, since ``NaN != NaN``: a reference-side
    difference (ROADMAP C), not followed."""
    row = np.array([0, 0, 0, 1, 1, 2, 2])
    col = np.array([0, 1, 2, 0, 1, 1, 2])
    A, B = _pair(row, col, None, (4, 3))
    x = np.array([[1.0, -np.inf], [np.nan, -np.inf], [np.nan, -np.inf]],
                 np.float32)
    j, p = _both(A, B, x, reduce)
    _assert_exact(j, p)
    np.testing.assert_array_equal(p[1], [[1, 0], [4, 3], [5, 5], [7, 7]])
    assert np.isnan(p[0][:3, 0]).all() and np.all(p[0][3] == 0)
    seg = _spmm_min if reduce == "min" else _spmm_max
    out_s, arg_s = seg(4, jnp.asarray(row), jnp.asarray(col), None,
                       jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(out_s), p[0])
    np.testing.assert_array_equal(np.asarray(arg_s)[:3, 0], [7, 7, 7])


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_batched_operand(reduce):
    A, B = _graph(8, 35, 25, 150)
    j, p = _both(A, B, _x(9, 3, 25, 12), reduce)
    _assert_exact(j, p)
    assert p[1].shape == (3, 35, 12)


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_minmax_half_operands_compare_in_their_dtype(dtype, reduce):
    """Each product is rounded to the operand's dtype before it is
    compared, as JAX computes it: arg and out agree exactly, near-ties
    included (the uniform N(0, 1) inputs round many products together)."""
    A, B = _graph(10, 50, 45, 400)
    _assert_exact(*_both(A, B, _x(11, 45, 40), reduce, dtype))


def test_plain_versions_chunk_alike(monkeypatch):
    """The plain versions' chunking (a row longer than the budget stays
    one chunk) changes no result."""
    rng = np.random.RandomState(12)
    row = np.concatenate([rng.randint(0, 30, 300), np.full(90, 4)])
    col = rng.randint(0, 20, 390)
    _, B = _pair(row, col, rng.randn(390).astype(np.float32), (30, 20))
    rowptr, c, v = B.csr()
    st = B.storage
    x = torch.from_numpy(_x(13, 20, 8))
    g = torch.from_numpy(_x(14, 30, 8))
    outs = []
    for budget in (1 << 24, 64):
        monkeypatch.setattr(mm_mod, "_PLAIN_CHUNK_ELEMS", budget)
        out, arg = csr_spmm_minmax_plain(rowptr, c, v, x, False)
        outs.append((out, arg, minmax_edge_dot_plain(rowptr, c, x, g, arg),
                     minmax_spmm_t_plain(st.colptr(), st.csc_row(),
                                         st.csr2csc(), v, g, arg)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _grad_case(A, B, x, reduce, dtype=None, tol=1e-5):
    """``jax.grad`` of ``<spmm_<reduce>(A, x)[0], gout>`` against the
    port's autograd, for the value (when there is one) and ``x``."""
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    if dtype is not None:
        xj, xp = xj.astype(getattr(jnp, dtype)), xp.to(getattr(torch, dtype))
    out_shape = x.shape[:-2] + (A.sparse_size(0), x.shape[-1])
    gout = _x(97, *out_shape)
    vj = A.storage.value()

    def loss(v, xx):
        a = A if v is None else A.set_value(v, layout="coo")
        return (JFN[reduce](a, xx)[0].astype(jnp.float32) * gout).sum()

    if vj is None:
        gv_j, gx_j = None, jax.grad(lambda xx: loss(None, xx))(xj)
    else:
        gv_j, gx_j = jax.grad(loss, argnums=(0, 1))(vj, xj)
    xp.requires_grad_(True)
    inputs = [xp]
    if B.storage.value() is not None:
        v = B.storage.value().clone().requires_grad_(True)
        B = B.set_value(v, layout="coo")
        inputs.insert(0, v)
    out, _ = PFN[reduce](B, xp)
    grads = torch.autograd.grad(out, inputs,
                                torch.from_numpy(gout).to(out.dtype))
    assert grads[-1].dtype == xp.dtype
    assert rel_err(grads[-1].float(), np.asarray(gx_j.astype(jnp.float32))
                   ) <= tol
    if gv_j is not None:
        assert grads[0].dtype == torch.float32
        assert rel_err(grads[0], np.asarray(gv_j)) <= tol
    return grads


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 40])
def test_minmax_grads_match_jax(K, values, reduce):
    A, B = _graph(15, 60, 50, 500, values=values)
    _grad_case(A, B, _x(16, 50, K), reduce)


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_grads_empty_rows_and_batched(reduce):
    A, B = _graph(17, 40, 30, 200, empty_rows=True)
    _grad_case(A, B, _x(18, 30, 24), reduce)
    A, B = _graph(19, 35, 25, 150)
    gv, gx = _grad_case(A, B, _x(20, 3, 25, 12), reduce)
    assert gx.shape == (3, 25, 12)


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_minmax_grads_half_operands(dtype, reduce):
    A, B = _graph(21, 50, 45, 400)
    _grad_case(A, B, _x(22, 45, 40), reduce, dtype=dtype, tol=1e-2)


@pytest.mark.parametrize("wanted", ["value", "x", "both"])
def test_minmax_backward_runs_only_the_requested_kernels(monkeypatch, wanted):
    calls = []
    for name in ("minmax_edge_dot", "minmax_spmm_t"):
        fn = getattr(pmatmul, name)
        monkeypatch.setattr(pmatmul, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n)
                            or _f(*a))
    _, B = _graph(23, 30, 20, 120)
    v = B.storage.value().clone().requires_grad_(wanted != "x")
    x = torch.from_numpy(_x(24, 20, 8)).requires_grad_(wanted != "value")
    out, _ = pts.spmm_max(B.set_value(v, layout="coo"), x)
    out.sum().backward()
    want = {"value": ["minmax_edge_dot"], "x": ["minmax_spmm_t"],
            "both": ["minmax_edge_dot", "minmax_spmm_t"]}[wanted]
    assert calls == want


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_minmax_grads_ignore_non_finite_losers(reduce):
    """An operand entry that is infinite at an edge that did not win
    gives no gradient term: the port's grad_value stays finite.  JAX
    multiplies its 0/1 routing by that entry and gets NaN there: a
    reference-side difference (ROADMAP C)."""
    row, col = np.array([0, 0, 1]), np.array([0, 1, 1])
    val = np.array([1.0, 2.0, 3.0], np.float32)
    A, B = _pair(row, col, val, (2, 2))
    # Edge 0 reads x[0], which loses row 0 to edge 1's 2 * 5.
    loser = -np.inf if reduce == "max" else np.inf
    x = np.array([[loser], [5.0]], np.float32)
    v = torch.from_numpy(val).requires_grad_(True)
    out, arg = PFN[reduce](B.set_value(v, layout="coo"), torch.from_numpy(x))
    np.testing.assert_array_equal(arg.numpy(), [[1], [2]])
    out.sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), [0.0, 5.0, 5.0])
    gv = jax.grad(lambda vv: JFN[reduce](A.set_value(vv, layout="coo"),
                                         jnp.asarray(x))[0].sum())(
        jnp.asarray(val))
    assert np.isnan(np.asarray(gv)[0])
    np.testing.assert_array_equal(np.asarray(gv)[1:], [5.0, 5.0])


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_segment_min_max_match_jax(reduce):
    rng = np.random.RandomState(25)
    data = rng.randn(50, 3).astype(np.float32)
    ids = np.sort(rng.randint(0, 12, 50)) * 2  # odd segments stay empty
    jfn = jseg.segment_min if reduce == "min" else jseg.segment_max
    pfn = pseg.segment_min if reduce == "min" else pseg.segment_max
    ref = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), 25))
    got = pfn(torch.from_numpy(data), torch.from_numpy(ids), 25)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.all(ref[1::2] == 0)
