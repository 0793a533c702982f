"""The port's SpMM gradients, the transpose passes and the GCN train step
against the JAX package on the same numpy inputs (CPU, where each
kernel runs its plain version), plus the new kernels' plain versions
against host oracles.

Gradients are compared through ``<spmm(A, x), gout>`` for a seeded
``gout``: ``grad_value`` and ``grad_x`` against ``jax.grad`` of the JAX
``spmm`` (or of its routed custom-VJP primitive where a prebuilt hybrid
or dense view must be kept).  Tolerances (max |diff| / max |ref|):
1e-5 for float32 (summation order differs), 1e-4 where a block or dense
store is bf16 (JAX splits the f32 operand or cotangent into bf16 terms,
the port multiplies it exactly), 1e-2 for float16/bfloat16 operands
(gradients are rounded to the operand's dtype).  Three Adam steps agree
with three ``optax.adam`` steps to 1e-4 of the largest parameter
magnitude: both compute the same update, but a coordinate whose gradient
is near Adam's epsilon can differ in its last bits.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.models import GCN as JGCN
from pytorch_sparse_tpu.models import gcn_norm as jgcn_norm
from pytorch_sparse_tpu.ops.kernels import hybrid as jhyb
from pytorch_sparse_tpu.ops.matmul import _hybrid_spmm_sum
from pytorch_sparse_tpu.ops.matmul import spmm as jspmm
from pytorch_sparse_tpu_torch.models import GCN, gcn_norm
from pytorch_sparse_tpu_torch.ops.kernels import (
    block_spmm_t, block_spmm_t_plain, csr_spmm, edge_dot, edge_dot_plain)
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.ops.matmul import spmm as pspmm
from pytorch_sparse_tpu_torch.storage import SparseStorage
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.testing import rel_err
from test_torch_spmm import _graph, _hybrid_pair, _pair, _x

# The op packages re-export functions under their modules' names.
pmatmul = importlib.import_module("pytorch_sparse_tpu_torch.ops.matmul")
ed_mod = importlib.import_module(
    "pytorch_sparse_tpu_torch.ops.kernels.edge_dot")


def _jax_grads(fwd, v, x, gout):
    """``jax.grad`` of ``<fwd(v, x), gout>`` w.r.t. ``v`` (when not None)
    and ``x``, as float32 numpy arrays."""
    if v is None:
        gx = jax.grad(lambda xx: (fwd(None, xx).astype(jnp.float32)
                                  * gout).sum())(x)
        return None, np.asarray(gx.astype(jnp.float32))
    gv, gx = jax.grad(
        lambda vv, xx: (fwd(vv, xx).astype(jnp.float32) * gout).sum(),
        argnums=(0, 1))(v, x)
    return np.asarray(gv), np.asarray(gx.astype(jnp.float32))


def _port_grads(B, x, gout, reduce):
    """Port gradients of ``<spmm(B, x), gout>`` w.r.t. ``B``'s value
    (when it has one) and ``x``.  The value is made a leaf that requires
    grad in place, so a prebuilt hybrid view stays installed."""
    v = B.storage.value()
    inputs = [x.requires_grad_(True)]
    if v is not None:
        inputs.insert(0, v.requires_grad_(True))
    out = pspmm(B, x, reduce)
    assert out.dtype == x.dtype
    grads = torch.autograd.grad(out, inputs, torch.from_numpy(gout).to(
        out.dtype))
    gx = grads[-1].float().numpy()
    return (grads[0].numpy() if v is not None else None), gx


def _jax_value(A):
    v = A.storage.value()
    return None if v is None else jnp.asarray(v)


def _csr_case(A, B, x, reduce, dtype=None, tol=1e-5):
    xj, xp = jnp.asarray(x), torch.from_numpy(x)
    if dtype is not None:
        xj, xp = xj.astype(getattr(jnp, dtype)), xp.to(getattr(torch, dtype))
    out_shape = x.shape[:-2] + (A.sparse_size(0), x.shape[-1])
    gout = _x(99, *out_shape)

    def fwd(v, xx):
        return jspmm(A if v is None else A.set_value(v, layout="coo"), xx,
                     reduce)

    gv_j, gx_j = _jax_grads(fwd, _jax_value(A), xj, jnp.asarray(gout))
    gv_p, gx_p = _port_grads(B, xp, gout, reduce)
    assert not B.storage.has_hybrid()
    assert rel_err(gx_p, gx_j) <= tol
    if gv_j is not None:
        assert rel_err(gv_p, gv_j) <= tol
    return gv_p, gx_p


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 40, 128])
def test_csr_route_grads_match_jax(K, values, reduce):
    A, B = _graph(0, 60, 50, 500, values=values)
    _csr_case(A, B, _x(1, 50, K), reduce)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_csr_route_grads_empty_rows(reduce):
    A, B = _graph(2, 40, 30, 200, empty_rows=True)
    gv, gx = _csr_case(A, B, _x(3, 30, 40), reduce)
    assert np.all(np.isfinite(gx)) and np.all(np.isfinite(gv))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_csr_route_grads_batched_operand(reduce):
    A, B = _graph(4, 35, 25, 150)
    _, gx = _csr_case(A, B, _x(5, 3, 25, 12), reduce)
    assert gx.shape == (3, 25, 12)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_csr_route_grads_half_operands(dtype):
    A, B = _graph(6, 50, 45, 400)
    _csr_case(A, B, _x(7, 45, 40), "sum", dtype=dtype, tol=1e-2)


def _routed_case(A, B, h_jax, x, reduce, tol):
    """Gradients through a prebuilt hybrid or dense view: JAX's routed
    custom-VJP primitive (divided by the degree for ``mean``, as its
    ``spmm_mean`` does) against the port's public ``spmm``."""
    row, col = A.storage.row(), A.storage.col()
    deg = jnp.maximum(A.storage.rowcount(), 1).astype(jnp.float32)
    gout = _x(98, A.sparse_size(0), x.shape[1])

    def fwd(v, xx):
        out = _hybrid_spmm_sum(h_jax, row, col, v, xx)
        return out / deg[:, None] if reduce == "mean" else out

    gv_j, gx_j = _jax_grads(fwd, _jax_value(A), jnp.asarray(x),
                            jnp.asarray(gout))
    hp = B.storage.hybrid(auto=False)
    gv_p, gx_p = _port_grads(B, torch.from_numpy(x), gout, reduce)
    assert B.storage.hybrid(auto=False) is hp  # the routed path ran
    assert rel_err(gx_p, gx_j) <= tol
    assert rel_err(gv_p, gv_j) <= tol


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("B_blk", [16, 32])
@pytest.mark.parametrize("store,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-4)])
def test_hybrid_route_grads_match_jax(store, tol, B_blk, reduce):
    A, B, hj, hp = _hybrid_pair(store, B_blk)
    assert 0 < hp.dense_nnz < B.nnz() and hp.rest_t is not None
    _routed_case(A, B, hj, _x(9, 100, 24), reduce, tol)


@pytest.mark.parametrize("store,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-4)])
def test_dense_route_grads_match_jax(store, tol):
    rng = np.random.RandomState(10)
    M, N, E = 70, 60, 1500
    row, col = rng.randint(0, M, E), rng.randint(0, N, E)
    A, B = _pair(row, col, rng.randn(E).astype(np.float32), (M, N))
    A, B = A.coalesce(), B.coalesce()
    r = A.storage.numpy_view("row")
    c = A.storage.numpy_view("col")
    v = np.asarray(A.storage.value())
    dj = jhyb.build_dense(
        r, c, v, M, N, dtype=None if store == "float32" else jnp.bfloat16)
    B.storage.set_hybrid_(phyb.build_dense(
        r, c, v, M, N, device="cpu",
        dtype=None if store == "float32" else torch.bfloat16))
    _routed_case(A, B, dj, _x(11, N, 33), "sum", tol)


@pytest.mark.parametrize("store,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-4)])
def test_hybrid_spmm_t_matches_jax(store, tol):
    A, B, hj, hp = _hybrid_pair(store, 16)
    np.testing.assert_array_equal(hp.order_t.numpy(), np.asarray(hj.order_t))
    # cb_ptr is the port's pointer over the JAX schedule's column blocks.
    scol = np.asarray(hj.slot_col)[np.asarray(hj.order_t)]
    C = -(-100 // 16)
    np.testing.assert_array_equal(
        hp.cb_ptr.numpy(), np.searchsorted(scol, np.arange(C + 1)))
    assert np.all(np.diff(scol) >= 0)
    g = _x(12, 120, 20)
    # HIGHEST: the JAX block pass emulates f32 products with bf16 terms.
    out_j = np.asarray(jhyb.hybrid_spmm_t(
        hj, jnp.asarray(g), precision=jax.lax.Precision.HIGHEST))
    out_p = phyb.hybrid_spmm_t(hp, torch.from_numpy(g))
    assert out_p.shape == (100, 20)
    assert rel_err(out_p, out_j) <= tol
    if store == "float32":  # a bf16 store quantized the values
        assert rel_err(out_p, B.to_dense().numpy().T @ g) <= tol


@pytest.mark.parametrize("M,E,route", [(2048, 40_000, "HybridFormat"),
                                       (128, 10_000, "DenseFormat")])
def test_trained_value_rebuilds_routed_view(M, E, route, monkeypatch):
    """Optimizer steps write a trainable value in place; every later
    forward on the hybrid or dense route must use the new values, as the
    CSR route (which reads them live) does."""
    monkeypatch.setattr(SparseStorage, "_HYBRID_B", 16)
    monkeypatch.setattr(SparseStorage, "_HYBRID_MIN_EDGES", 1000)
    A = pcommunity(M, E, n_comm=8, seed=1, equal_sizes=True, device="cpu")
    st = A.storage
    v = st.value().requires_grad_(True)
    x = torch.from_numpy(_x(24, M, 8))
    gout = torch.from_numpy(_x(25, M, 8))
    opt = torch.optim.Adam([v], lr=0.1)
    views = []
    for _ in range(3):  # two steps, then the forward after the second
        out = pspmm(A, x)
        views.append(st.hybrid(auto=False))
        assert type(views[-1]).__name__ == route
        ref = csr_spmm(st.rowptr(), st.col(), v.detach(), x)
        assert rel_err(out.detach(), ref) <= 1e-5
        opt.zero_grad()
        (out * gout).sum().backward()
        grad_ref = edge_dot(st.rowptr(), st.col(), x, gout)
        assert rel_err(v.grad, grad_ref) <= 1e-6
        opt.step()
    assert views[0] is not views[1] and views[1] is not views[2]


def test_dense_spmm_t_matches_transpose():
    A, B = _graph(13, 50, 40, 600)
    B = B.coalesce()
    d = phyb.build_dense(B.storage.numpy_view("row"),
                         B.storage.numpy_view("col"),
                         B.storage.value().numpy(), 50, 40, device="cpu")
    g = _x(14, 50, 9)
    assert rel_err(phyb.dense_spmm_t(d, torch.from_numpy(g)),
                   B.to_dense().numpy().T @ g) <= 1e-6


def test_edge_dot_plain_matches_float64_loop(monkeypatch):
    rng = np.random.RandomState(15)
    deg = rng.randint(0, 6, 30)
    deg[::7] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.randint(0, 20, rowptr[-1]).astype(np.int32)
    x, g = _x(16, 20, 37), _x(17, 30, 37)
    ref = np.zeros(rowptr[-1])
    for r in range(30):
        for e in range(rowptr[r], rowptr[r + 1]):
            ref[e] = np.dot(x[col[e]].astype(np.float64),
                            g[r].astype(np.float64))
    # A small chunk bound drives the chunked loop over several chunks.
    monkeypatch.setattr(ed_mod, "_PLAIN_CHUNK_ELEMS", 37 * 7)
    args = [torch.from_numpy(a) for a in (rowptr, col, x, g)]
    before = edge_dot.launches
    out = edge_dot(*args)
    assert edge_dot.launches == before  # the CPU runs the plain version
    assert out.shape == (rowptr[-1],) and out.dtype == torch.float32
    assert rel_err(out, ref) <= 1e-6
    assert torch.equal(out, edge_dot_plain(*args))


@pytest.mark.parametrize("B,K", [(8, 5), (6, 130)])
def test_block_t_plain_version_matches_dense_oracle(B, K):
    """``blocks^T @ g`` against the dense matrix's transpose, with block
    and K sizes that are not multiples of the kernel's tiles."""
    rng = np.random.RandomState(18)
    R, C, nb = 3, 4, 7
    keys = np.sort(rng.choice(R * C, nb, replace=False))
    slot_row, slot_col = keys // C, keys % C
    order_t = np.argsort(slot_col, kind="stable")
    cb_ptr = np.searchsorted(slot_col[order_t], np.arange(C + 1))
    blocks = rng.randn(nb + 1, B, B).astype(np.float32)
    blocks[nb] = 0
    dense = np.zeros((R * B, C * B), np.float32)
    for s in range(nb):
        r, c = slot_row[s], slot_col[s]
        dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = blocks[s]
    gb = _x(19, R * B, K)
    i32 = [torch.from_numpy(a.astype(np.int32))
           for a in (slot_row, order_t, cb_ptr)]
    before = block_spmm_t.launches
    out = block_spmm_t(torch.from_numpy(blocks), *i32, torch.from_numpy(gb))
    assert block_spmm_t.launches == before
    assert out.shape == (C * B, K)
    assert rel_err(out, dense.T @ gb) <= 1e-6
    assert torch.equal(out, block_spmm_t_plain(torch.from_numpy(blocks),
                                               *i32, torch.from_numpy(gb)))


def test_new_wrappers_raise_off_cpu_without_a_kernel():
    rowptr = torch.tensor([0, 1, 2], dtype=torch.int32, device="meta")
    col = torch.tensor([1, 0], dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        edge_dot(rowptr, col, torch.empty(2, 3, device="meta"),
                 torch.empty(2, 3, device="meta"))
    i32 = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError):
        block_spmm_t(torch.empty(2, 4, 4, device="meta"), i32, i32,
                     torch.tensor([0, 1], dtype=torch.int32, device="meta"),
                     torch.empty(4, 3, device="meta"))


@pytest.mark.parametrize("route", ["csr", "hybrid"])
def test_backward_computes_only_requested_grads(route, monkeypatch):
    """A GCN-style backward (operand grad only) runs no edge dot and
    keeps no operand for it; a value-only backward runs no transpose
    pass."""
    calls = {"edge_dot": 0, "transpose": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(pmatmul, "edge_dot",
                        count("edge_dot", pmatmul.edge_dot))
    if route == "csr":
        _, B = _graph(20, 40, 30, 300)
        monkeypatch.setattr(pmatmul, "csr_spmm",
                            count("transpose", pmatmul.csr_spmm))
        x = torch.from_numpy(_x(21, 30, 8))
    else:
        _, B, _, _ = _hybrid_pair("float32", 16)
        monkeypatch.setattr(pmatmul, "hybrid_spmm_t",
                            count("transpose", pmatmul.hybrid_spmm_t))
        x = torch.from_numpy(_x(21, 100, 8))
    v = B.storage.value()
    x.requires_grad_(True)
    out = pspmm(B, x)
    assert out.grad_fn.saved_tensors[1] is None  # no operand kept
    out.sum().backward()
    fwd_csr = 1 if route == "csr" else 0  # the CSR forward counts too
    assert calls == {"edge_dot": 0, "transpose": 1 + fwd_csr}
    x.requires_grad_(False)
    v.requires_grad_(True)
    out = pspmm(B, x)
    assert out.grad_fn.saved_tensors[1] is not None
    out.sum().backward()
    assert calls == {"edge_dot": 1, "transpose": 1 + 2 * fwd_csr}
    assert v.grad is not None and v.grad.shape == v.shape


def test_backward_is_not_differentiated_twice():
    """The kernels have no backward of their own, so a second derivative
    raises instead of silently dropping terms."""
    _, B = _graph(22, 20, 15, 60)
    x = torch.from_numpy(_x(23, 15, 4)).requires_grad_(True)
    gx, = torch.autograd.grad(pspmm(B, x).pow(2).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.sum().backward()


# ----------------------------------------------------------------------
# GCN training
# ----------------------------------------------------------------------

def _adj_pair(seed, M, E):
    A, B = _graph(seed, M, M, E, values=False)
    return jgcn_norm(A.coalesce()), gcn_norm(B.coalesce())


def _gcn_setup(layers, widths, seed=2, M=90):
    An, Bn = _adj_pair(1, M, 600)
    params = JGCN.init(jax.random.PRNGKey(seed), *widths, num_layers=layers)
    rng = np.random.RandomState(seed)
    for layer in params["layers"]:  # non-zero biases get gradients too
        layer["b"] = jnp.asarray(
            rng.randn(*layer["b"].shape).astype(np.float32) * 0.1)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    x = _x(3, M, widths[0])
    labels = np.random.RandomState(4).randint(0, widths[-1], M)
    mask = (np.random.RandomState(5).rand(M) < 0.4).astype(np.float32)
    return An, Bn, params, np_params, x, labels, mask


def _torch_param_grads(model):
    return [p.grad.numpy() for pair in zip(model.weights, model.biases)
            for p in pair]


def _jax_param_list(tree):
    return [np.asarray(layer[k]) for layer in tree["layers"]
            for k in ("w", "b")]


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("layers,widths", [(2, (16, 32, 7)),
                                           (3, (16, 32, 7))])
def test_gcn_loss_and_grads_match_jax(layers, widths, use_mask):
    An, Bn, params, np_params, x, labels, mask = _gcn_setup(layers, widths)
    jmask = jnp.asarray(mask) if use_mask else None
    loss_j, grads_j = jax.value_and_grad(JGCN.loss)(
        params, An, jnp.asarray(x), jnp.asarray(labels), jmask)
    model = GCN.from_jax_params(np_params, device="cpu")
    loss_p = model.loss(Bn, torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(mask) if use_mask else None)
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    got, ref = _torch_param_grads(model), _jax_param_list(grads_j)
    assert len(got) == 2 * layers
    for g_p, g_j in zip(got, ref):
        assert g_p.shape == g_j.shape
        assert rel_err(g_p, g_j) <= 1e-5


def test_three_adam_steps_match_optax():
    An, Bn, params, np_params, x, labels, mask = _gcn_setup(3, (16, 32, 7))
    xj, yj, mj = jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)
    opt = optax.adam(1e-2)
    state = opt.init(params)
    losses_j = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(JGCN.loss)(params, An, xj, yj, mj)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))

    model = GCN.from_jax_params(np_params, device="cpu")
    adam = torch.optim.Adam(model.parameters(), lr=1e-2)
    xt, yt, mt = (torch.from_numpy(a) for a in (x, labels, mask))
    losses_p = []
    for _ in range(3):
        adam.zero_grad()
        loss = model.loss(Bn, xt, yt, mt)
        loss.backward()
        adam.step()
        losses_p.append(loss.item())
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-5)
    assert losses_p[2] < losses_p[0]
    for p, q in zip([p.detach().numpy() for pair in
                     zip(model.weights, model.biases) for p in pair],
                    _jax_param_list(params)):
        assert np.abs(p - q).max() <= 1e-4 * np.abs(q).max()


def test_gcn_dropout_is_seeded_and_scaled():
    _, Bn = _adj_pair(6, 80, 500)
    model = GCN(12, 64, 5, num_layers=2, device="cpu")
    x = torch.from_numpy(_x(7, 80, 12))
    y = torch.from_numpy(np.random.RandomState(8).randint(0, 5, 80))

    def loss(seed):
        gen = torch.Generator().manual_seed(seed)
        return model.loss(Bn, x, y, dropout_rate=0.5, generator=gen)

    assert loss(3).item() == loss(3).item()
    assert loss(3).item() != loss(4).item()
    with torch.no_grad():
        assert torch.equal(model(Bn, x, dropout_rate=0.0), model(Bn, x))

    # The hidden layer is relu(A (x W) + b), then the mask; an identity
    # head exposes its first columns in the logits.
    w, b = model.weights[0], model.biases[0]
    with torch.no_grad():
        pre = torch.relu(pts.spmm_sum(Bn, x @ w) + b)
        gen = torch.Generator().manual_seed(9)
        keep = torch.rand(pre.shape, generator=gen) >= 0.25
        model.weights[1].copy_(torch.eye(64)[:, :5])
        model.biases[1].zero_()
        logits = model(Bn, x, dropout_rate=0.25,
                       generator=torch.Generator().manual_seed(9))
    expect = pts.spmm_sum(Bn, torch.where(keep, pre / 0.75, 0.0)[:, :5])
    assert torch.allclose(logits, expect, atol=1e-6)
    share = keep.float().mean().item()
    assert abs(share - 0.75) < 0.02
