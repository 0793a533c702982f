"""Routed views follow every write to a storage's values.

The hybrid and dense routes multiply through stores that hold copies of
the values.  After any write to ``value``, an in-place optimizer step or
a write through ``.data`` (which bumps no version counter), the next
routed product, forward and backward, must equal the CSR route on the
new values and a fresh JAX product of them (the JAX package's values are
immutable, so a fresh computation is its reference).  Tolerance: 1e-5
of max |ref| (float32 sums in another order).
"""

import importlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_sparse_tpu.ops.matmul import spmm as jspmm
from pytorch_sparse_tpu.tensor import SparseTensor as JSparseTensor
from pytorch_sparse_tpu_torch import SparseTensor
from pytorch_sparse_tpu_torch.ops.kernels import csr_spmm
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phyb
from pytorch_sparse_tpu_torch.ops.matmul import spmm as pspmm
from pytorch_sparse_tpu_torch.storage import SparseStorage
from pytorch_sparse_tpu_torch.testing import community_graph as pcommunity
from pytorch_sparse_tpu_torch.testing import rel_err

bs = importlib.import_module("pytorch_sparse_tpu_torch.ops.kernels.block_spmm")

ROUTES = [(2048, 40_000, "HybridFormat"), (128, 10_000, "DenseFormat")]


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.fixture
def small_router(monkeypatch):
    monkeypatch.setattr(SparseStorage, "_HYBRID_B", 16)
    monkeypatch.setattr(SparseStorage, "_HYBRID_MIN_EDGES", 1000)


def _graph(M, E, seed=1):
    return pcommunity(M, E, n_comm=8, seed=seed, equal_sizes=True,
                      device="cpu")


def _store(h):
    return h.dense if isinstance(h, phyb.DenseFormat) else h.blocks


def _csr_and_jax(A, v, x, gout):
    """The CSR route's forward and ``grad_x`` on values ``v``, and JAX's
    fresh forward on the same numpy inputs."""
    st = A.storage
    out = csr_spmm(st.rowptr(), st.col(), v, x)
    grad_x = csr_spmm(st.colptr(), st.csc_row(), v[st.csr2csc().long()],
                      gout)
    J = JSparseTensor(row=jnp.asarray(st.numpy_view("row")),
                      col=jnp.asarray(st.numpy_view("col")),
                      value=jnp.asarray(v.numpy()),
                      sparse_sizes=A.sparse_sizes(), is_sorted=True)
    return out, grad_x, np.asarray(jspmm(J, jnp.asarray(x.numpy()), "sum"))


@pytest.mark.parametrize("M,E,route", ROUTES)
@pytest.mark.parametrize("write", ["data", "inplace"])
def test_untracked_write_reaches_the_routed_product(M, E, route, write,
                                                    small_router):
    A = _graph(M, E)
    v = A.storage.value()
    x = torch.from_numpy(_x(2, M, 8)).requires_grad_(True)
    gout = torch.from_numpy(_x(3, M, 8))
    pspmm(A, x)  # builds the view from the first values
    h0 = A.storage.hybrid(auto=False)
    assert type(h0).__name__ == route
    new = torch.from_numpy(_x(4, v.shape[0]))
    if write == "data":
        v.data.copy_(new)  # no version counter moves
    else:
        with torch.no_grad():
            v.copy_(new)
    out = pspmm(A, x)
    grad_x, = torch.autograd.grad(out, x, gout)
    ref, ref_gx, jref = _csr_and_jax(A, new, x.detach(), gout)
    assert rel_err(out.detach(), ref) <= 1e-5
    assert rel_err(out.detach(), jref) <= 1e-5
    assert rel_err(grad_x, ref_gx) <= 1e-5
    h1 = A.storage.hybrid(auto=False)
    assert type(h1).__name__ == route and h1 is not h0
    assert A.storage.hybrid(auto=False) is h1  # unchanged values: kept


@pytest.mark.parametrize("M,E,route", ROUTES)
def test_optimizer_step_refreshes_without_a_host_rebuild(M, E, route,
                                                         small_router,
                                                         monkeypatch):
    A = _graph(M, E)
    st = A.storage
    v = st.value().requires_grad_(True)
    x = torch.from_numpy(_x(5, M, 8))
    gout = torch.from_numpy(_x(6, M, 8))
    opt = torch.optim.SGD([v], lr=0.5)
    views = []
    for step in range(3):
        out = pspmm(A, x)
        views.append(st.hybrid(auto=False))
        if step == 0:  # the structure is built once, on the host
            def no_rebuild(*a, **k):
                raise AssertionError("the view was rebuilt on the host")
            monkeypatch.setattr(phyb, "build_hybrid", no_rebuild)
            monkeypatch.setattr(phyb, "build_dense", no_rebuild)
        assert rel_err(out.detach(), _csr_and_jax(
            A, v.detach(), x, gout)[0]) <= 1e-5
        opt.zero_grad()
        (out * gout).sum().backward()
        opt.step()
    assert views[0] is not views[1] and views[1] is not views[2]
    for a, b in zip(views, views[1:]):
        assert a.index is b.index  # one structure, new stores
        if route == "HybridFormat":
            assert a.slot_row is b.slot_row and a.order_t is b.order_t


def test_refresh_leaves_the_old_store_to_a_pending_backward(small_router):
    """A refresh writes a new store: a backward still pending on the old
    view computes with the values its forward used."""
    M = 2048
    A = _graph(M, 40_000)
    v = A.storage.value()
    old_v = v.clone()
    x = torch.from_numpy(_x(7, M, 8)).requires_grad_(True)
    gout = torch.from_numpy(_x(8, M, 8))
    out0 = pspmm(A, x)
    blocks0 = A.storage.hybrid(auto=False).blocks
    kept = blocks0.clone()
    v.data.mul_(-3.0)
    out1 = pspmm(A, x)
    assert torch.equal(blocks0, kept)
    g0, = torch.autograd.grad(out0, x, gout)
    g1, = torch.autograd.grad(out1, x, gout)
    assert rel_err(g0, _csr_and_jax(A, old_v, x.detach(), gout)[1]) <= 1e-5
    assert rel_err(g1, _csr_and_jax(A, v, x.detach(), gout)[1]) <= 1e-5


@pytest.mark.parametrize("M,E,route", ROUTES)
def test_a_refresh_frees_the_old_store_first(M, E, route, small_router,
                                              monkeypatch):
    """In a training loop (forward, backward, a write, the next forward
    while the last step's output is still alive) the old store is freed
    before the new one is written, so one store is held at a time."""
    A = _graph(M, E)
    v = A.storage.value()
    x = torch.from_numpy(_x(14, M, 8)).requires_grad_(True)
    gout = torch.from_numpy(_x(15, M, 8))
    out = pspmm(A, x)
    (out * gout).sum().backward()
    old = weakref.ref(_store(A.storage.hybrid(auto=False)))
    freed = []
    for name in ("_block_store", "_dense_store"):
        def writer(*a, _f=getattr(phyb, name), **k):
            freed.append(old() is None)
            return _f(*a, **k)
        monkeypatch.setattr(phyb, name, writer)
    new = torch.from_numpy(_x(16, v.shape[0]))
    v.data.copy_(new)
    out = pspmm(A, x)
    assert freed == [True]
    grad_x, = torch.autograd.grad(out, x, gout)
    ref, ref_gx, _ = _csr_and_jax(A, new, x.detach(), gout)
    assert rel_err(out.detach(), ref) <= 1e-5
    assert rel_err(grad_x, ref_gx) <= 1e-5


def test_a_trained_store_is_never_overwritten(small_router):
    M = 2048
    A = _graph(M, 40_000)
    h = phyb.build_hybrid_from_tensor(A, B=16)
    h.blocks.requires_grad_(True)
    A.storage.set_hybrid_(h)
    kept = h.blocks.detach().clone()
    A.storage.value().data.mul_(2.0)
    assert A.storage.hybrid(auto=False) is h
    assert torch.equal(h.blocks.detach(), kept)


def test_a_view_that_cannot_follow_writes_is_refused(small_router):
    A = _graph(2048, 40_000)
    h = phyb.build_hybrid_from_tensor(A, B=16)
    bare = phyb.HybridFormat(h.blocks, h.slot_row, h.slot_col, h.rb_ptr,
                             h.order_t, h.cb_ptr, h.rest, h.rest_t, h.M, h.N,
                             h.B, h.dense_nnz)
    A.storage.set_hybrid_(bare)
    with pytest.raises(RuntimeError, match="StoreIndex"):
        A.storage.hybrid()


def test_bf16_store_is_dropped_when_new_values_do_not_fit(small_router):
    """Implicit-one-like values fit a bf16 store at budget 0; values that
    do not fit send the router back to an f32 store."""
    M = 2048
    A = _graph(M, 40_000)
    v = A.storage.value()
    v.data.fill_(1.0)
    x = torch.from_numpy(_x(9, M, 8))
    pspmm(A, x)
    assert _store(A.storage.hybrid(auto=False)).dtype == torch.bfloat16
    new = torch.from_numpy(_x(10, v.shape[0]))
    v.data.copy_(new)
    out = pspmm(A, x)
    assert _store(A.storage.hybrid(auto=False)).dtype == torch.float32
    assert rel_err(out, _csr_and_jax(A, new, x, x)[0]) <= 1e-5


@pytest.mark.parametrize("B", [16, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_duplicates_refresh_as_they_build(B, dtype):
    """Duplicate edges add up left to right in edge order, at the build
    and at every refresh alike, and a bf16 store is the f32 sums rounded
    once; a ragged B pads the store's rows."""
    rng = np.random.RandomState(11)
    M, E = 4 * B, 6 * B * B // 4
    row, col = rng.randint(0, M, E), rng.randint(0, M, E)
    row[: E // 4], col[: E // 4] = row[E // 4: E // 2], col[E // 4: E // 2]
    A = SparseTensor(row=row, col=col, value=_x(12, E), sparse_sizes=(M, M),
                     device="cpu")
    assert not A.is_coalesced()
    st = A.storage
    h = phyb.build_hybrid(st.numpy_view("row"), st.numpy_view("col"),
                          st.value(), M, M, B=B, min_density=0.0,
                          block_dtype=dtype, device="cpu")
    st.set_hybrid_(h)

    def expected(vals):
        want = torch.zeros((h.nb + 1) * B * B, dtype=torch.float32)
        ids = np.arange(E)
        rr, cc = st.numpy_view("row"), st.numpy_view("col")
        key = (rr // B) * (-(-M // B)) + cc // B
        slot = np.searchsorted(np.unique(key), key)
        flat = (slot * B + rr % B) * B + cc % B
        for e in ids:  # left to right, in f32
            want[flat[e]] += vals[e]
        return want.view(h.nb + 1, B, B).to(dtype)

    assert torch.equal(h.blocks, expected(st.value()))
    new = torch.from_numpy(_x(13, E))
    st.value().data.copy_(new)
    h1 = st.hybrid(auto=False)
    assert h1 is not h and torch.equal(h1.blocks, expected(new))
    Bp = bs.store_pitch(B, dtype)
    assert h1.blocks.stride() == (B * Bp, Bp, 1)
    assert bs.store_layout(h1.blocks).data_ptr() == h1.blocks.data_ptr()
