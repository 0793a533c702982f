"""``save_npz``/``load_npz`` and the profiler hooks of the port, on the
CPU.

Round trips keep every storage field, cache and routed view bit for bit;
a restored view serves ``spmm`` without a host rebuild.  Each package
reads the other's storage fields: the port skips the JAX package's TPU
views (``_ell*``, ``_hybrid.*``), and the JAX package ignores the port's
(``_view.*``).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu_torch.ops.kernels import hybrid as phybrid
from pytorch_sparse_tpu_torch.utils import annotate, timed, trace

FIELDS = ("row", "rowptr", "col", "value", "rowcount", "colptr", "colcount",
          "csr2csc", "csc2csr")


def _graph(seed=0, M=40, E=160, dtype=torch.float32, value=True, N=None):
    rng = np.random.RandomState(seed)
    N = M if N is None else N
    pos = rng.choice(M * N, E, replace=False)
    row, col = pos // N, pos % N
    v = rng.randn(E).astype(np.float32)
    return pts.SparseTensor(
        row=row, col=col,
        value=torch.from_numpy(v).to(dtype) if value else None,
        sparse_sizes=(M, N), device="cpu"), (row, col, v)


def _field(st, f):
    t = getattr(st, f"_{f}")
    return None if t is None else t.detach()


def _same_storage(a, b):
    sa, sb = a.storage, b.storage
    assert sa.sparse_sizes() == sb.sparse_sizes()
    assert sa.cached_keys() == sb.cached_keys()
    for f in FIELDS:
        x, y = _field(sa, f), _field(sb, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            assert torch.equal(x, y), f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64, None])
@pytest.mark.parametrize("fill", [False, True])
def test_round_trip(tmp_path, dtype, fill):
    A, _ = _graph(value=dtype is not None,
                  dtype=dtype or torch.float32)
    if fill:
        A.fill_cache_()
    path = str(tmp_path / "a.npz")
    pts.save_npz(path, A)
    B = pts.load_npz(path, device="cpu")
    _same_storage(A, B)
    assert B.storage.numpy_view("col").dtype == np.int64
    if dtype is not None:
        assert B.storage.value().dtype == dtype
    assert torch.equal(A.to_dense(), B.to_dense())


def test_round_trip_rowptr_only(tmp_path):
    A, _ = _graph(M=30, N=20, E=90)
    C = pts.SparseTensor(rowptr=A.storage.rowptr(), col=A.storage.col(),
                         value=A.storage.value(), sparse_sizes=(30, 20),
                         device="cpu")
    assert not C.storage.has_row()
    path = str(tmp_path / "c.npz")
    pts.save_npz(path, C)
    D = pts.load_npz(path, device="cpu")
    assert not D.storage.has_row()
    _same_storage(C, D)
    assert torch.equal(C.storage.row(), D.storage.row())


def _community(seed=3, M=96):
    """One dense community block plus a random remainder (the JAX
    package's ``test_npz_roundtrip_hybrid`` graph)."""
    rng = np.random.RandomState(seed)
    r = np.concatenate([rng.randint(0, 32, 600), rng.randint(0, M, 200)])
    c = np.concatenate([rng.randint(0, 32, 600), rng.randint(0, M, 200)])
    v = rng.randn(800).astype(np.float32)
    return pts.SparseTensor(row=r, col=c, value=torch.from_numpy(v),
                            sparse_sizes=(M, M), device="cpu").coalesce(
        "add")


def _no_builds(monkeypatch):
    """Make any host build of a view fail."""
    def refuse(*a, **k):
        raise AssertionError("a view was built after the load")

    for name in ("build_hybrid", "build_dense"):
        monkeypatch.setattr(phybrid, name, refuse)
    monkeypatch.setattr(phybrid.StoreIndex, "__init__", refuse)


@pytest.mark.parametrize("kind", ["hybrid", "hybrid_bf16", "aligned",
                                  "dense", "dense_bf16", "implicit_ones"])
def test_routed_view_round_trip_serves_the_same_bits(tmp_path, monkeypatch,
                                                     kind):
    A = _community()
    if kind == "implicit_ones":
        A = A.set_value(None)
    M = A.sparse_size(0)
    store = torch.bfloat16 if kind.endswith("bf16") else None
    if kind.startswith("dense"):
        h = phybrid.build_dense(A.storage.numpy_view("row"),
                                A.storage.numpy_view("col"),
                                A.storage.value(), M, M, dtype=store,
                                device="cpu")
    else:
        h = phybrid.build_hybrid_from_tensor(
            A, B=32, min_density=0.3, block_dtype=store,
            partptr=[0, 40, M] if kind == "aligned" else None)
        assert h.nb > 0 and h.rest is not None
    A.storage.set_hybrid_(h)
    x = torch.from_numpy(np.random.RandomState(5).randn(M, 16).astype(
        np.float32))
    want = pts.spmm_sum(A, x)
    path = str(tmp_path / "v.npz")
    pts.save_npz(path, A)
    _no_builds(monkeypatch)
    B = pts.load_npz(path, device="cpu")
    h2 = B.storage.hybrid(auto=False)
    assert type(h2) is type(h)
    got = pts.spmm_sum(B, x)
    assert torch.equal(got, want)
    assert B.storage.hybrid(auto=False) is h2  # served, not refreshed
    store2 = phybrid.store_of(h2)
    assert store2.dtype == phybrid.store_of(h).dtype
    if kind.startswith("hybrid") or kind == "aligned":
        assert (h2.M, h2.N, h2.B, h2.nb, h2.dense_nnz, h2.M_pad) == (
            h.M, h.N, h.B, h.nb, h.dense_nnz, h.M_pad)
        # The same padded buffer the block kernels read.
        layout = phybrid.store_layout(h2.blocks)
        assert layout.data_ptr() == h2.blocks.data_ptr()
        assert torch.equal(layout, phybrid.store_layout(h.blocks))
        assert (h2.row_map is None) == (kind != "aligned")
    # A write to the values reaches the restored view as it reaches the
    # original (a refresh on the device, no host build).
    if kind != "implicit_ones":
        B.storage.value().data.mul_(2.0)
        A.storage.value().data.mul_(2.0)
        assert torch.equal(pts.spmm_sum(B, x), pts.spmm_sum(A, x))
    # The gradient of the operand is the transpose product.
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    pts.spmm_sum(A, xa).sum().backward()
    pts.spmm_sum(B, xb).sum().backward()
    assert torch.equal(xa.grad, xb.grad)


def test_view_without_store_index_is_not_saved(tmp_path):
    A = _community()
    h = phybrid.build_hybrid_from_tensor(A, B=32, min_density=0.3)
    h.index = None
    A.storage.set_hybrid_(h)
    with pytest.raises(ValueError, match="StoreIndex"):
        pts.save_npz(str(tmp_path / "x.npz"), A)


def _jax_pair(seed=0, M=40, E=160):
    rng = np.random.RandomState(seed)
    pos = rng.choice(M * M, E, replace=False)
    row, col = pos // M, pos % M
    v = rng.randn(E).astype(np.float32)
    J = jts.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=jnp.asarray(v), sparse_sizes=(M, M))
    P = pts.SparseTensor(row=row, col=col, value=torch.from_numpy(v),
                         sparse_sizes=(M, M), device="cpu")
    return J, P


def _equal_to_jax(P, J):
    """The port's storage fields equal the JAX package's (bf16 values
    compared as float32)."""
    assert P.storage.sparse_sizes() == J.storage.sparse_sizes()
    assert sorted(P.storage.cached_keys()) == sorted(J.storage.cached_keys())
    for f in FIELDS:
        x, y = _field(P.storage, f), getattr(J.storage, f"_{f}")
        assert (x is None) == (y is None), f
        if x is None:
            continue
        y = jnp.asarray(y)
        if y.dtype == jnp.bfloat16:
            assert x.dtype == torch.bfloat16
            x, y = x.float(), y.astype(jnp.float32)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=f)


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_port_reads_a_jax_file(tmp_path, fill, bf16):
    J, _ = _jax_pair(seed=7)
    if bf16:
        J = J.set_value(J.storage.value().astype(jnp.bfloat16), layout="coo")
    if fill:
        J.fill_cache_()
    path = str(tmp_path / "j.npz")
    jts.save_npz(path, J)
    P = pts.load_npz(path, device="cpu")
    _equal_to_jax(P, J)
    assert not P.storage.has_hybrid()


def test_port_skips_the_jax_views(tmp_path):
    """A JAX file with its ELL views and a hybrid view (``_ell*``,
    ``_hybrid.*``) loads in the port, which builds its own view when
    asked."""
    from pytorch_sparse_tpu.ops.kernels.hybrid import (
        build_hybrid_from_tensor as jbuild)

    rng = np.random.RandomState(3)
    M = 96
    r = np.concatenate([rng.randint(0, 32, 600), rng.randint(0, M, 200)])
    c = np.concatenate([rng.randint(0, 32, 600), rng.randint(0, M, 200)])
    key = np.unique(r * M + c)
    r, c = key // M, key % M
    v = rng.randn(r.size).astype(np.float32)
    J = jts.SparseTensor(row=jnp.asarray(r), col=jnp.asarray(c),
                         value=jnp.asarray(v), sparse_sizes=(M, M))
    J.fill_cache_()
    J.storage.ell()
    J.storage.ell_t()
    J.storage.set_hybrid_(jbuild(J, B=32, min_density=0.05))
    path = str(tmp_path / "jh.npz")
    jts.save_npz(path, J)
    with np.load(path) as z:
        keys = z.files
    assert any(k.startswith("_ell") for k in keys)
    assert any(k.startswith("_hybrid.") for k in keys)
    P = pts.load_npz(path, device="cpu")
    _equal_to_jax(P, J)
    assert not P.storage.has_hybrid()
    x = rng.randn(M, 8).astype(np.float32)
    dense = np.zeros((M, M))
    dense[r, c] = v
    ref = dense @ x.astype(np.float64)
    got = pts.spmm_sum(P, torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, None])
def test_jax_reads_a_port_file(tmp_path, fill, dtype):
    _, P = _jax_pair(seed=9)
    if dtype is None:
        P = P.set_value(None)
    elif dtype != torch.float32:
        P = P.set_value(P.storage.value().to(dtype), layout="coo")
    if fill:
        P.fill_cache_()
    path = str(tmp_path / "p.npz")
    pts.save_npz(path, P)
    J = jts.load_npz(path)
    _equal_to_jax(P, J)


def test_jax_reads_a_port_file_with_a_view(tmp_path):
    """The port's ``_view.*`` keys (a bf16 block store with its
    ``.dtype`` record) are no JAX view: JAX loads the storage fields and
    leaves them."""
    A = _community()
    A.storage.set_hybrid_(phybrid.build_hybrid_from_tensor(
        A, B=32, min_density=0.3, block_dtype=torch.bfloat16))
    path = str(tmp_path / "pv.npz")
    pts.save_npz(path, A)
    J = jts.load_npz(path)
    _equal_to_jax(A, J)
    assert not J.storage.has_hybrid()


def test_load_npz_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    A, _ = _graph()
    path = str(tmp_path / "a.npz")
    pts.save_npz(path, A)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.load_npz(path)
    assert pts.load_npz(path, device="cpu").device().type == "cpu"


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    A, _ = _graph()
    x = torch.randn(40, 8)
    with trace(str(tmp_path), device="cpu"):
        with annotate("port-spmm-region"):
            pts.spmm_sum(A, x)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port-spmm-region" for e in events)


def test_trace_on_the_card_raises_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with trace(str(tmp_path)):
            pass


def test_timed_returns_seconds_and_the_result():
    A, _ = _graph()
    x = torch.randn(40, 8)
    calls = []

    def fn(a, b, scale=1.0):
        calls.append(1)
        return pts.spmm_sum(a, b) * scale

    secs, out = timed(fn, A, x, iters=3, warmup=1, scale=2.0)
    assert isinstance(secs, float) and secs > 0
    assert len(calls) == 4
    assert torch.equal(out, pts.spmm_sum(A, x) * 2.0)
