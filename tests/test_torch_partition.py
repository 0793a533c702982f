"""The port's partitioner against the JAX package's, on the CPU.

The same numpy graphs go through both packages.  The JAX package's
native library is loaded (its default), so its ``partition`` runs the
native multilevel partitioner; the port runs its own copy of that code
(``csrc/host_partition.cpp``), built here with the host C++ compiler.
Both must give the same ``perm``, ``partptr`` and permuted
``row``/``col``/``value``, bit for bit.  The threaded ``mt_partition``
is nondeterministic, so it is held to the contract and to cut and
balance bounds only, as the JAX package's ``tests/test_metis.py`` holds
its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.csrc import bindings as jbindings
from pytorch_sparse_tpu.partition import partition_fn as jpartition_fn
from pytorch_sparse_tpu_torch import _build
from pytorch_sparse_tpu_torch.partition import _native, partition_fn


def _community(seed, M=2048, E=24_000, n_comm=32, p_in=0.85, sym=True):
    """Unique ``(row, col)`` pairs of a planted-community graph (no
    self-loops), symmetric when ``sym``, in random order."""
    rng = np.random.RandomState(seed)
    comm = rng.randint(0, n_comm, M)
    src = rng.randint(0, M, E)
    dst = rng.randint(0, M, E)
    intra = rng.rand(E) < p_in
    for c in range(n_comm):
        members = np.flatnonzero(comm == c)
        sel = intra & (comm[src] == c)
        if members.size:
            dst[sel] = members[rng.randint(0, members.size, int(sel.sum()))]
    if sym:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = np.unique(src.astype(np.int64) * M + dst)
    key = key[key // M != key % M]
    key = key[rng.permutation(key.size)]
    return M, key // M, key % M


def _pair(M, row, col, value=None):
    """The same matrix in both packages (the port's on the CPU)."""
    J = jts.SparseTensor(
        row=jnp.asarray(row), col=jnp.asarray(col),
        value=None if value is None else jnp.asarray(value),
        sparse_sizes=(M, M))
    P = pts.SparseTensor(
        row=row, col=col,
        value=None if value is None else torch.from_numpy(value),
        sparse_sizes=(M, M), device="cpu")
    return J, P


def _same(jout, pout):
    (ja, jpp, jperm), (pa, ppp, pperm) = jout, pout
    assert ppp.dtype == torch.int64 and pperm.dtype == torch.int64
    assert ppp.device.type == "cpu" and pperm.device.type == "cpu"
    np.testing.assert_array_equal(ppp.numpy(), np.asarray(jpp))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))
    for view in ("row", "col"):
        np.testing.assert_array_equal(pa.storage.numpy_view(view),
                                      np.asarray(ja.storage.numpy_view(view)))
    assert sorted(pa.storage.cached_keys()) == sorted(ja.storage.cached_keys())
    jv, pv = ja.storage.value(), pa.storage.value()
    assert (jv is None) == (pv is None)
    if pv is not None:
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def _contract(A_row, A_col, M, out):
    """``partptr`` runs from 0 to ``M`` and never falls, ``perm`` is a
    permutation, and the permuted matrix is the original relabelled
    through ``perm``'s inverse."""
    padj, partptr, perm = out
    pp, pm = partptr.numpy(), perm.numpy()
    assert pp[0] == 0 and pp[-1] == M and (np.diff(pp) >= 0).all()
    assert np.array_equal(np.sort(pm), np.arange(M))
    inv = np.empty(M, np.int64)
    inv[pm] = np.arange(M)
    got = (padj.storage.numpy_view("row") * M
           + padj.storage.numpy_view("col"))
    assert np.array_equal(got, np.sort(inv[A_row] * M + inv[A_col]))


def _cut(out, M):
    padj, partptr, _ = out
    part = np.searchsorted(partptr.numpy(), np.arange(M), side="right") - 1
    r, c = padj.storage.numpy_view("row"), padj.storage.numpy_view("col")
    return float((part[r] != part[c]).mean())


@pytest.fixture(scope="module")
def graph():
    return _community(0)


@pytest.mark.parametrize("num_parts", [1, 2, 4, 8, 13])
def test_partition_unweighted_matches_jax(graph, num_parts):
    M, row, col = graph
    J, P = _pair(M, row, col)
    pout = pts.partition(P, num_parts)
    _same(jts.partition(J, num_parts), pout)
    _contract(row, col, M, pout)


@pytest.mark.parametrize("kind", ["float", "integer"])
def test_partition_weighted_matches_jax(graph, kind):
    M, row, col = graph
    rng = np.random.RandomState(1)
    if kind == "float":
        value = (rng.rand(row.size) * 3 + 0.1).astype(np.float32)
    else:
        value = rng.randint(1, 20, row.size).astype(np.int32)
    J, P = _pair(M, row, col, value)
    _same(jts.partition(J, 4, weighted=True),
          pts.partition(P, 4, weighted=True))
    # Unweighted on the same valued matrix: the values only ride along.
    _same(jts.partition(J, 4), pts.partition(P, 4))


def test_partition_node_weight_matches_jax(graph):
    M, row, col = graph
    nw = (np.random.RandomState(2).rand(M) + 0.5).astype(np.float32)
    J, P = _pair(M, row, col)
    _same(jts.partition(J, 4, node_weight=jnp.asarray(nw)),
          pts.partition(P, 4, node_weight=torch.from_numpy(nw)))
    # A numpy node weight is taken as well.
    _same(jts.partition(J, 4, node_weight=jnp.asarray(nw)),
          P.partition(4, node_weight=nw))


def test_partition_balance_edge_matches_jax(graph):
    M, row, col = graph
    J, P = _pair(M, row, col)
    _same(jts.partition(J, 4, balance_edge=True),
          pts.partition(P, 4, balance_edge=True))
    with pytest.raises(ValueError, match="balance_edge"):
        pts.partition(P, 4, balance_edge=True, node_weight=np.ones(M))


def test_partition_splits_two_cliques():
    """``tests/test_metis.py:41``: two disconnected 8-cliques split
    apart, the permuted matrix block-diagonal, as in the JAX package."""
    pairs = [(off + i, off + j) for off in (0, 8) for i in range(8)
             for j in range(8) if i != j]
    row = np.array([p[0] for p in pairs])
    col = np.array([p[1] for p in pairs])
    J, P = _pair(16, row, col)
    pout = P.partition(num_parts=2)
    _same(J.partition(num_parts=2), pout)
    out, partptr, perm = pout
    assert partptr.tolist() == [0, 8, 16]
    assert sorted(map(tuple, (sorted(perm[:8].tolist()),
                              sorted(perm[8:].tolist())))) == [
        tuple(range(8)), tuple(range(8, 16))]
    r, c, _ = out.coo()
    assert not bool(((r < 8) & (c >= 8)).any())
    assert not bool(((r >= 8) & (c < 8)).any())


@pytest.mark.parametrize("num_parts", [1, 3, 7])
def test_partition_fn_rcm_chunks_match_jax(graph, num_parts):
    M, row, col = graph
    _, P = _pair(M, row, col)
    rowptr = P.storage.numpy_view("rowptr")
    colh = P.storage.numpy_view("col")
    nw = np.random.RandomState(4).rand(M) + 0.5
    for w in (None, nw):
        got = partition_fn(rowptr, colh, num_parts, w, refine=False)
        want = jpartition_fn(rowptr, colh, num_parts, w, refine=False)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < num_parts


@pytest.mark.parametrize("workers", [0, 2])
def test_native_entries_match_jax_library(graph, workers):
    """The host library's entries against the JAX package's native
    library on one graph: the serial entry (and, at 2 workers, the
    threaded one on the contract) and ``coarsen_clusters``."""
    M, row, col = graph
    _, P = _pair(M, row, col)
    rowptr = P.storage.numpy_view("rowptr")
    colh = P.storage.numpy_view("col")
    ew = np.random.RandomState(5).randint(1, 9, colh.size)
    got, cut = _native.multilevel_partition(rowptr, colh, 8, edge_weight=ew,
                                            num_workers=workers)
    if workers == 0:
        want, wcut = jbindings.multilevel_partition(rowptr, colh, 8,
                                                    edge_weight=ew)
        np.testing.assert_array_equal(got, want)
        assert cut == wcut
    assert got.min() >= 0 and got.max() < 8
    for target in (16, 100):
        c1, n1 = _native.coarsen_clusters(rowptr, colh, target)
        c2, n2 = jbindings.coarsen_clusters(rowptr, colh, target)
        assert n1 == n2
        np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("method,fine", [("coarsen", 300), ("auto", 300),
                                         ("partition", 40), ("auto", 40)])
def test_partition_fine_quotient_matches_jax(graph, method, fine):
    M, row, col = graph
    J, P = _pair(M, row, col)
    pout = pts.partition_fine(P, 4, fine_parts=fine, fine_method=method)
    _same(jts.partition_fine(J, 4, fine_parts=fine, fine_method=method),
          pout)
    _contract(row, col, M, pout)


@pytest.mark.parametrize("weighted,with_nw", [(True, False), (False, True),
                                              (True, True)])
@pytest.mark.parametrize("fine", [40, 300])
def test_partition_fine_weighted_passthrough_matches_jax(weighted, with_nw,
                                                         fine):
    M, row, col = _community(11, M=1024, E=12_000, n_comm=16)
    rng = np.random.RandomState(12)
    value = (rng.rand(row.size) + 0.1).astype(np.float32)
    nw = (rng.rand(M) + 0.5).astype(np.float32)
    J, P = _pair(M, row, col, value)
    pout = pts.partition_fine(
        P, 4, fine_parts=fine, weighted=weighted,
        node_weight=torch.from_numpy(nw) if with_nw else None)
    _same(jts.partition_fine(
        J, 4, fine_parts=fine, weighted=weighted,
        node_weight=jnp.asarray(nw) if with_nw else None), pout)
    _contract(row, col, M, pout)


@pytest.mark.parametrize("fine", [32, 300])
def test_partition_fine_within_matches_jax(graph, fine):
    M, row, col = graph
    J, P = _pair(M, row, col)
    pout = pts.partition_fine(P, 4, fine_parts=fine, grouping="within")
    _same(jts.partition_fine(J, 4, fine_parts=fine, grouping="within"), pout)
    _contract(row, col, M, pout)
    # The coarse parts are the direct partition's.
    direct = pts.partition(P, 4)
    assert torch.equal(pout[1], direct[1])
    assert _cut(pout, M) == _cut(direct, M)


def test_partition_fine_small_fine_parts_is_partition(graph):
    M, row, col = graph
    _, P = _pair(M, row, col)
    a, b = pts.partition_fine(P, 4, fine_parts=4), pts.partition(P, 4)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    with pytest.raises(ValueError, match="grouping"):
        pts.partition_fine(P, 4, fine_parts=64, grouping="rows")


@pytest.mark.parametrize("weights", [
    [1.0, 1.0, 1.0],
    [0.5, 0.25, 0.25, 1.0],
    [3.0, 0.1, 0.2, 0.2, 7.5],
    [0.0, 1e-12, 1.0, 1e9],
])
def test_weight2metis_matches_jax(weights):
    w = np.asarray(weights, np.float32)
    want = jts.weight2metis(jnp.asarray(w))
    got = pts.weight2metis(torch.from_numpy(w))
    assert (want is None) == (got is None)
    if got is not None:
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.min() >= 1 and got.max() <= 2**31 - 1
    # numpy input with the CPU asked for
    got_np = pts.weight2metis(w, device="cpu")
    assert (got_np is None) == (got is None)
    if got is not None:
        assert torch.equal(got_np, got)


def test_weight2metis_caps_below_int32():
    w = np.asarray([0.0, 1.0, 1e12], np.float64)
    got = pts.weight2metis(torch.from_numpy(w))
    # The largest ratio is scaled onto the cap (less a rounding step).
    assert 2**31 - 3 <= got.max().item() <= 2**31 - 1
    assert got.min().item() >= 1
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jts.weight2metis(w)))


def _sbm(seed=0, B=4, NB=1000, intra=12_000, inter=2_400):
    """``tests/test_metis.py:66``'s planted blocks."""
    rng = np.random.RandomState(seed)
    N = B * NB
    rows, cols = [], []
    for b in range(B):
        rows.append(rng.randint(0, NB, intra) + b * NB)
        cols.append(rng.randint(0, NB, intra) + b * NB)
    rows.append(rng.randint(0, N, inter))
    cols.append(rng.randint(0, N, inter))
    row, col = np.concatenate(rows), np.concatenate(cols)
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    rowptr = np.zeros(N + 1, np.int64)
    np.add.at(rowptr, row + 1, 1)
    return N, NB, np.cumsum(rowptr), row, col


def test_multilevel_recovers_planted_partition():
    B = 4
    N, NB, rowptr, row, col = _sbm()
    cluster, cut = _native.multilevel_partition(rowptr, col, B)
    assert cut / (row.shape[0] // 2) < 0.10
    assert np.bincount(cluster, minlength=B).min() > 0.7 * NB
    want, wcut = jbindings.multilevel_partition(rowptr, col, B)
    assert cut == wcut and np.array_equal(cluster, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mt_partition_contract_cut_and_balance(seed):
    """Four OpenMP workers: nondeterministic, so held to the contract and
    to cut and balance bounds (``tests/test_metis.py:156``)."""
    B = 4
    N, NB, _, row, col = _sbm(seed=seed, NB=800, intra=9_000, inter=1_800)
    key = np.unique(row * N + col)
    key = key[key // N != key % N]
    r, c = key // N, key % N
    P = pts.SparseTensor(row=r, col=c, sparse_sizes=(N, N), device="cpu")
    out = P.mt_partition(B, num_workers=4)
    _contract(r, c, N, out)
    sizes = np.diff(out[1].numpy())
    assert sizes.size == B and sizes.min() > 0.5 * NB
    assert sizes.max() <= 1.05 * N / B + 1
    assert _cut(out, N) < 0.15
    out2 = pts.mt_partition(P, B, num_workers=4)
    _contract(r, c, N, out2)


def test_missing_compiler_raises(monkeypatch, tmp_path, graph):
    M, row, col = graph
    _, P = _pair(M, row, col)
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="compiler"):
        pts.partition(P, 2)
    with pytest.raises(RuntimeError, match="compiler"):
        _build.build(_build.HOST_SOURCES)


def test_host_library_builds_under_build_with_a_hashed_name():
    path = _build.build(_build.HOST_SOURCES)["host_partition"]
    assert path.exists() and path.parent.name == "build"
    assert path.name.startswith("host_partition-")
    assert "libsparse_tpu_native" not in path.name
    assert _build.library_path("host_partition") == path


@pytest.mark.parametrize("bad", ["col", "rowptr", "edge_weight",
                                 "node_weight"])
def test_native_entries_check_their_input(bad):
    """The library trusts its input, so the wrappers check it."""
    rowptr = np.array([0, 2, 3, 4])
    col = np.array([1, 2, 0, 0])
    kw = {}
    if bad == "col":
        col = np.array([1, 3, 0, 0])
    elif bad == "rowptr":
        rowptr = np.array([0, 2, 3, 5])
    elif bad == "edge_weight":
        kw["edge_weight"] = np.ones(3, np.int64)
    with pytest.raises(ValueError):
        if bad == "node_weight":
            _native.multilevel_partition(rowptr, col, 2,
                                         node_weight=np.ones(4))
        else:
            _native.multilevel_partition(rowptr, col, 2, **kw)
    if bad != "node_weight":
        with pytest.raises(ValueError):
            _native.coarsen_clusters(rowptr, col, 2, **kw)


def test_cluster_gcn_parts_match_jax():
    """The slice as a whole at a small size: the within-ordered partition
    of both packages, then on each part the diagonal block, ``gcn_norm``
    and a 3-layer GCN's loss and every parameter gradient, at the same
    weights, within 1e-5 of max |ref|."""
    import jax

    from pytorch_sparse_tpu.models import GCN as JGCN
    from pytorch_sparse_tpu.models import gcn_norm as jgcn_norm
    from pytorch_sparse_tpu_torch.models import GCN, gcn_norm

    M, row, col = _community(21, M=1024, E=10_000, n_comm=16)
    J, P = _pair(M, row, col)
    jout = jts.partition_fine(J, 4, fine_parts=16, grouping="within")
    pout = pts.partition_fine(P, 4, fine_parts=16, grouping="within")
    _same(jout, pout)
    (jadj, jpp, jperm), (padj, ppp, pperm) = jout, pout
    rng = np.random.RandomState(22)
    x = rng.randn(M, 12).astype(np.float32)
    labels = rng.randint(0, 5, M)
    params = JGCN.init(jax.random.PRNGKey(3), 12, 16, 5, num_layers=3)
    model = GCN.from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    pp, perm = ppp.numpy(), pperm.numpy()

    def rel(got, want):
        want = np.asarray(want)
        return float(np.abs(got.detach().numpy() - want).max()
                     / np.abs(want).max())

    for p in range(4):
        lo, n = int(pp[p]), int(pp[p + 1] - pp[p])
        xb, yb = x[perm[lo:lo + n]], labels[perm[lo:lo + n]]
        jblk = jgcn_norm(jadj.narrow(0, lo, n).narrow(1, lo, n))
        pblk = gcn_norm(padj.narrow(0, lo, n).narrow(1, lo, n))
        jloss, jgrad = jax.value_and_grad(JGCN.loss)(
            params, jblk, jnp.asarray(xb), jnp.asarray(yb))
        model.zero_grad()
        loss = model.loss(pblk, torch.from_numpy(xb), torch.from_numpy(yb))
        loss.backward()
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
        for i, layer in enumerate(jgrad["layers"]):
            assert rel(model.weights[i].grad, layer["w"]) <= 1e-5
            assert rel(model.biases[i].grad, layer["b"]) <= 1e-5


def test_host_library_builds_without_openmp(monkeypatch, tmp_path, graph):
    """A compiler that cannot build OpenMP code (no ``libgomp`` spec, as
    on some CUDA images) builds the library without ``-fopenmp``; the
    serial entry gives the same clusters and the threaded one runs the
    serial pipeline."""
    cxx = tmp_path / "c++-without-openmp"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do\n  if [ "$a" = -fopenmp ]; '
                   'then echo "cannot read spec file libgomp.spec" >&2; '
                   'exit 1; fi\ndone\nexec c++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.host_flags.cache_clear()
    try:
        assert "-fopenmp" not in _build.host_flags()
        M, row, col = graph
        _, P = _pair(M, row, col)
        rowptr = P.storage.numpy_view("rowptr")
        colh = P.storage.numpy_view("col")
        got, cut = _native.multilevel_partition(rowptr, colh, 8)
        want, wcut = jbindings.multilevel_partition(rowptr, colh, 8)
        assert cut == wcut and np.array_equal(got, want)
        mt, _ = _native.multilevel_partition(rowptr, colh, 8, num_workers=4)
        assert np.array_equal(mt, want)
        assert list((tmp_path / "build").glob("host_partition-*.so"))
    finally:
        _build.host_flags.cache_clear()
