"""The port's samplers against the JAX package on the same numpy inputs.

Indices compare exactly, and values carried through the sampled edge ids
must be equal.  The JAX package samples on the host through its native
library by default (``bindings.available()``); cases that draw nothing
are also held against its numpy fallback, forced in-process.  The walk
and ``sample`` take JAX's own uniform matrix and must return JAX's
output.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.csrc import bindings
from pytorch_sparse_tpu_torch.ops.kernels import random_walk_plain
from pytorch_sparse_tpu_torch.sample import MinibatchPrefetcher, _draws

@pytest.fixture(autouse=True)
def _native_library():
    if not bindings.available():
        pytest.skip("the JAX package's native library (its default "
                    "sampling path) did not load")


def _force_fallback(monkeypatch):
    monkeypatch.setattr(bindings, "available", lambda: False)


def _edges(M=300, E=1200, seed=0):
    """A coalesced graph with isolated nodes (no edges out of 250..299)
    and five hub rows of degree > 64, with float32 values."""
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.randint(0, 250, E), np.repeat(np.arange(5), 90)])
    col = np.concatenate([rng.randint(0, M, E), rng.randint(0, M, 450)])
    key = np.unique(row * M + col)
    row, col = key // M, key % M
    val = rng.randn(row.shape[0]).astype(np.float32)
    return M, row, col, val


def _pair(M, row, col, val=None):
    J = jts.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=(M, M))
    P = pts.SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, M),
                         device="cpu")
    return J, P


def _np(x):
    return np.asarray(x).astype(np.int64)


SUBSET = np.array([0, 3, 17, 260, 4, 99, 250, 1, 2, 123, 299, 42])


def _check_adj(jout, pout):
    (jadj, jnid), (padj, pnid) = jout, pout
    np.testing.assert_array_equal(_np(pnid), _np(jnid))
    np.testing.assert_array_equal(_np(padj.storage.rowptr()),
                                  _np(jadj.storage.rowptr()))
    np.testing.assert_array_equal(_np(padj.storage.col()),
                                  _np(jadj.storage.col()))
    assert padj.sparse_sizes() == tuple(jadj.sparse_sizes())
    np.testing.assert_array_equal(padj.storage.value().numpy(),
                                  np.asarray(jadj.storage.value()))


@pytest.mark.parametrize("num", [-1, 1, 3, 10])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_sample_adj_equals_native(seed, replace, num):
    M, row, col, val = _edges()
    J, P = _pair(M, row, col, val)
    jout = jts.sample_adj(J, jnp.asarray(SUBSET), num, replace, seed=seed)
    pout = pts.sample_adj(P, SUBSET, num, replace, seed=seed)
    _check_adj(jout, pout)
    assert pout[0].device().type == "cpu" and pout[1].dtype == torch.int32


@pytest.mark.parametrize("replace", [False, True])
def test_sample_adj_full_rows_equal_fallback(monkeypatch, replace):
    """No draw (``num_neighbors=-1``): the fallback's numpy sampler gives
    the same rows.  (With ``num >= deg`` the fallback still ranks random
    keys, so its first-seen order differs there.)"""
    num = -1
    M, row, col, val = _edges()
    J, P = _pair(M, row, col, val)
    _force_fallback(monkeypatch)
    jout = jts.sample_adj(J, jnp.asarray(SUBSET), num, replace, seed=3)
    _check_adj(jout, pts.sample_adj(P, SUBSET, num, replace, seed=3))


def test_sample_adj_method_seed_rules():
    M, row, col, val = _edges()
    J, P = _pair(M, row, col, val)
    a, nid = P.sample_adj(SUBSET, 3, seed=None)
    b, nid0 = pts.sample_adj(P, SUBSET, 3, seed=0)
    assert torch.equal(nid, nid0) and torch.equal(a.storage.col(),
                                                  b.storage.col())
    # Seeds are taken mod 2**64, as the native library's uint64.
    c, nid1 = pts.sample_adj(P, SUBSET, 3, seed=2**64 + 5)
    d, nid5 = pts.sample_adj(P, SUBSET, 3, seed=5)
    assert torch.equal(nid1, nid5)
    with pytest.raises(TypeError, match="seed"):
        pts.sample_adj(P, SUBSET, 3, seed=np.random.default_rng(0))
    with pytest.raises(TypeError, match="seed"):
        pts.sample_adj(P, SUBSET, 3, seed=1.5)


def _csc(M, row, col):
    """(colptr, row) of the graph: edges grouped by target, as
    ``neighbor_sample`` reads them."""
    order = np.lexsort((row, col))
    colptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=M))])
    return colptr, row[order]


INPUT = np.array([5, 0, 77, 260, 1, 140, 299, 33])


def _check_neighbor(jout, pout):
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(_np(p), _np(j))


@pytest.mark.parametrize("fanouts", [[3, 2], [-1, 4]])
@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("replace", [False, True])
def test_neighbor_sample_equals_native(fanouts, directed, replace):
    M, row, col, _ = _edges(seed=1)
    colptr, rows = _csc(M, col, row)  # in-edges of a node: its CSR row here
    jout = jts.neighbor_sample(jnp.asarray(colptr), jnp.asarray(rows),
                               jnp.asarray(INPUT), fanouts, replace,
                               directed, seed=11)
    pout = pts.neighbor_sample(colptr, rows, INPUT, fanouts, replace,
                               directed, seed=11, device="cpu")
    _check_neighbor(jout, pout)
    assert np.array_equal(_np(pout[0][:INPUT.size]), INPUT)


@pytest.mark.parametrize("directed", [True, False])
def test_neighbor_sample_full_equals_fallback(monkeypatch, directed):
    M, row, col, _ = _edges(seed=1)
    colptr, rows = _csc(M, col, row)
    _force_fallback(monkeypatch)
    jout = jts.neighbor_sample(jnp.asarray(colptr), jnp.asarray(rows),
                               jnp.asarray(INPUT), [-1, -1], False,
                               directed, seed=4)
    _check_neighbor(jout, pts.neighbor_sample(colptr, rows, INPUT, [-1, -1],
                                              directed=directed, seed=4,
                                              device="cpu"))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("permuted", [False, True])
def test_saint_subgraph_equals_jax(monkeypatch, native, permuted):
    M, row, col, val = _edges(seed=2)
    J, P = _pair(M, row, col, val)
    idx = np.arange(0, 280, 3)
    if permuted:
        idx = np.random.RandomState(3).permutation(idx)
    if not native:
        _force_fallback(monkeypatch)
    jsub, je = jts.saint_subgraph(J, jnp.asarray(idx))
    psub, pe = P.saint_subgraph(idx)
    np.testing.assert_array_equal(_np(pe), _np(je))
    np.testing.assert_array_equal(_np(psub.storage.row()),
                                  _np(jsub.storage.row()))
    np.testing.assert_array_equal(_np(psub.storage.col()),
                                  _np(jsub.storage.col()))
    np.testing.assert_array_equal(psub.storage.value().numpy(),
                                  np.asarray(jsub.storage.value()))
    assert psub.sparse_sizes() == (idx.size, idx.size)


def test_relabel_equals_jax():
    rng = np.random.RandomState(4)
    col = rng.randint(0, 90, 400)
    idx = rng.permutation(90)[:25]
    jl, jn = jts.relabel(jnp.asarray(col), jnp.asarray(idx))
    pl, pn = pts.relabel(col, idx, device="cpu")
    np.testing.assert_array_equal(_np(pl), _np(jl))
    np.testing.assert_array_equal(_np(pn), _np(jn))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("bipartite", [True, False])
def test_relabel_one_hop_equals_jax(monkeypatch, native, bipartite):
    M, row, col, val = _edges(seed=5)
    J, P = _pair(M, row, col, val)
    rowptr, c = J.storage.rowptr(), J.storage.col()
    if not native:
        _force_fallback(monkeypatch)
    jout = jts.relabel_one_hop(rowptr, c, jnp.asarray(val), jnp.asarray(
        SUBSET), bipartite)
    pout = pts.relabel_one_hop(np.asarray(rowptr), np.asarray(c),
                               torch.from_numpy(val), SUBSET, bipartite,
                               device="cpu")
    for i in (0, 1, 3):
        np.testing.assert_array_equal(_np(pout[i]), _np(jout[i]))
    np.testing.assert_array_equal(pout[2].numpy(), np.asarray(jout[2]))


def _walk_graph():
    """Rows of degree 0 (80..99 have no out-edges), long rows and a node
    whose only edge leads to a dead end."""
    rng = np.random.RandomState(6)
    M = 100
    row = np.concatenate([rng.randint(0, 80, 600), [3] * 70])
    col = np.concatenate([rng.randint(0, M, 600), rng.randint(0, M, 70)])
    return M, row, col


@pytest.mark.parametrize("L", [1, 5, 20])
def test_random_walk_equals_jax(L):
    M, row, col = _walk_graph()
    J, P = _pair(M, row, col)
    start = np.concatenate([np.arange(M), np.arange(M)[::-1]])
    key = jax.random.PRNGKey(L)
    want = jts.random_walk(J, jnp.asarray(start), L, key)
    rand = np.asarray(jax.random.uniform(key, (start.size, L)))
    got = pts.random_walk(P, start, L, rand=rand)
    assert got.dtype == torch.int32 and got.shape == (start.size, L + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[80:100] == torch.arange(80, 100)[:, None]).all()
    np.testing.assert_array_equal(
        P.random_walk(start, L, rand=rand).numpy(), got.numpy())


def test_random_walk_generator_is_deterministic():
    M, row, col = _walk_graph()
    _, P = _pair(M, row, col)
    start = np.arange(M)
    a = pts.random_walk(P, start, 12,
                        generator=torch.Generator().manual_seed(9))
    b = pts.random_walk(P, start, 12,
                        generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    assert torch.equal(pts.random_walk(P, start, 12),
                       pts.random_walk(P, start, 12))
    # Every step is an edge of the graph, or a stay at a degree-0 node.
    edges = set(zip(row.tolist(), col.tolist()))
    deg = np.bincount(row, minlength=M)
    for w in a.numpy():
        for u, v in zip(w[:-1], w[1:]):
            assert (u, v) in edges or (deg[u] == 0 and u == v)


def test_random_walk_checks_rand():
    M, row, col = _walk_graph()
    _, P = _pair(M, row, col)
    with pytest.raises(ValueError, match="shape"):
        pts.random_walk(P, np.arange(4), 3, rand=torch.rand(4, 2))
    with pytest.raises(TypeError, match="float32"):
        pts.random_walk(P, np.arange(4), 3,
                        rand=torch.rand(4, 3, dtype=torch.float64))
    rp, c, _ = P.csr()
    with pytest.raises(ValueError, match="shape"):
        random_walk_plain(rp, c, torch.arange(4, dtype=torch.int32),
                          torch.rand(5, 3))


@pytest.mark.parametrize("start", [[0, -1, 5], [99, 100], [10**6]])
def test_random_walk_rejects_start_outside_the_graph(start):
    M, row, col = _walk_graph()
    _, P = _pair(M, row, col)
    with pytest.raises(ValueError, match="start nodes"):
        pts.random_walk(P, start, 3)


@pytest.mark.parametrize("bad", [1.0, -0.25, float("nan")])
def test_random_walk_rejects_rand_outside_unit_interval(bad):
    M, row, col = _walk_graph()
    _, P = _pair(M, row, col)
    rand = torch.rand(4, 3)
    rand[2, 1] = bad
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        pts.random_walk(P, np.arange(4), 3, rand=rand)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        pts.sample(P, 3, np.arange(4), rand=rand)


@pytest.mark.parametrize("subset", [None, np.array([7, 90, 3, 3, 85])])
def test_sample_equals_jax(subset):
    M, row, col = _walk_graph()
    J, P = _pair(M, row, col)
    key = jax.random.PRNGKey(2)
    n = M if subset is None else subset.size
    want = jts.sample(J, 6, None if subset is None else jnp.asarray(subset),
                      key)
    rand = np.asarray(jax.random.uniform(key, (n, 6)))
    got = pts.sample(P, 6, subset, rand=rand)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        P.sample(6, subset, rand=rand).numpy(), got.numpy())


def test_sample_degree_zero_rows_reference_defect():
    """Reference defect (``pytorch_sparse_tpu/sample/sample.py:42-45``): a
    row of degree 0 draws position ``rowptr[row]``, which belongs to the
    next row's neighbours, and past the last edge ``jnp.take`` fills
    ``-2**31``.  The port matches both."""
    key = jax.random.PRNGKey(1)
    rand = np.asarray(jax.random.uniform(key, (3, 4)))
    # Row 2 (the last) is empty: its position is E.  Then row 1 (in the
    # middle) is empty: its position is row 2's first edge, column 0.
    for row, col, empty, fill in [([0, 0, 1], [1, 2, 0], 2, -2**31),
                                  ([0, 0, 2], [1, 2, 0], 1, 0)]:
        J = jts.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                             sparse_sizes=(3, 3))
        P = pts.SparseTensor(row=np.array(row), col=np.array(col),
                             sparse_sizes=(3, 3), device="cpu")
        want = np.asarray(jts.sample(J, 4, key=key))
        got = pts.sample(P, 4, rand=rand).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[empty] == fill).all()


def test_draw_stream_matches_splitmix_and_xoshiro_reference():
    """The vectorized stream against a scalar Python transcription of
    ``native.cpp:43-73`` (arbitrary-precision ints, masked to 64 bits)."""
    mask = (1 << 64) - 1

    def splitmix(x):
        x = (x + 0x9E3779B97F4A7C15) & mask
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return x, z ^ (z >> 31)

    def rotl(x, k):
        return ((x << k) | (x >> (64 - k))) & mask

    def draws(seed, stream, element, ns):
        x = (seed ^ ((0x9E3779B97F4A7C15 * (stream + 1)) & mask)
             ^ ((0xBF58476D1CE4E5B9 * (element + 1)) & mask))
        s = []
        for _ in range(4):
            x, z = splitmix(x)
            s.append(z)
        out = []
        for n in ns:
            res = (rotl((s[1] * 5) & mask, 7) * 9) & mask
            t = (s[1] << 17) & mask
            s[2] ^= s[0]
            s[3] ^= s[1]
            s[1] ^= s[2]
            s[0] ^= s[3]
            s[2] ^= t
            s[3] = rotl(s[3], 45)
            out.append((res * n) >> 64)
        return out

    elements = np.array([0, 1, 5, 1000, 2**31 + 7])
    ns = [1, 2, 97, 2**40 + 1, 2**62 + 3]
    for seed, stream in [(0, 0), (2**63 + 11, 3), (12345, 1)]:
        st = _draws.seed_states(seed, stream, elements)
        got = np.stack([_draws.below(st, np.full(elements.size, n))
                        for n in ns], axis=1)
        want = [draws(seed, stream, int(e), ns) for e in elements]
        np.testing.assert_array_equal(got, np.array(want, np.int64))


def test_floyd_draws_are_distinct_and_in_row():
    starts = np.array([0, 100, 300, 1000])
    deg = np.array([100, 200, 15, 5000])
    rix, e = _draws.draw_candidates(starts, deg, 15, False, 8, 2)
    assert np.array_equal(rix, np.repeat(np.arange(4), 15))
    for i in range(4):
        mine = e[rix == i]
        assert np.unique(mine).size == 15
        assert ((mine >= starts[i]) & (mine < starts[i] + deg[i])).all()
    assert np.array_equal(e[rix == 2], np.arange(300, 315))  # whole row


# MinibatchPrefetcher: the JAX package's ``tests/test_loader.py`` cases.
def test_loader_order_preserved_under_racing_workers():
    def make(it):
        time.sleep(0.002 * (8 - it % 8))
        return it * 10

    got = list(MinibatchPrefetcher(make, 24, num_workers=4, depth=6))
    assert got == [it * 10 for it in range(24)]


def test_loader_single_worker_matches_multi():
    def make(it):
        return (it, it ** 2)

    a = list(MinibatchPrefetcher(make, 17, num_workers=1))
    b = list(MinibatchPrefetcher(make, 17, num_workers=5, depth=3))
    assert a == b


def test_loader_depth_bounds_in_flight():
    lock = threading.Lock()
    live, peak = [0], [0]

    def make(it):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.005)
        return it

    for _ in MinibatchPrefetcher(make, 30, num_workers=8, depth=3):
        with lock:
            live[0] -= 1
        time.sleep(0.002)
    assert peak[0] <= 3


def test_loader_worker_exception_propagates():
    def make(it):
        if it == 5:
            raise RuntimeError("sampler exploded")
        return it

    with pytest.raises(RuntimeError, match="sampler exploded"):
        list(MinibatchPrefetcher(make, 10, num_workers=2))


def test_loader_batches_equal_synchronous_sampling():
    """Seeds derived from the batch index give the same sampled batches
    through the prefetcher as in a plain loop."""
    M, row, col, val = _edges(seed=7)
    _, P = _pair(M, row, col, val)

    def make(it):
        adj, nid = pts.sample_adj(P, SUBSET, 4, seed=100 + it)
        return nid.tolist(), adj.storage.col().tolist()

    want = [make(it) for it in range(6)]
    assert list(MinibatchPrefetcher(make, 6, num_workers=3)) == want
