"""The port's homogeneous host samplers (``csrc/host_sample.cpp``)
against the JAX package's native library and the port's plain versions.

``sample_adj``, ``neighbor_sample``, ``saint_subgraph`` and
``relabel_one_hop`` run on the port's host library, a copy of the JAX
package's ``native.cpp`` samplers.  Each library entry
(``sample._native``) must return the arrays of the JAX package's
``bindings`` (its default path here) and of the port's numpy plain
version bit for bit: degree-0 rows, full rows (``-1``), draws with and
without replacement, frontiers large enough for the library's parallel
draw, and seeds past 2**63 (taken mod 2**64, as ``ctypes`` passes them
to JAX's library).  The public functions check node ids before the
library indexes with them, raise ``TypeError`` on a non-int seed and,
without a host compiler, raise instead of falling back to numpy.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.csrc import bindings
from pytorch_sparse_tpu_torch import _build
from pytorch_sparse_tpu_torch.sample import MinibatchPrefetcher, _native
from pytorch_sparse_tpu_torch.sample._draws import native_seed
from pytorch_sparse_tpu_torch.sample.neighbor import neighbor_sample_plain
from pytorch_sparse_tpu_torch.sample.relabel import relabel_one_hop_plain
from pytorch_sparse_tpu_torch.sample.saint import saint_subgraph_plain
from pytorch_sparse_tpu_torch.sample.sample import sample_adj_plain


@pytest.fixture(autouse=True)
def _native_library():
    if not bindings.available():
        pytest.skip("the JAX package's native library (its default "
                    "sampling path) did not load")


def _csr(M, E, seed, empty_from=None, hubs=0):
    """A coalesced ``(rowptr, col)`` over ``M`` nodes: no edge leaves the
    rows from ``empty_from`` on, and ``hubs`` rows of degree > 64."""
    rng = np.random.RandomState(seed)
    top = M if empty_from is None else empty_from
    row = np.concatenate([rng.randint(0, top, E),
                          np.repeat(np.arange(hubs), 90)])
    col = np.concatenate([rng.randint(0, M, E), rng.randint(0, M, 90 * hubs)])
    key = np.unique(row * M + col)
    row, col = key // M, key % M
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=M))])
    return rowptr.astype(np.int64), col.astype(np.int64)


SMALL = dict(M=300, E=1200, seed=0, empty_from=250, hubs=5)
# 500 rows of about 20 edges: 5,000 draws at num=10, past the library's
# parallel threshold (64 rows and 4,096 candidates).
LARGE = dict(M=2000, E=40_000, seed=1, empty_from=1900)
SUBSET = np.array([0, 3, 17, 260, 4, 99, 250, 1, 2, 123, 299, 42])
SEEDS = [0, 7, 2**63 + 5, 2**64 - 1, -3]


def _subset(case):
    if case == "small":
        return _csr(**SMALL), SUBSET
    rowptr, col = _csr(**LARGE)
    return (rowptr, col), np.random.RandomState(2).permutation(2000)[:500]


def _equal(*outs):
    for arrays in outs[1:]:
        assert len(arrays) == len(outs[0])
        for a, b in zip(outs[0], arrays):
            np.testing.assert_array_equal(np.asarray(a, np.int64),
                                          np.asarray(b, np.int64))


@pytest.mark.parametrize("case", ["small", "large"])
@pytest.mark.parametrize("num", [-1, 1, 3, 10])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_adj_library_equals_jax_native_and_plain(case, num, replace,
                                                        seed):
    (rowptr, col), idx = _subset(case)
    s = native_seed(seed)
    got = _native.sample_adj(rowptr, col, idx, num, replace, s)
    _equal(got, bindings.sample_adj(rowptr, col, idx, num, replace, seed),
           sample_adj_plain(rowptr, col, idx, num, replace, s))


def test_sample_adj_degree_zero_rows():
    """Rows without edges draw nothing: an empty adjacency whose
    ``n_id`` is the subset, in the library, JAX's library and the plain
    version."""
    rowptr, col = _csr(**SMALL)
    idx = np.arange(250, 300)[::-1].copy()
    for num, replace in ((-1, False), (3, False), (3, True)):
        got = _native.sample_adj(rowptr, col, idx, num, replace, 4)
        assert got[1].size == 0 and np.array_equal(got[3], idx)
        assert np.array_equal(got[0], np.zeros(51, np.int64))
        _equal(got, bindings.sample_adj(rowptr, col, idx, num, replace, 4),
               sample_adj_plain(rowptr, col, idx, num, replace, 4))


@pytest.mark.parametrize("fanouts", [[3, 2], [-1, 4], [-1, -1], [5, 5, 5]])
@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("seed", [11, 2**63 + 1])
def test_neighbor_sample_library_equals_jax_native_and_plain(
        fanouts, directed, replace, seed):
    colptr, row = _csr(**SMALL)  # a CSC: the targets' sources
    inp = np.array([5, 0, 77, 260, 1, 140, 299, 33])
    nums = np.asarray(fanouts, np.int64)
    got = _native.neighbor_sample(colptr, row, inp, fanouts, replace,
                                  directed, seed)
    _equal(got, bindings.neighbor_sample(colptr, row, inp, nums, replace,
                                         directed, seed),
           neighbor_sample_plain(colptr, row, inp, fanouts, replace,
                                 directed, seed))
    assert np.array_equal(got[0][:inp.size], inp)


def test_neighbor_sample_large_frontier():
    """A frontier of 500 targets at fanouts 10, 5: the library's parallel
    draw, equal to JAX's and to the plain version."""
    colptr, row = _csr(**LARGE)
    inp = np.random.RandomState(3).permutation(2000)[:500]
    got = _native.neighbor_sample(colptr, row, inp, [10, 5], False, True, 9)
    _equal(got, bindings.neighbor_sample(colptr, row, inp,
                                         np.array([10, 5]), False, True, 9),
           neighbor_sample_plain(colptr, row, inp, [10, 5], False, True, 9))


@pytest.mark.parametrize("order", ["sorted", "permuted", "empty_rows"])
def test_saint_subgraph_library_equals_jax_native_and_plain(order):
    rowptr, col = _csr(**SMALL)
    idx = np.arange(0, 280, 3)
    if order == "permuted":
        idx = np.random.RandomState(3).permutation(idx)
    elif order == "empty_rows":
        idx = np.arange(240, 300)
    got = _native.saint_subgraph(rowptr, col, idx, 300)
    _equal(got, bindings.saint_subgraph(rowptr, col, idx),
           saint_subgraph_plain(rowptr, col, idx, 300))


def test_saint_subgraph_of_a_wide_matrix():
    """A matrix with more columns than rows: the library's association
    table spans the columns (JAX's library sizes it by the rows and
    would read past it), so columns past the last row are dropped."""
    M, N = 50, 400
    rng = np.random.RandomState(4)
    row, col = rng.randint(0, M, 600), rng.randint(0, N, 600)
    P = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, N),
                         device="cpu").coalesce()
    rowptr = P.storage.numpy_view("rowptr")
    cols = P.storage.numpy_view("col")
    idx = np.arange(0, 50, 2)
    got = _native.saint_subgraph(rowptr, cols, idx, N)
    _equal(got, saint_subgraph_plain(rowptr, cols, idx, N))
    sub, e_id = P.saint_subgraph(idx)
    assert sub.sparse_sizes() == (25, 25)
    assert np.array_equal(np.sort(e_id.numpy()), np.sort(got[2]))


@pytest.mark.parametrize("case", ["small", "large"])
def test_relabel_one_hop_library_equals_jax_native_and_plain(case):
    (rowptr, col), idx = _subset(case)
    got = _native.relabel_one_hop(rowptr, col, idx)
    _equal(got, bindings.relabel_one_hop(rowptr, col, idx),
           relabel_one_hop_plain(rowptr, col, idx))


def _graph():
    rowptr, col = _csr(**SMALL)
    val = np.random.RandomState(5).randn(col.size).astype(np.float32)
    J = jts.SparseTensor(rowptr=jnp.asarray(rowptr), col=jnp.asarray(col),
                         value=jnp.asarray(val), sparse_sizes=(300, 300))
    P = pts.SparseTensor(rowptr=rowptr, col=col, value=torch.from_numpy(val),
                         sparse_sizes=(300, 300), device="cpu")
    return rowptr, col, J, P


@pytest.mark.parametrize("seed", [2**63 + 11, -1])
def test_public_samplers_take_seeds_mod_two_to_the_64(seed):
    """Ints past 2**63 and negative ints reach the library mod 2**64, as
    ``ctypes`` passes them to JAX's: the public outputs are JAX's."""
    rowptr, col, J, P = _graph()
    jadj, jnid = jts.sample_adj(J, jnp.asarray(SUBSET), 4, False, seed=seed)
    padj, pnid = pts.sample_adj(P, SUBSET, 4, False, seed=seed)
    np.testing.assert_array_equal(pnid.numpy(), np.asarray(jnid))
    np.testing.assert_array_equal(padj.storage.numpy_view("col"),
                                  np.asarray(jadj.storage.col()))
    np.testing.assert_array_equal(padj.storage.value().numpy(),
                                  np.asarray(jadj.storage.value()))
    inp = np.array([5, 0, 77, 260])
    jout = jts.neighbor_sample(jnp.asarray(rowptr), jnp.asarray(col),
                               jnp.asarray(inp), [3, 2], seed=seed)
    pout = pts.neighbor_sample(rowptr, col, inp, [3, 2], seed=seed,
                               device="cpu")
    for a, b in zip(pout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_public_samplers_reject_non_int_seeds():
    rowptr, col, _, P = _graph()
    for bad in (1.5, np.random.default_rng(0), "3", True):
        with pytest.raises(TypeError, match="seed"):
            pts.sample_adj(P, SUBSET, 3, seed=bad)
        with pytest.raises(TypeError, match="seed"):
            pts.neighbor_sample(rowptr, col, SUBSET, [2], seed=bad,
                                device="cpu")


def test_public_samplers_check_node_ids():
    """Node ids outside the graph raise ``ValueError`` before the library
    indexes with them."""
    rowptr, col, _, P = _graph()
    for bad in (np.array([0, 300]), np.array([-1, 2])):
        with pytest.raises(ValueError, match="subset"):
            pts.sample_adj(P, bad, 3)
        with pytest.raises(ValueError, match="node_idx"):
            P.saint_subgraph(bad)
        with pytest.raises(ValueError, match="idx"):
            pts.relabel_one_hop(rowptr, col, None, bad, device="cpu")
        with pytest.raises(ValueError, match="input_node"):
            pts.neighbor_sample(rowptr, col, bad, [2], device="cpu")
    wild = col.copy()
    wild[7] = 300
    with pytest.raises(ValueError, match="row"):
        pts.neighbor_sample(rowptr, wild, SUBSET, [2], device="cpu")
    falling = rowptr.copy()
    falling[10] = falling[11] + 1
    with pytest.raises(ValueError, match="colptr"):
        pts.neighbor_sample(falling, col, SUBSET, [2], device="cpu")
    with pytest.raises(ValueError, match="rowptr"):
        pts.relabel_one_hop(falling, col, None, np.array([10]),
                            device="cpu")


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """No numpy fallback: without a host compiler the four samplers
    raise."""
    rowptr, col, _, P = _graph()
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.host_flags.cache_clear()
    try:
        for call in (lambda: pts.sample_adj(P, SUBSET, 3),
                     lambda: P.saint_subgraph(SUBSET),
                     lambda: pts.relabel_one_hop(rowptr, col, None, SUBSET,
                                                 device="cpu"),
                     lambda: pts.neighbor_sample(rowptr, col, SUBSET, [2],
                                                 device="cpu")):
            with pytest.raises(RuntimeError, match="compiler"):
                call()
    finally:
        _build.host_flags.cache_clear()


def test_library_calls_release_the_interpreter_lock():
    """The library is loaded as a ``ctypes.CDLL`` (not a ``PyDLL``), whose
    foreign calls release the interpreter lock."""
    lib = _build.load("host_sample")
    assert isinstance(lib, ctypes.CDLL)
    assert not isinstance(lib, ctypes.PyDLL)


def _hops(P, M, it, fanouts=(4, 3)):
    """Batch ``it`` of a GraphSAGE loader: seeds derived from ``it``,
    ``sample_adj`` per hop on the graph whose values are its edge ids."""
    frontier = torch.from_numpy(np.random.RandomState(100_000 + it).choice(
        M, 32, replace=False))
    out = []
    for h, k in enumerate(fanouts):
        adj, n_id = pts.sample_adj(P, frontier, k, seed=1000 + it * 10 + h)
        out.append((adj.storage.numpy_view("rowptr"),
                    adj.storage.value().numpy(), n_id.numpy()))
        frontier = n_id
    return out


def test_prefetcher_at_0_and_4_workers_gives_the_same_batches():
    """Batches made in a plain loop (0 workers) and through the
    prefetcher's 4 threads, whose library calls run at once: the same
    ``n_id``, ``e_id`` and ``rowptr`` of every hop, in order."""
    rowptr, col = _csr(**LARGE)
    P = pts.SparseTensor(rowptr=rowptr, col=col, value=torch.arange(
        col.size, dtype=torch.int32), sparse_sizes=(2000, 2000), device="cpu")
    want = [_hops(P, 2000, it) for it in range(12)]
    got = list(MinibatchPrefetcher(lambda it: _hops(P, 2000, it), 12,
                                   num_workers=4))
    assert len(got) == 12
    for a, b in zip(want, got):
        _equal(*[[x for hop in batch for x in hop] for batch in (a, b)])
