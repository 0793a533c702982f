"""The port's typed, temporal, HGT and ego samplers against the JAX
package's native path on the same numpy inputs and ``int`` seeds.

The JAX package runs these samplers in its C++ library by default
(``bindings.available()``); the port runs its own copy
(``csrc/host_sample.cpp``).  Every output array must be equal, values
and order, per node type and relation.  The JAX outputs are int32; the
port's are int64 tensors on the device asked for (the CPU here).
"""

import os
import pathlib
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
import pytorch_sparse_tpu_torch as pts
from pytorch_sparse_tpu.csrc import bindings

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _native_library():
    if not bindings.available():
        pytest.skip("the JAX package's native library (its default "
                    "sampling path) did not load")


NODE_TYPES = ["a", "b", "c"]


def _csc(rng, n_dst, n_src, E):
    col = np.sort(rng.randint(0, n_dst, E))
    cp = np.zeros(n_dst + 1, np.int64)
    np.add.at(cp, col + 1, 1)
    return np.cumsum(cp), rng.randint(0, n_src, E).astype(np.int64)


def _typed_graph(rng, n_rel, scale=1):
    """``tests/test_sampler_properties.py``'s random typed graph: n_rel
    relations over up to three node types, some destinations isolated."""
    sizes = {nt: int(rng.randint(8, 60)) * scale for nt in NODE_TYPES}
    edge_types, colptr, rowd = [], {}, {}
    for r in range(n_rel):
        s = NODE_TYPES[rng.randint(0, len(NODE_TYPES))]
        d = NODE_TYPES[rng.randint(0, len(NODE_TYPES))]
        key = f"{s}__r{r}__{d}"
        E = int(rng.randint(0, 6 * sizes[d]))
        colptr[key], rowd[key] = _csc(rng, sizes[d], sizes[s], E)
        edge_types.append((s, f"r{r}", d))
    seeds = {nt: rng.choice(sizes[nt], size=rng.randint(1, 5),
                            replace=False)
             for nt in NODE_TYPES[:rng.randint(1, 3)]}
    return sizes, edge_types, colptr, rowd, seeds


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _assert_typed_equal(pout, jout):
    assert len(pout) == len(jout) == 4
    for p, j in zip(pout, jout):
        assert set(p) == set(j)
        for k in j:
            assert p[k].dtype == torch.int64 and p[k].device.type == "cpu"
            np.testing.assert_array_equal(
                p[k].numpy(), np.asarray(j[k]).astype(np.int64), err_msg=k)


def _hetero_both(node_types, edge_types, colptr, rowd, seeds, nn, num_hops,
                 replace, directed, seed, times=None):
    if times is None:
        jout = jts.hetero_neighbor_sample(
            node_types, edge_types, _jax(colptr), _jax(rowd), _jax(seeds),
            nn, num_hops=num_hops, replace=replace, directed=directed,
            seed=seed)
        pout = pts.hetero_neighbor_sample(
            node_types, edge_types, colptr, rowd, seeds, nn,
            num_hops=num_hops, replace=replace, directed=directed,
            seed=seed, device="cpu")
    else:
        jout = jts.hetero_temporal_neighbor_sample(
            node_types, edge_types, _jax(colptr), _jax(rowd), _jax(seeds),
            nn, _jax(times), num_hops=num_hops, replace=replace,
            directed=directed, seed=seed)
        pout = pts.hetero_temporal_neighbor_sample(
            node_types, edge_types, colptr, rowd, seeds, nn, times,
            num_hops=num_hops, replace=replace, directed=directed,
            seed=seed, device="cpu")
    _assert_typed_equal(pout, jout)
    return pout


# ---- the fixed cases of the JAX package's tests ------------------------

def _writes():
    # tests/test_neighbor_sample.py:47: author -> paper, CSC over paper.
    return ({"author__writes__paper": np.array([0, 2, 3])},
            {"author__writes__paper": np.array([0, 1, 1])})


@pytest.mark.parametrize("directed", [True, False])
def test_hetero_fixed_case(directed):
    colptr, row = _writes()
    out = _hetero_both(["paper", "author"], [("author", "writes", "paper")],
                       colptr, row, {"paper": np.array([0])},
                       {"author__writes__paper": [-1]}, 1, False, directed,
                       0)
    assert out[0]["author"].tolist() == [0, 1]
    assert out[1]["author__writes__paper"].tolist() == [0, 1]


def test_hetero_temporal_fixed_case():
    colptr, row = _writes()
    out = _hetero_both(["paper", "author"], [("author", "writes", "paper")],
                       colptr, row, {"paper": np.array([0])},
                       {"author__writes__paper": [-1]}, 1, False, True, 0,
                       times={"paper": np.array([5, 5]),
                              "author": np.array([3, 9])})
    assert out[0]["author"].tolist() == [0]


def _hgt_both(colptr, rowd, inputs, num_samples, num_hops, seed):
    jout = jts.hgt_sample(_jax(colptr), _jax(rowd), _jax(inputs),
                          num_samples, num_hops, seed=seed)
    pout = pts.hgt_sample(colptr, rowd, inputs, num_samples, num_hops,
                          seed=seed, device="cpu")
    _assert_typed_equal(pout, jout)
    return pout


@pytest.mark.parametrize("samples", [[2], [1]])
@pytest.mark.parametrize("seed", [0, 11])
def test_hgt_fixed_cases(samples, seed):
    # tests/test_hgt.py's bipartite graph: 2 papers, 3 authors.
    colptr = {"author__writes__paper": np.array([0, 2, 3])}
    row = {"author__writes__paper": np.array([0, 1, 2])}
    out = _hgt_both(colptr, row, {"paper": np.array([0, 1])},
                    {"author": samples, "paper": [0]}, 1, seed)
    assert out[0]["paper"].tolist() == [0, 1]
    assert len(out[0]["author"]) == samples[0]


def _ego_graph():
    row = np.array([0, 0, 0, 1, 1, 2, 2, 2, 2, 3, 4, 4, 5, 5])
    col = np.array([1, 2, 3, 0, 2, 0, 1, 4, 5, 0, 2, 5, 2, 4])
    return 6, row, col


def _ego_both(M, row, col, val, roots, depth, num, replace, seed):
    J = jts.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=(M, M))
    P = pts.SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, M),
                         device="cpu")
    jout = jts.ego_k_hop_sample_adj(J, jnp.asarray(roots), depth, num,
                                    replace=replace, seed=seed)
    pout = pts.ego_k_hop_sample_adj(P, roots, depth, num, replace=replace,
                                    seed=seed)
    (jadj, *jrest), (padj, *prest) = jout, pout
    for p, j in zip(prest, jrest):
        assert p.dtype == torch.int64 and p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert padj.sparse_sizes() == tuple(jadj.sparse_sizes())
    for view in ("rowptr", "col"):
        np.testing.assert_array_equal(
            padj.storage.numpy_view(view),
            np.asarray(getattr(jadj.storage, view)()).astype(np.int64))
    if val is not None:
        np.testing.assert_array_equal(padj.storage.value().numpy(),
                                      np.asarray(jadj.storage.value()))
    return pout


def test_ego_fixed_case():
    # tests/test_ego_sample.py's graph and expected stitched nets.
    M, row, col = _ego_graph()
    adj, n_id, e_id, ptr, root = _ego_both(M, row, col, None,
                                           np.array([0, 1]), 1, 3, False, 0)
    assert n_id.tolist() == [0, 1, 2, 3, 0, 1, 2]
    assert adj.storage.rowptr().tolist() == [0, 3, 5, 7, 8, 10, 12, 14]
    assert ptr.tolist() == [0, 4, 7] and root.tolist() == [0, 5]


# ---- tests/test_native_parity.py's graphs ------------------------------

def _two_type_graph(seed):
    rng = np.random.RandomState(seed)
    N = {"x": 40, "y": 30}
    colptr, rowd = {}, {}
    for s, d in (("x", "y"), ("y", "x")):
        colptr[f"{s}__to__{d}"], rowd[f"{s}__to__{d}"] = _csc(
            rng, N[d], N[s], 150)
    return rng, N, colptr, rowd


@pytest.mark.parametrize("budget", [-1, 2, 5])
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("directed", [True, False])
def test_hetero_native_parity_graph(budget, replace, directed):
    _, _, colptr, rowd = _two_type_graph(1)
    nn = {k: [budget, budget] for k in colptr}
    _hetero_both(["x", "y"], [("x", "to", "y"), ("y", "to", "x")], colptr,
                 rowd, {"x": np.array([0, 3, 7])}, nn, 2, replace, directed,
                 5)


@pytest.mark.parametrize("budget", [-1, 2, 5])
@pytest.mark.parametrize("replace", [False, True])
def test_hetero_temporal_native_parity_graph(budget, replace):
    rng, N, colptr, rowd = _two_type_graph(2)
    times = {nt: rng.randint(0, 10, N[nt]) for nt in ("x", "y")}
    nn = {k: [budget, budget] for k in colptr}
    _hetero_both(["x", "y"], [("x", "to", "y"), ("y", "to", "x")], colptr,
                 rowd, {"x": np.array([0, 3, 7])}, nn, 2, replace, True, 5,
                 times=times)


def _random_graph(M=60, E=300, seed=0, values=False):
    rng = np.random.RandomState(seed)
    key = np.unique(rng.randint(0, M, E) * M + rng.randint(0, M, E))
    val = rng.randn(key.shape[0]).astype(np.float32) if values else None
    return M, key // M, key % M, val


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("num", [-1, 1, 3, 8])
@pytest.mark.parametrize("replace", [False, True])
def test_ego_native_parity_graph(depth, num, replace):
    M, row, col, val = _random_graph(values=True)
    _ego_both(M, row, col, val, np.array([1, 5, 9, 1, 59]), depth, num,
              replace, 3)


# ---- tests/test_sampler_properties.py's randomized cases ---------------

@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("directed", [True, False])
def test_hetero_randomized(case, replace, directed):
    rng = np.random.RandomState(100 + case)
    _, edge_types, colptr, rowd, seeds = _typed_graph(
        rng, n_rel=int(rng.randint(1, 5)))
    budget, num_hops = int(rng.randint(1, 6)), int(rng.randint(1, 4))
    nn = {k: [budget] * num_hops for k in colptr}
    _hetero_both(NODE_TYPES, edge_types, colptr, rowd, seeds, nn, num_hops,
                 replace, directed, case)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("directed", [True, False])
def test_hetero_temporal_randomized(case, replace, directed):
    rng = np.random.RandomState(200 + case)
    sizes, edge_types, colptr, rowd, seeds = _typed_graph(
        rng, n_rel=int(rng.randint(1, 4)))
    width = int(rng.randint(2, 20))
    times = {nt: rng.randint(0, width, sizes[nt]) for nt in NODE_TYPES}
    budget, num_hops = int(rng.randint(1, 5)), int(rng.randint(1, 3))
    nn = {k: [budget] * num_hops for k in colptr}
    _hetero_both(NODE_TYPES, edge_types, colptr, rowd, seeds, nn, num_hops,
                 replace, directed, case, times=times)


@pytest.mark.parametrize("case", range(6))
def test_hetero_full_neighbourhood_randomized(case):
    rng = np.random.RandomState(300 + case)
    _, edge_types, colptr, rowd, seeds = _typed_graph(
        rng, n_rel=int(rng.randint(1, 5)))
    budget = -1 if case % 2 == 0 else 10 ** 6
    num_hops = int(rng.randint(1, 4))
    nn = {k: [budget] * num_hops for k in colptr}
    _hetero_both(NODE_TYPES, edge_types, colptr, rowd, seeds, nn, num_hops,
                 False, True, case)


@pytest.mark.parametrize("case", range(6))
def test_hgt_randomized(case):
    rng = np.random.RandomState(500 + case)
    _, _, colptr, rowd, seeds = _typed_graph(rng,
                                             n_rel=int(rng.randint(1, 5)))
    num_hops = int(rng.randint(1, 4))
    num_samples = {nt: [int(rng.randint(0, 12)) for _ in range(num_hops)]
                   for nt in NODE_TYPES[:int(rng.randint(1, 4))]}
    _hgt_both(colptr, rowd, seeds, num_samples, num_hops, case)


@pytest.mark.parametrize("case", range(4))
def test_hgt_hubs_past_the_neighbour_cap(case):
    """Destinations of more than 50 sources draw 50 of them (the cap),
    which consumes the stream between the budget updates."""
    rng = np.random.RandomState(600 + case)
    colptr, rowd = {}, {}
    colptr["a__r0__b"], rowd["a__r0__b"] = _csc(rng, 30, 400, 4000)
    colptr["b__r1__a"], rowd["b__r1__a"] = _csc(rng, 400, 30, 1200)
    _hgt_both(colptr, rowd, {"b": rng.choice(30, 4, replace=False)},
              {"a": [40, 20, 10], "b": [5, 5, 5]}, 3, case)


# ---- edges of the contract -----------------------------------------------

def _big_graph():
    """Two types, four relations of 12,000-30,000 edges each."""
    rng = np.random.RandomState(7)
    N = {"p": 3000, "q": 2000}
    colptr, rowd = {}, {}
    for i, (s, d, E) in enumerate((("p", "p", 30_000), ("q", "p", 12_000),
                                   ("p", "q", 20_000), ("q", "q", 15_000))):
        colptr[f"{s}__e{i}__{d}"], rowd[f"{s}__e{i}__{d}"] = _csc(
            rng, N[d], N[s], E)
    return rng, N, colptr, rowd


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("kind", ["hetero", "temporal", "hgt"])
def test_graph_past_ten_thousand_edges_a_relation(kind, replace):
    rng, N, colptr, rowd = _big_graph()
    seeds = {"p": rng.choice(N["p"], 64, replace=False)}
    edge_types = [tuple(k.split("__")) for k in colptr]
    nn = {k: [10, 5] for k in colptr}
    if kind == "hgt":
        _hgt_both(colptr, rowd, seeds, {"p": [128, 64], "q": [96, 32]}, 2,
                  31)
        return
    times = ({nt: rng.randint(2010, 2020, N[nt]) for nt in ("p",)}
             if kind == "temporal" else None)
    _hetero_both(["p", "q"], edge_types, colptr, rowd, seeds, nn, 2,
                 replace, True, 2**40 + 9, times=times)


@pytest.mark.parametrize("kind", ["hetero", "temporal", "hgt"])
def test_empty_relation_type_without_input_and_full_budget(kind):
    """A relation with no edges, a node type with no input, and
    ``num_neighbors=-1`` on another relation."""
    rng = np.random.RandomState(9)
    colptr, rowd = {}, {}
    colptr["a__full__b"], rowd["a__full__b"] = _csc(rng, 20, 25, 90)
    colptr["c__none__b"], rowd["c__none__b"] = (np.zeros(21, np.int64),
                                                np.zeros(0, np.int64))
    colptr["b__back__a"], rowd["b__back__a"] = _csc(rng, 25, 20, 80)
    seeds = {"b": np.array([3, 11, 0])}
    edge_types = [tuple(k.split("__")) for k in colptr]
    nn = {"a__full__b": [-1, -1], "c__none__b": [4, 4],
          "b__back__a": [3, -1]}
    if kind == "hgt":
        out = _hgt_both(colptr, rowd, seeds, {"a": [5, 5], "c": [5, 5]}, 2,
                        1)
    else:
        times = ({"a": rng.randint(0, 5, 25), "b": rng.randint(0, 5, 20)}
                 if kind == "temporal" else None)
        out = _hetero_both(["a", "b", "c"], edge_types, colptr, rowd, seeds,
                           nn, 2, False, True, 1, times=times)
    assert out[0]["c"].numel() == 0
    assert out[1]["c__none__b"].numel() == 0


@pytest.mark.parametrize("seed", [2**63 + 5, 2**64 - 1, -3])
@pytest.mark.parametrize("kind", ["hetero", "temporal", "hgt", "ego"])
def test_seeds_past_two_to_the_63(kind, seed):
    """Seeds are taken mod 2**64, as ctypes passes them to the JAX
    package's library."""
    if kind == "ego":
        M, row, col, _ = _random_graph()
        _ego_both(M, row, col, None, np.array([2, 4, 8]), 2, 2, False, seed)
        return
    rng, N, colptr, rowd = _two_type_graph(3)
    seeds = {"x": np.array([1, 2, 3])}
    if kind == "hgt":
        _hgt_both(colptr, rowd, seeds, {"y": [6], "x": [3]}, 1, seed)
        return
    times = ({nt: rng.randint(0, 10, N[nt]) for nt in ("x", "y")}
             if kind == "temporal" else None)
    _hetero_both(["x", "y"], [("x", "to", "y"), ("y", "to", "x")], colptr,
                 rowd, seeds, {k: [3, 3] for k in colptr}, 2, False, True,
                 seed, times=times)


def test_tensor_inputs_and_tuple_keys_give_the_same_samples():
    _, _, colptr, rowd = _two_type_graph(4)
    ets = [("x", "to", "y"), ("y", "to", "x")]
    args = dict(node_types=["x", "y"], edge_types=ets, num_hops=2, seed=8,
                device="cpu")
    a = pts.hetero_neighbor_sample(
        colptr_dict=colptr, row_dict=rowd,
        input_node_dict={"x": np.array([5, 1])},
        num_neighbors_dict={k: [2, 2] for k in colptr}, **args)
    b = pts.hetero_neighbor_sample(
        colptr_dict={tuple(k.split("__")): torch.from_numpy(v)
                     for k, v in colptr.items()},
        row_dict={k: torch.from_numpy(v).int() for k, v in rowd.items()},
        input_node_dict={"x": torch.tensor([5, 1])},
        num_neighbors_dict={tuple(k.split("__")): [2, 2] for k in colptr},
        **args)
    for da, db in zip(a, b):
        assert set(da) == set(db)
        assert all(torch.equal(da[k], db[k]) for k in da)


@pytest.mark.parametrize("kind", ["hetero", "temporal", "hgt", "ego"])
@pytest.mark.parametrize("seed", [np.random.default_rng(0), 1.5, "7", True])
def test_non_int_seed_raises(kind, seed):
    _, _, colptr, rowd = _two_type_graph(5)
    seeds = {"x": np.array([0])}
    with pytest.raises(TypeError, match="seed"):
        if kind == "hetero":
            pts.hetero_neighbor_sample(
                ["x", "y"], list(colptr), colptr, rowd, seeds,
                {k: [2] for k in colptr}, 1, seed=seed, device="cpu")
        elif kind == "temporal":
            pts.hetero_temporal_neighbor_sample(
                ["x", "y"], list(colptr), colptr, rowd, seeds,
                {k: [2] for k in colptr}, {}, 1, seed=seed, device="cpu")
        elif kind == "hgt":
            pts.hgt_sample(colptr, rowd, seeds, {"y": [2]}, 1, seed=seed,
                           device="cpu")
        else:
            M, row, col, _ = _random_graph()
            P = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M),
                                 device="cpu")
            pts.ego_k_hop_sample_adj(P, [1], 2, 2, seed=seed)


def test_out_of_range_inputs_raise_before_the_library():
    _, _, colptr, rowd = _two_type_graph(6)
    with pytest.raises(ValueError, match="outside"):
        pts.hetero_neighbor_sample(
            ["x", "y"], list(colptr), colptr, rowd, {"x": np.array([40])},
            {k: [2] for k in colptr}, 1, seed=0, device="cpu")
    bad = dict(colptr, **{"x__to__y": colptr["x__to__y"][:-1]})
    with pytest.raises(ValueError, match="colptr"):
        pts.hgt_sample(bad, rowd, {"x": np.array([0])}, {"y": [2]}, 1,
                       seed=0, device="cpu")
    bad_row = dict(rowd, **{"x__to__y": rowd["x__to__y"] + 40})
    with pytest.raises(ValueError, match="row of 'x__to__y'"):
        pts.hetero_neighbor_sample(
            ["x", "y"], list(colptr), colptr, bad_row, {"x": np.array([0])},
            {k: [2] for k in colptr}, 1, seed=0, device="cpu")
    with pytest.raises(ValueError, match="times"):
        pts.hetero_temporal_neighbor_sample(
            ["x", "y"], list(colptr), colptr, rowd, {"x": np.array([0])},
            {k: [2] for k in colptr}, {"x": np.zeros(10, np.int64)}, 1,
            seed=0, device="cpu")
    M, row, col, _ = _random_graph()
    P = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        pts.ego_k_hop_sample_adj(P, [M], 1, 2, seed=0)
    wide = pts.SparseTensor(row=row, col=col + 5, sparse_sizes=(M, M + 5),
                            device="cpu")
    with pytest.raises(ValueError, match="past the last row"):
        pts.ego_k_hop_sample_adj(wide, [1], 1, 2, seed=0)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, colptr, rowd = _two_type_graph(7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.hetero_neighbor_sample(
            ["x", "y"], list(colptr), colptr, rowd, {"x": np.array([0])},
            {k: [2] for k in colptr}, 1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pts.hgt_sample(colptr, rowd, {"x": np.array([0])}, {"y": [2]}, 1,
                       seed=0)


def test_ego_is_independent_of_the_thread_count():
    """Each root draws from a stream of its own: the library's OpenMP
    loop gives the bits of one thread at any thread count."""
    M, row, col, _ = _random_graph(M=400, E=4000, seed=2)
    roots = np.arange(0, 400, 3)
    code = (
        "import numpy as np, sys\n"
        "from pytorch_sparse_tpu_torch.sample import _native\n"
        "d = np.load(sys.argv[1])\n"
        "out = _native.ego_k_hop(d['rowptr'], d['col'], d['roots'], 2, 4, "
        "False, 12)\n"
        "np.savez(sys.argv[2], *out)\n")
    P = pts.SparseTensor(row=row, col=col, sparse_sizes=(M, M), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in.npz")
        np.savez(src, rowptr=P.storage.numpy_view("rowptr"),
                 col=P.storage.numpy_view("col"), roots=roots)
        outs = []
        for threads in ("1", "4"):
            dst = os.path.join(tmp, f"out{threads}.npz")
            env = dict(os.environ, OMP_NUM_THREADS=threads,
                       PYTHONPATH=str(ROOT))
            subprocess.run([sys.executable, "-c", code, src, dst], env=env,
                           cwd=ROOT, check=True)
            with np.load(dst) as f:
                outs.append([f[k] for k in sorted(f.files)])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
