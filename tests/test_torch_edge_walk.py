"""The per-edge walk of K4 (``edge_dot``) and K7a (``minmax_edge_dot``),
``csrc/edge_walk.cuh``, on the CPU: its choice of instance
(``edge_instance`` in ``ops/kernels/edge_dot.py``), held to what the
CUDA sources instantiate, and a numpy model of its order of sums held
against the JAX package.

The model sums each edge as the kernel does: each lane of the row's
``lanes`` adds its columns' products from 0 as one ``fmaf`` chain (pass,
chunk, then column within the chunk; K7a only the entries whose argout
names the edge), then the lanes' partials add in the butterfly's tree
(partners ``s ^ lanes/2`` first, down to ``s ^ 1``).  The transposing
butterfly that sums a batch of 8 edges at once adds each edge's
partials in that same tree.  The model is held to JAX's ``ell_edge_dot``
and ``ell_minmax_bwd``'s ``grad_value`` to 1e-5 of max |ref| in the
random, ties, inf, nan and empty-row cases.  The kernels themselves run
only on the card (``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.ops.kernels.ell import ell_edge_dot, ell_minmax_bwd
from pytorch_sparse_tpu_torch.ops.kernels import (
    edge_dot, edge_dot_plain, minmax_edge_dot, minmax_edge_dot_plain)
from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
    TILE_COLUMNS, walk_instance)
from pytorch_sparse_tpu_torch.ops.kernels.edge_dot import (
    EDGES_IN_FLIGHT, edge_instance, launch_edge_instance)

CSRC = Path(__file__).resolve().parents[1] / "pytorch_sparse_tpu_torch" / \
    "csrc"

# Degrees around the 8 edges in flight and the 32-edge index batches,
# rows of one edge, a long row, and empty rows between them.
DEGREES = [0, 1, 7, 8, 9, 0, 1, 31, 32, 33, 0, 15, 17, 2, 65, 1, 3, 130]
WIDTHS = [1, 3, 8, 40, 47, 128, 256, 300]
CASES = ["random", "ties", "inf", "nan", "empty"]


def lane_columns(K, inst):
    """Each lane's columns in the order of its ``fmaf`` chain: pass,
    chunk, column within the chunk; a chunk is live where its first
    column is below K."""
    tile = inst.lanes * inst.vec * inst.chunks
    lanes = []
    for s in range(inst.lanes):
        cols = []
        for p in range(inst.passes):
            for j in range(inst.chunks):
                first = p * tile + (s + inst.lanes * j) * inst.vec
                if first < K:
                    cols.extend(range(first, first + inst.vec))
        lanes.append(cols)
    return lanes


def _fmaf(a, b, c):
    """float32 fmaf through float64 (the product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def walk_edge_dot(rowptr, col, x, g, inst, arg=None):
    """The edge walk's sums: K4, or K7a where ``arg`` is given."""
    E, K = col.size, x.shape[1]
    row = np.repeat(np.arange(rowptr.size - 1), np.diff(rowptr))
    X, G = x[col], g[row]
    hit = None if arg is None else arg[row] == np.arange(E)[:, None]
    part = np.zeros((E, inst.lanes), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for s, cols in enumerate(lane_columns(K, inst)):
            for k in cols:
                f = _fmaf(X[:, k], G[:, k], part[:, s])
                part[:, s] = f if hit is None else np.where(hit[:, k], f,
                                                            part[:, s])
        lanes, o = np.arange(inst.lanes), inst.lanes // 2
        while o >= 1:
            part = part + part[:, lanes ^ o]
            o //= 2
    return part[:, 0]


def batch_lanes(inst):
    """Where the transposing butterfly leaves a batch's U dots: for each
    lane, the edges of the batch whose dots it holds and stores (one lane
    of each ``lanes // U`` where ``lanes > U``)."""
    U, L = inst.edges_in_flight, inst.lanes
    held = []
    for s in range(L):
        if L > U and s % (L // U):
            held.append([])
        else:
            held.append([s * U // L + i for i in range(max(1, U // L))])
    return held


def transposing_butterfly(parts):
    """The kernel's fold over ``parts`` ``(lanes, U)``: at offset o a lane
    keeps one half of its values (the upper where bit o of its place is
    set) and adds its partner's copy of it, until one value is left,
    which partners then add.  Returns each lane's values."""
    L, U = parts.shape
    v = [list(parts[s]) for s in range(L)]
    o, n = L // 2, U
    while o >= 1:
        new = []
        for s in range(L):
            up = bool(s & o)
            if n > 1:
                keep = v[s][n // 2:n] if up else v[s][:n // 2]
                recv = v[s ^ o][n // 2:n] if up else v[s ^ o][:n // 2]
                new.append([np.float32(a + b) for a, b in zip(keep, recv)])
            else:
                new.append([np.float32(v[s][0] + v[s ^ o][0])])
        v, n, o = new, max(1, n // 2), o // 2
    return v


# ----------------------------------------------------------------------
# The instance choice
# ----------------------------------------------------------------------

@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 160), (161, 300)])
def test_every_width_is_covered_exactly_once(lo, hi, aligned):
    """Each width's instance puts every column in one lane's chain once,
    in passes of at most 256 columns inside the lane; the lanes are a
    power of two that divides the warp; U edges' chunks fit a lane's 64
    registers."""
    for K in range(lo, hi + 1):
        inst = edge_instance(K, aligned)
        cols = [c for lane in lane_columns(K, inst) for c in lane]
        assert sorted(cols) == list(range(K)), (K, inst)
        tile = inst.lanes * inst.vec * inst.chunks
        assert tile <= TILE_COLUMNS
        assert (inst.passes - 1) * tile < K <= inst.passes * tile
        assert inst.passes == 1 or tile == TILE_COLUMNS
        assert inst.lanes * inst.rows_per_warp == 32
        assert inst.lanes & (inst.lanes - 1) == 0
        assert inst.vec == (4 if aligned and K % 4 == 0 else 1)
        assert inst.edges_in_flight * inst.chunks * inst.vec <= 64
        w = walk_instance(K, aligned)
        assert (inst.vec, inst.lanes, inst.chunks, inst.passes) == \
            (w.vec, w.lanes, w.chunks, w.col_tiles)


@pytest.mark.parametrize("K,rows", [(1, 32), (4, 32), (8, 16), (20, 4),
                                    (40, 2), (47, 2), (128, 1), (300, 1)])
def test_narrow_widths_walk_several_rows_a_warp(K, rows):
    """16 rows a warp at GAT's K=8, 2 at K=40, one at K=128."""
    assert edge_instance(K, True).rows_per_warp == rows
    assert edge_instance(K, False).rows_per_warp == rows


@pytest.mark.parametrize("K", [4, 8, 40, 128, 256, 300])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_one_misaligned_operand_selects_the_scalar_instance(K, which):
    """K4 reads x and g, K7a also arg: any one off a 16-byte boundary
    runs the scalar instance."""
    tensors = [torch.zeros(3, K), torch.zeros(3, K),
               torch.zeros(3, K, dtype=torch.int32)]
    assert launch_edge_instance(K, *tensors) == edge_instance(K, True)
    flat = torch.zeros(3 * K + 1, dtype=tensors[which].dtype)
    tensors[which] = flat[1:].view(3, K)
    assert launch_edge_instance(K, *tensors) == edge_instance(K, False)
    assert launch_edge_instance(K, *tensors).vec == 1


def test_every_chosen_instance_is_instantiated():
    """Both kernels launch through ``csr_walk::dispatch``, whose table
    lists every instance ``edge_instance`` chooses; the passes' kernel
    is instantiated where a pass is a full tile; U is the CSR walk's;
    the alignment covers the operands the Python mirror reads."""
    header = (CSRC / "csr_walk.cuh").read_text()
    walk = (CSRC / "edge_walk.cuh").read_text()
    cases = {tuple(int(v) for v in m) for m in re.findall(
        r"CSR_WALK_CASE\((\d+), (\d+), (\d+)\)", header)}
    chosen = {(i.vec, i.lanes, i.chunks)
              for K in range(1, 1025) for aligned in (True, False)
              for i in [edge_instance(K, aligned)]}
    assert chosen <= cases
    assert re.search(rf"constexpr int kEdgesInFlight = {EDGES_IN_FLIGHT};",
                     header)
    assert "constexpr int kEdgesInFlight = csr_walk::kEdgesInFlight;" in walk
    assert "csr_walk::dispatch(in," in walk
    assert "csr_walk::aligned16({x, g, MINMAX ? arg : nullptr})" in walk
    assert "S::LPR * S::VEC * S::CPL ==\n                         " \
        "csr_walk::kTileColumns" in walk
    assert "edge_walk::run<false>" in (CSRC / "edge_dot.cu").read_text()
    assert "edge_walk::run<true>" in (CSRC / "spmm_minmax.cu").read_text()


@pytest.mark.parametrize("lanes,U", [(1, 8), (2, 8), (4, 8), (8, 8),
                                     (16, 8), (32, 8), (32, 4), (32, 2)])
def test_transposing_butterfly_leaves_each_dot_where_the_store_reads(lanes,
                                                                     U):
    """The fold leaves edge t's dot in the lanes ``batch_lanes`` names
    (the store's rule), and each dot is the butterfly tree's sum of the
    lanes' partials, bit for bit."""
    from collections import namedtuple

    inst = namedtuple("I", "lanes edges_in_flight")(lanes, U)
    rng = np.random.RandomState(lanes * 10 + U)
    parts = rng.randn(lanes, U).astype(np.float32)
    v = transposing_butterfly(parts)
    tree = parts.T.copy()
    o = lanes // 2
    while o >= 1:
        tree = tree + tree[:, np.arange(lanes) ^ o]
        o //= 2
    stored = {}
    for s, edges in enumerate(batch_lanes(inst)):
        for i, t in enumerate(edges):
            assert t not in stored
            stored[t] = v[s][i]
    assert sorted(stored) == list(range(U))
    for t in range(U):
        assert np.float32(stored[t]) == tree[t, 0]


@pytest.mark.parametrize("K", [1, 8, 128])
def test_cpu_tensors_run_the_plain_versions(K):
    """On the CPU both wrappers run their plain versions: no launch and
    no instance."""
    rng = np.random.RandomState(96)
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col = torch.from_numpy(rng.randint(0, 4, 5).astype(np.int32))
    x = torch.from_numpy(rng.randn(4, K).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, K).astype(np.float32))
    arg = torch.from_numpy(rng.randint(0, 5, (3, K)).astype(np.int32))
    before = (edge_dot.launches, minmax_edge_dot.launches,
              edge_dot.last_instance, minmax_edge_dot.last_instance)
    assert torch.equal(edge_dot(rowptr, col, x, g),
                       edge_dot_plain(rowptr, col, x, g))
    assert torch.equal(minmax_edge_dot(rowptr, col, x, g, arg),
                       minmax_edge_dot_plain(rowptr, col, x, g, arg))
    assert (edge_dot.launches, minmax_edge_dot.launches,
            edge_dot.last_instance, minmax_edge_dot.last_instance) == before


# ----------------------------------------------------------------------
# The model of the sums against the JAX package
# ----------------------------------------------------------------------

def _case(case, K, seed):
    """``(rowptr, col, x, g)``: rows of DEGREES (``empty``: every third
    row emptied), x N(0, 1) (``ties`` small integers, ``inf`` a fifth
    -inf and some +inf, ``nan`` 2% NaN), g N(0, 1)."""
    rng = np.random.RandomState(seed)
    degrees = np.array(DEGREES * 2)
    if case == "empty":
        degrees[::3] = 0
    M, N = degrees.size, 160
    rowptr = np.concatenate([[0], np.cumsum(degrees)])
    col = np.concatenate([np.sort(rng.choice(N, d, replace=False))
                          for d in degrees]).astype(np.int64)
    x = rng.randn(N, K).astype(np.float32)
    if case == "ties":
        x = rng.randint(-2, 3, (N, K)).astype(np.float32)
    elif case == "inf":
        x[rng.rand(N, K) < 0.2] = -np.inf
        x[rng.rand(N, K) < 0.02] = np.inf
    elif case == "nan":
        x[rng.rand(N, K) < 0.02] = np.nan
    g = rng.randn(M, K).astype(np.float32)
    return rowptr, col, x, g


def _jax_matrix(rowptr, col, N):
    row = np.repeat(np.arange(rowptr.size - 1), np.diff(rowptr))
    return jts.SparseTensor(row=jnp.asarray(row.astype(np.int32)),
                            col=jnp.asarray(col.astype(np.int32)),
                            sparse_sizes=(rowptr.size - 1, N))


def _close(got, ref):
    """Within 1e-5 of max |ref| over the finite entries, and non-finite
    at the same entries with the same values."""
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    if fin.any():
        scale = np.abs(ref[fin]).max()
        assert np.abs(got[fin] - ref[fin]).max() <= 1e-5 * max(scale, 1e-30)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", WIDTHS)
def test_edge_dot_model_matches_jax_ell_edge_dot(K, case, aligned):
    rowptr, col, x, g = _case(case, K, 97)
    A = _jax_matrix(rowptr, col, x.shape[0])
    ref = np.asarray(ell_edge_dot(A.storage.ell(), jnp.asarray(x),
                                  jnp.asarray(g)))
    got = walk_edge_dot(rowptr, col, x, g, edge_instance(K, aligned))
    _close(got, ref)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    plain = edge_dot_plain(i32(rowptr), i32(col), torch.from_numpy(x),
                           torch.from_numpy(g)).numpy()
    _close(plain, ref)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", WIDTHS)
def test_minmax_edge_dot_model_matches_jax_grad_value(K, case, aligned):
    """On JAX's max argout: the masked sums equal JAX's ``grad_value``
    except on the edges where JAX multiplies a non-finite entry that the
    edge did not win by its 0 mask (NaN there, the reference defect the
    port does not copy); those equal the plain version."""
    rowptr, col, x, g = _case(case, K, 98)
    M, N, E = rowptr.size - 1, x.shape[0], col.size
    A = _jax_matrix(rowptr, col, N)
    _, arg = jts.spmm_max(A, jnp.asarray(x))
    arg = np.asarray(arg)
    ref, _ = ell_minmax_bwd(A.storage.ell(), A.storage.ell_t(),
                            jnp.asarray(col.astype(np.int32)),
                            jnp.ones(E, jnp.float32), jnp.asarray(x),
                            jnp.asarray(arg), jnp.asarray(g))
    ref = np.asarray(ref)
    got = walk_edge_dot(rowptr, col, x, g, edge_instance(K, aligned), arg)
    row = np.repeat(np.arange(M), np.diff(rowptr))
    lost_nonfinite = (~np.isfinite(x[col])
                      & (arg[row] != np.arange(E)[:, None])).any(-1)
    assert np.isnan(ref[lost_nonfinite]).all()
    _close(got[~lost_nonfinite], ref[~lost_nonfinite])
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    plain = minmax_edge_dot_plain(i32(rowptr), i32(col), torch.from_numpy(x),
                                  torch.from_numpy(g), i32(arg)).numpy()
    _close(got, plain)
    if case in ("random", "ties"):
        assert not lost_nonfinite.any()
