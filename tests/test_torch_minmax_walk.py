"""The min/max walks of K11b (``shard_spmm_minmax``, ``csrc/
minmax_walk.cuh``) and K7b (``minmax_spmm_t``, ``csrc/spmm_minmax.cu``)
on the CPU: their choice of instance (``csr_spmm.launch_instance`` over
the tensors each kernel reads and writes, and ``edges_in_flight``), held
to what the CUDA sources instantiate, and a numpy model of each walk's
order of work held against the JAX package.

K6 (``csr_spmm_minmax``, ``csrc/spmm_minmax.cu``) runs the same walk
over the whole matrix with its own end of row, for float32, float16 and
bfloat16: its instance choice (the element size in the alignment) and
the model with each product rounded to the operand's type and K6's end
of row, ``(0, E)`` on an empty row, are held to JAX's
``ell_spmm_minmax`` and the plain version bit for bit.

The model of K11b walks a row as the kernel does: index batches of
``max(lanes, U)`` edges clamped to the row's last edge, ``U`` edges at a
time with the tail edges compared too, the running best from the
sentinel (``+inf`` for min, ``-inf`` for max) under ``!(h <= best) &&
best == best`` (max), and the first edge where no edge was taken.  It
must give JAX's ``_group_ell_minmax`` and ``_combine_minmax`` bit for
bit: ties keep the first CSR edge, the first NaN wins, an all-sentinel
row takes its first edge.  The model of K7b sums each column's won
entries in CSC order with the tail edges masked.  The kernels themselves
run only on the card (``tests/test_torch_dist_gpu.py``,
``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.ops.kernels.ell import ell_spmm_minmax
from pytorch_sparse_tpu.parallel import dist as jdist
from pytorch_sparse_tpu_torch.ops.kernels import (
    csr_spmm_minmax, csr_spmm_minmax_plain, minmax_spmm_t,
    minmax_spmm_t_plain, shard_spmm_minmax, shard_spmm_minmax_plain)
from pytorch_sparse_tpu_torch.ops.kernels.csr_spmm import (
    TILE_COLUMNS, launch_instance, walk_instance)
from pytorch_sparse_tpu_torch.ops.kernels.shard_spmm import NO_EDGE

import _torch_dist_workers as W
from test_torch_csr_walk import _columns
from test_torch_dist import _jax_tables

CSRC = Path(__file__).resolve().parents[1] / "pytorch_sparse_tpu_torch" / \
    "csrc"

# csr_walk.cuh's U (walk_kernel's edges in flight) and the registers a
# lane gives a min/max walk's edges in flight.
EDGES_IN_FLIGHT, ROW_REGISTERS = 8, 64


def edges_in_flight(inst, weight):
    """``edges_in_flight`` of ``csrc/csr_walk.cuh`` for a walk that counts
    ``weight`` registers a lane for each column of an edge in flight:
    K11b 2 (its row chunk, and the best value and edge beside it), K7b 4
    (its ``arg`` and ``g`` chunks, twice)."""
    regs = weight * inst.chunks * inst.vec
    return EDGES_IN_FLIGHT if regs * EDGES_IN_FLIGHT <= ROW_REGISTERS \
        else ROW_REGISTERS // regs


# Degrees around the walks' 8 edges in flight and 32-edge index batches,
# rows of one edge, and empty rows between them.
DEGREES = [0, 1, 7, 8, 9, 0, 1, 31, 32, 33, 0, 15, 17, 2, 65, 1, 3]


def _misaligned(rows, K, dtype=torch.float32):
    """A (rows, K) tensor 4 bytes off a 16-byte boundary."""
    flat = torch.zeros(rows * K + 1, dtype=dtype)
    t = flat[1:].view(rows, K)
    assert t.data_ptr() % 16 != 0
    return t


# ----------------------------------------------------------------------
# The instance choice of K11b and K7b
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["shard_spmm_minmax", "minmax_spmm_t"])
@pytest.mark.parametrize("lo,hi", [(1, 64), (65, 160), (161, 300)])
def test_every_width_is_covered_exactly_once(kernel, lo, hi):
    """Over aligned operands each width's instance writes every column of
    the output once, in tiles of at most 256 columns; a sub-warp's lanes
    are a power of two that divides the warp; U edges' rows fit the
    registers the walk gives them."""
    weight = 2 if kernel == "shard_spmm_minmax" else 4
    for K in range(lo, hi + 1):
        t = torch.zeros(2, K)
        inst = launch_instance(K, t, t, t.int())
        assert inst == walk_instance(K, True)
        assert sorted(_columns(K, inst)) == list(range(K)), (K, inst)
        tile = inst.lanes * inst.vec * inst.chunks
        assert tile <= TILE_COLUMNS
        assert inst.lanes * inst.rows_per_warp == 32
        U = edges_in_flight(inst, weight)
        assert U & (U - 1) == 0 and 1 <= U <= EDGES_IN_FLIGHT
        assert U * weight * inst.chunks * inst.vec <= ROW_REGISTERS


@pytest.mark.parametrize("K", [4, 8, 20, 40, 128, 256, 300])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_one_misaligned_tensor_selects_the_scalar_instance(K, which):
    """K11b reads buf and writes out and arg; K7b reads g and arg and
    writes out: any one of the three off a 16-byte boundary runs the
    scalar instance, which covers the same columns."""
    tensors = [torch.zeros(3, K), torch.zeros(3, K), torch.zeros(
        3, K, dtype=torch.int32)]
    assert launch_instance(K, *tensors) == walk_instance(K, True)
    assert launch_instance(K, *tensors).vec == 4
    tensors[which] = _misaligned(3, K, tensors[which].dtype)
    inst = launch_instance(K, *tensors)
    assert inst == walk_instance(K, False) and inst.vec == 1
    assert sorted(_columns(K, inst)) == list(range(K))


@pytest.mark.parametrize("K,rows,u11b,u7b", [
    (1, 32, 8, 8), (4, 32, 8, 4), (8, 16, 8, 4), (20, 4, 8, 4),
    (40, 2, 8, 4), (128, 1, 8, 4), (256, 1, 4, 2), (300, 1, 4, 2)])
def test_narrow_widths_walk_several_rows_a_warp(K, rows, u11b, u7b):
    """Several rows (K11b) or columns (K7b) a warp below K=128, and the
    edges in flight of the aligned instance: K11b 8, and 4 where a lane
    holds two float4 chunks (K=256, 300); K7b 4 with one float4 chunk a
    lane, 2 with two, 8 with one scalar column (K=1)."""
    inst = walk_instance(K, True)
    assert inst.rows_per_warp == rows
    assert walk_instance(K, False).rows_per_warp == rows
    assert edges_in_flight(inst, 2) == u11b
    assert edges_in_flight(inst, 4) == u7b


def test_every_chosen_instance_is_instantiated_by_both_kernels():
    """Both kernels launch through ``csr_walk::dispatch``, whose table
    lists every instance ``walk_instance`` chooses, with the alignment of
    the tensors the Python mirror reads and the edges in flight it
    assumes; the walk's constants are this file's."""
    header = (CSRC / "csr_walk.cuh").read_text()
    cases = {tuple(int(v) for v in m) for m in re.findall(
        r"CSR_WALK_CASE\((\d+), (\d+), (\d+)\)", header)}
    chosen = {(i.vec, i.lanes, i.chunks)
              for K in range(1, 1025) for aligned in (True, False)
              for i in [walk_instance(K, aligned)]}
    assert chosen == cases
    for name, value in (("kEdgesInFlight", EDGES_IN_FLIGHT),
                        ("kRowRegisters", ROW_REGISTERS),
                        ("kTileColumns", TILE_COLUMNS)):
        assert re.search(rf"constexpr int {name} = {value};", header)
    shard = (CSRC / "shard_spmm.cu").read_text()
    mm = (CSRC / "spmm_minmax.cu").read_text()
    walk = (CSRC / "minmax_walk.cuh").read_text()
    assert "csr_walk::aligned16({buf, out, arg})" in shard
    assert "csr_walk::aligned16({g, arg, out})" in mm
    assert "csr_walk::dispatch(" in shard and "csr_walk::dispatch(" in mm
    assert "constexpr int U = kEdgesInFlight;" in header
    assert "edges_in_flight(2 * CPL * VEC)" in walk
    assert "edges_in_flight(4 * CPL * VEC)" in mm


@pytest.mark.parametrize("K", [1, 8, 128])
def test_cpu_tensors_run_the_plain_versions(K):
    """On the CPU both wrappers run their plain versions: no launch and
    no instance."""
    rng = np.random.RandomState(90)
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col = torch.from_numpy(rng.randint(0, 4, 5).astype(np.int32))
    buf = torch.from_numpy(rng.randn(4, K).astype(np.float32))
    before = (shard_spmm_minmax.launches, minmax_spmm_t.launches,
              shard_spmm_minmax.last_instance, minmax_spmm_t.last_instance)
    got = shard_spmm_minmax(rowptr, col, None, buf, False, 3)
    ref = shard_spmm_minmax_plain(rowptr, col, None, buf, False, 3)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    colptr = torch.tensor([0, 1, 3, 3, 5], dtype=torch.int32)
    csc_row = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32)
    csr2csc = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    g = torch.from_numpy(rng.randn(3, K).astype(np.float32))
    arg = torch.from_numpy(rng.randint(0, 5, (3, K)).astype(np.int32))
    t_args = (colptr, csc_row, csr2csc, None, g, arg)
    assert torch.equal(minmax_spmm_t(*t_args), minmax_spmm_t_plain(*t_args))
    assert (shard_spmm_minmax.launches, minmax_spmm_t.launches,
            shard_spmm_minmax.last_instance,
            minmax_spmm_t.last_instance) == before


# ----------------------------------------------------------------------
# A model of the K11b walk against JAX's group functions
# ----------------------------------------------------------------------

def _walk_minmax(rowptr, col, val, buf, is_min, U, CH, dtype=None):
    """``(best, best_e)`` of ``minmax_walk`` for each row: edges in index
    batches of ``CH`` clamped to the row's last edge, ``U`` at a time
    (tail edges compared too), from the sentinel under the ``beats``
    rule, the first edge where none was taken; ``best_e`` -1 on an empty
    row.  With a half ``dtype`` (``buf`` and ``val`` hold its values as
    float32) each product is rounded to it, as ``Elem<T>::round``
    does."""
    R, K = rowptr.size - 1, buf.shape[1]
    sentinel = np.float32(np.inf if is_min else -np.inf)
    best = np.full((R, K), sentinel, np.float32)
    best_e = np.full((R, K), -1, np.int64)
    for r in range(R):
        start, end = int(rowptr[r]), int(rowptr[r + 1])
        for base in range(start, end, CH):
            n = min(CH, end - base)
            for g in range(0, n, U):
                for u in range(U):
                    e = min(base + g + u, end - 1)
                    h = buf[col[e]]
                    if val is not None:
                        with np.errstate(over="ignore", invalid="ignore"):
                            h = (val[e] * h).astype(np.float32)
                            if dtype is not None:
                                h = h.astype(dtype).astype(np.float32)
                    b = best[r]
                    with np.errstate(invalid="ignore"):
                        worse = (h >= b) if is_min else (h <= b)
                    take = ~worse & (b == b)
                    best[r] = np.where(take, h, b)
                    best_e[r] = np.where(take, base + g + u, best_e[r])
        if start < end:
            best_e[r][best_e[r] < 0] = start
    return best, best_e


def _end_of_row(best, best_e, is_min, e0, pos, row_map, n_rows, run):
    """K11b's end of row: global ids, then a write or a combine."""
    gid = np.where(best_e < 0, NO_EDGE,
                   e0 + pos[np.maximum(best_e, 0)]).astype(np.int32)
    if run is None:
        out = np.full((n_rows, best.shape[1]), np.inf if is_min else
                      -np.inf, np.float32)
        arg = np.full(out.shape, NO_EDGE, np.int32)
        out[row_map], arg[row_map] = best, gid
        return out, arg
    out, arg = run[0].copy(), run[1].copy()
    o, a = out[row_map], arg[row_map]
    better = (best < o) if is_min else (best > o)
    better |= (best == o) & (gid < a)
    out[row_map] = np.where(better, best, o)
    arg[row_map] = np.where(better, gid, a)
    return out, arg


def _degree_group(seed, n_rows, n_buf, degrees):
    """(r, c, v, pos): a group whose rows (spread over ``n_rows`` shard
    rows) have the given degrees, in CSR order, with sign values (so
    that products of the integer operand tie) and positions into a
    shard of three times its edges."""
    rng = np.random.RandomState(seed)
    rows = np.sort(rng.choice(n_rows, len(degrees), replace=False))
    r = np.repeat(rows, degrees)
    c = rng.randint(0, n_buf, r.size)
    v = np.sign(rng.randn(r.size)).astype(np.float32)
    pos = np.sort(rng.choice(3 * r.size, r.size, replace=False))
    return r, c, v, pos


def _tie_buffer(seed, n_buf, K):
    """Small integers (ties), with -inf and +inf rows (the sentinels
    themselves) and NaN entries."""
    buf = W.tie_operand(seed, n_buf, K)
    buf[::7] = -np.inf
    buf[3::7] = np.inf
    buf[5::11, ::3] = np.nan
    return buf


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("K", [1, 8, 40, 128, 256])
def test_walk_model_matches_jax_group_minmax(is_min, combine, values,
                                             compact, K):
    """The walk's order of work at the instance K takes (its U and
    index batch) gives JAX's extreme and global argout exactly, written
    or combined into a running pair, over a compact group (rows with
    edges, sent through ``row_map``) or one with empty rows, and so does
    the plain version."""
    n_rows, n_buf, Kx, e0 = 60, 45, 12, 1000
    r, c, v, pos = _degree_group(91, n_rows, n_buf, DEGREES * 2)
    if not values:
        v = np.ones_like(v)
    buf = _tie_buffer(92, n_buf, Kx)
    E = r.size
    it, vt, et, inv = _jax_tables(r, c, v, pos, n_rows, n_buf, e0, 4 * E)
    ext, arg = jdist._group_ell_minmax(it, vt, et, inv, jnp.asarray(buf),
                                       is_min)
    run = (W.tie_operand(93, n_rows, Kx), np.random.RandomState(94).randint(
        e0, e0 + 3 * E, (n_rows, Kx)).astype(np.int32))
    if combine:
        ext, arg = jdist._combine_minmax(
            tuple(jnp.asarray(a) for a in run), (ext, arg), is_min)
    ext, arg = np.asarray(ext), np.asarray(arg)

    if compact:
        keep, counts = np.unique(r, return_counts=True)
        rowptr = np.concatenate([[0], np.cumsum(counts)])
    else:
        keep = np.arange(n_rows)
        rowptr = np.searchsorted(r, np.arange(n_rows + 1))
    inst = walk_instance(K, True)
    U = edges_in_flight(inst, 2)
    best, best_e = _walk_minmax(rowptr, c, v if values else None, buf,
                                is_min, U, max(inst.lanes, U))
    got = _end_of_row(best, best_e, is_min, e0, pos, keep, n_rows,
                      run if combine else None)
    np.testing.assert_array_equal(got[1], arg)
    np.testing.assert_array_equal(got[0], ext)

    i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32))
    row_map = i32(keep) if compact else None
    kw = dict(pos=i32(pos), row_map=row_map, n_rows=n_rows)
    if combine:
        kw = dict(pos=i32(pos), row_map=row_map,
                  out=torch.from_numpy(run[0].copy()),
                  arg=torch.from_numpy(run[1].copy()))
    plain = shard_spmm_minmax(i32(rowptr), i32(c), torch.from_numpy(v)
                              if values else None, torch.from_numpy(buf),
                              is_min, e0, **kw)
    np.testing.assert_array_equal(plain[1].numpy(), arg)
    np.testing.assert_array_equal(plain[0].numpy(), ext)


@pytest.mark.parametrize("is_min", [True, False])
def test_all_sentinel_rows_and_one_edge_rows_take_their_first_edge(is_min):
    """A row whose every product is the sentinel takes no edge in the
    walk; the end of the walk gives it its first edge, as a start from
    the first edge would.  A row of one edge takes that edge whatever
    its product, and a tail edge (the last edge read again) never
    replaces the best."""
    sent = np.inf if is_min else -np.inf
    buf = np.array([[sent, 1.0], [sent, np.nan], [2.0, 2.0]], np.float32)
    rowptr = np.array([0, 3, 4, 5, 5])
    col = np.array([0, 0, 1, 0, 2])
    for U, CH in ((8, 8), (4, 32), (1, 1)):
        best, best_e = _walk_minmax(rowptr, col, None, buf, is_min, U, CH)
        np.testing.assert_array_equal(best_e[0], [0, 2])   # sentinel, NaN
        np.testing.assert_array_equal(best_e[1], [3, 3])   # one edge
        np.testing.assert_array_equal(best_e[2], [4, 4])
        np.testing.assert_array_equal(best_e[3], [-1, -1])  # empty
        np.testing.assert_array_equal(best[0], [sent, np.nan])
        np.testing.assert_array_equal(best[1], [sent, 1.0])


# ----------------------------------------------------------------------
# A model of the K7b walk against the plain version
# ----------------------------------------------------------------------

def _walk_spmm_t(colptr, csc_row, csr2csc, val, g, arg, U, CH):
    """K7b's order of work: each column's edges in CSC order, in index
    batches of ``CH`` clamped to the column's last edge, ``U`` at a time,
    a tail edge masked, an element added where its row's arg names the
    edge (float32 sums; exact for the integer inputs below)."""
    N, K = colptr.size - 1, g.shape[1]
    out = np.zeros((N, K), np.float32)
    for c in range(N):
        start, end = int(colptr[c]), int(colptr[c + 1])
        for base in range(start, end, CH):
            n = min(CH, end - base)
            for t in range(0, n, U):
                for u in range(U):
                    p = min(base + t + u, end - 1)
                    r, e = csc_row[p], csr2csc[p]
                    v = np.float32(1.0 if val is None else val[e])
                    won = (arg[r] == e) & (t + u < n)
                    with np.errstate(invalid="ignore"):
                        out[c] = np.where(won, out[c] + v * g[r], out[c])
    return out


@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 8, 40, 128, 256])
def test_walk_model_of_minmax_spmm_t_matches_the_plain_version(values, K):
    """Integer values and gradients, so that every sum is exact: the
    walk's masked sum in CSC order equals the plain version's bit for
    bit, non-finite g on rows no edge won and values on edges that won
    nothing add nothing, and empty columns stay 0."""
    rng = np.random.RandomState(95)
    M, N = 100, len(DEGREES)
    colptr = np.concatenate([[0], np.cumsum(DEGREES)])
    E = int(colptr[-1])
    csc_row = np.concatenate([np.sort(rng.choice(M - 5, d, replace=False))
                              for d in DEGREES]).astype(np.int32)
    csr_order = np.lexsort((np.repeat(np.arange(N), DEGREES), csc_row))
    csr2csc = np.empty(E, np.int32)
    csr2csc[csr_order] = np.arange(E, dtype=np.int32)
    # Each (row, k) won by a random edge of the row; rows M-5.. empty.
    arg = np.full((M, K), E, np.int32)
    for row in range(M - 5):
        edges = csr2csc[csc_row == row]
        if edges.size:
            arg[row] = rng.choice(edges, K)
    g = rng.randint(-3, 4, (M, K)).astype(np.float32)
    g[M - 5:] = np.nan
    val = rng.randint(-2, 3, E).astype(np.float32)
    val[~np.isin(np.arange(E), arg)] = np.inf
    v = val if values else None
    inst = walk_instance(K, True)
    U = edges_in_flight(inst, 4)
    got = _walk_spmm_t(colptr, csc_row, csr2csc, v, g, arg, U,
                       max(inst.lanes, U))
    t = torch.from_numpy
    ref = minmax_spmm_t_plain(
        t(colptr.astype(np.int32)), t(csc_row), t(csr2csc),
        None if v is None else t(v), t(g), t(arg)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[np.diff(colptr) == 0], 0.0)


# ----------------------------------------------------------------------
# K6: csr_spmm_minmax on the same walk, in float32, float16 and bfloat16
# ----------------------------------------------------------------------

# (torch dtype, numpy dtype of its values, JAX dtype)
K6_TYPES = {
    "float32": (torch.float32, np.float32, jnp.float32),
    "float16": (torch.float16, np.float16, jnp.float16),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16, jnp.bfloat16),
}


def _offset(rows, K, dtype, nbytes):
    """A (rows, K) tensor ``nbytes`` past a 16-byte boundary."""
    k = nbytes // torch.tensor([], dtype=dtype).element_size()
    t = torch.zeros(rows * K + k, dtype=dtype)[k:].view(rows, K)
    assert t.data_ptr() % 16 == nbytes
    return t


@pytest.mark.parametrize("name", list(K6_TYPES))
@pytest.mark.parametrize("K", [1, 4, 8, 20, 40, 47, 128, 256, 300])
def test_k6_instance_takes_the_element_size(name, K):
    """K6's chunks are 4 elements of x's type: float4 loads for float32,
    8-byte loads for a half type.  x and out on a 4-element boundary
    (16 bytes, or 8 for a half type) and arg on 16 bytes run the float4
    instance (where K % 4 == 0); any one of them off its boundary runs
    the scalar instance, which covers the same columns."""
    dtype = K6_TYPES[name][0]
    esize = torch.tensor([], dtype=dtype).element_size()
    x, out = torch.zeros(3, K, dtype=dtype), torch.zeros(2, K, dtype=dtype)
    arg = torch.zeros(2, K, dtype=torch.int32)
    assert launch_instance(K, x, out, arg) == walk_instance(K, True)
    chunk = 4 * esize
    for nbytes in (4, 8, 12):
        want = walk_instance(K, nbytes % chunk == 0)
        assert launch_instance(K, _offset(3, K, dtype, nbytes), out,
                               arg) == want
        assert launch_instance(K, x, _offset(2, K, dtype, nbytes),
                               arg) == want
        inst = launch_instance(K, x, out, _offset(2, K, torch.int32,
                                                  nbytes))
        assert inst == walk_instance(K, False)
        assert sorted(_columns(K, inst)) == list(range(K))


def test_k6_runs_the_walk_with_its_own_end_of_row():
    """spmm_minmax.cu launches K6 as an instance of minmax_walk through
    csr_walk::dispatch, for the three dtypes of the wrapper's codes, with
    the alignment the Python mirror assumes; the old warp-a-row kernel
    is gone, and the walk has the half types' 8-byte chunk loads."""
    mm = (CSRC / "spmm_minmax.cu").read_text()
    walk = (CSRC / "minmax_walk.cuh").read_text()
    from pytorch_sparse_tpu_torch.ops.kernels.spmm_minmax import (
        _DTYPE_CODES)

    assert _DTYPE_CODES == {torch.float32: 0, torch.float16: 1,
                            torch.bfloat16: 2}
    assert "dtype: 0 float32, 1 float16, 2 bfloat16" in mm
    for t in ("float", "__half", "__nv_bfloat16"):
        assert f"launch_minmax<{t}>(" in mm
    assert "csr_walk::minmax_walk<VEC, LPR, CPL, IS_MIN, HAS_VAL>(" in mm
    assert "const uintptr_t chunk = dtype == 0 ? 16 : 8;" in mm
    assert "csr_walk::aligned16({arg})" in mm
    assert "csr_walk::dispatch(in" in mm
    assert "csr_minmax_kernel<" not in mm and "kpl_for" not in mm
    assert "av[q] = empty ? E : best_e[j][q];" in mm
    assert "ov[q] = empty ? 0.f : best[j][q];" in mm
    for t in ("__half", "__nv_bfloat16"):
        assert f"struct Bits16<{t}>" in walk
    assert "__ldg(reinterpret_cast<const uint2*>(p))" in walk
    assert "typename T = float>" in walk


def _k6_model(rowptr, col, val, x32, is_min, K, dtype):
    """K6 as the model walks it at the instance K takes: ``(out, arg)``
    with ``(0, E)`` on an empty row, ``out`` in float32."""
    inst = walk_instance(K, True)
    U = edges_in_flight(inst, 2)
    v = None if val is None else val.astype(dtype).astype(np.float32)
    best, best_e = _walk_minmax(rowptr, col, v, x32, is_min, U,
                                max(inst.lanes, U),
                                None if dtype == np.float32 else dtype)
    E = col.size
    empty = best_e < 0
    return np.where(empty, 0.0, best).astype(np.float32), \
        np.where(empty, E, best_e).astype(np.int32)


def _k6_graph(seed, N, degrees):
    """Rows of the given degrees, each over distinct sorted columns (so
    that JAX's CSR order is the order given), with small-integer values
    that include 0 (0 * inf is NaN)."""
    rng = np.random.RandomState(seed)
    col = np.concatenate([np.sort(rng.choice(N, d, replace=False))
                          for d in degrees]).astype(np.int64)
    row = np.repeat(np.arange(len(degrees)), degrees)
    rowptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    val = rng.randint(-2, 3, col.size).astype(np.float32)
    return row, col, rowptr, val


def _k6_check(row, col, rowptr, val, x32, is_min, K, name):
    """The model, JAX's ``ell_spmm_minmax`` and the plain version agree
    bit for bit (out in the operand's type, arg exactly)."""
    tdt, ndt, jdt = K6_TYPES[name]
    M, N = rowptr.size - 1, x32.shape[0]
    A = jts.SparseTensor(row=row, col=col, value=val, sparse_sizes=(M, N))
    jv = None if val is None else jnp.asarray(val)
    jout, jarg = ell_spmm_minmax(A.storage.ell(), jv,
                                 jnp.asarray(x32).astype(jdt), is_min)
    jout = np.asarray(jout.astype(jnp.float32))
    out, arg = _k6_model(rowptr, col, val, x32, is_min, K, ndt)
    np.testing.assert_array_equal(arg, np.asarray(jarg))
    np.testing.assert_array_equal(out, jout)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    pout, parg = csr_spmm_minmax_plain(
        i32(rowptr), i32(col), None if val is None else
        torch.from_numpy(val), torch.from_numpy(x32).to(tdt), is_min)
    assert pout.dtype == tdt
    np.testing.assert_array_equal(parg.numpy(), arg)
    np.testing.assert_array_equal(pout.float().numpy(), out)


@pytest.mark.parametrize("name", list(K6_TYPES))
@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("K", [1, 8, 40, 128, 256])
def test_k6_walk_model_matches_jax_ell_minmax(name, is_min, values, K):
    """The walk's order of work at K's instance (index batches clamped to
    the row's last edge, U edges at a time with the tail compared, the
    sentinel start, the first edge on a row that took none) with each
    product rounded to the operand's type and K6's end of row gives
    JAX's ELL min/max bit for bit, out and arg, and so does the plain
    version: ties keep the first CSR edge, the first NaN wins, an
    all-sentinel row takes its first edge, an empty row gives (0, E)."""
    degrees = DEGREES * 2 + [300]
    row, col, rowptr, val = _k6_graph(97, 400, degrees)
    x32 = _tie_buffer(98, 400, 12)
    x32 = x32.astype(K6_TYPES[name][1]).astype(np.float32)
    _k6_check(row, col, rowptr, val if values else None, x32, is_min, K,
              name)


@pytest.mark.parametrize("name", list(K6_TYPES))
@pytest.mark.parametrize("is_min", [True, False])
def test_k6_products_rounded_to_the_sentinel_take_the_first_edge(name,
                                                                 is_min):
    """Products that round to the sentinel in the operand's type (float16
    overflows at 65,504; bfloat16 and float32 near 3.4e38) are the
    sentinel: a row of them takes its first edge with the sentinel as
    out; a row of one edge takes it whatever its product; an empty row
    gives (0, E)."""
    big = {"float32": 3e38, "float16": 60000.0, "bfloat16": 3e38}[name]
    sign = 1.0 if is_min else -1.0
    x32 = np.array([[sign * big, 1.0], [sign * big, np.nan],
                    [sign * big, -2.0]], np.float32)
    with np.errstate(over="ignore"):
        x32 = x32.astype(K6_TYPES[name][1]).astype(np.float32)
    degrees = [3, 1, 0, 2]
    row = np.repeat(np.arange(4), degrees)
    col = np.array([0, 1, 2, 1, 0, 1])
    rowptr = np.concatenate([[0], np.cumsum(degrees)])
    val = np.array([4.0, 4.0, 4.0, -1.0, 4.0, 4.0], np.float32)
    out, arg = _k6_model(rowptr, col, val, x32, is_min, 2,
                         K6_TYPES[name][1])
    sentinel = np.inf if is_min else -np.inf
    assert out[0, 0] == sentinel and arg[0, 0] == 0
    assert np.isnan(out[0, 1]) and arg[0, 1] == 1  # the first NaN
    assert arg[1].tolist() == [3, 3]
    assert out[2].tolist() == [0.0, 0.0] and arg[2].tolist() == [6, 6]
    _k6_check(row, col, rowptr, val, x32, is_min, 2, name)


def test_k6_cpu_tensors_run_the_plain_version():
    """On the CPU the wrapper runs its plain version: no launch, no
    instance."""
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    col = torch.tensor([0, 3, 1, 1, 2], dtype=torch.int32)
    x = torch.from_numpy(np.random.RandomState(99).randn(4, 8).astype(
        np.float32))
    before = (csr_spmm_minmax.launches, csr_spmm_minmax.last_instance)
    got = csr_spmm_minmax(rowptr, col, None, x, False)
    ref = csr_spmm_minmax_plain(rowptr, col, None, x, False)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (csr_spmm_minmax.launches,
            csr_spmm_minmax.last_instance) == before
