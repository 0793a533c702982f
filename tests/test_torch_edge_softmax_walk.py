"""The forward edge softmax K8 (``edge_softmax``, ``csrc/edge_softmax.cu``)
on the CPU: its choice of instance (``sweep_instance`` in
``ops/kernels/edge_softmax.py``), held to what the CUDA source
instantiates, and a numpy model of its lanes, heads and reductions held
against the JAX package's ``ell_edge_softmax``.

The model follows the kernel.  In the ``chunks`` instance (H dividing
32, aligned operands) lane ``s`` of a row's sub-warp holds the slab's
16-byte chunks ``c0 + s + lanes * j``, elements outside the slab masked;
each lane folds its chunks position by position (a NaN-propagating max,
then a float32 sum of the exponentials from 0), combines the positions
of one head within the lane (H = 1, 2), and the butterfly combines the
lanes over xor offsets ``lanes/2, ..., max(1, H/4)``: no true head index
enters, so a wrong lane-to-head map shows as a wrong softmax.  In the
``edges`` instance (any H, any alignment) lane ``s`` holds the row's
edges ``s + lanes * j``, four heads a pass, and the butterfly combines
every lane.  Each exponential is multiplied by ``1 / max(sum, 1e-16)``,
a NaN sum kept.
A row past the register cap sweeps its slab instead, which folds the
same chunks in the same order, so the model covers it too.  The kernel
itself runs only on the card (``tests/test_torch_kernels_gpu.py``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_sparse_tpu as jts
from pytorch_sparse_tpu.ops.kernels.ell import ell_edge_softmax
from pytorch_sparse_tpu_torch.ops.kernels import (
    edge_softmax, edge_softmax_plain)
from pytorch_sparse_tpu_torch.ops.kernels.edge_softmax import (
    CHUNKS_AT_MEAN, HEADS_A_PASS, LANE_CHUNKS, launch_sweep_instance,
    sweep_instance)
from pytorch_sparse_tpu_torch.testing import rel_err

CSRC = Path(__file__).resolve().parents[1] / "pytorch_sparse_tpu_torch" / \
    "csrc"
HEADS = [1, 2, 3, 4, 8, 16, 32]
# Rows of 0 to 2,000 edges: empty rows, one edge, around a lane's chunks
# and the sub-warp's, and rows far past the register cap.
DEGREES = [0, 1, 2, 3, 7, 8, 9, 0, 15, 16, 17, 31, 33, 0, 64, 65, 130, 2000]


# ----------------------------------------------------------------------
# The instance choice
# ----------------------------------------------------------------------

def _units(M, E, H, vec):
    """The chunks (vec 4) or edges (vec 1) of the mean row."""
    if vec == 4:
        return -(-E * H // (4 * M)) + (H < 4)
    return -(-E // M)


@pytest.mark.parametrize("H", range(1, 41))
def test_every_choice_keeps_heads_and_caps_registers(H):
    """Over mean degrees from 0 to 2,000: float4 chunks exactly where H
    divides 32 and the operands are aligned; lanes a power of two that
    divides the warp, at least H/4 (so that a lane's positions keep
    their heads: 4 * lanes is a multiple of H); a lane keeps
    ``LANE_CHUNKS`` chunks, twice that only at 32 lanes, and the cap is
    at least twice the mean row below 32 lanes."""
    for M, E in ((0, 0), (5, 0), (100, 37), (169_343, 1_335_586),
                 (232_965, 15_623_351), (23_296, 11_499_616), (3, 6000)):
        for aligned in (True, False):
            inst = sweep_instance(M, E, H, aligned)
            assert inst.vec == (4 if aligned and 32 % H == 0 else 1)
            L = inst.lanes
            assert L & (L - 1) == 0 and 1 <= L <= 32
            assert L * inst.rows_per_warp == 32
            assert inst.chunks in (LANE_CHUNKS, 2 * LANE_CHUNKS)
            assert inst.chunks == LANE_CHUNKS or L == 32
            units = _units(max(M, 1), E, H, inst.vec)
            assert L * inst.chunks >= 2 * units or L == 32
            assert L == 1 or (L // 2) * CHUNKS_AT_MEAN < units or \
                L == max(1, H // 4)
            if inst.vec == 4:
                assert L >= max(1, H // 4) and (4 * L) % H == 0


@pytest.mark.parametrize("M,E,H,want", [
    (169_343, 1_335_586, 8, (4, 8, 4, 4)),    # GAT's graph: 4 rows a warp
    (169_343, 1_335_586, 1, (4, 2, 16, 4)),   # 16 rows a warp
    (232_965, 15_623_351, 8, (4, 32, 1, 8)),  # community hybrid
    (232_965, 15_623_351, 1, (4, 16, 2, 4)),
    (169_343, 1_335_586, 3, (1, 4, 8, 4)),    # the edges instance
    (100, 0, 32, (4, 8, 4, 4)),               # at least H/4 lanes
])
def test_the_models_graphs_take_these_instances(M, E, H, want):
    assert tuple(sweep_instance(M, E, H, True)) == want


def test_a_misaligned_operand_runs_the_edges_instance():
    """logits or out off a 16-byte boundary: the edges instance."""
    rowptr_M, E, H = 50, 400, 8
    lg = torch.zeros(E, H)
    out = torch.zeros(E, H)
    off = torch.zeros(E * H + 1)[1:].view(E, H)
    assert launch_sweep_instance(rowptr_M, lg, out).vec == 4
    assert launch_sweep_instance(rowptr_M, off, out).vec == 1
    assert launch_sweep_instance(rowptr_M, lg, off).vec == 1
    assert launch_sweep_instance(rowptr_M, lg, out) == \
        sweep_instance(rowptr_M, E, H, True)


def test_the_source_instantiates_every_choice():
    """edge_softmax.cu's constants are the mirror's, its chunks instances
    run for every H that divides 32 from H/4 lanes (at least 1) to 32,
    2 * kLaneChunks only at 32 lanes, and the edges instance from 1 lane;
    the denominator keeps a NaN sum; K8b's kernels stay a warp a row."""
    src = (CSRC / "edge_softmax.cu").read_text()
    for name, value in (("kChunksAtMean", CHUNKS_AT_MEAN),
                        ("kLaneChunks", LANE_CHUNKS),
                        ("kHeadsAPass", HEADS_A_PASS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    hs = {int(h) for h in re.findall(r"case (\d+): return launch_chunks<",
                                     src)}
    assert hs == {1, 2, 4, 8, 16, 32}
    assert "template <int H, int LPR = (H < 4 ? 1 : H / 4)>" in src
    assert "template <int LPR = 1>\nint launch_edges(" in src
    assert "} else if constexpr (LPR == 32) {" in src
    assert ("in.vec = aligned && H > 0 && H <= 32 && 32 % H == 0 ? 4 : 1;"
            in src)
    assert src.count("1.f / nan_max(1e-16f,") == 4
    assert "fmaxf(sum" not in src
    assert "edge_softmax_kernel<" not in src
    assert "edge_softmax_generic_kernel" not in src
    assert "edge_softmax_bwd_kernel<H><<<" in src
    assert "edge_softmax_bwd_generic_kernel<<<" in src


# ----------------------------------------------------------------------
# A numpy model of the kernel against JAX
# ----------------------------------------------------------------------

def _nan_max(a, b):
    """The kernel's max: ``b`` where it is larger or NaN."""
    with np.errstate(invalid="ignore"):
        return np.where((b > a) | np.isnan(b), b, a)


def _combine(a, b, is_max):
    return _nan_max(a, b) if is_max else (a + b).astype(np.float32)


def _butterfly(v, lanes, lo, is_max):
    """Combine rows of ``v`` (one a lane) over xor offsets lanes/2, ...,
    lo, as the shuffles do."""
    off = lanes // 2
    while off >= lo:
        v = _combine(v, v[np.arange(lanes) ^ off], is_max)
        off //= 2
    return v


def _reduce_heads(v, H, lanes, is_max):
    """``reduce_heads``: (lanes, 4) partials to each position's head."""
    v = v.copy()
    if H == 1:
        v[:, 0] = _combine(_combine(v[:, 0], v[:, 1], is_max),
                           _combine(v[:, 2], v[:, 3], is_max), is_max)
    elif H == 2:
        v[:, 0] = _combine(v[:, 0], v[:, 2], is_max)
        v[:, 1] = _combine(v[:, 1], v[:, 3], is_max)
    nv, lo = (H, 1) if H < 4 else (4, H // 4)
    v[:, :nv] = _butterfly(v[:, :nv], lanes, lo, is_max)
    for q in range(nv, 4):
        v[:, q] = v[:, q % nv]
    return v


def _reciprocal(s):
    """1 / max(sum, 1e-16), a NaN sum kept: each exponential is
    multiplied by it."""
    d = _nan_max(np.float32(1e-16), s).astype(np.float32)
    return (np.float32(1) / d).astype(np.float32)


def _model_chunks(rowptr, lg, inst):
    """The chunks instance on every row; ``out`` NaN where not written."""
    H = lg.shape[1]
    flat, L = lg.reshape(-1), inst.lanes
    out = np.full(flat.shape, np.nan, np.float32)
    for r in range(rowptr.size - 1):
        lo, hi = int(rowptr[r]) * H, int(rowptr[r + 1]) * H
        if lo == hi:
            continue
        c0, c1 = lo // 4, (hi + 3) // 4
        J = -(-(c1 - c0) // L)
        c = c0 + np.arange(L)[:, None] + L * np.arange(J)[None, :]
        idx = 4 * c[:, :, None] + np.arange(4)
        valid = (c[:, :, None] < c1) & (idx >= lo) & (idx < hi)
        v = np.where(valid, flat[np.clip(idx, 0, flat.size - 1)], -np.inf)
        m = np.full((L, 4), -np.inf, np.float32)
        for j in range(J):
            m = _nan_max(m, v[:, j])
        m = _reduce_heads(m, H, L, True)
        with np.errstate(invalid="ignore", over="ignore"):
            e = np.where(valid, np.exp(v - m[:, None]), 0).astype(np.float32)
        s = np.zeros((L, 4), np.float32)
        for j in range(J):
            s = (s + e[:, j]).astype(np.float32)
        r = _reciprocal(_reduce_heads(s, H, L, False))
        with np.errstate(invalid="ignore", over="ignore"):
            o = (e * r[:, None]).astype(np.float32)
        out[idx[valid]] = o[valid]
    return out.reshape(lg.shape)


def _model_edges(rowptr, lg, inst):
    """The edges instance on every row: lane s holds edges s + lanes*j,
    ``HEADS_A_PASS`` heads a pass."""
    H, L = lg.shape[1], inst.lanes
    out = np.full(lg.shape, np.nan, np.float32)
    for r in range(rowptr.size - 1):
        start, n = int(rowptr[r]), int(rowptr[r + 1] - rowptr[r])
        if n == 0:
            continue
        J = -(-n // L)
        k = np.arange(L)[:, None] + L * np.arange(J)[None, :]
        live = k < n
        rows = lg[start + np.minimum(k, n - 1)]              # (L, J, H)
        for h0 in range(0, H, HEADS_A_PASS):
            nh = min(HEADS_A_PASS, H - h0)
            v = np.where(live[:, :, None], rows[:, :, h0:h0 + nh], -np.inf)
            m = np.full((L, nh), -np.inf, np.float32)
            for j in range(J):
                m = _nan_max(m, v[:, j])
            m = _butterfly(m, L, 1, True)
            with np.errstate(invalid="ignore", over="ignore"):
                e = np.where(live[:, :, None], np.exp(v - m[:, None]),
                             0).astype(np.float32)
            s = np.zeros((L, nh), np.float32)
            for j in range(J):
                s = (s + e[:, j]).astype(np.float32)
            r = _reciprocal(_butterfly(s, L, 1, False))
            with np.errstate(invalid="ignore", over="ignore"):
                o = (e * r[:, None]).astype(np.float32)
            out[(start + k)[live], h0:h0 + nh] = o[live]
    return out


def _graph(seed, degrees, N=2500):
    """Rows of the given degrees over distinct sorted columns (JAX's CSR
    order is the order given)."""
    rng = np.random.RandomState(seed)
    col = np.concatenate([np.sort(rng.choice(N, d, replace=False))
                          for d in degrees]).astype(np.int64)
    row = np.repeat(np.arange(len(degrees)), degrees)
    rowptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int64)
    return row, col, rowptr


def _logits(seed, E, H, specials):
    """N(0, 4) logits; with ``specials`` a tenth -inf, every head of
    every 13th edge -inf, NaN and +inf entries."""
    rng = np.random.RandomState(seed)
    lg = (rng.randn(E, H) * 4).astype(np.float32)
    if specials:
        lg[rng.rand(E, H) < 0.1] = -np.inf
        lg[::13] = -np.inf
        lg[rng.rand(E, H) < 0.002] = np.nan
        lg[rng.rand(E, H) < 0.001] = np.inf
    return lg


def _held_to_jax(got, ref, gate=1e-5):
    """NaN exactly where JAX has NaN, the rest within ``gate`` of max
    |ref|."""
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert rel_err(torch.from_numpy(np.where(nan, 0, got)),
                   torch.from_numpy(np.where(nan, 0, ref))) <= gate


@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_model_matches_jax_ell_edge_softmax(H, specials, aligned):
    """The model at the instance the kernel takes for this graph (chunks
    where H divides 32 and aligned, else edges) on rows of 0 to 2,000
    edges gives JAX's ``ell_edge_softmax`` within 1e-5 of max |ref|,
    with NaN where JAX has NaN (all -inf row-heads, NaN and +inf
    logits), and so does the plain version."""
    row, col, rowptr = _graph(100, DEGREES)
    M, E = rowptr.size - 1, col.size
    lg = _logits(101, E, H, specials)
    A = jts.SparseTensor(row=row, col=col, sparse_sizes=(M, 2500))
    ref = np.asarray(ell_edge_softmax(A.storage.ell(), jnp.asarray(lg)))
    inst = sweep_instance(M, E, H, aligned)
    model = _model_chunks if inst.vec == 4 else _model_edges
    got = model(rowptr, lg, inst)
    _held_to_jax(got, ref)
    if specials:
        assert np.isnan(ref).any()
    plain = edge_softmax_plain(torch.from_numpy(rowptr.astype(np.int32)),
                               torch.from_numpy(lg)).numpy()
    _held_to_jax(plain, ref)


# Every (H, lanes) of the chunks instances: lanes from max(1, H/4) to 32.
CHUNKS_INSTANCES = [(H, lanes) for H in (1, 2, 4, 8, 16, 32)
                    for lanes in (1, 2, 4, 8, 16, 32)
                    if lanes >= max(1, H // 4)]


@pytest.mark.parametrize("H,lanes", CHUNKS_INSTANCES)
def test_every_chunks_instance_keeps_its_heads(H, lanes):
    """Every (H, lanes) that the chunks instances compile, on short rows
    whose slabs of H = 1, 2 start and end inside chunks: the butterfly
    alone gives each head its max and sum (JAX within 1e-5)."""
    degrees = [1, 3, 0, 5, 2, 7, 1, 0, 11, 6, 4, 9]
    row, col, rowptr = _graph(102, degrees, N=40)
    M, E = rowptr.size - 1, col.size
    lg = _logits(103, E, H, True)
    A = jts.SparseTensor(row=row, col=col, sparse_sizes=(M, 40))
    ref = np.asarray(ell_edge_softmax(A.storage.ell(), jnp.asarray(lg)))
    for chunks in (LANE_CHUNKS, 2 * LANE_CHUNKS):
        inst = sweep_instance(M, E, H, True)._replace(
            lanes=lanes, rows_per_warp=32 // lanes, chunks=chunks)
        _held_to_jax(_model_chunks(rowptr, lg, inst), ref)


def test_a_lanes_positions_hold_one_head():
    """The kernel never computes a head: position q of lane s holds head
    (4 s + q) % H at every chunk j of every row for lanes >= H/4 (H >=
    4), and q % H for H = 1, 2, whatever the slab's offset."""
    for H, lanes in CHUNKS_INSTANCES:
        for first_edge in (0, 1, 3, 5, 8):
            c0 = first_edge * H // 4
            for s in range(lanes):
                for j in range(4):
                    for q in range(4):
                        idx = 4 * (c0 + s + lanes * j) + q
                        want = (4 * s + q) % H if H >= 4 else q % H
                        assert idx % H == want


def test_cpu_tensors_run_the_plain_version():
    """On the CPU the wrapper runs its plain version: no launch, no
    instance."""
    rowptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    lg = torch.from_numpy(_logits(104, 5, 8, False))
    before = (edge_softmax.launches, edge_softmax.last_instance)
    assert torch.equal(edge_softmax(rowptr, lg),
                       edge_softmax_plain(rowptr, lg))
    assert (edge_softmax.launches, edge_softmax.last_instance) == before
